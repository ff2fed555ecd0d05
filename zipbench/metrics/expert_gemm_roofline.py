"""The routed-expert GEMMs' share of their roofline over the profiled
sub-window: the least time their work needs (``work.expert_ffn_work`` per
layer-step: each distinct routed expert's weights read once, each routed
token's activation read and written once; bound by 3.35 TB/s or 989
TFLOP/s) over the device time of the kernels named in KERNELS, %.  A
window whose steps routed tokens but ran no such kernel is an error."""
from zipbench import work

KERNELS = ("zipmoe_gemm_kernel",)


def read(v):
    if v.device is None or not v.device["ops"] or not v.prof_stats:
        return None
    least = 0.0
    for st in v.prof_stats:
        routes = st["routes"]
        n_pairs = routes.size
        n_distinct = len({int(e) for e in routes.reshape(-1)})
        least += work.least_seconds(*work.expert_ffn_work(
            v.cfg, n_distinct, n_pairs))
    dev = sum(e - s for name, s, e, d in v.device["ops"]
              if d == 0 and any(k in name for k in KERNELS)) * 1e-6
    if dev <= 0.0:
        raise RuntimeError("expert_gemm_roofline: the profiled steps routed "
                           "tokens but no kernel named in KERNELS ran")
    return 100.0 * least / dev
