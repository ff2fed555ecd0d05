#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, in order; any
failure exits non-zero:

1. Environment: the card's name and power limit, torch's version, and the
   build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and timed with CUDA events (median of 25 samples
   after warm-up) beside its plain version, one PyTorch call computing the
   same function where there is one, and its bound on an H100 SXM
   (3.35 TB/s, 989 TFLOP/s bf16 dense).
3. The main path at full width: qwen2-moe-a2.7b with every width as
   published, depth cut to 2 layers, seeded random weights.  Build the
   compressed store (groups compressed in parallel), check every expert
   tensor loads bit-exactly, then serve a batch of 4 requests for 8 greedy
   tokens through ``ZipServer(device_cache=True, ffn_impl="ragged")`` with
   an F pool smaller than a step's distinct experts, and hold its logits
   against the resident model under teacher forcing.  A second server with
   every expert slab-resident must move zero h2d and zero weight-copy
   bytes on its decode steps.
4. One JSON line with each kernel's launches on the main path, error, times
   and bound; then the result line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2-moe-a2.7b"
N_LAYERS = 2                 # the only cut: depth (24 published)
BATCH = 4                    # requests served together
NEW_TOKENS = 8
SEED = 0
POOLS_SMALL = {"F": 8, "C": 8, "S": 16, "E": 16}   # F < a step's ~16 experts
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12     # dense bf16 tensor-core peak
# ragged GEMM vs its f32 plain version: both sum in f32 but in another
# order, and both round once to bf16, so outputs may differ by a bf16 ulp
# of the largest outputs; allow two (2^-7 of the largest |output|)
GEMM_REL_TOL = 2.0 ** -7
# served vs resident logits: bf16 activations (ulp 2^-8 relative) through
# 2 layers whose expert sums run in other orders (slab kernel vs bmm) and
# whose gates are rounded at other places.  Measured 0.74% of the largest
# |logit| on the H100; the CPU parity tests hold the port to 2% of it
LOGIT_REL_TOL = 0.02


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def med_ms(fn, torch, samples: int = 25, per: int = 10, warm: int = 5):
    """Median over `samples` of the mean time of `per` back-to-back calls,
    from CUDA events, after `warm` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / per)
    return statistics.median(out)


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------
def kernel_phase(torch, np, dev, cfg):
    from repro_torch.core import bitfield
    from repro_torch.kernels import _build, moe_gemm, recovery, ref
    lib = _build.library()
    d, f = cfg.d_model, cfg.d_expert
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    # -- splice: all 65,536 bit patterns, then full-width tensors ----------
    u = torch.arange(65536, dtype=torch.int32, device=dev).to(torch.int16)
    e, s = bitfield.decompose(u.view(torch.bfloat16))
    got = recovery.recover_bf16(e, s)
    check(torch.equal(got.view(torch.int16), u),
          "splice differs from the bit pattern it should rebuild")
    sets = []      # 8 distinct full-width planes: 92 MB, more than the L2
    for _ in range(8):
        sets.append((torch.randint(0, 256, (d * f,), dtype=torch.uint8,
                                   device=dev, generator=g),
                     torch.randint(0, 256, (d * f,), dtype=torch.uint8,
                                   device=dev, generator=g)))
    e, s = sets[0]
    k = recovery.recover_bf16(e, s)
    r = ref.recover_bf16_ref(e, s)
    check(torch.equal(k.view(torch.int16), r.view(torch.int16)),
          "splice [2048, 1408] not bit-exact against its plain version")
    print(f"splice: 65536 patterns and [{d}, {f}] bit-exact", flush=True)
    out = torch.empty(d * f, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    it = [0]

    def splice_k():
        a, b = sets[it[0] % 8]
        it[0] += 1
        lib.zipmoe_splice(a.data_ptr(), b.data_ptr(), out.data_ptr(), d * f,
                          stream)

    def splice_p():
        a, b = sets[it[0] % 8]
        it[0] += 1
        ref.recover_bf16_ref(a, b)

    ms = med_ms(splice_k, torch)
    pms = med_ms(splice_p, torch)
    bms, by = bound(4.0 * d * f, 0.0)
    res["splice"] = dict(
        name="splice", route="cuda",
        source="src/repro_torch/kernels/csrc/recovery.cu",
        replaces="src/repro/kernels/recovery.py:44",
        max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=None, shape=[d, f])

    # -- splice-admit into a [cap, 2048, 1408] slab ------------------------
    cap, slot = 8, 5
    buf = torch.randn((cap, d, f), device=dev, generator=g).to(torch.bfloat16)
    before = buf.clone()
    w = torch.randn((d, f), device=dev, generator=g).to(torch.bfloat16)
    e, s = bitfield.decompose(w)
    want = ref.splice_admit_ref(buf, e, s, slot)
    ptr = buf.data_ptr()
    moe_gemm.slab_splice_admit(buf, e, s, slot)
    torch.cuda.synchronize()
    check(buf.data_ptr() == ptr, "splice-admit moved the slab")
    check(torch.equal(buf.view(torch.int16), want.view(torch.int16)),
          "splice-admit differs from its plain version")
    check(torch.equal(buf[slot].view(torch.int16), w.view(torch.int16)),
          "splice-admit slot does not hold the spliced tensor")
    others = [i for i in range(cap) if i != slot]
    check(torch.equal(buf[others].view(torch.int16),
                      before[others].view(torch.int16)),
          "splice-admit touched another slot")
    print(f"splice-admit: slot {slot} of [{cap}, {d}, {f}] bit-exact, other "
          f"slots byte-identical, data_ptr unchanged", flush=True)
    del before, want

    def admit_k():
        a, b = sets[it[0] % 8]
        it[0] += 1
        lib.zipmoe_splice_admit(buf.data_ptr(), it[0] % cap, d * f,
                                a.data_ptr(), b.data_ptr(), stream)

    def admit_p():
        a, b = sets[it[0] % 8]
        it[0] += 1
        buf[it[0] % cap] = ref.recover_bf16_ref(a, b).view(d, f)

    ms = med_ms(admit_k, torch)
    pms = med_ms(admit_p, torch)
    bms, by = bound(4.0 * d * f, 0.0)
    res["splice_admit"] = dict(
        name="splice_admit", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:172",
        max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=None, shape=[cap, d, f])
    del buf, sets

    # -- slot-indexed ragged GEMM at the main path's shapes ----------------
    # a decode step of 4 tokens x top-4: 16 (token, expert) pairs, one
    # 8-row tile each; here 14 distinct slots, a repeated slot and a pad
    # tile, against a stack of 16 experts
    n_e = 16
    ts = np.asarray(list(range(14)) + [3, 0], np.int32)
    T = ts.size * 8
    errs, times = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0}
    flops = nbytes = 0.0
    for (dd, ff) in ((d, f), (f, d)):           # gate/up, then down
        x = torch.randn((T, dd), device=dev, generator=g).to(torch.bfloat16)
        x[8:16] = 0                              # a singleton group
        x[9] = torch.randn((dd,), device=dev, generator=g).to(torch.bfloat16)
        x[-8:] = 0                               # the pad tile
        wb = (torch.randn((n_e, dd, ff), device=dev, generator=g)
              * 0.02).to(torch.bfloat16)
        k = moe_gemm.slab_ragged_gemm(x, wb, ts).float()
        r = ref.slab_gemm_ref(x, wb, ts).float()
        err = (k - r).abs().max().item()
        scale = r.abs().max().item()
        check(err <= GEMM_REL_TOL * scale,
              f"ragged GEMM [{dd}->{ff}] error {err} > "
              f"{GEMM_REL_TOL} x {scale}")
        errs.append(err)
        ts_d = torch.from_numpy(ts).to(dev)
        ts_l = ts_d.long()
        o = torch.empty((T, ff), dtype=torch.bfloat16, device=dev)
        times["ms"] += med_ms(lambda: lib.zipmoe_slab_gemm(
            x.data_ptr(), wb.data_ptr(), ts_d.data_ptr(), o.data_ptr(),
            T // 8, dd, ff, dd * ff, stream), torch)
        times["plain_ms"] += med_ms(lambda: ref.slab_gemm_ref(x, wb, ts),
                                    torch)
        times["library_ms"] += med_ms(lambda: torch.bmm(
            x.view(T // 8, 8, dd), wb.index_select(0, ts_l)), torch)
        distinct = len(set(ts.tolist()))
        nbytes += 2.0 * T * dd + 2.0 * distinct * dd * ff + 4 * ts.size \
            + 2.0 * T * ff
        flops += 2.0 * T * dd * ff
        print(f"ragged GEMM [{T}, {dd}] x slab[{n_e}, {dd}, {ff}]: max abs "
              f"err {err:.3g} (max |out| {scale:.3g}, tolerance "
              f"{GEMM_REL_TOL:.3g} x max |out|)", flush=True)
        del wb
    bms, by = bound(nbytes, flops)
    res["slab_gemm"] = dict(
        name="slab_gemm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:123",
        max_abs_err=max(errs), ms=times["ms"], plain_ms=times["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=times["library_ms"],
        shape=[T, d, f, "+", T, f, d])
    return res


# ----------------------------------------------------------------------------
# phase 3: the main path at full width
# ----------------------------------------------------------------------------
def main_path(torch, np, dev, cfg, store_dir):
    from repro_torch.core import bitfield
    from repro_torch.core.codec import DEFAULT_CODEC
    from repro_torch.core.store import build_store
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.zipserve import ZipServer

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"init_params: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    store = build_store(params, cfg, store_dir, device=dev)
    build_s = time.perf_counter() - t0
    print(f"build_store: codec {store.codec.name} (default {DEFAULT_CODEC}), "
          f"{len(store.groups)} groups, {os.cpu_count()} threads, "
          f"{build_s:.1f} s, ratio {store.ratio():.4f}", flush=True)

    # losslessness: every expert tensor loads bit-exactly
    from concurrent.futures import ThreadPoolExecutor
    keys = sorted(store.groups)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        loaded = pool.map(lambda key: (key, store.load_group(key)), keys)
        n_t = 0
        for (l, e), group in loaded:
            ffn = params["layers"][l]["ffn"]
            for name, bits in group.items():
                got = bitfield.from_bits(bits).to(dev)
                check(torch.equal(got.view(torch.int16),
                                  ffn[name][e].view(torch.int16)),
                      f"store tensor {(l, e, name)} not bit-exact")
                n_t += 1
    store.close()
    print(f"lossless: {n_t} expert tensors load bit-exactly", flush=True)

    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1))
                              ).to(dev)
    T = NEW_TOKENS + 1

    # -- the main path: small pools, device slabs, ragged FFN --------------
    zs = ZipServer(params, cfg, store_dir, L=6, pool_sizes=POOLS_SMALL,
                   device_cache=True, ffn_impl="ragged", prefetch=True,
                   device=dev)
    try:
        caches = zs.init_cache(BATCH, T)
        tok = prompt
        inputs, logits, steps = [], [], []
        torch.cuda.synchronize()
        _build.reset_launches()
        for i in range(NEW_TOKENS):
            t1 = time.perf_counter()
            inputs.append(tok)
            lg, caches = zs.decode_step(tok, caches, i)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            tok.cpu()                      # step ends when its token is known
            steps.append(time.perf_counter() - t1)
            logits.append(lg)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        stats = list(zs.stats)
        ov = zs.overlap_summary()
        cs = zs.cache_summary()
    finally:
        zs.close()
    served = torch.cat(inputs[1:] + [tok], dim=1).cpu().numpy()
    print(f"served {BATCH} requests x {NEW_TOKENS} tokens: "
          f"{served.tolist()}", flush=True)
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    tpot = statistics.mean(steps[1:])
    n_moe = len(cfg_moe_layers(cfg))
    blocked = sum(s["blocked_s"] for s in stats[n_moe:]) / (NEW_TOKENS - 1)
    print(f"TPOT (steps 2..{NEW_TOKENS}, {N_LAYERS} layers, pools "
          f"{POOLS_SMALL}): {tpot * 1e3:.1f} ms, of which "
          f"{blocked * 1e3:.1f} ms blocked on expert reconstruction; first "
          f"step {steps[0] * 1e3:.1f} ms; h2d_bytes {ov['h2d_bytes']}, "
          f"w_copy_bytes {ov['w_copy_bytes']}, splice_ops "
          f"{ov['splice_ops']}, pad_frac {ov['pad_frac']:.3f}, hit rate "
          f"{cs.get('hit_rate')}", flush=True)

    # -- resident model under teacher forcing -------------------------------
    # Rows are independent requests.  A token whose router picks another
    # expert set in the two models (a near-tie in router probabilities
    # flipped by bf16 noise) takes another FFN, and its row's KV cache
    # differs from then on: such a row is reported and left out of the
    # logit comparison for the rest of the run.
    rcache = init_cache(cfg, BATCH, T, device=dev)
    served_routes = [s["routes"] for s in stats]   # per step, per MoE layer
    live = np.ones(BATCH, bool)
    worst, agree, compared, flips = 0.0, 0, 0, []
    for i in range(NEW_TOKENS):
        ids = []
        rl, rcache = decode_step(params, cfg, inputs[i], rcache, i,
                                 router_ids=ids)
        for j, r_ids in enumerate(ids):
            mine = served_routes[i * n_moe + j]
            theirs = r_ids.reshape(BATCH, -1).cpu().numpy()
            for b in range(BATCH):
                if live[b] and set(mine[b]) != set(theirs[b]):
                    live[b] = False
                    flips.append((i, j, b))
        a, b_ = logits[i].float(), rl.float()
        check(bool(torch.isfinite(a).all()), f"non-finite logits at step {i}")
        check(a.shape == (BATCH, 1, cfg.vocab_size), f"logits {a.shape}")
        agree += int((a.argmax(-1) == b_.argmax(-1)).sum().item())
        if not live.any():
            continue
        rows = torch.from_numpy(np.flatnonzero(live)).to(dev)
        err = (a[rows] - b_[rows]).abs().max().item()
        scale = b_[rows].abs().max().item()
        worst = max(worst, err / scale)
        compared += int(live.sum())
        check(err <= LOGIT_REL_TOL * scale,
              f"step {i}: served vs resident logits differ by {err} "
              f"(> {LOGIT_REL_TOL} x {scale}) on identically routed rows "
              f"{np.flatnonzero(live).tolist()}")
    check(compared >= BATCH * NEW_TOKENS // 2,
          f"only {compared} (step, row) pairs routed identically")
    print(f"served vs resident logits on identically routed rows "
          f"({compared}/{BATCH * NEW_TOKENS} (step, row) pairs; routing "
          f"flips at (step, layer, row) {flips}): max |diff| / max |logit| "
          f"= {worst:.4g} (tolerance {LOGIT_REL_TOL}); greedy tokens agree "
          f"{agree}/{BATCH * NEW_TOKENS}", flush=True)

    # -- a fully cache-hit step: zero h2d and zero weight copy --------------
    ample = {"F": cfg.n_experts, "C": 0, "S": 0, "E": 0}
    zs = ZipServer(params, cfg, store_dir, L=6, pool_sizes=ample,
                   device_cache=True, ffn_impl="ragged", prefetch=True,
                   device=dev)
    try:
        for l in zs._moe_layers:           # warm every expert into the slab
            zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
        caches = zs.init_cache(BATCH, T)
        lg, caches = zs.decode_step(prompt, caches, 0)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        h2d0, w0 = zs.engine.h2d_bytes, zs.engine.w_copy_bytes
        g0 = _build.LAUNCHES["slab_gemm"]
        hit_steps, dev_ms = [], []
        for i in range(1, 4):
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            ev0.record()
            lg, caches = zs.decode_step(tok, caches, i)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            ev1.record()
            tok.cpu()
            hit_steps.append(time.perf_counter() - t1)
            dev_ms.append(ev0.elapsed_time(ev1))
        h2d = zs.engine.h2d_bytes - h2d0
        wc = zs.engine.w_copy_bytes - w0
        n_gemm = _build.LAUNCHES["slab_gemm"] - g0
    finally:
        zs.close()
    check(h2d == 0 and wc == 0,
          f"cache-hit steps moved h2d {h2d} / weight-copy {wc} bytes")
    check(n_gemm == 3 * 3 * len(cfg_moe_layers(cfg)),
          f"cache-hit steps launched the ragged GEMM {n_gemm} times")
    print(f"cache-hit steps: h2d_bytes 0, w_copy_bytes 0, {n_gemm} ragged "
          f"GEMM launches straight from the slabs; TPOT "
          f"{statistics.mean(hit_steps) * 1e3:.1f} ms host wall, "
          f"{statistics.mean(dev_ms):.1f} ms between the step's first and "
          f"last stream events", flush=True)
    return launches, {"tpot_ms": tpot * 1e3, "blocked_ms": blocked * 1e3,
                      "hit_tpot_ms": statistics.mean(hit_steps) * 1e3,
                      "hit_stream_ms": statistics.mean(dev_ms),
                      "build_store_s": build_s}


def cfg_moe_layers(cfg):
    return [i for i in range(cfg.n_layers) if cfg.moe_layer(i)]


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python "
          f"{sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    print(f"config {ARCH}: d_model {cfg.d_model}, {cfg.n_heads} heads x "
          f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"d_expert {cfg.d_expert}, {cfg.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}; depth cut {get_config(ARCH).n_layers} -> "
          f"{N_LAYERS} layers", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels: built={_build.BUILD_INFO['built']} in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.BUILD_INFO['path']}",
          flush=True)

    kres = kernel_phase(torch, np, dev, cfg)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_store_",
                                     dir=ROOT / "build") as tmp:
        launches, e2e = main_path(torch, np, dev, cfg, tmp)
    for name, r in kres.items():
        r["launches"] = launches[name]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")
    print(json.dumps({"main_path": e2e, "card": card}), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kres.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
