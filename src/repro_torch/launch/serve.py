"""Serving driver of the port: batched requests through the ZipMoE engine
or resident params, on the CUDA card (``--device cpu`` runs it on the
CPU with the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --mode zipmoe-batch --device-cache --requests 8 --max-new 16

--arch takes any entry of ``repro_torch.configs.registry``: the MoE
configs qwen2-moe-a2.7b (qwen1.5-moe-a2.7b), deepseekv2-lite,
deepseek-v2-236b and jamba-v0.1-52b (hybrid), the SSM mamba2-370m and the
dense granite-8b, deepseek-coder-33b, starcoder2-3b and qwen3-14b, served
at the CLI's smoke size (d_model 256, 6 layers, vocab 2048).  A config
without routed experts keeps its FFNs resident in the zipmoe modes (the
store holds them, nothing is fetched).

--mode resident     : in-memory serving (BatchServer: prefill + decode on
                      the resident weights).
--mode zipmoe       : routed experts live ONLY in the compressed store; every
                      MoE layer fetches through cache pools + the Alg-1
                      scheduler, with overlapped prefetch (--no-prefetch to
                      compare against the synchronous path).
--mode zipmoe-batch : continuous batching (BatchServer) over the compressed
                      store — requests admit/retire between decode steps
                      into a shared KV page pool, one Algorithm-1 block list
                      per step over the union of active requests.
                      --max-concurrency N caps the active set,
                      --arrival-trace replays offsets (e.g. ``0,0.05,0.1``),
                      --static-batch serves the epoch discipline instead
                      (the static-batch baseline).  Prints TTFT/TPOT/queue-
                      delay percentiles and the per-request table;
                      --spans also the ``spans:`` line, the host time of
                      each span of the decode step (``core/spans``), ms
                      per step.

Cache knobs (§3.4): --mem-budget BYTES (live pool planning; --replan-every,
--plan-step, --budget-split), --pool-sizes F,C,S,E, --cache-mode flat
(--flat-policy, --flat-capacity), --delta, --device-cache (device slabs:
splice-admit on a miss, the ragged FFN reads slots in place), --ffn-impl
ragged|grouped|loop.  Scheduler knobs (§3.3): --profile-p-times,
--cross-layer-depth N|auto, --freq-decay, --cache-window N.  Failure model:
--fault-plan SPEC, --no-verify, --fetch-deadline.

Peer-HBM tier (tier stack F/P/C/S/E): --mesh N (> 1) gives the store's
expert shards slab rows on N devices, --peer-devices the list (default
the cards cuda:0 .. cuda:N-1, and an error naming the cards found when
fewer are visible; ``cuda:0,cuda:0,cuda:0,cuda:0`` stands four rows on one
card, ``cpu,cpu,cpu,cpu`` runs on the CPU; the first must be --device),
--peer-budget BYTES each row's budget under --mem-budget (default
--mem-budget).  Prints the ``peer:`` line (link-served experts,
fallbacks, collective-permute and put bytes, the link's bandwidth).

The zipmoe modes print ``cache:`` telemetry next to the ``overlap:`` line
(zipmoe) or the ``metrics:`` and ``request[..]`` lines (zipmoe-batch).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import spans
from repro_torch.core.faults import FaultPlan
from repro_torch.core.store import build_store
from repro_torch.device import resolve_device, resolve_peer_devices
from repro_torch.models import init_params
from repro_torch.models.model import check_supported
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer


def print_sched_telemetry(zs, args):
    """Windowed cache series, measured p-time buckets, plans and faults
    (both ZipMoE modes)."""
    if args.cache_window:
        ws = zs.cache_summary(windows=True)["windows"]
        print("cache windows (hit rate per",
              f"{args.cache_window}-step window):",
              " ".join(f"{w['step_end']}:{w['hit_rate']:.2f}" for w in ws))
    if args.profile_p_times:
        ps = zs.p_time_summary()
        print(f"p-times: {ps['n_buckets']} buckets, "
              f"{ps['n_measurements']} measured "
              f"({ps['measure_wall_s']*1e3:.1f}ms profiling)")
    if args.mem_budget is not None:
        pls = zs.plan_summary()
        order = zs.engine.stack.order      # F/C/S/E, plus P on a mesh
        sizes = {l: "".join(f"{p}{s[p]}" for p in order if p in s)
                 for l, s in sorted((int(l), d["sizes"])
                                    for l, d in pls["layers"].items())}
        print(f"plan: budget={pls['mem_budget']:.0f}B "
              f"resident={pls['bytes_resident']:.0f}B "
              f"replans={pls['n_replans']} "
              f"({', '.join(ev['reason'] for ev in pls['replans'])}) "
              f"sizes={sizes}")
    if args.mesh > 1:
        ps = zs.peer_summary()
        print(f"peer: served={ps['served']} fallbacks={ps['fallbacks']} "
              f"collective_bytes={ps['total_bytes']} "
              f"put_bytes={ps['peer_put_bytes']} "
              f"link_bw={ps['link']['bw']/1e9:.1f}GB/s")
    if zs._auto_depth:
        ov = zs.overlap_summary()
        print(f"auto-depth: depth={ov['cross_layer_depth']} "
              f"changes={len(ov['depth_events'])}")
    fs = zs.fault_summary()
    if args.fault_plan or fs["failed_experts"] or fs["worker_restarts"]:
        st = fs["store"]
        print(f"faults: injected={fs.get('injected', {}).get('total', 0)} "
              f"retries={st['read_retries']} "
              f"checksum_failures={st['checksum_failures']} "
              f"quarantined={st['quarantined']} "
              f"worker_restarts={fs['worker_restarts']} "
              f"deadline_hits={fs['deadline_hits']} "
              f"spec_drops={fs['spec_drops']} "
              f"fallback_loads={fs['fallback_loads']} "
              f"failed_experts={fs['failed_experts']} "
              f"refetches={fs['fault_refetches']}")


def print_transfer(zs, n_steps: int):
    """The ``overlap:``, ``transfer:`` and ``gemm:`` lines."""
    ov = zs.overlap_summary()
    print(f"overlap: hidden={ov['hidden_fetch_s']*1e3:.1f}ms of "
          f"{ov['total_fetch_s']*1e3:.1f}ms fetch "
          f"(frac={ov['hidden_frac']:.2f}, pred_hits={ov['pred_hits']} "
          f"misses={ov['pred_misses']})")
    print(f"transfer: h2d={ov['h2d_bytes']/1e6:.2f}MB "
          f"({ov['h2d_bytes']/n_steps/1e3:.1f}kB/step) "
          f"w_copy={ov['w_copy_bytes']/1e6:.2f}MB "
          f"splice={ov['splice_ms']:.1f}ms/{ov['splice_ops']}ops "
          f"slab_writes={ov['slab_writes']} "
          f"slab_resident={ov['slab_resident']}")
    print(f"gemm: pad_frac={ov['pad_frac']:.3f} "
          f"(real={ov['tokens_real']} padded={ov['tokens_padded']} rows) "
          f"compiles={ov['gemm_compiles']}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--mode", default="zipmoe",
                    choices=["resident", "zipmoe", "zipmoe-batch"])
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable overlapped expert prefetch")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-concurrency", type=int, default=None,
                    help="continuous batching: max requests decoding at "
                         "once (admit/retire between steps; default "
                         "--batch)")
    ap.add_argument("--arrival-trace", default=None,
                    help="comma-separated arrival offsets in seconds, one "
                         "per request (cycled), replayed from serve start; "
                         "e.g. ``0,0.05,0.1``")
    ap.add_argument("--spans", action="store_true",
                    help="zipmoe-batch: record the decode step's spans and "
                         "print their host time per step (the spans: line)")
    ap.add_argument("--static-batch", action="store_true",
                    help="zipmoe-batch: use the epoch discipline (bucket, "
                         "prefill together, decode in lockstep) instead of "
                         "continuous batching")
    ap.add_argument("--store-dir", default=None,
                    help="where to build the compressed store (default: a "
                         "temporary directory, removed at exit)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--bandwidth-gbps", type=float, default=None,
                    help="emulate a slow offload tier")
    ap.add_argument("--pool-sizes", default=None,
                    help="hierarchical pool capacities F,C,S,E per layer "
                         "(default 2,2,4,8; with --mem-budget: a static "
                         "override of the initial plan)")
    ap.add_argument("--mem-budget", type=float, default=None,
                    help="global cache byte budget: per-layer pools are "
                         "planned online (§3.4) and re-planned under "
                         "drift instead of using fixed --pool-sizes")
    ap.add_argument("--replan-every", type=int, default=16,
                    help="probe the windowed hit rate every N decode steps "
                         "and re-plan the pools on drift (--mem-budget)")
    ap.add_argument("--plan-step", type=float, default=0.25,
                    help="γ grid resolution of the §3.4 pool-ratio search")
    ap.add_argument("--cache-mode", default="hier", choices=["hier", "flat"],
                    help="hierarchical F/C/S/E pools vs flat full-tensor map")
    ap.add_argument("--flat-policy", default="lru",
                    choices=["lru", "fifo", "lfu", "marking"])
    ap.add_argument("--flat-capacity", type=int, default=None,
                    help="flat-mode capacity (default: sum of pool sizes)")
    ap.add_argument("--delta", type=int, default=1,
                    help="dispatch-threshold rank tolerance δ")
    ap.add_argument("--device-cache", action="store_true",
                    help="device-resident expert slabs: fused splice-admit "
                         "on the card, F pool holds slab slots, the ragged "
                         "FFN reads the slab in place by slot index")
    ap.add_argument("--ffn-impl", default="ragged",
                    choices=["ragged", "grouped", "loop"],
                    help="expert FFN path: slot-indexed ragged GEMM "
                         "(default), padded grouped GEMM, or the per-token "
                         "reference loop")
    ap.add_argument("--profile-p-times", action="store_true",
                    help="sort Algorithm-1 blocks by measured per-expert "
                         "grouped-GEMM times instead of class constants")
    ap.add_argument("--cross-layer-depth", default="0",
                    help="extend each step submission with the next N MoE "
                         "layers' predictions under one block schedule; "
                         "'auto' tunes N online from the observed "
                         "hidden-fetch fraction")
    ap.add_argument("--mesh", type=int, default=1,
                    help="shard the compressed store's experts over N "
                         "devices ('ep' axis) and add the peer-HBM (P) "
                         "tier: hits on experts resident in a neighbor's "
                         "slab row copy over the link instead of the host "
                         "decode path")
    ap.add_argument("--peer-devices", default=None,
                    help="comma-separated devices of the --mesh rows, the "
                         "first the compute device (default: cuda:0 .. "
                         "cuda:N-1; e.g. cpu,cpu,cpu,cpu)")
    ap.add_argument("--budget-split", default="proportional",
                    choices=["proportional", "waterfill"],
                    help="cross-layer byte-budget split: activity-"
                         "proportional, or water-filling on marginal "
                         "makespan gain per byte")
    ap.add_argument("--peer-budget", type=float, default=None,
                    help="per-device peer-slab byte budget (default: "
                         "--mem-budget)")
    ap.add_argument("--freq-decay", type=float, default=1.0,
                    help="FreqTracker exponential decay (<1 forgets stale "
                         "popularity under drifting traces; 1.0 = never)")
    ap.add_argument("--cache-window", type=int, default=0,
                    help="record cache hit/miss deltas every N decode steps "
                         "(cache_summary windowed series; 0 = off)")
    ap.add_argument("--fault-plan", default=None,
                    help="seeded fault injection spec, e.g. "
                         "'bitflip:p=0.1;eio:count=3;worker_kill:count=1;"
                         "seed=42' (kinds: bitflip, truncate, eio, delay, "
                         "worker_kill)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip per-chunk checksum verification on read")
    ap.add_argument("--fetch-deadline", type=float, default=120.0,
                    help="seconds before a blocked expert fetch raises "
                         "FetchTimeout instead of hanging (0 = unbounded)")
    args = ap.parse_args(argv)
    if args.mesh < 1:
        ap.error("--mesh expects a device count >= 1")
    if args.cross_layer_depth != "auto":
        try:
            args.cross_layer_depth = int(args.cross_layer_depth)
        except ValueError:
            ap.error("--cross-layer-depth expects an integer or 'auto'")
    args.pool_sizes_dict = None
    if args.pool_sizes is None and args.mem_budget is None:
        args.pool_sizes = "2,2,4,8"     # static default, no planner
    if args.pool_sizes is not None:
        parts = args.pool_sizes.split(",")
        try:
            args.pool_sizes_dict = dict(zip("FCSE", (int(x) for x in parts)))
        except ValueError:
            args.pool_sizes_dict = None
        if args.pool_sizes_dict is None or len(parts) != 4:
            ap.error("--pool-sizes expects exactly 4 comma-separated "
                     "integers (F,C,S,E), e.g. 2,2,4,8")
    return args


def serve_zip(args, params, cfg, dev, store_dir, rng):
    """The two ZipMoE modes over a store built in `store_dir`."""
    store = build_store(params, cfg, store_dir, device=dev)
    print(f"store: {store_dir} ratio={store.ratio():.3f} "
          f"rho={store.rho():.3f}")
    store.close()
    zs = ZipServer(params, cfg, store_dir, L=args.workers,
                   pool_sizes=args.pool_sizes_dict,
                   bandwidth_gbps=args.bandwidth_gbps,
                   prefetch=not args.no_prefetch,
                   ffn_impl=args.ffn_impl,
                   cache_mode=args.cache_mode,
                   flat_capacity=args.flat_capacity,
                   flat_policy=args.flat_policy, delta=args.delta,
                   profile_p_times=args.profile_p_times,
                   cross_layer_depth=args.cross_layer_depth,
                   freq_decay=args.freq_decay,
                   cache_window=args.cache_window,
                   device_cache=args.device_cache,
                   mem_budget=args.mem_budget,
                   replan_every=args.replan_every,
                   plan_step=args.plan_step,
                   budget_split=args.budget_split,
                   mesh_devices=args.mesh,
                   peer_budget=args.peer_budget,
                   peer_devices=args.peer_devs,
                   verify=False if args.no_verify else None,
                   faults=(FaultPlan.parse(args.fault_plan)
                           if args.fault_plan else None),
                   fetch_deadline_s=args.fetch_deadline or None,
                   device=dev)
    try:
        if args.mode == "zipmoe-batch":
            serve_batch(args, cfg, zs, rng)
        else:
            serve_steps(args, cfg, zs, rng)
        print_sched_telemetry(zs, args)
    finally:
        zs.close()


def serve_batch(args, cfg, zs, rng):
    arrivals = ([float(x) for x in args.arrival_trace.split(",")]
                if args.arrival_trace else [0.0])
    srv = BatchServer(None, cfg, max_batch=args.batch,
                      max_len=args.prompt_len + args.max_new,
                      zip_server=zs, max_concurrency=args.max_concurrency,
                      continuous=not args.static_batch)
    for i in range(args.requests):
        srv.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                   args.max_new, arrival_s=arrivals[i % len(arrivals)])
    if args.spans:
        spans.enable()
    try:
        srv.run()
    finally:
        spans.disable()
    print("metrics:", srv.metrics())
    for rid, d in sorted(srv.request_summary().items()):
        parts = []
        if d.get("error"):
            parts.append(f"FAILED ({d['error']})")
        if d["ttft_s"] is not None:
            parts.append(f"ttft={d['ttft_s']*1e3:.1f}ms")
        if d["tpot_s"] is not None:
            parts.append(f"tpot={d['tpot_s']*1e3:.1f}ms")
        if d["queue_delay_s"] is not None:
            parts.append(f"qdelay={d['queue_delay_s']*1e3:.1f}ms")
        if "cache_hit_rate" in d:
            parts.append(f"hit_rate={d['cache_hit_rate']:.2f}")
        print(f"request[{rid}]: toks={d['n_tokens']}", " ".join(parts))
    print("cache:", srv.cache_summary())
    n_steps = max(1, len(zs.stats) // max(1, len(zs._moe_layers)))
    print_transfer(zs, n_steps)
    if args.spans:
        split = spans.split(spans.take())
        print("spans:", " ".join(f"{k}={v:.3f}" if k != "steps"
                                 else f"steps={v}"
                                 for k, v in split.items()),
              f"dropped={spans.dropped()}")


def serve_steps(args, cfg, zs, rng):
    B, S = args.batch, args.prompt_len
    caches = zs.init_cache(B, S + args.max_new)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    t0 = time.time()
    out, caches, m = zs.generate(tok, caches, S, max_new_tokens=args.max_new)
    print(f"generated {out.shape} in {time.time()-t0:.2f}s "
          f"tpot={m['tpot_s']*1e3:.1f}ms")
    io = sum(s["io_bytes"] for s in zs.stats)
    print(f"expert I/O total={io/1e6:.2f}MB over {len(zs.stats)} "
          f"layer-fetches")
    cs = zs.cache_summary()
    print(f"cache[{cs['mode']}]: hits by state:", cs["hits"],
          f"misses: {cs['misses']} hit_rate={cs['hit_rate']:.2f}")
    print("cache transitions:", cs["transitions"],
          f"evictions={cs['evictions']} occupancy={cs['occupancy']}")
    print_transfer(zs, max(1, args.max_new))


def main(argv=None):
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch, d_model=256, n_layers=6,
                           vocab_size=2048)
    check_supported(cfg, "rows")
    dev = resolve_device(args.device)
    args.peer_devs = None
    if args.mesh > 1 and args.mode != "resident":
        try:
            args.peer_devs = resolve_peer_devices(
                args.mesh, args.peer_devices.split(",")
                if args.peer_devices else None)
        except (RuntimeError, ValueError) as e:
            sys.exit(f"serve: --mesh {args.mesh}: {e}")
        if args.peer_devs[0] != dev:
            sys.exit(f"serve: --mesh {args.mesh}: the first peer device "
                     f"{args.peer_devs[0]} is not the compute device {dev} "
                     f"(--device); pass --peer-devices starting with {dev}")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)

    if args.mode == "resident":
        srv = BatchServer(params, cfg, max_batch=args.batch)
        for _ in range(args.requests):
            srv.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                       args.max_new)
        srv.run()
        print("metrics:", srv.metrics())
        return

    if args.store_dir is not None:
        serve_zip(args, params, cfg, dev, args.store_dir, rng)
        return
    with tempfile.TemporaryDirectory(prefix="zipmoe_store_") as store_dir:
        serve_zip(args, params, cfg, dev, store_dir, rng)


if __name__ == "__main__":
    main()
