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
   main path's shapes, and timed with CUDA events beside its plain
   version, one PyTorch call computing the same function where there is
   one, and its bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense).
   Each time is the median of 25 samples of 10 calls that the device runs
   back to back: every sample is queued behind a device-side wait that
   outlasts the host's enqueue of its calls (the script fails if it does
   not), so the events time the device and not the host's launch rate;
   the host's time to enqueue one call is printed beside it.  The
   splices' yardsticks are timed too: a bf16 ``copy_`` of a splice's bytes
   (into one buffer, and into the slab slots the splice-admit writes) and
   an empty kernel launched back to back.  Each
   kernel's share of its bound, and its registers, shared memory and
   spills from ``nvcc -Xptxas -v``, are printed too; the grouped GEMM is
   timed with its contraction slices both walked by one CTA and spread
   over CTAs (the bits are held equal), and a repeated ``zip_gemm`` launch
   is held bit-equal.
3. The main path at full width: qwen2-moe-a2.7b with every width as
   published, depth cut to 2 layers, seeded random weights.  Build ONE
   compressed store (groups compressed in parallel), check every expert
   tensor loads bit-exactly, then serve a batch of 4 requests of greedy
   tokens through each ``ZipServer`` path, each from that store:

   * ``device_cache=True, ffn_impl="ragged"`` with an F pool smaller than a
     step's distinct experts (8 tokens), held against the resident model
     under teacher forcing;
   * ``fused_recovery=True, ffn_impl="grouped"`` (8 tokens), held against
     the resident model, with no standalone splice;
   * ``fused_recovery=True, ffn_impl="loop"`` (8 tokens), bit-identical to
     the batched fused path;
   * every expert slab-resident, ``ffn_impl="ragged"`` and ``"grouped"``
     (4 tokens): bit-identical to each other, zero h2d bytes on the hit
     steps, zero weight-copy bytes on the ragged path and the gather copy
     on the grouped one;
   * ``profile_p_times=True`` (3 tokens): measured p-time buckets;
   * ``device_recovery=True, ffn_impl="grouped"`` (8 tokens): the engine's
     I/O and decompression workers splice each recovered tensor on the
     card; logits bit-identical to the ragged path's, and one splice
     launch per splice the engine counts;
   * ``device_cache=True, ffn_impl="ragged", mem_budget=...`` (8 tokens,
     a forced re-plan before step 4): live §3.4 planning with the host's
     profiled u/c; logits bit-identical to the ragged path's, at least two
     plans and one re-plan, resident bytes within the budget.  The
     profiled PlanConsts, each plan's sizes and each re-plan's wall time
     are printed.

   Each path's launch counts are reset just before its first step and
   read just after its last (after its prefetch jobs are drained where
   the counts are compared with the engine's); every kernel must launch
   on the paths that run it.
4. Slab migration, on the engine directly, from the same store: planning
   constants pinned to a decompression-bound persona (so F pools get
   bytes and slabs are built), a drifting trace (the popular set flips at
   mid-trace, layer 1 goes idle).  Every re-plan is watched from outside:
   a drift re-plan must happen, at least one re-plan must carry residents
   from an old slab into a new one, layer 0's F residents must read back
   bit for bit equal to the store after every re-plan, and layer 1's slab
   must exist during the trace, be freed at its end, and every SlotRef
   into it taken before a re-plan must be stale.
5. One JSON line with each kernel's launches on its path, error, times and
   bound; then the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
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
PROFILE_STEPS = 3            # the measured-p path needs only a few steps
# the planned path: one global budget of 24 experts' bf16 bytes (a fifth
# of the two layers' 120 experts), the probe every 4 steps, and a forced
# re-plan before step 4
PLAN_BUDGET_EXPERTS = 24
PLAN_REPLAN_EVERY = 4
PLAN_FORCED_AT = 4
# the slab-migration run: the JAX package's drift test (two 40-step zipf
# phases, seeds 5 and 99, top-2; 10 experts' bytes; a probe every 8 steps)
MIGRATION_PHASE = 40
MIGRATION_BUDGET_EXPERTS = 10
MIGRATION_REPLAN_EVERY = 8
# the kernels each served path must launch (phases 3 and 4); the planned
# path must also launch the splice-admit when its plans give F bytes, the
# standalone splice when they do not
PATH_KERNELS = {
    "ragged": ("splice", "splice_admit", "slab_gemm"),
    "fused-grouped": ("zip_gemm_grouped",),
    "fused-loop": ("zip_gemm",),
    "grouped-cache-hit": ("grouped_gemm",),
    "profile": ("grouped_gemm", "slab_gemm"),
    "device-recovery": ("splice", "grouped_gemm"),
    "planned": ("slab_gemm",),
    "migration": ("splice_admit",),
}
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
# phase 2's device-side wait before each timed sample (med_ms)
WAIT_MIN_MS = 1.0
WAIT_FACTOR = 4.0
CALIBRATE_WAIT_MS = 50.0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def sleep_rate(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    cycles = 2_000_000
    torch.cuda._sleep(cycles)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(cycles)
    e.record()
    e.synchronize()
    return cycles / s.elapsed_time(e)


def med_ms(fn, torch, cycles_per_ms: float, samples: int = 25,
           per: int = 10, warm: int = 5):
    """Device time of one call of `fn`, and the host's time to enqueue one:
    medians over `samples` of the mean over `per` calls, after `warm`
    untimed calls.

    The device runs each sample's `per` calls back to back: a device-side
    wait (``torch.cuda._sleep``) is queued before the start event, so the
    host has queued every call before the device reaches the first, and
    the events time the device, not the host's launch rate.  The wait is
    WAIT_FACTOR times the host's enqueue of `per` calls behind a long wait
    (the device busy, as in a sample; the larger of two), and at least
    WAIT_MIN_MS.  A sample whose enqueue (the wait's own included) outlasts
    its wait fails the script; so does an `fn` that synchronises with the
    device."""
    where = f"chip_smoke.py:{fn.__code__.co_firstlineno}"
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    busy = []
    for _ in range(2):
        torch.cuda._sleep(int(CALIBRATE_WAIT_MS * cycles_per_ms))
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        busy.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    wait_ms = max(WAIT_MIN_MS, WAIT_FACTOR * max(busy))
    cycles = int(wait_ms * cycles_per_ms)
    dev, host = [], []
    gc.disable()
    try:
        for _ in range(samples):
            w = torch.cuda.Event(enable_timing=True)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            w.record()
            torch.cuda._sleep(cycles)
            s.record()
            t1 = time.perf_counter()
            for _ in range(per):
                fn()
            e.record()
            t2 = time.perf_counter()
            e.synchronize()
            waited = w.elapsed_time(s)
            check((t2 - t0) * 1e3 < waited,
                  f"timing the call at {where}: the host took "
                  f"{(t2 - t0) * 1e3:.4f} ms to enqueue {per} calls, longer "
                  f"than the device's {waited:.4f} ms wait (enqueue behind "
                  f"a long wait: {max(busy):.4f} ms): the events would time "
                  f"the host")
            dev.append(s.elapsed_time(e) / per)
            host.append((t2 - t1) * 1e3 / per)
    finally:
        gc.enable()
    return statistics.median(dev), statistics.median(host)


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
    rate = sleep_rate(torch)

    def timed(fn):
        return med_ms(fn, torch, rate)

    # -- splice: all 65,536 bit patterns, then full-width tensors ----------
    u = torch.arange(65536, dtype=torch.int32, device=dev).to(torch.int16)
    e, s = bitfield.decompose(u.view(torch.bfloat16))
    got = recovery.recover_bf16(e, s)
    check(torch.equal(got.view(torch.int16), u),
          "splice differs from the bit pattern it should rebuild")
    n_sets = 16    # distinct full-width plane pairs: 92 MB, past the L2
    sets = []
    for _ in range(n_sets):
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
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice(a.data_ptr(), b.data_ptr(), out.data_ptr(), d * f,
                          stream)

    def splice_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        ref.recover_bf16_ref(a, b)

    ms, hms = timed(splice_k)
    bms, by = bound(4.0 * d * f, 0.0)
    res["splice"] = dict(
        name="splice", route="cuda",
        source="src/repro_torch/kernels/csrc/recovery.cu",
        replaces="src/repro/kernels/recovery.py:44",
        max_abs_err=0.0, ms=ms, host_ms=hms, plain_ms=timed(splice_p)[0],
        bound_ms=bms, bound_by=by, library_ms=None, shape=[d, f])

    # -- the copy yardstick: one streaming pass of a splice's bytes --------
    # dst.copy_(src) on bf16 [d * f] moves the 11.53 MB a splice moves,
    # with its sources rotating over 92 MB as the splice's planes do.  Not
    # the same function, so no kernel's library_ms: it shows what one
    # streaming pass of this size reaches on this card
    srcs = [torch.cat(pair).view(torch.bfloat16) for pair in sets]
    dst = torch.empty(d * f, dtype=torch.bfloat16, device=dev)

    def copy_k():
        dst.copy_(srcs[it[0] % len(srcs)])
        it[0] += 1

    copy_ms, copy_hms = timed(copy_k)
    check(torch.equal(dst.view(torch.int16),
                      srcs[(it[0] - 1) % len(srcs)].view(torch.int16)),
          "the copy yardstick did not copy")
    # the floor under every row: an empty kernel, launched back to back
    launch_ms = timed(lambda: torch.cuda._sleep(0))[0]
    print(f"copy yardstick: bf16 [{d * f}] dst.copy_(src) {copy_ms:.6g} ms "
          f"({4.0 * d * f / copy_ms / 1e9:.4g} TB/s), host "
          f"{copy_hms:.6g} ms to enqueue one; an empty kernel "
          f"{launch_ms:.6g} ms", flush=True)

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

    # the admit's own yardstick: the same copy into the slots it rotates
    # over, which are cold in the L2 as a slab slot is
    def copy_slot():
        buf[it[0] % cap].view(-1).copy_(srcs[it[0] % len(srcs)])
        it[0] += 1

    copy_slot_ms = timed(copy_slot)[0]
    del srcs, dst

    def admit_k():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice_admit(buf.data_ptr(), it[0] % cap, d * f,
                                a.data_ptr(), b.data_ptr(), stream)

    def admit_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        buf[it[0] % cap] = ref.recover_bf16_ref(a, b).view(d, f)

    ms, hms = timed(admit_k)
    res["splice_admit"] = dict(
        name="splice_admit", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:172",
        max_abs_err=0.0, ms=ms, host_ms=hms, plain_ms=timed(admit_p)[0],
        bound_ms=bms, bound_by=by, library_ms=None, shape=[cap, d, f])
    for name, yard in (("splice", copy_ms), ("splice_admit", copy_slot_ms)):
        print(f"{name}: {res[name]['ms']:.6g} ms on the device, "
              f"{res[name]['ms'] / copy_ms:.4g}x the copy yardstick, "
              f"{res[name]['ms'] / yard:.4g}x the copy into its own output "
              f"({yard:.6g} ms), {res[name]['bound_ms'] / res[name]['ms']:.4g}"
              f" of the bound; the host takes {res[name]['host_ms']:.6g} ms "
              f"to enqueue one", flush=True)
    del buf, sets

    # -- slot-indexed ragged GEMM at the main path's shapes ----------------
    # a decode step of 4 tokens x top-4: 16 (token, expert) pairs, one
    # 8-row tile each; here 14 distinct slots, a repeated slot and a pad
    # tile, against a stack of 16 experts
    n_e = 16
    ts = np.asarray(list(range(14)) + [3, 0], np.int32)
    T = ts.size * 8
    errs, times = [], {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
                       "library_ms": 0.0}
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
        # sa keeps the bounds and scratch alive for the raw pointers in
        # sargs, taken once so that the timed calls hold no Python work
        sa = moe_gemm.split_args(T // 8, dd, ff, dev)
        sargs = sa.args
        ms, hms = timed(lambda: lib.zipmoe_slab_gemm(
            x.data_ptr(), wb.data_ptr(), ts_d.data_ptr(), o.data_ptr(),
            T // 8, dd, ff, dd * ff, *sargs, stream))
        times["ms"] += ms
        times["host_ms"] += hms
        # the slots as a device tensor: from numpy the plain version would
        # copy them to the card and synchronise on every call
        times["plain_ms"] += timed(lambda: ref.slab_gemm_ref(x, wb, ts_l))[0]
        times["library_ms"] += timed(lambda: torch.bmm(
            x.view(T // 8, 8, dd), wb.index_select(0, ts_l)))[0]
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
        max_abs_err=max(errs), ms=times["ms"], host_ms=times["host_ms"],
        plain_ms=times["plain_ms"], bound_ms=bms, bound_by=by, library_ms=times["library_ms"],
        shape=[T, d, f, "+", T, f, d])

    # -- grouped and fused GEMMs at the main path's shapes ------------------
    # a decode step's padded batch: 16 active experts x C = 8 rows (4
    # tokens x top-4 spread one or two per expert), gate/up then down
    n_e, C = 16, 8
    acc = {k: {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "err": 0.0, "bytes": 0.0, "flops": 0.0}
           for k in ("grouped_gemm", "zip_gemm_grouped", "zip_gemm")}
    for (dd, ff) in ((d, f), (f, d)):
        x = torch.randn((n_e, C, dd), device=dev, generator=g).to(
            torch.bfloat16)
        x[:, 2:] = 0                             # pad rows of each group
        wb = (torch.randn((n_e, dd, ff), device=dev, generator=g)
              * 0.02).to(torch.bfloat16)
        e8, s8 = (p.view(n_e, dd, ff) for p in bitfield.decompose(wb))
        o = torch.empty((n_e, C, ff), dtype=torch.bfloat16, device=dev)
        # the grouped GEMM against its plain version and torch.bmm
        k = moe_gemm.grouped_gemm(x, wb)
        r = ref.moe_gemm_ref(x, wb)
        err = (k.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        check(err <= GEMM_REL_TOL * scale, f"grouped GEMM [{dd}->{ff}] "
              f"error {err} > {GEMM_REL_TOL} x {scale}")
        a = acc["grouped_gemm"]
        a["err"] = max(a["err"], err)
        sa = moe_gemm.split_args(n_e * C // 8, dd, ff, dev)
        sargs = sa.args
        own_ms, hms = timed(lambda: lib.zipmoe_grouped_gemm(
            x.data_ptr(), wb.data_ptr(), o.data_ptr(), n_e, C, dd, ff,
            *sargs, stream))
        a["ms"] += own_ms
        a["host_ms"] += hms
        # the other distribution of the same slices: the same bits
        other = moe_gemm.split_args(n_e * C // 8, dd, ff, dev,
                                    spread=not sa.spread)
        oargs = other.args
        o.zero_()
        check(lib.zipmoe_grouped_gemm(
            x.data_ptr(), wb.data_ptr(), o.data_ptr(), n_e, C, dd, ff,
            *oargs, stream) == 0, "grouped GEMM launch refused")
        check(torch.equal(o.view(torch.int16), k.view(torch.int16)),
              f"grouped GEMM [{dd}->{ff}] differs between its slice "
              f"distributions")
        alt_ms = timed(lambda: lib.zipmoe_grouped_gemm(
            x.data_ptr(), wb.data_ptr(), o.data_ptr(), n_e, C, dd, ff,
            *oargs, stream))[0]
        dist = {True: "spread", False: "walked"}
        print(f"grouped GEMM [{n_e}, {C}, {dd}] x [{n_e}, {dd}, {ff}]: "
              f"{len(sa.bounds) - 1} slices {dist[sa.spread]} (the "
              f"wrapper's choice) {own_ms:.6g} ms, "
              f"{dist[other.spread]} {alt_ms:.6g} ms, bit-equal", flush=True)
        a["plain_ms"] += timed(lambda: ref.moe_gemm_ref(x, wb))[0]
        a["library_ms"] += timed(lambda: torch.bmm(x, wb))[0]
        a["bytes"] += 2.0 * n_e * (C * dd + dd * ff + C * ff)
        a["flops"] += 2.0 * n_e * C * dd * ff
        # the fused splice + grouped GEMM: the same bits as splicing first
        kz = moe_gemm.zip_gemm_grouped(x, e8, s8)
        check(torch.equal(kz.view(torch.int16), k.view(torch.int16)),
              f"zip_gemm_grouped [{dd}->{ff}] differs from the grouped GEMM "
              f"on the spliced weights")
        rz = ref.zip_gemm_grouped_ref(x, e8, s8)
        err = (kz.float() - rz.float()).abs().max().item()
        check(err <= GEMM_REL_TOL * scale, f"zip_gemm_grouped [{dd}->{ff}] "
              f"error {err} > {GEMM_REL_TOL} x {scale}")
        a = acc["zip_gemm_grouped"]
        a["err"] = max(a["err"], err)
        ms, hms = timed(lambda: lib.zipmoe_zip_gemm_grouped(
            x.data_ptr(), e8.data_ptr(), s8.data_ptr(), o.data_ptr(), n_e, C,
            dd, ff, *sargs, stream))
        a["ms"] += ms
        a["host_ms"] += hms
        a["plain_ms"] += timed(lambda: ref.zip_gemm_grouped_ref(x, e8,
                                                                 s8))[0]
        a["bytes"] += 2.0 * n_e * (C * dd + dd * ff + C * ff)
        a["flops"] += 2.0 * n_e * C * dd * ff
        # one expert at a time: the batched kernel's rows, bit for bit;
        # timed launches rotate over the 16 experts (92 MB, past the L2)
        for e in range(n_e):
            one = moe_gemm.zip_gemm(x[e], e8[e], s8[e])
            check(torch.equal(one.view(torch.int16), kz[e].view(torch.int16)),
                  f"zip_gemm expert {e} [{dd}->{ff}] differs from its row "
                  f"of zip_gemm_grouped")
        # a repeated launch gives the same bits, whatever order its CTAs
        # (slices spread over them) arrive in
        reps = [moe_gemm.zip_gemm(x[5], e8[5], s8[5]) for _ in range(10)]
        check(all(torch.equal(r_.view(torch.int16), kz[5].view(torch.int16))
                  for r_ in reps), f"zip_gemm [{dd}->{ff}] differs between "
              f"repeated launches")
        a = acc["zip_gemm"]
        a["err"] = max(a["err"], acc["zip_gemm_grouped"]["err"])
        one_sa = moe_gemm.split_args(C // 8, dd, ff, dev)
        one_args = one_sa.args
        ptrs = [(x[e].data_ptr(), e8[e].data_ptr(), s8[e].data_ptr(),
                 o[e].data_ptr()) for e in range(n_e)]

        def zip_rotating(split):
            def launch():
                p_ = ptrs[it[0] % n_e]
                it[0] += 1
                lib.zipmoe_zip_gemm(*p_, C, dd, ff, *split, stream)
            return launch

        zip_one = zip_rotating(one_args)

        def zip_one_plain():
            e = it[0] % n_e
            it[0] += 1
            ref.zip_gemm_grouped_ref(x[e:e + 1], e8[e:e + 1], s8[e:e + 1])

        one_ms, host_ms = timed(zip_one)
        a["ms"] += one_ms
        a["host_ms"] += host_ms
        a["plain_ms"] += timed(zip_one_plain)[0]
        # the same launches with one CTA walking every slice (what the
        # wrapper does at E = 16): the same bits, and the host's own time
        # per launch, which a one-tile launch comes close to
        walk_sa = moe_gemm.split_args(C // 8, dd, ff, dev, spread=False)
        walk_args = walk_sa.args
        o.zero_()
        check(lib.zipmoe_zip_gemm(*ptrs[5], C, dd, ff, *walk_args,
                                  stream) == 0, "zip_gemm launch refused")
        check(torch.equal(o[5].view(torch.int16), kz[5].view(torch.int16)),
              f"zip_gemm [{dd}->{ff}] differs between its slice "
              f"distributions")
        walk_ms = timed(zip_rotating(walk_args))[0]
        print(f"zip_gemm one tile [{dd}->{ff}]: {len(one_sa.bounds) - 1} "
              f"slices spread (the wrapper's choice) {one_ms:.6g} ms, "
              f"walked {walk_ms:.6g} ms, bit-equal; the host takes "
              f"{host_ms:.6g} ms to enqueue one", flush=True)
        a["bytes"] += 2.0 * (C * dd + dd * ff + C * ff)
        a["flops"] += 2.0 * C * dd * ff
        print(f"grouped / zip GEMMs [{n_e}, {C}, {dd}] x [{n_e}, {dd}, {ff}]: "
              f"grouped max abs err {acc['grouped_gemm']['err']:.3g} (max "
              f"|out| {scale:.3g}); zip_gemm_grouped bit-equal to the "
              f"grouped GEMM, zip_gemm bit-equal to its rows", flush=True)
        del wb, e8, s8
    lines = {"grouped_gemm": "src/repro/kernels/moe_gemm.py:76",
             "zip_gemm_grouped": "src/repro/kernels/moe_gemm.py:268",
             "zip_gemm": "src/repro/kernels/moe_gemm.py:227"}
    for name, a in acc.items():
        bms, by = bound(a["bytes"], a["flops"])
        res[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/moe_gemm.cu",
            replaces=lines[name], max_abs_err=a["err"], ms=a["ms"],
            host_ms=a["host_ms"], plain_ms=a["plain_ms"], bound_ms=bms,
            bound_by=by,
            # no single PyTorch call splices and multiplies
            library_ms=a["library_ms"] if name == "grouped_gemm" else None)
    # each kernel's share of its bound and the host's time to enqueue one
    # launch (a GEMM row: its d->f + f->d pair), the copy yardstick, and
    # the registers, shared memory and spills of every kernel
    print(json.dumps({
        "bound_share": {n: r["bound_ms"] / r["ms"] for n, r in res.items()},
        "host_enqueue_ms": {n: r["host_ms"] for n, r in res.items()},
        "copy_yardstick_ms": copy_ms, "copy_into_slot_ms": copy_slot_ms,
        "empty_kernel_ms": launch_ms, "ptxas": ptxas_usage(_build)}),
        flush=True)
    return res


# the kernels' entry functions in the ptxas log, by the name phase 2 gives
PTXAS_NAMES = {"splice": r"zipmoe_splice_kernel",
               "splice_admit": r"zipmoe_splice_admit_kernel",
               "SlabSource": r"gemm_kernel\w*SlabSource",
               "StackSource": r"gemm_kernel\w*StackSource",
               "PlaneSource": r"gemm_kernel\w*PlaneSource"}


def ptxas_usage(_build):
    """Registers, static shared memory and spill bytes of each kernel (the
    two splices and the three GEMM instantiations), from the build's
    ``nvcc -Xptxas -v`` log."""
    log = (Path(_build.BUILD_INFO["path"]).parent / "ptxas.log").read_text()
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        head = entry.splitlines()[0]
        name = next((n for n, pat in PTXAS_NAMES.items()
                     if re.search(pat, head)), None)
        if name is None:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        check(regs is not None and spill is not None,
              f"ptxas log has no register line for {name}")
        out[name] = {"registers": int(regs.group(1)),
                     "static_smem": int(smem.group(1)) if smem else 0,
                     "spill_stores": int(spill.group(1)),
                     "spill_loads": int(spill.group(2))}
    check(sorted(out) == sorted(PTXAS_NAMES),
          f"ptxas log names {sorted(out)}, expected {sorted(PTXAS_NAMES)}")
    return out


# ----------------------------------------------------------------------------
# phase 3: the main path at full width
# ----------------------------------------------------------------------------
def serve(torch, zs, prompt, steps, t_len, before_step=None, drain=False):
    """Greedy decode of `prompt` for `steps` tokens; the launch counters are
    reset just before the first step and read just after the last (after
    the prefetch jobs still in flight finished, with `drain`).  A step
    ends when its token is known on the host; ``before_step(zs, i)`` runs
    before step i, outside its time.  Returns the step inputs, logits, host
    step times, served tokens, launches and stats."""
    from repro_torch.kernels import _build
    caches = zs.init_cache(prompt.shape[0], t_len)
    tok = prompt
    inputs, logits, times = [], [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for i in range(steps):
        if before_step is not None:
            before_step(zs, i)
        t1 = time.perf_counter()
        inputs.append(tok)
        lg, caches = zs.decode_step(tok, caches, i)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        tok.cpu()
        times.append(time.perf_counter() - t1)
        logits.append(lg)
    if drain:
        zs.drain_pending()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    served = torch.cat(inputs[1:] + [tok], dim=1).cpu().numpy()
    return dict(inputs=inputs, logits=logits, times=times, served=served,
                launches=launches, stats=list(zs.stats),
                overlap=zs.overlap_summary(), cache=zs.cache_summary())


def path_numbers(run, n_moe: int):
    """TPOT over steps 2.., blocked time per step, traffic counters."""
    steps = len(run["times"])
    stats, ov = run["stats"], run["overlap"]
    return {"tpot_ms": statistics.mean(run["times"][1:]) * 1e3,
            "blocked_ms": sum(s["blocked_s"] for s in stats[n_moe:])
            / (steps - 1) * 1e3,
            "first_step_ms": run["times"][0] * 1e3,
            "h2d_bytes": ov["h2d_bytes"], "w_copy_bytes": ov["w_copy_bytes"],
            "splice_ops": ov["splice_ops"], "steps": steps,
            "hit_rate": run["cache"].get("hit_rate")}


def check_resident(torch, np, dev, cfg, params, run, what: str):
    """Hold a served run's logits against the resident model under teacher
    forcing.  Rows are independent requests.  A token whose router picks
    another expert set in the two models (a near-tie in router
    probabilities flipped by bf16 noise) takes another FFN, and its row's
    KV cache differs from then on: such a row is reported and left out of
    the logit comparison for the rest of the run."""
    from repro_torch.models import decode_step, init_cache
    n_moe = len(cfg_moe_layers(cfg))
    steps = len(run["inputs"])
    rcache = init_cache(cfg, BATCH, steps + 1, device=dev)
    served_routes = [s["routes"] for s in run["stats"]]
    live = np.ones(BATCH, bool)
    worst, agree, compared, flips = 0.0, 0, 0, []
    for i in range(steps):
        ids = []
        rl, rcache = decode_step(params, cfg, run["inputs"][i], rcache, i,
                                 router_ids=ids)
        for j, r_ids in enumerate(ids):
            mine = served_routes[i * n_moe + j]
            theirs = r_ids.reshape(BATCH, -1).cpu().numpy()
            for b in range(BATCH):
                if live[b] and set(mine[b]) != set(theirs[b]):
                    live[b] = False
                    flips.append((i, j, b))
        a, b_ = run["logits"][i].float(), rl.float()
        check(bool(torch.isfinite(a).all()),
              f"{what}: non-finite logits at step {i}")
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
              f"{what} step {i}: served vs resident logits differ by {err} "
              f"(> {LOGIT_REL_TOL} x {scale}) on identically routed rows "
              f"{np.flatnonzero(live).tolist()}")
    check(compared >= BATCH * steps // 2,
          f"{what}: only {compared} (step, row) pairs routed identically")
    print(f"{what}: served vs resident logits on identically routed rows "
          f"({compared}/{BATCH * steps} (step, row) pairs; routing flips at "
          f"(step, layer, row) {flips}): max |diff| / max |logit| = "
          f"{worst:.4g} (tolerance {LOGIT_REL_TOL}); greedy tokens agree "
          f"{agree}/{BATCH * steps}", flush=True)
    return worst


def same_logits(torch, a, b) -> bool:
    return all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(a["logits"], b["logits"]))


def warm_hit_run(torch, zs, cfg, prompt, steps: int = 4):
    """Warm every expert into F (the slab in device mode), then serve
    `steps` steps; steps 2.. are full cache hits.  Returns the run plus
    the h2d / weight-copy bytes of those hit steps and their host and
    stream times."""
    from repro_torch.kernels import _build
    for l in zs._moe_layers:
        zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
    caches = zs.init_cache(BATCH, steps + 1)
    lg, caches = zs.decode_step(prompt, caches, 0)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    logits = [lg]
    h2d0, w0 = zs.engine.h2d_bytes, zs.engine.w_copy_bytes
    torch.cuda.synchronize()
    _build.reset_launches()
    host_ms, dev_ms = [], []
    for i in range(1, steps):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        ev0.record()
        lg, caches = zs.decode_step(tok, caches, i)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        ev1.record()
        tok.cpu()
        host_ms.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(ev0.elapsed_time(ev1))
        logits.append(lg)
    torch.cuda.synchronize()
    return {"logits": logits, "launches": dict(_build.LAUNCHES),
            "h2d_bytes": zs.engine.h2d_bytes - h2d0,
            "w_copy_bytes": zs.engine.w_copy_bytes - w0,
            "tpot_ms": statistics.mean(host_ms),
            "stream_ms": statistics.mean(dev_ms)}


def main_path(torch, np, dev, cfg, store_dir):
    """Build one full-width store, then serve every path from it.  Returns
    each path's launch counts and numbers."""
    from repro_torch.core import bitfield
    from repro_torch.core.codec import DEFAULT_CODEC
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
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
    n_moe = len(cfg_moe_layers(cfg))
    launches, numbers = {}, {"build_store_s": build_s}

    def server(**kw):
        return ZipServer(params, cfg, store_dir, L=6, prefetch=True,
                         device=dev, **kw)

    def run_path(name, steps, before_step=None, drain=False, inspect=None,
                 **kw):
        zs = server(**kw)
        try:
            run = serve(torch, zs, prompt, steps, steps + 1, before_step,
                        drain)
            if kw.get("profile_p_times"):
                run["p_times"] = zs.p_time_summary()
            if inspect is not None:
                run["inspect"] = inspect(zs)
        finally:
            zs.close()
        launches[name] = run["launches"]
        numbers[name] = path_numbers(run, n_moe)
        print(f"{name}: served {run['served'].tolist()}; launches "
              f"{run['launches']}; {json.dumps(numbers[name])}", flush=True)
        return run

    # -- the slice-1 path: small pools, device slabs, ragged FFN -----------
    ragged = run_path("ragged", NEW_TOKENS, pool_sizes=POOLS_SMALL,
                      device_cache=True, ffn_impl="ragged")
    numbers["ragged"]["logit_rel_err"] = check_resident(
        torch, np, dev, cfg, params, ragged, "ragged")

    # -- (a) fused recovery, one batched zip GEMM per projection -----------
    fused = run_path("fused-grouped", NEW_TOKENS, pool_sizes=POOLS_SMALL,
                     fused_recovery=True, ffn_impl="grouped")
    numbers["fused-grouped"]["logit_rel_err"] = check_resident(
        torch, np, dev, cfg, params, fused, "fused-grouped")
    check(numbers["fused-grouped"]["splice_ops"] == 0,
          "the fused path ran standalone splices")

    # -- (b) fused recovery, one zip GEMM per expert: the same bits --------
    loop = run_path("fused-loop", NEW_TOKENS, pool_sizes=POOLS_SMALL,
                    fused_recovery=True, ffn_impl="loop")
    check(same_logits(torch, fused, loop),
          "fused loop logits differ from the fused batched path")
    check(numbers["fused-loop"]["h2d_bytes"]
          == numbers["fused-grouped"]["h2d_bytes"],
          "fused loop and batched paths uploaded other plane bytes")
    print("fused-loop: logits bit-identical to fused-grouped", flush=True)
    del fused, loop

    # -- (c) every expert slab-resident: ragged vs grouped FFN -------------
    ample = {"F": cfg.n_experts, "C": 0, "S": 0, "E": 0}
    hits = {}
    for impl in ("ragged", "grouped"):
        zs = server(pool_sizes=ample, device_cache=True, ffn_impl=impl)
        try:
            hits[impl] = warm_hit_run(torch, zs, cfg, prompt)
        finally:
            zs.close()
        name = f"{impl}-cache-hit"
        launches[name] = hits[impl]["launches"]
        numbers[name] = {k: v for k, v in hits[impl].items()
                         if k not in ("logits", "launches")}
        print(f"{name}: launches {launches[name]}; "
              f"{json.dumps(numbers[name])}", flush=True)
    check(hits["ragged"]["h2d_bytes"] == 0
          and hits["ragged"]["w_copy_bytes"] == 0,
          f"ragged cache-hit steps moved {hits['ragged']}")
    check(hits["grouped"]["h2d_bytes"] == 0
          and hits["grouped"]["w_copy_bytes"] > 0,
          "grouped cache-hit steps: expected 0 h2d and a weight copy, got "
          f"{numbers['grouped-cache-hit']}")
    check(same_logits(torch, hits["ragged"], hits["grouped"]),
          "grouped cache-hit logits differ from the ragged ones")
    n_hit = 3 * 3 * n_moe                 # steps x projections x layers
    check(launches["ragged-cache-hit"]["slab_gemm"] == n_hit,
          f"ragged cache-hit steps: {launches['ragged-cache-hit']}")
    check(launches["grouped-cache-hit"]["grouped_gemm"] == n_hit,
          f"grouped cache-hit steps: {launches['grouped-cache-hit']}")
    print("grouped-cache-hit: logits bit-identical to ragged-cache-hit",
          flush=True)
    del hits

    # -- (d) measured p-times ----------------------------------------------
    prof = run_path("profile", PROFILE_STEPS, pool_sizes=POOLS_SMALL,
                    device_cache=True, profile_p_times=True)
    pt = prof["p_times"]
    measured = {k: b for k, b in pt["buckets"].items()
                if "measured" in b["source"]}
    check(pt["n_measurements"] > 0 and measured,
          f"profile_p_times measured no bucket: {pt}")
    numbers["profile"]["p_time_buckets"] = pt["buckets"]
    print(f"profile: {pt['n_measurements']} buckets measured in "
          f"{pt['measure_wall_s'] * 1e3:.1f} ms: {pt['buckets']}", flush=True)
    del prof

    # -- (e) device recovery: splices on the engine's worker threads -------
    # each worker launches on its thread's current stream and synchronises
    # it before handing the tensor over; bit-identical logits show the
    # decode thread never read a tensor whose splice was still queued
    devrec = run_path("device-recovery", NEW_TOKENS, drain=True,
                      pool_sizes=POOLS_SMALL, device_recovery=True,
                      ffn_impl="grouped")
    lr = devrec["launches"]
    check(same_logits(torch, ragged, devrec),
          "device-recovery logits differ from the ragged path's")
    check(lr["splice"] == devrec["overlap"]["splice_ops"] > 0,
          f"device-recovery: {lr['splice']} splice launches, the engine "
          f"counted {devrec['overlap']['splice_ops']} splices")
    check(lr["grouped_gemm"] > 0, f"device-recovery launches {lr}")
    print("device-recovery: logits bit-identical to ragged; splice launches "
          f"= engine splices = {lr['splice']}", flush=True)
    del devrec

    # -- (f) live §3.4 planning under one byte budget ----------------------
    f_bytes = store.groups[min(store.groups)].full_bytes
    budget = PLAN_BUDGET_EXPERTS * f_bytes

    def forced_replan(zs, i):
        if i == PLAN_FORCED_AT:
            zs.engine.replan(reason="forced")

    def plan_info(zs):
        return {"plan": zs.plan_summary(),
                "consts": {l: dataclasses.asdict(zs.engine.plan_consts(l))
                           for l in zs._moe_layers}}

    # earlier servers' slabs live until the collector breaks their
    # engine <-> cache cycles: collect first, so the peak is this path's
    gc.collect()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    planned = run_path("planned", NEW_TOKENS, before_step=forced_replan,
                       inspect=plan_info, device_cache=True,
                       ffn_impl="ragged", mem_budget=budget,
                       replan_every=PLAN_REPLAN_EVERY)
    peak = torch.cuda.max_memory_allocated()
    ps, consts = planned["inspect"]["plan"], planned["inspect"]["consts"]
    events = [{"step": ev["step"], "reason": ev["reason"],
               "wall_ms": ev["wall_s"] * 1e3,
               "sizes": {str(l): sz for l, sz in ev["sizes"].items()}}
              for ev in ps["replans"]]
    gave_f = any(sz.get("F", 0) > 0 for ev in ps["replans"]
                 for sz in ev["sizes"].values())
    print(f"planned: budget {budget} B ({PLAN_BUDGET_EXPERTS} experts x "
          f"{f_bytes} B); profiled PlanConsts per layer {consts}", flush=True)
    for ev in events:
        print(f"planned: plan at step {ev['step']} ({ev['reason']}) in "
              f"{ev['wall_ms']:.3f} ms: sizes {ev['sizes']}", flush=True)
    check(same_logits(torch, ragged, planned),
          "planned logits differ from the ragged path's")
    check(ps["n_plans"] >= 2 and ps["n_replans"] >= 1,
          f"planned: {ps['n_plans']} plans, {ps['n_replans']} re-plans")
    check(ps["bytes_resident"] <= budget,
          f"planned: {ps['bytes_resident']} B resident > budget {budget} B")
    need = "splice_admit" if gave_f else "splice"
    check(planned["launches"][need] > 0,
          f"planned: plans {'gave' if gave_f else 'did not give'} F bytes "
          f"but {need} never launched: {planned['launches']}")
    numbers["planned"].update(
        budget_bytes=budget, plans=events, consts=consts, f_gets_bytes=gave_f,
        bytes_resident=ps["bytes_resident"], peak_mem_bytes=peak,
        mem_before_bytes=base_mem,
        replan_ms=[ev["wall_ms"] for ev in events])
    print(f"planned: logits bit-identical to ragged; F bytes planned: "
          f"{gave_f}; resident {ps['bytes_resident']} B; device memory "
          f"{base_mem} B allocated before the path, {peak} B at its peak",
          flush=True)
    del planned

    # -- (g) slab migration on the engine, with pinned planning constants --
    launches["migration"], numbers["migration"] = migration_run(
        torch, np, dev, cfg, store_dir, store.groups[min(store.groups)])
    return launches, numbers


def migration_run(torch, np, dev, cfg, store_dir, group):
    """The JAX package's drift test at full width, on the port's engine in
    device-slab mode, with every re-plan checked from outside.  Returns the
    launches and numbers of the run."""
    from repro_torch.core import bitfield
    from repro_torch.core.engine import ZipMoEEngine
    from repro_torch.core.planner import PlanConsts
    from repro_torch.core.slab import SlotRef
    from repro_torch.core.store import ExpertStore
    from repro_torch.core.workload import zipf_trace
    from repro_torch.kernels import _build
    truth = ExpertStore(store_dir)
    eng = ZipMoEEngine(ExpertStore(store_dir), n_experts=cfg.n_experts,
                       n_layers=cfg.n_layers, L=6, freq_decay=0.9,
                       device_cache=True, device=dev)
    want = {}

    def store_bits(l, e):
        if (l, e) not in want:
            grp = truth.load_group((l, e))
            want[(l, e)] = [bitfield.from_bits(grp[t.name]).to(dev)
                            for t in group.tensors]
        return want[(l, e)]

    def as_tensor(v):
        if isinstance(v, SlotRef):
            return v.read()
        if isinstance(v, np.ndarray):
            return bitfield.from_bits(v).to(dev)
        return v

    watched, migrations, l1_refs = [], [], []
    plain_replan = eng.replan

    def replan(reason="manual", hit_rate=None):
        before = {l: eng._slabs.get(l) for l in (0, 1)}
        slots = {l: dict(s.slot_of) if s is not None else {}
                 for l, s in before.items()}
        if before[1] is not None:
            l1_refs.extend(v for ent in eng.caches[1].pools["F"].values()
                           if ent.payload is not None
                           for v in ent.payload.full.values()
                           if isinstance(v, SlotRef) and v.slab is before[1])
        out = plain_replan(reason=reason, hit_rate=hit_rate)
        torch.cuda.synchronize()
        caps = {}
        for l in (0, 1):
            old, new = before[l], eng._slabs.get(l)
            caps[l] = [old.capacity if old is not None else None,
                       new.capacity if new is not None else None]
            if old is not None and new is not None and new is not old:
                carried = set(slots[l]) & set(new.slot_of)
                if carried:
                    migrations.append({"layer": l, "carried": len(carried),
                                       "from": old.capacity,
                                       "to": new.capacity})
        checked = 0
        for e, ent in eng.caches[0].pools["F"].items():
            if ent.payload is None:
                continue
            ref_t = store_bits(0, e)
            for tidx, v in ent.payload.full.items():
                check(not isinstance(v, SlotRef) or v.valid,
                      f"migration: layer 0 expert {e} holds a stale SlotRef "
                      f"after the {reason} re-plan")
                check(torch.equal(as_tensor(v).view(torch.int16),
                                  ref_t[tidx].view(torch.int16)),
                      f"migration: layer 0 expert {e} tensor {tidx} differs "
                      f"from the store after the {reason} re-plan")
                checked += 1
        watched.append({"reason": reason, "wall_ms":
                        eng.planner.replans[-1]["wall_s"] * 1e3,
                        "slab_caps": caps, "checked_tensors": checked})
        return out

    eng.replan = replan
    eng.plan_consts = lambda layer: PlanConsts(u=1.0, v=0.1, c=1.0, L=4, K=4,
                                               n_tensors=3)
    phase1 = zipf_trace(cfg.n_experts, 2, MIGRATION_PHASE, alpha=1.4, seed=5)
    phase2 = zipf_trace(cfg.n_experts, 2, MIGRATION_PHASE, alpha=1.4,
                        seed=99)
    slab1_seen = False
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        eng.configure_planner(MIGRATION_BUDGET_EXPERTS * group.full_bytes,
                              replan_every=MIGRATION_REPLAN_EVERY,
                              plan_step=0.25, drift_margin=0.05,
                              profile_per_layer=False)
        for i, sel in enumerate(phase1 + phase2):
            eng.fetch_experts(0, sorted(sel))
            if i < len(phase1) and i % 3 == 0:      # layer 1 idles at T/2
                eng.fetch_experts(1, sorted(sel))
            slab1_seen = slab1_seen or eng._slabs.get(1) is not None
            eng.note_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        ps = eng.plan_summary()
        final_slab1 = eng._slabs.get(1)
    finally:
        eng.shutdown()
        truth.close()
    reasons = [ev["reason"] for ev in ps["replans"]]
    for w in watched:
        print(f"migration: re-plan ({w['reason']}) in {w['wall_ms']:.3f} ms, "
              f"slab capacities [before, after] {w['slab_caps']}, "
              f"{w['checked_tensors']} layer-0 F tensors bit-exact", flush=True)
    print(f"migration: trace {len(phase1)} + {len(phase2)} steps (the JAX "
          f"package's drift test; not cut) in {wall:.1f} s; re-plan reasons "
          f"{reasons}; migrations {migrations}; launches {launches}",
          flush=True)
    check("drift" in reasons, f"migration: no drift re-plan in {reasons}")
    check(slab1_seen and final_slab1 is None,
          f"migration: layer 1's slab seen {slab1_seen}, at the end "
          f"{final_slab1}")
    check(l1_refs and not any(r.valid for r in l1_refs),
          f"migration: {len(l1_refs)} SlotRefs into layer 1's slabs taken "
          f"before a re-plan, {sum(r.valid for r in l1_refs)} still valid")
    check(migrations, "migration: no re-plan carried residents into a new "
          "slab")
    return launches, {"reasons": reasons, "migrations": migrations,
                      "replans": watched, "stale_refs_checked": len(l1_refs),
                      "wall_s": wall}


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
    # every kernel runs on some path, and every path runs its kernels; a
    # kernel's launches are its count on the first path that runs it
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path: "
                  f"{launches[path]}")
    for name in _build.LAUNCHES:
        path = next((p for p, names in PATH_KERNELS.items()
                     if name in names), None)
        check(path is not None, f"kernel {name} is on no served path")
        check(name in kres, f"kernel {name} was not held against its plain "
              f"version")
        kres[name]["launches"] = launches[path][name]
        kres[name]["path"] = path
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")
    print(json.dumps({"kernel_paths": {k: r["path"]
                                       for k, r in kres.items()}}),
          flush=True)
    print(json.dumps({"main_path": e2e, "card": card}), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kres.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
