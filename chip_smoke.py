#!/usr/bin/env python3
"""The port's CUDA kernels (``src/repro_torch/kernels/csrc``) on one NVIDIA
GPU: each against its plain PyTorch version at the served shapes, and
timed beside its bound.  This is the repo's table of single-kernel times
on the card; whether the port serves and trains correctly on the card is
the ``gpu``-marked tests' job (``python -m pytest -q -m gpu tests/``).

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, in order; any
failure exits non-zero:

1. Environment: the card's name and power limit, torch's version, and the
   build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes (qwen2-moe-a2.7b's experts), and timed with CUDA
   events beside its plain version, one PyTorch call computing the same
   function where there is one, and its bound on an H100 SXM (the
   roofline constants of ``repro_torch.launch.mesh``).
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
   is held bit-equal.  The splice, the splice-admit and the ragged GEMM
   are also held and timed at jamba-v0.1-52b's expert shapes (d 4096, f
   14336, 4 tokens x top-2) and at switch-large-128's (d 1024, f 2816, 4
   tokens x top-1), beside ``torch.bmm``.  The two MLA decode kernels
   (``mla_rope_write``, ``mla_absorbed_attend``) at both benchmark cells'
   attention shapes
   (deepseekv2-lite, 16 heads; kanana-2-30b-a3b, 32; 16 rows over a T_pad
   of 1,536): each against its plain version on the card (the written
   latent bit-equal, the rope within one ulp, the output within 2^-7 of
   the largest), timed beside its bound (bytes at the HBM rate or f32
   operations at the f32 rate, whichever is larger), and, kernel and plain
   version alike, on the host clock a call (the plain versions
   synchronise, so ``med_ms`` cannot time them).

Last, one JSON line with each kernel's error, times and bound, and the
result line.
"""
from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2-moe-a2.7b"     # the main path's expert shapes
SEED = 0
# kernels 1-3 at the expert shapes of the hybrid and encoder-decoder
# configs as well
JAMBA_ARCH = "jamba-v0.1-52b"
SWITCH_ARCH = "switch-large-128"
# the attend kernel against its plain version: both sum in f32 in another
# order, then round the per-head output to bf16 once; allow 2^-7 of the
# largest |output|
MLA_ABSORB_REL_TOL = 2.0 ** -7
# phase 2: the MLA decode kernels at the benchmark cells' attention shapes
# (deepseekv2-lite: 16 heads; kanana-2-30b-a3b: 32): 16 rows at positions
# spread evenly over T_pad = 1,536, 0 and T_pad - 1 among them; the timed
# calls rotate over MLA_KERNEL_SETS latent caches and wkv_b's, past the L2
MLA_KERNEL_ARCHS = (("deepseekv2-lite", "dsv2lite"),
                    ("kanana-2-30b-a3b", "kanana2"))
MLA_KERNEL_B, MLA_KERNEL_T = 16, 1536
MLA_KERNEL_SETS = 4
# a host-clock time of a call that synchronises (the plain versions): the
# mean over this many calls, after as many untimed ones
WALL_CALLS = 50
# ragged GEMM vs its f32 plain version: both sum in f32 but in another
# order, and both round once to bf16, so outputs may differ by a bf16 ulp
# of the largest outputs; allow two (2^-7 of the largest |output|)
GEMM_REL_TOL = 2.0 ** -7
# phase 2's device-side wait before each timed sample (med_ms): 8x the
# host's calibrated enqueue; a host hiccup on the H100's host has made one
# sample's enqueue outlast a 4x wait
WAIT_MIN_MS = 1.0
WAIT_FACTOR = 8.0
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
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    t_b = nbytes / HBM_BW
    t_o = flops / PEAK_FLOPS_BF16
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------
def ragged_gemm_rows(torch, dev, timed, g, d, f, n_e, ts, make_x, what):
    """The slot-indexed ragged GEMM over the 8-row tiles of slot vector
    `ts` against a stack of `n_e` experts, gate/up ([d] -> [f]) then down
    ([f] -> [d]) with ``make_x(K)`` the rows: each held against its plain
    version (GEMM_REL_TOL), then the pair timed with `timed` beside the
    plain version and ``torch.bmm`` over the gathered slots.  Returns the
    pair's numbers and its bound from these inputs."""
    from repro_torch.kernels import _build, moe_gemm, ref
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    T = ts.size * 8
    out = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": 0.0}
    flops = nbytes = 0.0
    for (dd, ff) in ((d, f), (f, d)):           # gate/up, then down
        x = make_x(dd)
        wb = (torch.randn((n_e, dd, ff), device=dev, generator=g)
              * 0.02).to(torch.bfloat16)
        k = moe_gemm.slab_ragged_gemm(x, wb, ts).float()
        r = ref.slab_gemm_ref(x, wb, ts).float()
        err = (k - r).abs().max().item()
        scale = r.abs().max().item()
        check(err <= GEMM_REL_TOL * scale,
              f"{what} [{dd}->{ff}] error {err} > {GEMM_REL_TOL} x {scale}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
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
        out["ms"] += ms
        out["host_ms"] += hms
        # the slots as a device tensor: from numpy the plain version would
        # copy them to the card and synchronise on every call
        out["plain_ms"] += timed(lambda: ref.slab_gemm_ref(x, wb, ts_l))[0]
        out["library_ms"] += timed(lambda: torch.bmm(
            x.view(T // 8, 8, dd), wb.index_select(0, ts_l)))[0]
        distinct = len(set(ts.tolist()))
        nbytes += 2.0 * T * dd + 2.0 * distinct * dd * ff + 4 * ts.size \
            + 2.0 * T * ff
        flops += 2.0 * T * dd * ff
        print(f"{what} [{T}, {dd}] x slab[{n_e}, {dd}, {ff}] "
              f"({len(sa.bounds) - 1} contraction slices): max abs err "
              f"{err:.3g} (max |out| {scale:.3g}, tolerance "
              f"{GEMM_REL_TOL:.3g} x max |out|)", flush=True)
        del wb
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = [T, d, f, "+", T, f, d]
    return out


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
    ts = np.asarray(list(range(14)) + [3, 0], np.int32)

    def main_rows(dd):
        x = torch.randn((ts.size * 8, dd), device=dev, generator=g).to(
            torch.bfloat16)
        x[8:16] = 0                              # a singleton group
        x[9] = torch.randn((dd,), device=dev, generator=g).to(torch.bfloat16)
        x[-8:] = 0                               # the pad tile
        return x

    res["slab_gemm"] = dict(
        name="slab_gemm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:123",
        **ragged_gemm_rows(torch, dev, timed, g, d, f, 16, ts, main_rows,
                           "ragged GEMM"))

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


def expert_kernel_shapes(torch, np, dev, arch: str, label: str, ts):
    """Kernels 1-3 at `arch`'s expert shapes, each against its plain
    version and timed with ``med_ms`` beside its plain version and its
    bound: the splice of one [d_model, d_expert] tensor, the splice-admit
    into an 8-slot slab, and the ragged GEMM over the one-row 8-row tiles
    of slot vector `ts` (a decode step's (token, expert) pairs) against the
    layer's whole expert stack, d -> f, then f -> d with K = d_expert.
    jamba-v0.1-52b: d 4096, f 14336, 4 tokens x top-2 = 8 tiles over 16
    experts; switch-large-128: d 1024, f 2816, 4 tokens x top-1 = 4 tiles
    over 128.  Returns each kernel's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core import bitfield
    from repro_torch.kernels import _build, moe_gemm, recovery, ref
    lib = _build.library()
    cfg = get_config(arch)
    d, f, n_e = cfg.d_model, cfg.d_expert, cfg.n_experts
    g = torch.Generator(device=dev).manual_seed(SEED)
    rate = sleep_rate(torch)
    stream = torch.cuda.current_stream().cuda_stream
    res, it = {}, [0]

    def timed(fn):
        return med_ms(fn, torch, rate)

    # rotate over > 60 MB of planes, far past the L2 (jamba: 4 sets of
    # 117 MB; switch: 11 of 5.8 MB)
    n_sets = max(4, -(-60_000_000 // (2 * d * f)))
    sets = [(torch.randint(0, 256, (d * f,), dtype=torch.uint8, device=dev,
                           generator=g),
             torch.randint(0, 256, (d * f,), dtype=torch.uint8, device=dev,
                           generator=g)) for _ in range(n_sets)]
    e, s = sets[0]
    check(torch.equal(recovery.recover_bf16(e, s).view(torch.int16),
                      ref.recover_bf16_ref(e, s).view(torch.int16)),
          f"splice [{d}, {f}] not bit-exact against its plain version")
    out = torch.empty(d * f, dtype=torch.bfloat16, device=dev)

    def splice_k():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice(a.data_ptr(), b.data_ptr(), out.data_ptr(), d * f,
                          stream)

    def splice_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        ref.recover_bf16_ref(a, b)

    bms, by = bound(4.0 * d * f, 0.0)
    ms, hms = timed(splice_k)
    res["splice"] = dict(ms=ms, host_ms=hms, plain_ms=timed(splice_p)[0],
                         bound_ms=bms, bound_by=by, max_abs_err=0.0,
                         library_ms=None, shape=[d, f])

    cap, slot = 8, 5
    buf = torch.empty((cap, d, f), dtype=torch.bfloat16, device=dev)
    buf.view(torch.int16).random_(generator=g)
    w = (torch.randn((d, f), device=dev, generator=g) * 0.01).to(
        torch.bfloat16)
    e, s = bitfield.decompose(w)
    moe_gemm.slab_splice_admit(buf, e, s, slot)
    check(torch.equal(buf[slot].view(torch.int16), w.view(torch.int16)),
          f"splice-admit into [{cap}, {d}, {f}] does not hold the spliced "
          f"tensor")
    del w, e, s

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
    res["splice_admit"] = dict(ms=ms, host_ms=hms,
                               plain_ms=timed(admit_p)[0], bound_ms=bms,
                               bound_by=by, max_abs_err=0.0, library_ms=None,
                               shape=[cap, d, f])
    del buf, sets

    def one_row_per_tile(dd):
        x = torch.zeros((ts.size * 8, dd), dtype=torch.bfloat16, device=dev)
        x[::8] = torch.randn((ts.size, dd), device=dev, generator=g).to(
            torch.bfloat16)
        return x

    res["slab_gemm"] = ragged_gemm_rows(torch, dev, timed, g, d, f, n_e, ts,
                                        one_row_per_tile,
                                        f"{label} shapes: ragged GEMM")
    for name, r in res.items():
        lib_ms = "" if r["library_ms"] is None else \
            f", torch.bmm {r['library_ms']:.6g} ms"
        print(f"{label} shapes: {name} {r['ms']:.6g} ms on the device "
              f"(plain {r['plain_ms']:.6g} ms{lib_ms}), bound "
              f"{r['bound_ms']:.6g} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.4g} of the bound; the host takes "
              f"{r['host_ms']:.6g} ms to enqueue one", flush=True)
    print(json.dumps({f"kernels_at_{label}_shapes": res}), flush=True)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    return res


def wall_ms(fn, torch, calls: int = WALL_CALLS) -> float:
    """Host-clock ms per call of `fn`, synchronised before and after
    `calls` calls (after as many untimed ones): what a call costs the
    decode thread, launches and synchronisations included."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def mla_kernel_rows(torch, np, dev):
    """The two MLA decode kernels at each benchmark cell's attention
    widths (MLA_KERNEL_ARCHS; B 16, T_pad 1,536): each against its plain
    version on the card (the written latent bit-equal, the rope key and
    query within one bf16 ulp, the output within MLA_ABSORB_REL_TOL of the
    largest |output|), then timed with ``med_ms`` (device time; latent
    caches and ``wkv_b`` rotating past the L2) beside its bound, and both
    kernels and plain versions on the host clock (``wall_ms``: the plain
    versions synchronise three times a call, so ``med_ms`` cannot time
    them).  Returns each kernel's row at deepseekv2-lite's shapes, with
    kanana-2's numbers under ``kanana2``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode, ref
    from repro_torch.launch.mesh import F32_FLOPS, HBM_BW
    rate = sleep_rate(torch)
    rows = {"mla_rope_write": {}, "mla_absorbed_attend": {}}
    B, T = MLA_KERNEL_B, MLA_KERNEL_T
    for arch, label in MLA_KERNEL_ARCHS:
        cfg = get_config(arch)
        H, C, Dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
        Dn, Dv = cfg.qk_nope_dim, cfg.v_head_dim
        g = torch.Generator(device=dev).manual_seed(SEED)

        def rnd(shape, std=1.0):
            return (torch.randn(shape, generator=g, device=dev) * std).to(
                torch.bfloat16)

        pos = torch.linspace(0, T - 1, B, device=dev).round().long()
        q, kv = rnd((B, 1, H * (Dn + Dr))), rnd((B, 1, C + Dr))
        kv_norm = torch.rand(C, generator=g, device=dev) + 0.5
        sets = [(rnd((C, H * (Dn + Dv)), 0.05), rnd((B, T, C)),
                 rnd((B, T, Dr))) for _ in range(MLA_KERNEL_SETS)]
        scale = float(np.float32(1.0) / np.sqrt(np.float32(Dn + Dr)))
        wkv_b, ckv, k_rope = sets[0]
        plain = (ckv.clone(), k_rope.clone())
        qr_p = ref.mla_rope_write_ref(q, kv, kv_norm, pos, *plain,
                                      n_heads=H, rope_theta=cfg.rope_theta)
        qr_k = mla_decode.rope_write(q, kv, kv_norm, pos, ckv, k_rope,
                                     n_heads=H, rope_theta=cfg.rope_theta)
        torch.cuda.synchronize()
        ulp = {n: int((a.view(torch.int16).int() - b.view(torch.int16).int())
                      .abs().max()) for n, a, b in (
                          ("k_rope", k_rope, plain[1]), ("q_rope", qr_k, qr_p))}
        check(torch.equal(ckv.view(torch.int16), plain[0].view(torch.int16)),
              f"mla_rope_write at {label} shapes: the written latent differs "
              f"from its plain version")
        check(max(ulp.values()) <= 1, f"mla_rope_write at {label} shapes: "
              f"rope more than one ulp from its plain version: {ulp}")
        y_p = ref.mla_absorbed_attend_ref(q, qr_p, wkv_b, *plain, pos,
                                          n_heads=H, v_head_dim=Dv,
                                          scale=scale).float()
        y_k = mla_decode.absorbed_attend(q, qr_p, wkv_b, *plain, pos,
                                         n_heads=H, v_head_dim=Dv,
                                         scale=scale).float()
        err = (y_k - y_p).abs().max().item()
        top = y_p.abs().max().item()
        check(err <= MLA_ABSORB_REL_TOL * top, f"mla_absorbed_attend at "
              f"{label} shapes: error {err} > {MLA_ABSORB_REL_TOL} x {top}")
        it = [0]

        def write_k():
            mla_decode.rope_write(q, kv, kv_norm, pos, ckv, k_rope,
                                  n_heads=H, rope_theta=cfg.rope_theta)

        def write_p():
            ref.mla_rope_write_ref(q, kv, kv_norm, pos, *plain, n_heads=H,
                                   rope_theta=cfg.rope_theta)

        def attend_k():
            w, c, r = sets[it[0] % MLA_KERNEL_SETS]
            it[0] += 1
            mla_decode.absorbed_attend(q, qr_k, w, c, r, pos, n_heads=H,
                                       v_head_dim=Dv, scale=scale)

        def attend_p():
            w, c, r = sets[it[0] % MLA_KERNEL_SETS]
            it[0] += 1
            ref.mla_absorbed_attend_ref(q, qr_k, w, c, r, pos, n_heads=H,
                                        v_head_dim=Dv, scale=scale)

        n_read = float((pos + 1).sum().item())   # positions the rows read
        work = {
            "mla_rope_write": (
                2.0 * B * (2 * H * Dr + 2 * (C + Dr)) + 4.0 * C + 2.0 * Dr
                + 8.0 * B, 0.0, write_k, write_p, 0.0),
            "mla_absorbed_attend": (
                2.0 * B * H * (Dn + Dr + Dv) + 2.0 * C * H * (Dn + Dv)
                + 2.0 * n_read * (C + Dr) + 8.0 * B,
                2.0 * H * (B * C * (Dn + Dv) + n_read * (2 * C + Dr)),
                attend_k, attend_p, err)}
        for name, (nbytes, flops, kern, pl, e) in work.items():
            ms, hms = med_ms(kern, torch, rate)
            t_b, t_o = nbytes / HBM_BW, flops / F32_FLOPS
            row = dict(ms=ms, host_ms=hms, wall_ms=wall_ms(kern, torch),
                       plain_ms=wall_ms(pl, torch),
                       bytes_bound_ms=t_b * 1e3,
                       f32_ops_bound_ms=t_o * 1e3,
                       bound_ms=max(t_b, t_o) * 1e3,
                       bound_by="bytes" if t_b >= t_o else "f32 operations",
                       max_abs_err=e, shape=[B, T, H, C, Dr, Dn, Dv])
            print(f"{label} shapes: {name} {ms:.6g} ms on the device, bound "
                  f"{row['bound_ms']:.6g} ms ({row['bound_by']}; bytes "
                  f"{row['bytes_bound_ms']:.6g} ms), "
                  f"{row['bound_ms'] / ms:.4g} of the bound; host clock a "
                  f"call: kernel {row['wall_ms']:.6g} ms, plain "
                  f"{row['plain_ms']:.6g} ms; the host takes {hms:.6g} ms "
                  f"to enqueue one", flush=True)
            rows[name][label] = row
        del sets, ckv, k_rope, plain, wkv_b
        gc.collect()
        torch.cuda.empty_cache()
    out = {}
    for name, by in rows.items():
        first = by["dsv2lite"]
        out[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/mla_decode.cu",
            replaces="none (MLA decode was eager PyTorch)",
            library_ms=None, kanana2=by["kanana2"],
            **{k: first[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err", "shape")})
    print(json.dumps({"mla_kernels": rows}), flush=True)
    return out


# the kernels' entry functions in the ptxas log, by the name phase 2 gives
PTXAS_NAMES = {"splice": r"zipmoe_splice_kernel",
               "splice_admit": r"zipmoe_splice_admit_kernel",
               "SlabSource": r"gemm_kernel\w*SlabSource",
               "StackSource": r"gemm_kernel\w*StackSource",
               "PlaneSource": r"gemm_kernel\w*PlaneSource",
               "mla_rope_write": r"mla_rope_write_kernelI13__nv_bfloat16E",
               "mla_absorbed_attend":
                   r"mla_absorbed_attend_kernelI13__nv_bfloat16E"}


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


def phase_wall(name: str, t0: float) -> float:
    wall = time.perf_counter() - t0
    print(f"phase {name}: {wall:.1f} s", flush=True)
    return wall


def main():
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: run with none")
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
    cfg = get_config(ARCH)
    print(f"config {ARCH}: d_model {cfg.d_model}, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, d_expert {cfg.d_expert}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels: built={_build.BUILD_INFO['built']} in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.BUILD_INFO['path']}",
          flush=True)

    t0 = time.perf_counter()
    kres = kernel_phase(torch, np, dev, cfg)
    # 4 tokens x top-2 = 8 (token, expert) pairs, one tile each; 7
    # distinct experts (one chosen twice)
    expert_kernel_shapes(torch, np, dev, JAMBA_ARCH, "jamba", np.asarray(
        [0, 3, 5, 9, 12, 14, 15, 3], np.int32))
    # 4 tokens x top-1 = 4 tiles, 4 distinct experts of 128
    expert_kernel_shapes(torch, np, dev, SWITCH_ARCH, "switch", np.asarray(
        [7, 40, 93, 127], np.int32))
    kres.update(mla_kernel_rows(torch, np, dev))
    phase_wall("2", t0)
    for name in _build.LAUNCHES:
        check(name in kres, f"kernel {name} was not held against its plain "
              f"version")
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")
    keys = ["name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kres.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
