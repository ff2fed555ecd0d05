"""Expert compute for the H100 as hand-written CUDA kernels
(``csrc/moe_gemm.cu``), one tensor-core GEMM body with four weight sources
plus the slab splice-admit:

* ``slab_ragged_gemm`` — x [T, d] (tokens CSR-concatenated by expert, each
  group padded to an 8-row tile) against the WHOLE per-layer slab
  ``[capacity, d, f]``; each tile's weights are read in place from its
  expert's slot, named by ``tile_slot`` — no gather copy of the active
  experts.  Replaces the JAX package's Pallas ``slab_ragged_gemm``.
* ``grouped_gemm`` — the padded batch x [E, C, d] @ w [E, d, f].  Replaces
  the Pallas ``grouped_gemm``.
* ``zip_gemm_grouped`` / ``zip_gemm`` — fused recovery + GEMM: the weights
  arrive as the two u8 bit-planes and are spliced to bf16 in shared memory
  inside the GEMM, for every active expert at once ([E, C, d] against
  planes [E, d, f]) or for one expert ([C, d] against [d, f], the batched
  kernel at E = 1).  Replace the Pallas ``zip_gemm_grouped`` and
  ``zip_gemm``.
* ``slab_splice_admit`` — splice two u8 bit-planes straight into
  ``buf[slot]`` in one launch: a demand miss warms the slab as a side
  effect of its recovery.  The write goes through the slab's own pointer,
  so it is in place (``buf.data_ptr()`` never changes) and every other slot
  keeps its bytes.  Replaces the JAX package's aliased
  ``slab_splice_admit``.

Every GEMM cuts its contraction by :func:`split_plan`, a function of K
alone, and sums an output's slices left to right, so a row's result
depends on its own inputs only: the ragged and grouped GEMMs agree bit for
bit, and so do the batched and per-expert fused ones.  Whether each slice
gets its own CTA (:func:`spreads`) changes where the slices are added, not
the bits.

These wrappers take CUDA tensors only and raise on anything else; call them
through ``kernels/ops.py``, which runs the plain versions
(``kernels/ref.py``) for CPU tensors.
"""
from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

BLOCK_C = 8      # token rows per tile, fixed by the kernel
BLOCK_F = 64     # output columns per CTA, fixed by the kernel
CHUNK_ROWS = 64  # contraction rows per ring stage, fixed by the kernel
SLICE_CHUNKS = 8     # chunks per contraction slice, at most: S = ceil(K / 512)
MAX_SLICES = 64      # the kernel's SlicePlan capacity
# spread the slices over CTAs when one CTA per (tile, 64 columns) would
# put fewer than this many CTAs on each SM
SPREAD_BELOW_CTAS_PER_SM = 2


def split_plan(k: int) -> Tuple[int, ...]:
    """The fixed split of a k-row contraction: S + 1 ascending row bounds
    from 0 to k, the interior ones on 64-row chunk boundaries, with
    S = ceil(k / 512) (at least 1) and the chunks dealt out evenly.

    A function of k alone: every GEMM kernel adds an output's slices in
    this order whatever its weight source, expert count or tile count, which
    is what keeps the kernels bit-equal to each other."""
    if k < 0:
        raise ValueError(f"contraction length {k} < 0")
    chunks = -(-k // CHUNK_ROWS)
    s = max(1, -(-chunks // SLICE_CHUNKS))
    if s > MAX_SLICES:
        raise ValueError(f"contraction of {k} rows needs {s} slices; the "
                         f"kernel takes at most {MAX_SLICES} "
                         f"({MAX_SLICES * SLICE_CHUNKS * CHUNK_ROWS} rows)")
    return tuple(min(k, i * chunks // s * CHUNK_ROWS) for i in range(s + 1))


def spreads(n_tiles: int, f: int, n_slices: int, sm_count: int) -> bool:
    """Whether a launch gives each contraction slice its own CTA (f32
    partials in a scratch, added by the last CTA to arrive) instead of one
    CTA walking every slice of its (tile, 64 columns).  Only the launch's
    parallelism changes: the slices are added in the same order."""
    walkers = n_tiles * -(-f // BLOCK_F)
    return n_slices > 1 and walkers < SPREAD_BELOW_CTAS_PER_SM * sm_count


class SplitArgs(NamedTuple):
    """The split arguments of one GEMM launch; holds the host bounds and
    the scratch alive while the launch is built."""
    bounds: np.ndarray                  # int32 [S + 1]
    spread: bool
    partial: Optional[torch.Tensor]     # f32 [S * rows * f] when spread
    counters: Optional[torch.Tensor]    # int32 zeros, one per output tile

    @property
    def args(self) -> tuple:
        """The C entry points' trailing arguments before the stream."""
        ptr = (lambda t: t.data_ptr() if t is not None else None)
        return (self.bounds.ctypes.data, self.bounds.size - 1,
                int(self.spread), ptr(self.partial), ptr(self.counters))


_ws_lock = threading.Lock()
# (device index, stream) -> {"partial": f32, "counters": zeroed int32};
# launches on one stream run in order, and each leaves its counters zeroed
_workspace: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}  # guarded-by: _ws_lock
_sm_count: Dict[int, int] = {}  # guarded-by: _ws_lock


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _sms(device: torch.device) -> int:
    """The card's SM count (cached per device)."""
    idx = _index(device)
    with _ws_lock:
        if idx not in _sm_count:
            _sm_count[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        return _sm_count[idx]


def split_args(n_tiles: int, k: int, f: int, device: torch.device,
               spread: Optional[bool] = None) -> SplitArgs:
    """The plan, distribution and workspace of one launch of n_tiles
    8-row tiles over a k-row contraction into f columns on `device`'s
    current stream.  `spread` overrides :func:`spreads` (to time or test
    both distributions; the bits are the same)."""
    bounds = np.asarray(split_plan(k), np.int32)
    n = bounds.size - 1
    if spread is None:
        spread = spreads(n_tiles, f, n, _sms(device))
    if not (spread and n > 1):
        return SplitArgs(bounds, False, None, None)
    idx = _index(device)
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    n_partial = n * n_tiles * BLOCK_C * f
    n_count = n_tiles * -(-f // BLOCK_F)
    with _ws_lock:
        ws = _workspace.setdefault(key, {})
        if "partial" not in ws or ws["partial"].numel() < n_partial:
            ws["partial"] = torch.empty(n_partial, dtype=torch.float32,
                                        device=torch.device("cuda", idx))
        if "counters" not in ws or ws["counters"].numel() < n_count:
            ws["counters"] = torch.zeros(n_count, dtype=torch.int32,
                                         device=torch.device("cuda", idx))
        return SplitArgs(bounds, True, ws["partial"], ws["counters"])


def _check_rows(rows: int, f: int, what: str) -> None:
    """Shapes the tiled GEMM takes: whole 8-row tiles and 8-column
    weight vectors."""
    if rows % BLOCK_C:
        raise ValueError(f"{what}: {rows} rows is not a multiple of the "
                         f"{BLOCK_C}-row tile")
    if f % 8:
        raise ValueError(f"{what}: the kernel reads weights 8 columns at a "
                         f"time; f={f} must be a multiple of 8")


def _check_x(x: torch.Tensor, what: str) -> None:
    """The kernel stages x rows in 16-byte copies."""
    d = x.shape[-1]
    if d % 8 or x.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel copies x in 16-byte pieces: "
                         f"d={d} must be a multiple of 8 and x 16-byte "
                         f"aligned")


def _launch(name: str, fn, *args, device) -> None:
    """Launch one kernel on `device`'s current stream, raise on a refused
    launch, and count it."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"zipmoe_{name}")
    _build.LAUNCHES[name] += 1


def _launch_gemm(name: str, fn, *args, n_tiles: int, k: int, f: int,
                 device) -> None:
    """Launch one GEMM kernel with its split arguments."""
    sa = split_args(n_tiles, k, f, device)
    _launch(name, fn, *args, *sa.args, device=device)


def slab_ragged_gemm(x: torch.Tensor, buf: torch.Tensor,
                     tile_slot) -> torch.Tensor:  # hot-path
    """x: [T, d] bf16 CUDA (T a multiple of 8); buf: [capacity, d, f] bf16
    CUDA, f a multiple of 8; tile_slot: host int array [T // 8] of slots in
    [0, capacity).
    Returns x @ buf[slot-of-tile] -> [T, f] bf16 with f32 accumulation."""
    _build.require_cuda(x, torch.bfloat16, "x")
    _build.require_cuda(buf, torch.bfloat16, "buf", x.device)
    if x.dim() != 2 or buf.dim() != 3:
        raise ValueError(f"x must be [T, d] and buf [cap, d, f]; got "
                         f"{tuple(x.shape)}, {tuple(buf.shape)}")
    T, d = x.shape
    cap, d_w, f = buf.shape
    if d_w != d:
        raise ValueError(f"contraction mismatch: x d={d}, buf d={d_w}")
    if T % BLOCK_C:
        raise ValueError(f"T={T} is not a multiple of the {BLOCK_C}-row tile")
    if f % 8 or buf.data_ptr() % 16:
        raise ValueError(f"the kernel reads weights in 16-byte loads: f={f} "
                         f"must be a multiple of 8 and buf 16-byte aligned")
    _check_x(x, "slab_ragged_gemm")
    if isinstance(tile_slot, torch.Tensor):
        if tile_slot.device.type != "cpu":
            raise ValueError("tile_slot must be on the host, so its slots "
                             "can be range-checked before launch")
        tile_slot = tile_slot.numpy()
    # host-sync-ok: host slot vector, validated before upload
    ts = np.ascontiguousarray(tile_slot, dtype=np.int32)
    if ts.shape != (T // BLOCK_C,):
        raise ValueError(f"tile_slot shape {ts.shape}, expected "
                         f"({T // BLOCK_C},)")
    if ts.size and (ts.min() < 0 or ts.max() >= cap):
        raise ValueError(f"tile_slot out of range [0, {cap})")
    out = torch.empty((T, f), dtype=torch.bfloat16, device=x.device)
    if T == 0 or f == 0:            # nothing to launch, nothing to count
        return out
    ts_d = torch.from_numpy(ts).to(x.device)
    _launch_gemm("slab_gemm", _build.library().zipmoe_slab_gemm,
                 x.data_ptr(), buf.data_ptr(), ts_d.data_ptr(),
                 out.data_ptr(), T // BLOCK_C, d, f, d * f,
                 n_tiles=T // BLOCK_C, k=d, f=f, device=x.device)
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:  # hot-path
    """x: [E, C, d] bf16 CUDA (C a multiple of 8); w: [E, d, f] bf16 CUDA,
    f a multiple of 8, 16-byte aligned.
    Returns x @ w -> [E, C, f] bf16 with f32 accumulation."""
    _build.require_cuda(x, torch.bfloat16, "x")
    _build.require_cuda(w, torch.bfloat16, "w", x.device)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be [E, C, d] and w [E, d, f]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, C, d = x.shape
    if w.shape[:2] != (E, d):
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    f = w.shape[2]
    _check_rows(C, f, "grouped_gemm")
    if w.data_ptr() % 16:
        raise ValueError("grouped_gemm: the kernel reads weights in 16-byte "
                         "loads; w must be 16-byte aligned")
    _check_x(x, "grouped_gemm")
    out = torch.empty((E, C, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:            # nothing to launch, nothing to count
        return out
    _launch_gemm("grouped_gemm", _build.library().zipmoe_grouped_gemm,
                 x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
                 n_tiles=E * C // BLOCK_C, k=d, f=f, device=x.device)
    return out


def _check_planes(x: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor,
                  what: str) -> int:
    """Validate the fused kernels' operands; returns f."""
    _build.require_cuda(x, torch.bfloat16, "x")
    _build.require_cuda(exp, torch.uint8, "exp", x.device)
    _build.require_cuda(sm, torch.uint8, "sm", x.device)
    if exp.shape != sm.shape or exp.dim() != x.dim() \
            or exp.shape[:-1] != x.shape[:-2] + x.shape[-1:]:
        raise ValueError(f"{what}: planes {tuple(exp.shape)}/"
                         f"{tuple(sm.shape)} do not match x {tuple(x.shape)}")
    f = exp.shape[-1]
    _check_rows(x.shape[-2], f, what)
    if exp.data_ptr() % 8 or sm.data_ptr() % 8:
        raise ValueError(f"{what}: the kernel reads each plane in 8-byte "
                         f"loads; exp and sm must be 8-byte aligned")
    _check_x(x, what)
    return f


def zip_gemm_grouped(x: torch.Tensor, exp: torch.Tensor,
                     sm: torch.Tensor) -> torch.Tensor:  # hot-path
    """Fused recovery + grouped GEMM: x [E, C, d] bf16 CUDA (C a multiple
    of 8) against the u8 bit-planes exp, sm [E, d, f] (f a multiple of 8,
    8-byte aligned) -> x @ splice(exp, sm) as [E, C, f] bf16.  No bf16
    weight is written to device memory."""
    if x.dim() != 3:
        raise ValueError(f"x must be [E, C, d], got {tuple(x.shape)}")
    f = _check_planes(x, exp, sm, "zip_gemm_grouped")
    E, C, d = x.shape
    out = torch.empty((E, C, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:            # nothing to launch, nothing to count
        return out
    _launch_gemm("zip_gemm_grouped",
                 _build.library().zipmoe_zip_gemm_grouped, x.data_ptr(),
                 exp.data_ptr(), sm.data_ptr(), out.data_ptr(), E, C, d, f,
                 n_tiles=E * C // BLOCK_C, k=d, f=f, device=x.device)
    return out


def zip_gemm(x: torch.Tensor, exp: torch.Tensor,
             sm: torch.Tensor) -> torch.Tensor:
    """Fused recovery + GEMM for one expert: x [C, d] bf16 CUDA against
    planes exp, sm [d, f] -> [C, f] bf16; bit-equal to
    :func:`zip_gemm_grouped` on the same expert."""
    if x.dim() != 2:
        raise ValueError(f"x must be [C, d], got {tuple(x.shape)}")
    f = _check_planes(x, exp, sm, "zip_gemm")
    C, d = x.shape
    out = torch.empty((C, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:            # nothing to launch, nothing to count
        return out
    _launch_gemm("zip_gemm", _build.library().zipmoe_zip_gemm,
                 x.data_ptr(), exp.data_ptr(), sm.data_ptr(), out.data_ptr(),
                 C, d, f, n_tiles=C // BLOCK_C, k=d, f=f, device=x.device)
    return out


def slab_splice_admit(buf: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor,
                      slot: int) -> torch.Tensor:
    """Write splice(exp, sm) into ``buf[slot]`` in place and return `buf`.
    buf: [capacity, *shape] bf16 CUDA; exp, sm: u8 CUDA planes holding one
    slot's elements (any shape)."""
    _build.require_cuda(buf, torch.bfloat16, "buf")
    _build.require_cuda(exp, torch.uint8, "exp", buf.device)
    _build.require_cuda(sm, torch.uint8, "sm", buf.device)
    if buf.dim() < 2:
        raise ValueError(f"buf must be [capacity, ...], got {tuple(buf.shape)}")
    cap = buf.shape[0]
    slot_elems = buf[0].numel()
    if exp.numel() != slot_elems or sm.numel() != slot_elems:
        raise ValueError(f"planes hold {exp.numel()}/{sm.numel()} elements, "
                         f"a slot {slot_elems}")
    slot = int(slot)
    if not 0 <= slot < cap:
        raise ValueError(f"slot {slot} out of range [0, {cap})")
    if slot_elems == 0:             # nothing to launch, nothing to count
        return buf
    _launch("splice_admit", _build.library().zipmoe_splice_admit,
            buf.data_ptr(), slot, slot_elems, exp.data_ptr(), sm.data_ptr(),
            device=buf.device)
    return buf
