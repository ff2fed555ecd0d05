"""Device-resident expert slabs: preallocated stacked weight buffers.

The decode hot path historically paid a host-side staging tax the paper's
CUDA pipeline avoids: every step re-uploaded and re-stacked the active
experts' full bf16 weights from host memory, even when every expert was an
F-pool cache hit.  A :class:`DeviceSlabCache` removes that tax — per MoE
layer it preallocates one device buffer of shape ``[capacity, *tensor_shape]``
per expert tensor name (capacity = the layer's F-pool size), and F-pool
residency maps experts to *slots* in those buffers:

* **write** — a freshly spliced tensor lands in its slot by an in-place
  ``buf[slot].copy_(val)``; bit-planes land through the fused splice-admit
  kernel (``kernels/ops.slab_splice_set``), which writes the slot in place
  too.  The buffer is never reallocated (``data_ptr`` is stable).
* **gather** — ``index_select`` of the step's active slots: a device-side
  copy, zero host↔device traffic (the slot-indexed ragged GEMM reads the
  buffer in place instead and needs only the slot numbers).
* **free/reuse** — slots carry a generation counter; freeing a slot bumps
  it, so a stale :class:`SlotRef` held by an in-flight speculative job can
  be detected (``ref.valid``) and is never re-admitted as if it still named
  the old expert's weights.

Aliasing hazard (new in the port): ``SlotRef.read()`` returns a **view**
into the slab, not an immutable array as in the JAX package.  A view kept
past ``free()`` sees the next occupant's bytes and no generation check
fires, so views must not outlive the decode step that took them, and
``read_np`` returns a copy.

Thread model: all slab mutation happens on the engine caller's (decode)
thread — the same single-mutator discipline as the cache pools.  Worker
threads only produce the device tensors that are later written here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import checkz
from repro_torch.kernels import ops


@dataclass
class DevicePlanes:
    """One tensor held as its two ZipMoE bit-planes, ALREADY on device.

    The fused demand-miss path's in-flight form: the worker uploads the u8
    planes (charged to ``h2d_bytes``) but defers the splice; at collect
    time the decode thread lands them straight in a slab slot via the
    splice-admit kernel (one launch — no standalone spliced tensor).
    ``_sm_plane_of`` reads ``.sm`` for S-pool demotions."""
    exp: torch.Tensor            # u8, device, flat
    sm: torch.Tensor             # u8, device, flat
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return int(self.exp.numel()) + int(self.sm.numel())


@dataclass(frozen=True)
class SlotRef:
    """Handle to one tensor of one expert inside a slab.

    Cache payloads in ``device_cache`` mode carry these instead of host
    arrays.  A ref is only as durable as its slot's generation: freeing
    the slot (F-pool eviction/demotion) bumps ``slab.gen[slot]`` and every
    outstanding ref for the old occupant turns invalid."""
    slab: "DeviceSlabCache"
    slot: int
    gen: int
    name: str

    @property
    def valid(self) -> bool:
        return self.slab.gen[self.slot] == self.gen

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.slab.shapes[self.name]

    def read(self) -> torch.Tensor:
        """Device VIEW of the slot's tensor (no copy, no host transfer).
        It aliases the slab: do not keep it past the current step."""
        assert self.valid, f"stale SlotRef {self.name}@{self.slot}"
        return self.slab.bufs[self.name][self.slot]

    def read_np(self) -> np.ndarray:
        """One-time download of the slot (F→S payload demotion): a COPY of
        the tensor's bf16 bits as a uint16 ndarray, so a later slot reuse
        cannot change it."""
        t = self.read().detach().to("cpu", copy=True)
        arr = t.view(torch.int16).numpy().view(np.uint16)
        self.slab.d2h_bytes += arr.nbytes
        return arr


class DeviceSlabCache:
    """Per-layer stacked device buffers backing the F pool's residents."""

    def __init__(self, layer: int, shapes: Dict[str, Tuple[int, ...]],
                 capacity: int, device, dtype=torch.bfloat16):
        assert capacity > 0, capacity
        self.layer = layer
        self.capacity = int(capacity)
        self.shapes = {name: tuple(s) for name, s in shapes.items()}
        self.device = torch.device(device)
        self.dtype = dtype
        self.bufs: Dict[str, torch.Tensor] = {
            name: torch.zeros((self.capacity,) + tuple(s), dtype=dtype,
                              device=self.device)
            for name, s in self.shapes.items()}
        self.slot_of: Dict[int, int] = {}          # expert -> slot
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self.gen: List[int] = [0] * self.capacity
        self.writes = 0                             # slot-write count
        self.splice_writes = 0                      # of which fused admits
        self.splice_s = 0.0                         # fused-admit launch time
        self.d2h_bytes = 0                          # demotion downloads
        # no locks by design: all mutation on the engine caller's (decode)
        # thread; ZIPMOE_CHECK=1 asserts that (see checkz.MutatorGuard)
        self._guard = checkz.make_guard(f"DeviceSlabCache(layer={layer})")

    # -- queries -----------------------------------------------------------
    def __contains__(self, expert: int) -> bool:
        return expert in self.slot_of

    def refs(self, expert: int) -> Dict[str, SlotRef]:
        slot = self.slot_of[expert]
        g = self.gen[slot]
        return {name: SlotRef(self, slot, g, name) for name in self.shapes}

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs.values())

    # -- mutation (decode thread only) -------------------------------------
    def put(self, expert: int, tensors: Dict[str, object]
            ) -> Dict[str, SlotRef]:
        """Write `tensors` (one per name) into the expert's slot —
        allocating one if needed — in place.  A value may be a device
        tensor (plain slot copy) or a :class:`DevicePlanes` (fused
        splice-admit: the bit-plane splice and the slot write are ONE
        kernel launch)."""
        assert set(tensors) == set(self.shapes), (set(tensors),
                                                  set(self.shapes))
        self._guard.check()
        slot = self.slot_of.get(expert)
        if slot is None:
            assert self._free, f"slab full (capacity={self.capacity})"
            slot = self._free.pop()
            self.slot_of[expert] = slot
        for name, val in tensors.items():
            if isinstance(val, DevicePlanes):
                assert tuple(val.shape) == self.shapes[name], (name,
                                                               val.shape)
                t0 = time.perf_counter()
                ops.slab_splice_set(self.bufs[name], slot, val.exp, val.sm)
                self.splice_s += time.perf_counter() - t0
                self.splice_writes += 1
                continue
            assert tuple(val.shape) == self.shapes[name], (name, val.shape)
            self.bufs[name][slot].copy_(val)
        self.writes += 1
        return self.refs(expert)

    def free(self, expert: int):
        """Release the expert's slot; bumping the generation invalidates
        every outstanding SlotRef to the old occupant."""
        self._guard.check()
        slot = self.slot_of.pop(expert, None)
        if slot is None:
            return
        self.gen[slot] += 1
        self._free.append(slot)

    def retire(self):
        """Decommission the whole slab: every slot's generation is bumped so
        ALL outstanding SlotRefs turn stale, and the buffers are dropped so
        the device memory is reclaimed once the last reference dies; a read
        through a stale ref trips the usual validity assertion instead of
        returning zombie bytes."""
        self._guard.check()
        for slot in range(self.capacity):
            self.gen[slot] += 1
        self.slot_of.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self.bufs = {}

    # -- the hot-path read -------------------------------------------------
    def gather(self, name: str, slots: Sequence[int]) -> torch.Tensor:  # hot-path
        """``[len(slots), *shape]`` device gather — a MATERIALIZED copy of
        the active experts (callers charge it to ``w_copy_bytes``).  The
        slot-indexed ragged GEMM reads ``self.bufs[name]`` in place instead
        (``kernels/ops.slab_gemm``) and needs only the slot numbers.
        Callers must generation-check their SlotRefs first."""
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.device)
        return self.bufs[name].index_select(0, idx)

    def summary(self) -> Dict[str, object]:
        return {"layer": self.layer, "capacity": self.capacity,
                "resident": len(self.slot_of), "writes": self.writes,
                "splice_writes": self.splice_writes,
                "d2h_bytes": self.d2h_bytes, "nbytes": self.nbytes()}
