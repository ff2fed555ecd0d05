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

:class:`PeerSlabMesh` is the peer-HBM (P) tier's counterpart: one slab row
per device of the mesh, filled and fetched on the decode thread too.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitfield, checkz
from repro_torch.core.faults import PeerLinkError
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


# ----------------------------------------------------------------------------
# peer-HBM slabs: expert slabs sharded over a device mesh (the P tier)
# ----------------------------------------------------------------------------
@dataclass(frozen=True)
class PeerRef:
    """Handle to one tensor of one expert inside a peer slab row.

    P-pool cache payloads carry these instead of tensors — the bytes live
    in the OWNER device's memory, not in host memory and not on the
    compute device.  Validity follows the owner slot's generation, exactly
    like :class:`SlotRef`."""
    mesh_slab: "PeerSlabMesh"
    dev: int
    slot: int
    gen: int
    name: str

    @property
    def valid(self) -> bool:
        return self.mesh_slab.gen[self.dev][self.slot] == self.gen


class PeerSlabMesh:
    """Per-layer expert slabs sharded across a list of devices ('ep' axis).

    Row ``d`` is one ``[capacity, *tensor_shape]`` bf16 tensor per expert
    tensor name, allocated on ``devices[d]``.  Experts are assigned to rows
    by the EP owner rule (``distributed.sharding.ep_owner``: contiguous
    expert-id blocks), so a row is exactly the device's shard of the
    compressed store.  ``devices[0]`` is the compute device.

    * **put** — admission writes the expert's reconstructed tensors into
      its slot of the owner row in place (``row[slot].copy_``: a host
      upload for host bits, a device or peer copy for a device tensor);
      the bytes are charged to the ledger's ``peer_put_bytes`` (NOT the
      engine's h2d counter, which meters compute-device staging only).
    * **fetch** — a demand hit on a peer-resident expert copies its slot
      to the compute device (over NVLink between cards: a peer copy) into
      a FRESH tensor: a view of the row would see a later occupant's bytes
      once the slot is reused.  The fetch waits for the copy, as the JAX
      package's ``block_until_ready`` does; its wall time feeds the
      :class:`~repro_torch.core.profiles.LinkProfiler`, and each fetch
      charges one ``collective-permute`` of :meth:`expert_nbytes` to the
      ledger.
    * **free/retire** — slot generations exactly as in
      :class:`DeviceSlabCache`; stale :class:`PeerRef`\\ s never serve.

    Thread model: all mutation AND fetching happens on the engine caller's
    (decode) thread — peer fetches run synchronously at submit time, so
    the single-mutator discipline of the cache pools extends unchanged.
    """

    def __init__(self, layer: int, shapes: Dict[str, Tuple[int, ...]],
                 capacity: int, devices: Sequence, *, ledger=None,
                 link=None, dtype=torch.bfloat16):
        assert capacity > 0, capacity
        assert len(devices) > 1, devices
        self.layer = layer
        self.devices = [torch.device(d) for d in devices]
        self.n_dev = len(self.devices)
        self.capacity = int(capacity)          # physical slots per device row
        self.shapes = {name: tuple(s) for name, s in shapes.items()}
        self.names = sorted(self.shapes)
        self.dtype = dtype
        self.ledger = ledger
        self.link = link
        self.rows: List[Dict[str, torch.Tensor]] = [
            {name: torch.zeros((self.capacity,) + s, dtype=dtype, device=d)
             for name, s in self.shapes.items()}
            for d in self.devices]
        self.slot_of: Dict[int, Tuple[int, int]] = {}   # expert -> (dev, slot)
        self._free: List[List[int]] = [
            list(range(self.capacity - 1, -1, -1)) for _ in range(self.n_dev)]
        # per-device logical capacity (the per-device §3.4 solve may grant a
        # device fewer slots than the uniform physical row)
        self.dev_caps: List[int] = [self.capacity] * self.n_dev
        self.gen: List[List[int]] = [[0] * self.capacity
                                     for _ in range(self.n_dev)]
        self.writes = 0
        self.fetches = 0
        self.faults = None          # opt-in FaultPlan shim (core/faults)
        self.link_failures = 0      # fetch() aborts via PeerLinkError
        # no locks by design: all mutation on the engine caller's (decode)
        # thread; ZIPMOE_CHECK=1 asserts that (see checkz.MutatorGuard)
        self._guard = checkz.make_guard(f"PeerSlabMesh(layer={layer})")

    # -- queries -----------------------------------------------------------
    def __contains__(self, expert: int) -> bool:
        return expert in self.slot_of

    def refs(self, expert: int) -> Dict[str, PeerRef]:
        dev, slot = self.slot_of[expert]
        g = self.gen[dev][slot]
        return {name: PeerRef(self, dev, slot, g, name) for name in self.names}

    def has_free(self, dev: int) -> bool:
        used = self.capacity - len(self._free[dev])
        return bool(self._free[dev]) and used < self.dev_caps[dev]

    def expert_nbytes(self) -> int:
        """Bytes of one expert's tensors (the per-fetch payload size)."""
        item = torch.empty((), dtype=self.dtype).element_size()
        return sum(int(np.prod(s)) * item for s in self.shapes.values())

    def resident_bytes(self, dev: int) -> int:
        """Bytes of the experts resident in device `dev`'s row."""
        n = sum(1 for d, _ in self.slot_of.values() if d == dev)
        return n * self.expert_nbytes()

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for row in self.rows for t in row.values())

    def set_dev_caps(self, caps: Sequence[int]):
        """Apply per-device logical slot counts (the per-device planner
        solves).  Shrinking below a device's occupancy only gates NEW
        admissions — residents are freed by the cache's own demotions."""
        assert len(caps) == self.n_dev, (len(caps), self.n_dev)
        self.dev_caps = [min(self.capacity, max(0, int(c))) for c in caps]

    # -- mutation (decode thread only) -------------------------------------
    def put(self, expert: int, dev: int,
            tensors: Dict[str, object]) -> Dict[str, PeerRef]:
        """Write `tensors` into the expert's slot in device `dev`'s row.  A
        value is host bf16 bits (a uint16 ndarray) or a bf16 tensor on any
        device."""
        assert set(tensors) == set(self.shapes), (set(tensors),
                                                  set(self.shapes))
        self._guard.check()
        loc = self.slot_of.get(expert)
        if loc is None:
            assert self.has_free(dev), f"peer row {dev} full"
            slot = self._free[dev].pop()
            self.slot_of[expert] = loc = (dev, slot)
        else:
            assert loc[0] == dev, (expert, loc, dev)
        d, slot = loc
        nbytes = 0
        for name, val in tensors.items():
            assert tuple(val.shape) == self.shapes[name], (name, val.shape)
            if isinstance(val, np.ndarray):
                val = bitfield.from_bits(val)
            dst = self.rows[d][name][slot]
            dst.copy_(val)
            nbytes += dst.numel() * dst.element_size()
        self.writes += 1
        if self.ledger is not None:
            self.ledger.charge_put(nbytes)
        return self.refs(expert)

    def free(self, expert: int):
        self._guard.check()
        loc = self.slot_of.pop(expert, None)
        if loc is None:
            return
        dev, slot = loc
        self.gen[dev][slot] += 1
        self._free[dev].append(slot)

    def retire(self):
        """Decommission the mesh slab (re-planning resized the P tier):
        every generation bumps — all outstanding PeerRefs turn stale — and
        the rows are dropped for reclamation."""
        self._guard.check()
        for dev in range(self.n_dev):
            for slot in range(self.capacity):
                self.gen[dev][slot] += 1
            self._free[dev] = list(range(self.capacity - 1, -1, -1))
        self.slot_of.clear()
        self.rows = []

    # -- the fetch path (decode thread; synchronous) -----------------------
    def fetch(self, expert: int) -> Optional[Dict[str, torch.Tensor]]:
        """Copy the expert's tensors to the compute device (device 0).
        Returns {name: fresh device tensor} or None when the expert is not
        (validly) resident.  Charges the ledger one collective-permute of
        the expert's bytes and feeds the link profiler the measured wall
        time.  Raises :class:`PeerLinkError` when the (shim) link fails —
        the engine falls back to the local store path."""
        self._guard.check()
        loc = self.slot_of.get(expert)
        if loc is None or not self.rows:
            return None
        if self.faults is not None:
            try:
                self.faults.peer(expert)
            except PeerLinkError:
                self.link_failures += 1
                if self.ledger is not None:
                    self.ledger.charge_failure()
                raise
        dev, slot = loc
        dev0 = self.devices[0]
        t0 = time.perf_counter()
        # copy=True: a fresh tensor even where the row already lives on the
        # compute device (a view would alias the slot's next occupant)
        got = {name: self.rows[dev][name][slot].to(dev0, copy=True)
               for name in self.names}
        for d in {dev0, self.devices[dev]}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        dt = time.perf_counter() - t0
        self.fetches += 1
        nbytes = self.expert_nbytes()
        if self.ledger is not None:
            self.ledger.charge({"collective-permute": nbytes})
        if self.link is not None:
            self.link.record(nbytes, dt)
        return got

    def summary(self) -> Dict[str, object]:
        return {"layer": self.layer, "capacity": self.capacity,
                "n_dev": self.n_dev, "dev_caps": list(self.dev_caps),
                "resident": len(self.slot_of), "writes": self.writes,
                "fetches": self.fetches, "nbytes": self.nbytes()}
