"""Pluggable residency tiers: the §3.4 hierarchy as an explicit stack.

The paper's F ≺ C ≺ S ≺ E pool order used to be a hard-coded tuple whose
dispatch thresholds, payload-downgrade rules, and byte accounting were
duplicated across ``core/cache.py``, ``core/planner.py``, ``core/engine.py``
and ``core/slab.py``.  This module makes the hierarchy a first-class,
*ordered* :class:`TierStack`: each :class:`Tier` declares

* its ``state`` — the :class:`~repro_torch.core.states.CState` a resident maps to
  (which in turn fixes the reconstruction DAG via ``STATE_NEEDS``),
* its ``payload`` kind — which byte components back a resident
  (``full`` reconstructed bf16, ``sm+e``, ``sm``, or ``e`` chunks),
* ``cost_bytes`` — the per-expert residency cost derived from a layer's
  real component sizes (the §3.4 planner's byte denomination),
* ``peer`` — whether residents live in a *neighbor device's* HBM and are
  served over the interconnect (a peer copy) instead of the host decode
  path (the beyond-paper P tier; see DESIGN.md).

The default stack reproduces the paper hierarchy exactly; ``peer_stack()``
inserts the P (peer-HBM) tier between F and C — hotter than host-compressed
residency (a link fetch beats a full decode) but colder than local-HBM F.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Sequence, Tuple

from repro_torch.core.states import CState

# component keys of a layer's per-expert byte costs (engine._bytes_per_state
# feeds {"full": reconstructed bf16, "sm": raw SM planes, "e": E-chunks})
_PAYLOAD_KINDS = ("full", "sm+e", "sm", "e")


@dataclass(frozen=True)
class Tier:
    """One residency tier: name, residency state, payload kind, locality."""
    name: str
    state: CState
    payload: str                 # one of _PAYLOAD_KINDS
    peer: bool = False           # resident in a peer device's HBM

    def __post_init__(self):
        assert self.payload in _PAYLOAD_KINDS, self.payload

    def cost_bytes(self, parts: Dict[str, float]) -> float:
        """Per-expert residency cost from component sizes
        ``{"full": .., "sm": .., "e": ..}`` (bytes)."""
        if self.payload == "full":
            return float(parts["full"])
        if self.payload == "sm+e":
            return float(parts["sm"]) + float(parts["e"])
        if self.payload == "sm":
            return float(parts["sm"])
        return float(parts["e"])

    @property
    def needs(self) -> Tuple[bool, bool, bool]:
        """(E-chunk I/O, SM I/O, decompression) a hit in this tier still
        requires — delegated to the state's reconstruction DAG."""
        from repro_torch.core.states import STATE_NEEDS
        return STATE_NEEDS[self.state]


F_TIER = Tier("F", CState.F, "full")
P_TIER = Tier("P", CState.P, "full", peer=True)
C_TIER = Tier("C", CState.C, "sm+e")
S_TIER = Tier("S", CState.S, "sm")
E_TIER = Tier("E", CState.E, "e")


class TierStack:
    """An ordered residency hierarchy (hottest first).

    Immutable after construction; shared freely across caches/layers.
    ``order`` is the tuple of tier names in dispatch order — the drop-in
    replacement for the historical ``POOL_ORDER`` constant."""

    def __init__(self, tiers: Sequence[Tier]):
        self.tiers: Tuple[Tier, ...] = tuple(tiers)
        assert self.tiers, "empty tier stack"
        self.order: Tuple[str, ...] = tuple(t.name for t in self.tiers)
        self._by_name: Dict[str, Tier] = {t.name: t for t in self.tiers}
        assert len(self._by_name) == len(self.tiers), \
            f"duplicate tier names: {self.order}"

    def __iter__(self) -> Iterator[Tier]:
        return iter(self.tiers)

    def __len__(self) -> int:
        return len(self.tiers)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def tier(self, name: str) -> Tier:
        return self._by_name[name]

    def index(self, name: str) -> int:
        return self.order.index(name)

    @property
    def has_peer(self) -> bool:
        return any(t.peer for t in self.tiers)

    def bytes_per_state(self, parts: Dict[str, float]) -> Dict[str, float]:
        """Per-expert residency cost per tier from a layer's component
        sizes — what the engine feeds the planner and telemetry."""
        return {t.name: t.cost_bytes(parts) for t in self.tiers}

    def state_of(self, name: str) -> CState:
        return self._by_name[name].state


# the paper's §3.4 hierarchy — the default everywhere
DEFAULT_STACK = TierStack((F_TIER, C_TIER, S_TIER, E_TIER))

# F ≺ P ≺ C ≺ S ≺ E: peer-HBM residency between local-full and compressed
PEER_STACK = TierStack((F_TIER, P_TIER, C_TIER, S_TIER, E_TIER))


def peer_stack() -> TierStack:
    """The stack used when a device mesh is configured (``mesh_devices>1``)."""
    return PEER_STACK
