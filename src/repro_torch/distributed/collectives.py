"""Collective traffic, charged where the port calls ``torch.distributed``.

The JAX package parses the operand bytes of each collective out of the
compiled HLO (``collective_bytes``) because XLA inserts the collectives.
The port has no HLO to read: its collectives are explicit calls, so these
thin wrappers charge the operand bytes to a :class:`CollectiveLedger` at
the call site, under the JAX package's kind names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``, and a send/receive
pair as ``collective-permute``).  One charge is one op of its kind; the
ledger is per rank (per process).

``gloo`` reduces, gathers and exchanges CUDA tensors through the host
itself, but a send or receive of a CUDA tensor kills the ranks (seen on
the H100 with torch 2.11), so :func:`permute` stages a CUDA tensor
through pinned host buffers on a ``gloo`` group.  The bytes charged are
the operand's either way.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Optional

import torch
import torch.distributed as dist


class CollectiveLedger:
    """Collective-traffic meter: bytes and op counts per kind.

    Charges arrive from the thread that issues the collectives, but the
    totals may be read by telemetry calls from any thread — hence the
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._bytes: Dict[str, int] = defaultdict(int)
        # guarded-by: _lock
        self._ops: Dict[str, int] = defaultdict(int)
        # guarded-by: _lock  (host->peer-device upload bytes)
        self._put_bytes = 0
        # guarded-by: _lock  (fetches aborted by a failed link: events,
        # not traffic)
        self._link_failures = 0

    def charge(self, kinds: Dict[str, int]):
        """Record one op's traffic per kind (a 'total' key is ignored: it
        is recomputed on read)."""
        with self._lock:
            for kind, b in kinds.items():
                if kind == "total":
                    continue
                self._bytes[kind] += int(b)
                self._ops[kind] += 1

    def charge_put(self, nbytes: int):
        """Record a host->owner-device upload (admission traffic)."""
        with self._lock:
            self._put_bytes += int(nbytes)

    def charge_failure(self):
        """Record a fetch aborted by a link failure (no bytes moved)."""
        with self._lock:
            self._link_failures += 1

    def summary(self) -> Dict[str, object]:
        with self._lock:
            by_kind = dict(self._bytes)
            return {
                "collective_bytes": by_kind,
                "collective_ops": dict(self._ops),
                "total_bytes": sum(by_kind.values()),
                "peer_put_bytes": self._put_bytes,
                "link_failures": self._link_failures,
            }


def _charge(ledger: Optional[CollectiveLedger], kind: str,
            t: torch.Tensor):
    if ledger is not None:
        ledger.charge({kind: t.numel() * t.element_size()})


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None,
               ledger: Optional[CollectiveLedger] = None) -> torch.Tensor:
    """In-place all-reduce of `t` over `group`; returns `t`."""
    _charge(ledger, "all-reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into_tensor(out: torch.Tensor, t: torch.Tensor, group=None,
                           ledger: Optional[CollectiveLedger] = None
                           ) -> torch.Tensor:
    """Every rank's `t`, concatenated along dim 0 in group-rank order, into
    `out`; charges `t`'s bytes."""
    _charge(ledger, "all-gather", t)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def reduce_scatter_tensor(out: torch.Tensor, t: torch.Tensor,
                          op=dist.ReduceOp.SUM, group=None,
                          ledger: Optional[CollectiveLedger] = None
                          ) -> torch.Tensor:
    """The reduction of every rank's `t`, split along dim 0, this rank's
    part into `out`; charges `t`'s bytes."""
    _charge(ledger, "reduce-scatter", t)
    dist.reduce_scatter_tensor(out, t, op=op, group=group)
    return out


def all_to_all_single(out: torch.Tensor, t: torch.Tensor, group=None,
                      ledger: Optional[CollectiveLedger] = None
                      ) -> torch.Tensor:
    """Equal splits of `t` along dim 0 exchanged between the group's ranks
    into `out`; charges `t`'s bytes."""
    _charge(ledger, "all-to-all", t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def permute(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int,
            group=None, ledger: Optional[CollectiveLedger] = None
            ) -> torch.Tensor:
    """One hop of a collective permute: send `send` to group rank `dst`
    while receiving group rank `src`'s tensor into `recv` (same shape and
    dtype); returns `recv`.  Charges `send`'s bytes."""
    _charge(ledger, "collective-permute", send)
    staged = _host_staged(send, group)
    if staged:
        out = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        out.copy_(send)
        into = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
    else:
        out, into = send.contiguous(), recv
    dst_g = dist.get_global_rank(group, dst) if group is not None else dst
    src_g = dist.get_global_rank(group, src) if group is not None else src
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, dst_g, group),
            dist.P2POp(dist.irecv, into, src_g, group)]):
        work.wait()
    if staged:
        recv.copy_(into)
    return recv
