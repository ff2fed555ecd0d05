"""Failure taxonomy + seeded deterministic fault injection.

The serving stack's failure model (DESIGN.md §Failure model) is built on
two pieces that live here:

* The **exception taxonomy** every layer routes through:
  ``ChunkIntegrityError`` (checksum mismatch / short read that survived
  retries), ``PeerLinkError`` (remote-fetch failure on the P tier),
  ``FetchError`` (structured per-expert failure carried by a fetch job
  and re-raised by ``FetchHandle.result()``), ``FetchTimeout`` (a
  deadline-bounded wait expired), and ``WorkerKilled`` (a simulated
  worker crash; derives from ``BaseException`` on purpose so the worker
  loops' ``except Exception`` routing does NOT catch it — the thread
  really dies and the watchdog path is exercised).

* ``FaultPlan`` — an opt-in, *seeded* injection shim wired into
  ``ExpertStore._read`` (op ``read``), the store's decompression calls
  (op ``decode``), each engine worker-loop iteration (op ``worker``) and
  ``PeerSlabMesh.fetch`` (op ``peer``).  Fault kinds: ``bitflip``,
  ``truncate``, ``eio``, ``delay`` (straggler), ``worker_kill``,
  ``peer_link``.  All randomness comes from one ``random.Random(seed)``
  under a lock, so a given plan string replays the exact same fault
  sequence — chaos runs are reproducible and assertable in tests.

Plan strings (``launch.serve --fault-plan``) look like::

    bitflip:p=0.1;eio:count=3,after=10;worker_kill:count=1;seed=42

``;`` separates rules, ``,`` separates a rule's parameters.  Parameters:
``p`` (firing probability per eligible op, default 1.0), ``count`` (max
total firings), ``after`` (skip the first N eligible ops), ``delay_s``
(sleep length for ``delay``), ``op`` (override the injection site:
``read``/``decode``/``worker``/``peer``).
"""
from __future__ import annotations

import errno
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core import checkz


# ----------------------------------------------------------------------------
# failure types (used with or without injection)
# ----------------------------------------------------------------------------
class ChunkIntegrityError(RuntimeError):
    """A chunk failed checksum verification (or came back short) and the
    bounded retry budget is exhausted.  The chunk is quarantined."""

    def __init__(self, fname: str, offset: int, size: int, reason: str):
        super().__init__(f"{fname}@{offset}+{size}: {reason}")
        self.fname = fname
        self.offset = offset
        self.size = size
        self.reason = reason


class PeerLinkError(RuntimeError):
    """A peer-HBM fetch failed (injected or real collective error)."""


class FetchTimeout(TimeoutError):
    """A deadline-bounded wait on a fetch job expired."""


class FetchError(RuntimeError):
    """Structured per-expert fetch failure.

    ``failures`` maps ``(layer, expert)`` -> human-readable reason.  The
    engine attaches one to the ``_FetchJob`` instead of hanging; handles
    re-raise it for failed *demand* keys (speculative failures are
    dropped and counted)."""

    def __init__(self, failures: Dict[Tuple[int, int], str]):
        msg = "; ".join(f"L{k[0]}E{k[1]}: {v}"
                        for k, v in sorted(failures.items()))
        super().__init__(f"expert fetch failed [{msg}]")
        self.failures = dict(failures)


class WorkerKilled(BaseException):
    """Simulated worker crash.  BaseException so the worker loops'
    ``except Exception`` routing lets it escape and the thread dies —
    detection/respawn is the watchdog's job, not the loop's."""


class StepFault(RuntimeError):
    """A decode step could not serve some batch rows: an unrecoverable
    expert-fetch failure mapped through the router's selection to the
    rows that needed the failed experts.  Continuous batching catches
    this, retires ONLY ``rows`` with an error, and re-runs the step with
    the survivors (nothing was committed — the raise happens before any
    KV write)."""

    def __init__(self, layer: int, failed_ids, rows, cause: Exception):
        ids = sorted(int(e) for e in failed_ids)
        super().__init__(
            f"decode step failed at layer {layer} "
            f"(experts {ids}, batch rows {sorted(rows)}): {cause}")
        self.layer = layer
        self.failed_ids = set(ids)
        self.rows = sorted(int(b) for b in rows)
        self.cause = cause


# ----------------------------------------------------------------------------
# fault plan
# ----------------------------------------------------------------------------
KINDS = ("bitflip", "truncate", "eio", "delay", "worker_kill", "peer_link")
# injection site each kind defaults to (override per-rule with op=)
_DEFAULT_OP = {"bitflip": "read", "truncate": "read", "eio": "read",
               "delay": "read", "worker_kill": "worker",
               "peer_link": "peer"}
OPS = ("read", "decode", "worker", "peer")


@dataclass
class FaultRule:
    kind: str
    op: str = ""                      # "" -> kind's default site
    p: float = 1.0
    count: Optional[int] = None       # max firings (None = unlimited)
    after: int = 0                    # skip the first N eligible ops
    delay_s: float = 0.02
    seen: int = 0                     # guarded-by: FaultPlan._mu
    fired: int = 0                    # guarded-by: FaultPlan._mu

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if not self.op:
            self.op = _DEFAULT_OP[self.kind]
        if self.op not in OPS:
            raise ValueError(f"unknown fault op {self.op!r} "
                             f"(expected one of {OPS})")


@dataclass
class FaultPlan:
    """Deterministic, thread-safe fault injector (see module docstring)."""

    rules: List[FaultRule] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._mu = checkz.make_lock("faults._mu")

    # -- construction ------------------------------------------------------
    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Parse a ``--fault-plan`` string (see module docstring)."""
        rules: List[FaultRule] = []
        seed = 0
        for tok in filter(None, (t.strip() for t in spec.split(";"))):
            if tok.startswith("seed="):
                seed = int(tok[len("seed="):])
                continue
            kind, _, params = tok.partition(":")
            kw = {}
            for pr in filter(None, (p.strip() for p in params.split(","))):
                k, _, v = pr.partition("=")
                if k in ("p", "delay_s"):
                    kw[k] = float(v)
                elif k in ("count", "after"):
                    kw[k] = int(v)
                elif k == "op":
                    kw[k] = v
                else:
                    raise ValueError(f"unknown fault param {k!r} in {tok!r}")
            rules.append(FaultRule(kind=kind.strip(), **kw))
        return FaultPlan(rules=rules, seed=seed)

    # -- firing decision ---------------------------------------------------
    def _fire(self, rule: FaultRule) -> bool:
        with self._mu:
            rule.seen += 1
            if rule.seen <= rule.after:
                return False
            if rule.count is not None and rule.fired >= rule.count:
                return False
            if rule.p < 1.0 and self._rng.random() >= rule.p:
                return False
            rule.fired += 1
            return True

    def _rand_index(self, n: int) -> int:
        with self._mu:
            return self._rng.randrange(n)

    def _rules_for(self, op: str):
        return [r for r in self.rules if r.op == op]

    def _corrupt(self, data: bytes, rule: FaultRule) -> bytes:
        if rule.kind == "bitflip":
            if not data:
                return data
            i = self._rand_index(len(data))
            b = bytearray(data)
            b[i] ^= 1 << self._rand_index(8)
            return bytes(b)
        if rule.kind == "truncate":
            return data[:len(data) // 2]
        raise AssertionError(rule.kind)  # pragma: no cover

    # -- injection sites ---------------------------------------------------
    def read(self, fname: str, offset: int, data: bytes) -> bytes:
        """Shim for ``ExpertStore._read``: may corrupt/shorten the bytes,
        raise ``OSError(EIO)``, or sleep (straggler read)."""
        for rule in self._rules_for("read"):
            if not self._fire(rule):
                continue
            if rule.kind == "eio":
                raise OSError(errno.EIO, "injected EIO", fname)
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind in ("bitflip", "truncate"):
                data = self._corrupt(data, rule)
        return data

    def decode(self, data: bytes) -> bytes:
        """Shim for the store's codec decompression input: corrupting the
        compressed payload makes the codec itself fail (distinct from a
        disk-read fault, which checksums catch earlier)."""
        for rule in self._rules_for("decode"):
            if not self._fire(rule):
                continue
            if rule.kind == "eio":
                raise OSError(errno.EIO, "injected decode EIO")
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind in ("bitflip", "truncate"):
                data = self._corrupt(data, rule)
        return data

    def worker(self, name: str) -> None:
        """Shim run at the top of each engine worker-loop iteration: may
        kill the worker (``WorkerKilled``) or stall it (straggler)."""
        for rule in self._rules_for("worker"):
            if not self._fire(rule):
                continue
            if rule.kind == "worker_kill":
                raise WorkerKilled(name)
            if rule.kind == "delay":
                time.sleep(rule.delay_s)

    def peer(self, expert) -> None:
        """Shim for ``PeerSlabMesh.fetch``: may fail the link."""
        for rule in self._rules_for("peer"):
            if not self._fire(rule):
                continue
            if rule.kind == "peer_link":
                raise PeerLinkError(f"injected peer-link failure for "
                                    f"{expert}")
            if rule.kind == "delay":
                time.sleep(rule.delay_s)

    # -- telemetry ---------------------------------------------------------
    def summary(self) -> Dict[str, int]:
        """``{"kind@op": fired}`` plus a ``total`` count."""
        with self._mu:
            out = {f"{r.kind}@{r.op}": r.fired for r in self.rules}
            out["total"] = sum(r.fired for r in self.rules)
            return out
