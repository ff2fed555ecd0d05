"""Runtime concurrency checker (the dynamic half of tools/zipcheck).

Enabled by ``ZIPMOE_CHECK=1`` in the environment; with the variable unset
every factory returns the plain ``threading`` primitive / a no-op guard, so
production runs pay nothing.  Two independent checks:

* **Lock-order cycle detection** — :func:`make_lock` /
  :func:`make_condition` return instrumented locks that maintain one global
  acquired-while-holding edge graph (``A -> B`` = some thread acquired B
  while holding A).  A cycle in that graph is a deadlock *hazard* even if
  the interleaving that deadlocks was never hit, so closing one raises
  :class:`LockOrderError` immediately — turning a probabilistic hang into a
  deterministic hard failure the stress tests can assert on.

* **Owning-thread assertions** — the cache pools and device slabs have no
  locks BY DESIGN: all mutation happens on the engine caller's (decode)
  thread (see DESIGN.md "Threading model").  :func:`make_guard` returns a
  :class:`MutatorGuard` whose ``check()`` binds the first mutating thread
  as owner and raises :class:`GuardError` on any mutation from a different
  thread — the runtime teeth behind the ``# guarded-by`` / single-mutator
  prose contracts that tools/zipcheck verifies statically.

The instrumented lock is duck-type compatible with ``threading.Lock``
(acquire/release/locked/context manager), which is all
``threading.Condition`` needs — ``make_condition(lock)`` therefore builds a
*plain* Condition over the instrumented lock, and every
wait()/notify()-internal acquire/release flows through the order checker.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set


def enabled() -> bool:
    """True when runtime checking is on (read per call: tests flip the env
    var with monkeypatch *before* constructing the objects under check)."""
    return os.environ.get("ZIPMOE_CHECK", "") not in ("", "0")


class LockOrderError(RuntimeError):
    """Acquiring this lock here closes a cycle in the lock-order graph."""


class GuardError(RuntimeError):
    """A single-mutator structure was mutated from a non-owner thread."""


# ---------------------------------------------------------------------------
# lock-order graph (global: deadlock cycles span objects and threads)
# ---------------------------------------------------------------------------
_graph_mu = threading.Lock()
_edges: Dict[str, Set[str]] = {}      # held-lock name -> then-acquired names
_held_tl = threading.local()          # per-thread stack of held CheckedLocks


def _held_stack() -> List["CheckedLock"]:
    st = getattr(_held_tl, "stack", None)
    if st is None:
        st = _held_tl.stack = []
    return st


def _reaches(src: str, dst: str) -> bool:
    """DFS over the edge graph (caller holds _graph_mu)."""
    seen, todo = set(), [src]
    while todo:
        n = todo.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        todo.extend(_edges.get(n, ()))
    return False


def lock_order_edges() -> Dict[str, Set[str]]:
    """Snapshot of the acquired-while-holding graph (tests/debugging)."""
    with _graph_mu:
        return {k: set(v) for k, v in _edges.items()}


def reset_lock_order():
    """Drop all recorded edges (test isolation: the graph is process-global
    and outlives the engines that populated it)."""
    with _graph_mu:
        _edges.clear()


class CheckedLock:
    """``threading.Lock`` proxy feeding the lock-order graph.

    Duck-type complete for Condition use: acquire/release/locked plus the
    context-manager protocol.  ``Condition``'s default ``_is_owned`` probes
    with ``acquire(0)``/``release()`` — both flow through here, and the
    same-name edge those probes would record is skipped."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def _note_acquire(self):
        held = _held_stack()
        if not held:
            return
        with _graph_mu:
            for h in held:
                if h.name == self.name:
                    continue
                _edges.setdefault(h.name, set()).add(self.name)
                if _reaches(self.name, h.name):
                    cyc = f"{h.name} -> {self.name} ~> {h.name}"
                    raise LockOrderError(
                        f"lock-order cycle (deadlock hazard): acquiring "
                        f"{self.name!r} while holding {h.name!r} closes "
                        f"{cyc}")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._note_acquire()
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self):
        st = _held_stack()
        # Condition.wait releases out of stack order: pop by identity
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_lock(name: str):
    """A lock for guarded-by contracts: plain ``threading.Lock`` when
    checking is off, a :class:`CheckedLock` when on."""
    return CheckedLock(name) if enabled() else threading.Lock()


def make_condition(lock, name: str = ""):
    """A condition over `lock` (plain or checked — Condition only needs the
    lock duck type, so wait/notify re-acquires stay instrumented)."""
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# owning-thread guard for single-mutator structures
# ---------------------------------------------------------------------------
class MutatorGuard:
    """Cheap owner assertion: the first thread to call :meth:`check` owns
    the structure; any other thread mutating it afterwards raises.
    :meth:`rebind` releases ownership (tests that legitimately hand a
    structure between phases; the engine never calls it)."""

    __slots__ = ("name", "_owner")

    def __init__(self, name: str):
        self.name = name
        self._owner: Optional[int] = None

    def check(self):
        me = threading.get_ident()
        owner = self._owner
        if owner is None:
            self._owner = me
        elif owner != me:
            raise GuardError(
                f"{self.name}: mutated from thread {me} but owned by "
                f"thread {owner} (single-mutator contract: all mutation "
                f"on the engine caller's decode thread)")

    def rebind(self):
        self._owner = None


class _NullGuard:
    """Disabled-mode stand-in: ``check()`` is a no-op attribute lookup."""

    __slots__ = ()
    name = "<disabled>"

    def check(self):
        pass

    def rebind(self):
        pass


_NULL = _NullGuard()


def make_guard(name: str):
    """Owning-thread guard when checking is on, a shared no-op otherwise."""
    return MutatorGuard(name) if enabled() else _NULL
