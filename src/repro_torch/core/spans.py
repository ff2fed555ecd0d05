"""Spans of the decode step: a process-wide recorder, off by default.

    from repro_torch.core import spans
    spans.enable()              # start recording (at most `cap` records)
    ...                         # serve
    records = spans.take()      # the records so far; the list is cleared
    spans.disable()

A site is ``with spans.span("moe.csr", layer):``.  Off, it costs one flag
test and returns the shared no-op context ``NOOP``: no clock read, no
allocation, no string formatted.  On, it appends one :class:`Span` to an
in-memory list when it closes; past the cap a span is dropped and counted
(``dropped()``), never raised.  No file is written: whoever enabled the
recorder reads ``take()``.

Every record carries its name (a constant string), its start and end on
``time.perf_counter_ns()`` (the clock ``time.perf_counter`` reads), its
id, its parent's id (0: none), its thread, the id of the step it belongs to
(0: none) and one int attribute (-1: none).  A span given no attribute
takes its parent's.  The attribute is a layer index, or ``a << 16 | b``
for a (layer, expert) key (``key_of`` splits it).

Parents come from a thread-local stack: the innermost span open on the
thread.  A worker thread names the span that caused its work by adopting
it (``adopt(job_span, job_step, layer, expert)``): spans opened inside
the ``with`` take it as their parent, its step and its key.
``step_span`` opens the span that starts a step (``server.step``): it takes
a new step id (and, by ``tag``, the rows' request ids), and every span
under it carries that step id, so the spans of one request are found through the steps that
list it.

A site that already times its interval for a counter passes that reading
(``span(name, start=t0)`` and ``close(t1)``), so the span and the counter
cannot disagree.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Sequence, Tuple

_on = False
_cap = 0
_records: List["Span"] = []
_dropped = 0
_drop_lock = threading.Lock()
_ids = itertools.count(1)
_steps = itertools.count(1)
_local = threading.local()


class _Noop:
    """The shared context every site gets while the recorder is off."""
    __slots__ = ()
    id = 0
    step = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self, end=None):
        pass

    def tag(self, rids):
        pass


NOOP = _Noop()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One recorded interval (see the module docstring).  Opened on the
    thread's stack when made; ``close`` (or leaving its ``with``) pops it,
    with any span still open inside it (which is not recorded), and
    records it."""
    __slots__ = ("name", "start", "end", "id", "parent", "tid", "step",
                 "attr", "rids")

    def __init__(self, name: str, attr: int, start):
        st = _stack()
        top = st[-1] if st else None
        self.name = name
        self.id = next(_ids)
        self.parent = top.id if top is not None else 0
        self.step = top.step if top is not None else 0
        self.attr = attr if attr >= 0 or top is None else top.attr
        self.tid = threading.get_ident()
        self.rids = ()
        self.end = None
        st.append(self)
        self.start = time.perf_counter_ns() if start is None else start

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self, end=None):
        """End the span at `end` (a ``perf_counter_ns`` reading; default
        now) and record it.  A second close does nothing."""
        if self.end is not None:
            return
        self.end = time.perf_counter_ns() if end is None else end
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i:]     # and any span an exception left open in it
                break
        _keep(self)

    def tag(self, rids: Sequence[int]):
        """Record the request ids of the step's rows."""
        self.rids = tuple(rids)

    @property
    def dur_ns(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"step={self.step}, attr={self.attr}, "
                f"{self.dur_ns / 1e3:.1f} us)")


class _Adopted:
    """A frame on a worker thread's stack that stands for a span of
    another thread: spans opened under it take it as their parent."""
    __slots__ = ("id", "step", "attr")

    def __init__(self, span_id: int, step: int, attr: int):
        self.id, self.step, self.attr = span_id, step, attr

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        return False


def _keep(sp: Span):
    global _dropped
    if len(_records) < _cap:
        _records.append(sp)
    else:
        with _drop_lock:
            _dropped += 1


def span(name: str, a: int = -1, b: int = -1, start=None):
    """A span named `name`; attribute `a`, or ``a << 16 | b`` when `b` is
    given (a (layer, expert) key).  ``start``: a ``perf_counter_ns``
    reading the caller already took."""
    if not _on:
        return NOOP
    return Span(name, a if b < 0 else a << 16 | b, start)


def step_span(name: str):
    """The span that starts a step: a new step id.  ``tag(rids)`` records
    the request ids of the step's rows."""
    if not _on:
        return NOOP
    sp = Span(name, -1, None)
    sp.step = next(_steps)
    return sp


def adopt(span_id: int, step: int, a: int = -1, b: int = -1):
    """Open spans of this thread under span `span_id` of another thread
    (the submission that queued the work), in step `step`, with key
    ``a << 16 | b``."""
    if not _on:
        return NOOP
    return _Adopted(span_id, step, a if b < 0 else a << 16 | b)


def key_of(attr: int) -> Tuple[int, int]:
    """(layer, expert) of a key attribute."""
    return attr >> 16, attr & 0xFFFF


def enable(cap: int = 1 << 20):
    """Start recording, from an empty list, keeping at most `cap`
    records."""
    global _on, _cap, _records, _dropped
    _records, _dropped, _cap = [], 0, int(cap)
    _on = True


def disable():
    """Stop recording; what was recorded stays for ``take()``."""
    global _on
    _on = False


def take() -> List[Span]:
    """The records so far, in the order they closed; clears the list."""
    global _records
    out, _records = _records, []
    return out


def dropped() -> int:
    """Spans dropped at the cap since ``enable()``."""
    return _dropped


# ---- reading the records ---------------------------------------------------
def covered_ns(parent: Span, kids: Sequence[Span]) -> int:
    """The part of `parent`'s interval that the union of `kids` covers."""
    iv = sorted((max(k.start, parent.start), min(k.end, parent.end))
                for k in kids)
    tot, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot


def children(records: Sequence[Span]) -> Dict[int, List[Span]]:
    """Span id -> the spans of its own thread that name it as parent."""
    tid = {r.id: r.tid for r in records}
    out: Dict[int, List[Span]] = {}
    for r in records:
        if r.parent and tid.get(r.parent) == r.tid:
            out.setdefault(r.parent, []).append(r)
    return out


def self_ns(sp: Span, kids: Dict[int, List[Span]]) -> int:
    """`sp`'s duration minus the part its children cover."""
    return sp.dur_ns - covered_ns(sp, kids.get(sp.id, ()))


def split(records: Sequence[Span]) -> Dict[str, float]:
    """Milliseconds per step of each span name, summed over the records
    (a name nested in itself would count twice; none is), and
    ``zs.decode_rows.self``: the host time of ``zs.decode_rows`` that no
    child names.  Steps: the ``server.step`` spans, else the
    ``zs.decode_rows`` spans.  ``steps`` is their count."""
    n = sum(1 for r in records if r.name == "server.step") or \
        sum(1 for r in records if r.name == "zs.decode_rows")
    if not n:
        return {"steps": 0}
    kids = children(records)
    tot: Dict[str, int] = {}
    for r in records:
        tot[r.name] = tot.get(r.name, 0) + r.dur_ns
    tot["zs.decode_rows.self"] = sum(self_ns(r, kids) for r in records
                                     if r.name == "zs.decode_rows")
    out = {"steps": n}
    out.update({k: v / n / 1e6 for k, v in sorted(tot.items())})
    return out
