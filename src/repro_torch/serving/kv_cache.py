"""KV-cache utilities: per-layer views of stacked trees, cache growth,
memory accounting and the paged per-request decode state of continuous
batching.

The JAX package scans its decoder over super-blocks, so its trees carry a
leading ``[m]`` stack dim (``{"prefix": [...], "stack": {"sub_j": ...}}``).
The port keeps one entry per layer; :func:`unstack_layers` turns the first
form into the second and :func:`restack_layers` back.

Two allocation models of KV state live here:

* :class:`KVPagePool` — the continuous-batching allocator.  One
  fixed-size pool of KV *pages* (``page_size`` token slots each) shared by
  every active request: ``alloc`` reserves a request's whole page budget
  at admission (reservation == allocation, so a request in flight never
  stalls on pages), ``gather`` builds the active batch's ``[B, T, ...]``
  cache copies for one decode step, ``commit`` writes each row's NEW token
  back to its (page, offset), and ``free`` returns the pages at
  retirement.  Pages are never zeroed on reuse: attention masks positions
  ``> pos`` to exactly zero weight, so stale bytes are unobservable.
  Sequence-free leaves (a Mamba2 layer's ``ssm`` state and conv ring) get
  one per-request *slot* in a ``[max_slots, ...]`` buffer, gathered and
  rewritten whole each step; a slot IS zeroed when a new request takes
  it, because the Mamba2 recurrence reads its state unmasked (the JAX
  package's pool does not zero it, so there a request served in a
  recycled slot starts from its predecessor's state).
* :func:`grow_cache` — the whole-cache copy of the static-batch path, and
  the contiguous layout the page pool is tested against.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import check_supported, init_cache, \
    init_layer_cache, stack_layout


def map_tree(fn, tree):
    """`fn` applied to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List:
    """The leaves of a tree of dicts, lists and tuples, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def unstack_layers(tree, cfg):
    """Stacked decoder tree -> flat per-layer list (leaves are indexed, not
    copied)."""
    prefix, period, m = stack_layout(cfg)
    out = list(tree["prefix"])
    if tree.get("stack") is not None:
        for b in range(m):
            for j in range(period):
                out.append(map_tree(lambda x: x[b],
                                    tree["stack"][f"sub_{j}"]))
    return out


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def restack_layers(layers, cfg):
    """Inverse of :func:`unstack_layers`: a per-layer list -> the JAX
    package's stacked tree (stack leaves get a leading ``[m]`` dim)."""
    prefix, period, m = stack_layout(cfg)
    n_pre = len(prefix)
    out = {"prefix": list(layers[:n_pre]), "stack": None}
    if m:
        out["stack"] = {
            f"sub_{j}": _stack_trees([layers[n_pre + b * period + j]
                                      for b in range(m)])
            for j in range(period)}
    return out


def grow_cache(cfg, caches, batch: int, new_len: int):
    """Copy per-layer `caches` (a prefill's, sequence length S) into new
    zeroed buffers of length `new_len` on the same device.  Sequence-free
    leaves (``ssm`` state and conv ring, an encoder-decoder's cross-
    attention ``xkv``) have their final shape already and are copied
    whole."""
    dev = tree_leaves(caches)[0].device
    target = init_cache(cfg, batch, new_len, device=dev)

    def merge(dst, src):
        dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
        return dst

    return [{key: {name: merge(t[key][name], c[key][name])
                   for name in t[key]} for key in t}
            for t, c in zip(target, caches)]


def cache_bytes(cache) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))


# ----------------------------------------------------------------------------
# paged KV pool (continuous batching)
# ----------------------------------------------------------------------------
class KVPagePool:
    """Fixed-size page pool of per-request decode state, shared by all
    active requests.

    Per layer, the sequence leaves live in ``[n_pages, page_size, ...]``
    device buffers (GQA ``k``/``v``: ``[..., Hkv, D]``; MLA ``ckv``:
    ``[..., kv_lora_rank]`` and ``k_rope``: ``[..., qk_rope_dim]``)
    addressed through per-request page tables; the sequence-free leaves
    (Mamba2 ``ssm``: ``state [..., H, P, N]`` f32, ``conv [..., w-1, C]``)
    live in ``[max_slots, ...]`` buffers addressed by the request's slot.
    ``max_slots`` bounds how many requests hold pages at once (one slot
    each).  All bookkeeping (free lists, tables) is host-side Python: only
    the decode thread calls ``alloc``/``gather``/``commit``/``free``.
    """

    def __init__(self, cfg, *, page_size: int = 16, n_pages: int = 64,
                 max_slots: int = 8, device=None):
        if page_size < 1 or n_pages < 1 or max_slots < 1:
            raise ValueError(f"page_size {page_size}, n_pages {n_pages} and "
                             f"max_slots {max_slots} must be >= 1")
        check_supported(cfg, "rows")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.max_slots = int(max_slots)
        # per layer, split by allocation model: {"kv": {leaf: [n_pages,
        # page_size, ...]}} and {"ssm": {leaf: [max_slots, ...]}}
        self._paged: List[Dict] = []
        self._slot: List[Dict] = []
        for idx in range(cfg.n_layers):
            paged, slot = {}, {}
            for key, sub in init_layer_cache(cfg, idx, 1, self.page_size,
                                             self.device).items():
                if key == "kv":      # leaves [1, page_size, ...tail]
                    paged[key] = map_tree(lambda x: x.new_zeros(
                        (self.n_pages,) + x.shape[1:]), sub)
                else:                # leaves [1, ...tail] (sequence-free)
                    slot[key] = map_tree(lambda x: x.new_zeros(
                        (self.max_slots,) + x.shape[1:]), sub)
            self._paged.append(paged)
            self._slot.append(slot)
        self._free_pages: List[int] = list(range(self.n_pages))
        self._free_slots: List[int] = list(range(self.max_slots))
        self._tables: Dict[int, List[int]] = {}    # rid -> page ids
        self._slots: Dict[int, int] = {}           # rid -> slot id
        self._cap: Dict[int, int] = {}             # rid -> token capacity

    # -- accounting ------------------------------------------------------
    @property
    def n_used_pages(self) -> int:
        return self.n_pages - len(self._free_pages)

    @property
    def n_used_slots(self) -> int:
        return self.max_slots - len(self._free_slots)

    def page_nbytes(self) -> int:
        """Bytes one page holds across all layers' sequence leaves."""
        return cache_bytes(self._paged) // self.n_pages

    def slot_nbytes(self) -> int:
        """Bytes one request slot holds across all layers' sequence-free
        leaves (0 for a stack without Mamba2 layers)."""
        return cache_bytes(self._slot) // self.max_slots

    def used_bytes(self) -> int:
        """Bytes held by live (allocated) pages and slots — returns to 0
        once every request has retired (leak tripwire)."""
        return (self.n_used_pages * self.page_nbytes()
                + self.n_used_slots * self.slot_nbytes())

    def pool_bytes(self) -> int:
        """Total bytes of the backing buffers (fixed at construction)."""
        return (self.n_pages * self.page_nbytes()
                + self.max_slots * self.slot_nbytes())

    def summary(self) -> Dict[str, float]:
        return {"page_size": self.page_size, "n_pages": self.n_pages,
                "used_pages": self.n_used_pages,
                "used_slots": self.n_used_slots,
                "used_bytes": self.used_bytes(),
                "pool_bytes": self.pool_bytes(),
                "n_requests": len(self._tables)}

    # -- allocation ------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def alloc(self, rid: int, n_tokens: int):
        """Reserve `rid`'s full page budget (prompt + max new tokens) at
        admission.  All-or-nothing: a request that cannot get its whole
        allocation is not admitted, so active requests never stall on
        pages mid-flight."""
        if rid in self._tables:
            raise ValueError(f"rid {rid} already allocated")
        need = self.pages_for(n_tokens)
        if need > len(self._free_pages) or not self._free_slots:
            raise RuntimeError(
                f"KV page pool exhausted: rid {rid} needs {need} pages "
                f"({len(self._free_pages)} free) and a slot "
                f"({len(self._free_slots)} free)")
        self._tables[rid] = [self._free_pages.pop() for _ in range(need)]
        slot = self._slots[rid] = self._free_slots.pop()
        self._cap[rid] = need * self.page_size
        # a new request starts from the zero state: the recurrence reads
        # the slot unmasked, so a predecessor's state must not survive
        for ls in self._slot:
            for buf in tree_leaves(ls):
                buf[slot] = 0

    def free(self, rid: int):
        """Return `rid`'s pages and slot (retirement).  Pages are NOT
        zeroed — the next owner's masking makes them unobservable; a slot
        is zeroed when it is next allocated."""
        self._free_pages.extend(self._tables.pop(rid))
        self._free_slots.append(self._slots.pop(rid))
        self._cap.pop(rid)

    def capacity(self, rid: int) -> int:
        return self._cap[rid]

    # -- step views ------------------------------------------------------
    def gather(self, rids: Sequence[int]) -> List[Dict]:
        """Per-layer caches for one decode step over `rids`: each sequence
        leaf becomes a ``[B, T_pad, ...]`` COPY (advanced indexing),
        ``T_pad`` the longest active allocation; short rows pad with their
        own first page, masked, so its contents are irrelevant.  Each
        sequence-free leaf becomes a ``[B, ...]`` copy of the rows' slots.
        The views have the structure ``models.init_cache`` gives, so the
        decode path consumes them unchanged, writing the step's new state
        into them; page table and slots go to the device once per step."""
        B = len(rids)
        P = max(len(self._tables[r]) for r in rids)
        tables = np.asarray([self._tables[r]
                             + [self._tables[r][0]] * (P - len(self._tables[r]))
                             + [self._slots[r]]
                             for r in rids], np.int64)
        both = torch.from_numpy(tables).to(self.device)      # [B, P + 1]
        tab, slots = both[:, :P], both[:, P]
        T = P * self.page_size
        out = []
        for paged, slot in zip(self._paged, self._slot):
            view = {key: {name: buf[tab].reshape((B, T) + buf.shape[2:])
                          for name, buf in sub.items()}
                    for key, sub in paged.items()}
            view.update({key: map_tree(lambda buf: buf[slots], sub)
                         for key, sub in slot.items()})
            out.append(view)
        return out

    def commit(self, caches: Sequence[Dict], rids: Sequence[int], positions):
        """Write each row's NEW token back from the step's updated views:
        row ``b``'s ``positions[b]`` entry goes to its (page, offset), its
        sequence-free leaves to its slot, whole.  Raises, before any write,
        if a row would write past its allocated capacity (the max_len
        guard the server relies on)."""
        positions = np.asarray(positions, np.int64)
        for r, pos in zip(rids, positions):
            if pos >= self._cap[r]:
                raise ValueError(
                    f"rid {r}: position {pos} >= allocated capacity "
                    f"{self._cap[r]} (page budget overflow)")
        idx = np.asarray(
            [[self._tables[r][int(pos) // self.page_size]
              for r, pos in zip(rids, positions)],
             positions % self.page_size,
             np.arange(len(rids)),
             positions,
             [self._slots[r] for r in rids]], np.int64)
        pages, offs, rows, posv, slots = torch.from_numpy(idx).to(
            self.device)
        for view, paged, slot in zip(caches, self._paged, self._slot):
            for key, sub in paged.items():
                for name, buf in sub.items():
                    buf[pages, offs] = view[key][name][rows, posv]
            for key, sub in slot.items():
                for name, buf in sub.items():
                    buf[slots] = view[key][name]
