"""Expert store: offline initialization + runtime chunk reads (§3.1, §3.2).

``build_store`` converts a model's expert parameters into the chunked,
losslessly-compressed on-disk format: each BF16 tensor is split by
``core/bitfield.py`` into K compressed exponent shards (E-chunks, codec from
``core/codec.py``) and one raw sign–mantissa plane (SM-chunk) — the two I/O
units the §3.3 scheduler orders (E-chunks before SM-chunks within a block).
``ExpertStore`` is the runtime read interface: exact-range reads per chunk,
optional bandwidth throttling to emulate the paper's NVMe tier (3.5 GB/s
Samsung 970 EVO by default; configurable).

API:
  build_store(params, cfg, path, codec=, k_shards=, device=, workers=)
      offline packing (groups compressed in a thread pool); writes
      ``g{layer}_{expert}.bin`` files + a JSON manifest with per-tensor
      chunk offsets.
  ExpertStore(path, bandwidth_gbps=)
      .read_sm(key, tidx) / .read_e(key, tidx, shard)   — raw chunk bytes
      .decompress_e(key, tidx, shard, data)             — one worker op
      .load_tensor / .load_group                        — blocking full loads
      .ratio()  — store bytes / BF16 bytes (paper Fig. 3)
      .rho()    — compressed/raw exponent ratio (the scheduler's ρ)
  where ``key = (layer, expert)`` and tensors keep their parameter names.

Expert groups come from the port's per-layer parameter list
(``models/model.init_params``): a MoE layer's ``ffn.{w_gate,w_up,w_down}``
stacks ``[E, ...]`` give one group per (layer, expert); a dense layer's FFN
is a single always-active "expert 0".  The on-disk format (manifest v2,
per-chunk crc32, K E-shards) is byte-for-byte the JAX package's, so either
package reads a store the other built.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitfield, checkz
from repro_torch.core.chunks import (GroupMeta, chunk_crc,
                                     manifest_from_json, manifest_to_json,
                                     pack_group, unpack_tensor)
from repro_torch.core.codec import Codec, get_codec
from repro_torch.core.faults import ChunkIntegrityError, FaultPlan
from repro_torch.device import resolve_device

DEFAULT_K = 4


# ----------------------------------------------------------------------------
# expert-group extraction from per-layer params
# ----------------------------------------------------------------------------
EXPERT_TENSORS = ("w_gate", "w_up", "w_down")   # per-group tensor order


def iter_expert_groups(params, cfg
                       ) -> Iterator[Tuple[int, int, Dict[str, torch.Tensor]]]:
    """Yields (layer_idx, expert_idx, {tensor_name: tensor}) in layer, then
    expert order — the JAX package's group order."""
    for i, lp in enumerate(params["layers"]):
        ffn = lp.get("ffn")
        if ffn is None:
            continue
        if "router" in ffn:                       # MoE layer
            for e in range(ffn["w_up"].shape[0]):
                yield i, e, {name: ffn[name][e]
                             for name in EXPERT_TENSORS if name in ffn}
        else:                                     # dense MLP as expert 0
            yield i, 0, {name: ffn[name] for name in EXPERT_TENSORS
                         if name in ffn}


def _pack(tensors: Dict[str, torch.Tensor], device: torch.device, codec,
          k_shards: int):
    """Split one group into bit-planes on `device`, then compress on the
    host (zlib/zstd release the GIL, so pool threads overlap)."""
    planes = {}
    for name, t in tensors.items():
        exp, sm = bitfield.decompose(t.to(device))
        planes[name] = (exp.cpu().numpy(), sm.cpu().numpy(), tuple(t.shape))
    return pack_group(planes, codec, k_shards)


# ----------------------------------------------------------------------------
# offline build
# ----------------------------------------------------------------------------
def build_store(params, cfg, path: str, *, codec: str = None,
                k_shards: int = DEFAULT_K, device=None,
                workers: Optional[int] = None) -> "ExpertStore":
    """Write the compressed store for `params` into `path`.  Groups are
    split into bit-planes on `device` (the card by default) and compressed
    by a pool of `workers` threads (default: one per CPU); files, bytes and
    manifest are exactly what a serial build writes."""
    dev = resolve_device(device)
    os.makedirs(path, exist_ok=True)
    cd = get_codec(codec)
    groups = list(iter_expert_groups(params, cfg))
    n = workers or os.cpu_count() or 1

    def job(item):
        layer, expert, tensors = item
        fname = f"g{layer}_{expert}.bin"
        blob, metas = _pack(tensors, dev, cd, k_shards)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(blob)
        return GroupMeta(layer, expert, fname, metas)

    with ThreadPoolExecutor(max_workers=n) as pool:
        metas = list(pool.map(job, groups))      # input order: serial manifest
    extra = {"arch": cfg.name, "n_layers": cfg.n_layers,
             "n_experts": max(1, cfg.n_experts)}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write(manifest_to_json(metas, cd.name, k_shards, extra))
    return ExpertStore(path)


# ----------------------------------------------------------------------------
# runtime read interface
# ----------------------------------------------------------------------------
class ExpertStore:
    """Exact-range chunk reads with optional bandwidth emulation."""

    def __init__(self, path: str, *, bandwidth_gbps: Optional[float] = None,
                 verify: Optional[bool] = None,
                 faults: Optional[FaultPlan] = None,
                 max_retries: int = 3, retry_backoff_s: float = 0.002):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            codec_name, k, extra, groups = manifest_from_json(f.read())
        self.codec: Codec = get_codec(codec_name)
        self.k_shards = k
        self.extra = extra
        self.groups: Dict[Tuple[int, int], GroupMeta] = {g.key: g for g in groups}
        self.bandwidth = bandwidth_gbps * 1e9 if bandwidth_gbps else None
        # integrity: verify per-chunk CRCs on every read (v2 manifests);
        # verify=None auto-enables when the manifest carries checksums,
        # verify=False opts out (the benchmark's "clean" baseline row)
        has_crc = any(t.sm_crc is not None
                      for g in groups for t in g.tensors)
        self.verify = has_crc if verify is None else (verify and has_crc)
        self.faults = faults            # opt-in injection shim (core/faults)
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        # benchmark counters: bumped by _read(), which runs on the engine's
        # I/O thread AND on the decode thread (full loads / SM refetches)
        self.io_bytes = 0           # guarded-by: _fd_lock
        self.io_time = 0.0          # guarded-by: _fd_lock
        # per-thread FD cache: the I/O thread issues thousands of
        # exact-range reads per trace against a handful of .bin files —
        # open/close per chunk read was pure syscall tax.  FDs are
        # thread-local (seek+read races are impossible) but registered
        # globally so close() can release every descriptor at shutdown.
        self._fd_local = threading.local()
        self._fd_lock = checkz.make_lock("store._fd_lock")
        self._open_files: List = []     # guarded-by: _fd_lock
        self.open_calls = 0             # guarded-by: _fd_lock
        # fault/integrity counters (fault_summary); guarded-by: _fd_lock
        self.read_retries = 0           # verified-read retry attempts
        self.checksum_failures = 0      # CRC mismatches observed
        self.short_reads = 0            # partial-read continuations (EINTR)
        self.fd_reopens = 0             # stale/raising FDs dropped+reopened
        self.quarantined: set = set()   # {(fname, offset)} retry-exhausted

    def _fd(self, fname: str):
        cache = getattr(self._fd_local, "fds", None)
        if cache is None:
            cache = self._fd_local.fds = {}
        f = cache.get(fname)
        if f is None or f.closed:
            f = open(os.path.join(self.path, fname), "rb")
            cache[fname] = f
            with self._fd_lock:
                self.open_calls += 1
                self._open_files.append(f)
        return f

    def _drop_fd(self, fname: str, f) -> None:
        """Evict a raising descriptor from this thread's cache so the next
        ``_fd`` call reopens instead of re-hitting the poisoned handle."""
        cache = getattr(self._fd_local, "fds", None)
        if cache is not None and cache.get(fname) is f:
            cache.pop(fname, None)
        try:
            f.close()
        except OSError:
            pass
        with self._fd_lock:
            self.fd_reopens += 1
            if f in self._open_files:
                self._open_files.remove(f)

    def close(self):
        """Release every cached FD (engine shutdown hook).  Idempotent; a
        straggler read after close() transparently reopens."""
        with self._fd_lock:
            for f in self._open_files:
                try:
                    f.close()
                except OSError:  # pragma: no cover
                    pass
            self._open_files.clear()

    # -- raw range read (the I/O thread op) --------------------------------
    def _pread(self, fname: str, offset: int, size: int) -> bytes:
        """Positioned read that survives transient OS errors: short reads
        are continued until ``size`` bytes or EOF (EINTR-style partial
        returns), and a raising/stale cached FD is dropped and reopened
        once instead of poisoning this thread's cache."""
        for attempt in (0, 1):
            f = self._fd(fname)
            try:
                f.seek(offset)
                parts = []
                need = size
                while need > 0:
                    b = f.read(need)
                    if not b:       # EOF — caller verifies the final length
                        break
                    parts.append(b)
                    need -= len(b)
                    if need:
                        with self._fd_lock:
                            self.short_reads += 1
                return b"".join(parts)
            except (OSError, ValueError):
                # ValueError: operation on a closed/stale descriptor
                self._drop_fd(fname, f)
                if attempt:
                    raise
        raise AssertionError("unreachable")  # pragma: no cover

    def _read(self, fname: str, offset: int, size: int) -> bytes:
        t0 = time.perf_counter()
        data = self._pread(fname, offset, size)
        if self.faults is not None:
            data = self.faults.read(fname, offset, data)
        el = time.perf_counter() - t0
        if self.bandwidth:
            want = size / self.bandwidth
            if el < want:
                time.sleep(want - el)
                el = want
        # engine I/O thread and decode thread both land here concurrently:
        # unlocked `+=` loses increments (found by tools/zipcheck)
        with self._fd_lock:
            self.io_bytes += size
            self.io_time += el
        return data

    # -- verified chunk read (integrity + bounded retry + quarantine) ------
    def _read_chunk(self, fname: str, offset: int, size: int,
                    crc: Optional[int] = None) -> bytes:
        """Exact-range read with integrity checking: a read error, short
        result, or CRC mismatch retries up to ``max_retries`` times with
        exponential backoff; on exhaustion the chunk is quarantined and
        ``ChunkIntegrityError`` raised (callers fall back to a full
        re-read or fail the expert — never serve unverified bytes)."""
        reason = "unknown"
        for attempt in range(self.max_retries + 1):
            if attempt:
                with self._fd_lock:
                    self.read_retries += 1
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            try:
                data = self._read(fname, offset, size)
            except OSError as e:
                reason = f"read error: {e}"
                continue
            if len(data) != size:
                reason = f"short read ({len(data)}/{size} bytes)"
                continue
            if self.verify and crc is not None and chunk_crc(data) != crc:
                with self._fd_lock:
                    self.checksum_failures += 1
                reason = "checksum mismatch"
                continue
            return data
        with self._fd_lock:
            self.quarantined.add((fname, offset))
        raise ChunkIntegrityError(fname, offset, size, reason)

    def read_sm(self, key, tidx: int) -> bytes:
        g = self.groups[key]
        t = g.tensors[tidx]
        return self._read_chunk(g.file, t.sm_offset, t.sm_size, t.sm_crc)

    def read_e(self, key, tidx: int, shard: int) -> bytes:
        g = self.groups[key]
        t = g.tensors[tidx]
        crc = t.e_crcs[shard] if t.e_crcs else None
        return self._read_chunk(g.file, t.e_offsets[shard],
                                t.e_sizes[shard], crc)

    def decompress_e(self, key, tidx: int, shard: int, data: bytes) -> np.ndarray:
        t = self.groups[key].tensors[tidx]
        if self.faults is not None:
            data = self.faults.decode(data)
        return np.frombuffer(
            self.codec.decompress(data, t.e_raw_sizes[shard]), np.uint8)

    def decompress_e_into(self, key, tidx: int, shard: int, data: bytes,
                          out: np.ndarray) -> int:
        """Decompress one E-shard directly into the tensor's preallocated
        exponent plane `out` (u8, length n_elems) at its shard offset —
        the zero-copy shard-assembly path (no per-shard array, no
        full-plane concatenate).  Returns bytes written."""
        t = self.groups[key].tensors[tidx]
        if self.faults is not None:
            data = self.faults.decode(data)
        off = sum(t.e_raw_sizes[:shard])
        n = t.e_raw_sizes[shard]
        got = self.codec.decompress_into(
            data, memoryview(out)[off:off + n], n)
        if got != n:
            raise ValueError(
                f"decompressed length mismatch for {key} t{tidx} s{shard}: "
                f"{got} != {n}")
        return n

    # -- convenience full loads --------------------------------------------
    def load_tensor(self, key, tidx: int) -> np.ndarray:
        """One tensor's bf16 bits (uint16 ndarray of its shape)."""
        g = self.groups[key]
        t = g.tensors[tidx]
        crcs = {t.sm_offset: t.sm_crc}
        for off, c in zip(t.e_offsets,
                          t.e_crcs or [None] * len(t.e_offsets)):
            crcs[off] = c
        return unpack_tensor(
            lambda o, s: self._read_chunk(g.file, o, s, crcs.get(o)),
            t, self.codec)

    def load_group(self, key) -> Dict[str, np.ndarray]:
        g = self.groups[key]
        return {t.name: self.load_tensor(key, i) for i, t in enumerate(g.tensors)}

    def load_group_raw(self, key) -> bytes:
        """Full-tensor-equivalent read (what the no-compression baselines pay):
        reads sm+e and returns reconstructed bytes."""
        return b"".join(np.ascontiguousarray(v).tobytes()
                        for v in self.load_group(key).values())

    # -- stats ---------------------------------------------------------------
    def fault_summary(self) -> Dict[str, int]:
        """Integrity/recovery counters for the serving-level telemetry."""
        with self._fd_lock:
            return {
                "verify": int(self.verify),
                "read_retries": self.read_retries,
                "checksum_failures": self.checksum_failures,
                "short_reads": self.short_reads,
                "fd_reopens": self.fd_reopens,
                "quarantined": len(self.quarantined),
            }

    def ratio(self) -> float:
        """store bytes / original bf16 bytes (the paper's Fig. 3 number)."""
        tot_store = sum(g.sm_bytes + g.e_bytes for g in self.groups.values())
        tot_full = sum(g.full_bytes for g in self.groups.values())
        return tot_store / max(1, tot_full)

    def rho(self) -> float:
        """compressed exponent bytes / raw exponent bytes (the scheduler's ρ)."""
        e = sum(g.e_bytes for g in self.groups.values())
        raw = sum(g.e_raw_bytes for g in self.groups.values())
        return e / max(1, raw)

    def layer_rho(self, layer: int) -> float:
        """One layer's compressed/raw exponent ratio — entropy varies per
        layer, so the per-layer scheduler costs and PlanConsts use the
        layer's own ρ instead of the store-wide average.  Falls back to the
        global ρ for layers with no expert groups."""
        gs = [g for g in self.groups.values() if g.layer == layer]
        if not gs:
            return self.rho()
        return sum(g.e_bytes for g in gs) / max(1, sum(g.e_raw_bytes
                                                       for g in gs))
