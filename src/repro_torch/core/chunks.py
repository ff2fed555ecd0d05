"""E-chunk / SM-chunk containers and binary serialization (§3.1 step ❷).

Layout on disk (one ``.bin`` per expert group, mirroring per-expert SSD reads):

    [tensor_0 SM bytes][tensor_0 E-chunk 0]..[tensor_0 E-chunk K-1]
    [tensor_1 SM bytes] ...

The manifest (JSON) records offsets/sizes so readers can issue exact-range
reads per chunk — the unit of the scheduler's I/O operations.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import bitfield
from repro_torch.core.codec import Codec

# Manifest format versions:
#   1 — original layout (no checksums); still readable, verification off.
#   2 — adds per-chunk CRCs (sm_crc + e_crcs per tensor) and the "crc_algo"
#       field.  stdlib zlib.crc32 stands in for crc32c (no new deps; same
#       error-detection class), mirroring zlib-for-LZ4HC in core/codec.py.
MANIFEST_VERSION = 2
CRC_ALGO = "crc32"


def chunk_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


@dataclass
class TensorMeta:
    name: str
    shape: Tuple[int, ...]
    n_elems: int
    sm_offset: int
    sm_size: int                     # == n_elems (1 byte/elem)
    e_offsets: List[int]
    e_sizes: List[int]               # compressed sizes
    e_raw_sizes: List[int]           # decompressed sizes (shard lengths)
    # v2: per-chunk checksums over the on-disk bytes (None in v1 manifests)
    sm_crc: Optional[int] = None
    e_crcs: Optional[List[int]] = None

    def to_json(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d):
        d = dict(d)
        d["shape"] = tuple(d["shape"])
        return TensorMeta(**d)


@dataclass
class GroupMeta:
    layer: int
    expert: int
    file: str
    tensors: List[TensorMeta]

    @property
    def key(self) -> Tuple[int, int]:
        return (self.layer, self.expert)

    @property
    def sm_bytes(self) -> int:
        return sum(t.sm_size for t in self.tensors)

    @property
    def e_bytes(self) -> int:         # compressed
        return sum(sum(t.e_sizes) for t in self.tensors)

    @property
    def e_raw_bytes(self) -> int:
        return sum(sum(t.e_raw_sizes) for t in self.tensors)

    @property
    def full_bytes(self) -> int:      # reconstructed bf16
        return sum(2 * t.n_elems for t in self.tensors)

    def to_json(self):
        return {"layer": self.layer, "expert": self.expert, "file": self.file,
                "tensors": [t.to_json() for t in self.tensors]}

    @staticmethod
    def from_json(d):
        return GroupMeta(d["layer"], d["expert"], d["file"],
                         [TensorMeta.from_json(t) for t in d["tensors"]])


def pack_group(planes: Dict[str, Tuple[np.ndarray, np.ndarray,
                                       Tuple[int, ...]]],
               k_shards: int, compress_all
               ) -> Tuple[bytes, List[TensorMeta]]:
    """Compress one expert group already split into bit-planes:
    ``{name: (exp u8, sm u8, shape)}`` in tensor order.  Returns
    (blob, metas).  ``compress_all`` maps the list of every E-shard's raw
    bytes (tensor, then shard order) to their compressed bytes in the
    same order (``build_store`` compresses them on a thread pool)."""
    shards = {name: bitfield.shard_plane(exp, k_shards)
              for name, (exp, _, _) in planes.items()}
    raw = [shard.tobytes() for name in planes for shard in shards[name]]
    comps = iter(compress_all(raw))
    blob = bytearray()
    metas: List[TensorMeta] = []
    for name, (exp, sm, shape) in planes.items():
        sm_off = len(blob)
        blob += sm.tobytes()
        e_offs, e_sizes, e_raw, e_crcs = [], [], [], []
        for shard in shards[name]:
            comp = next(comps)
            e_offs.append(len(blob))
            blob += comp
            e_sizes.append(len(comp))
            e_raw.append(shard.size)
            e_crcs.append(chunk_crc(comp))
        metas.append(TensorMeta(
            name=name, shape=tuple(shape), n_elems=int(exp.size),
            sm_offset=sm_off, sm_size=int(sm.size),
            e_offsets=e_offs, e_sizes=e_sizes, e_raw_sizes=e_raw,
            sm_crc=chunk_crc(bytes(blob[sm_off:sm_off + sm.size])),
            e_crcs=e_crcs))
    return bytes(blob), metas


def unpack_tensor(blob_reader, meta: TensorMeta, codec: Codec) -> np.ndarray:
    """Full read+decompress+reconstruct of one tensor (bypass path): the
    tensor's bf16 bits as a uint16 ndarray."""
    sm = np.frombuffer(blob_reader(meta.sm_offset, meta.sm_size), np.uint8)
    shards = []
    for off, size, raw in zip(meta.e_offsets, meta.e_sizes, meta.e_raw_sizes):
        shards.append(np.frombuffer(
            codec.decompress(blob_reader(off, size), raw), np.uint8))
    exp = np.concatenate(shards)
    return bitfield.reconstruct_np(exp, sm, meta.shape)


def manifest_to_json(groups: List[GroupMeta], codec_name: str, k_shards: int,
                     extra: dict = None) -> str:
    return json.dumps({
        "version": MANIFEST_VERSION, "crc_algo": CRC_ALGO,
        "codec": codec_name, "k_shards": k_shards,
        "extra": extra or {},
        "groups": [g.to_json() for g in groups],
    })


def manifest_from_json(s: str):
    d = json.loads(s)
    version = d.get("version", 1)        # pre-checksum manifests carry none
    if version > MANIFEST_VERSION:
        raise ValueError(
            f"manifest format version {version} is newer than supported "
            f"({MANIFEST_VERSION}); rebuild the store or upgrade")
    if version >= 2 and d.get("crc_algo", CRC_ALGO) != CRC_ALGO:
        raise ValueError(f"unsupported manifest crc_algo "
                         f"{d.get('crc_algo')!r} (expected {CRC_ALGO!r})")
    return (d["codec"], d["k_shards"], d.get("extra", {}),
            [GroupMeta.from_json(g) for g in d["groups"]])
