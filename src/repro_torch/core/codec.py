"""Lossless compression backends (§2.2 / §4).

The paper integrates *lz4* and *zstd*.  Offline here, ``zstandard`` is
available and is the paper's best-ratio codec; ``zlib`` (level 9) stands in
for LZ4HC (same general-LZ family; see DESIGN.md §7).  ``raw`` is the
identity codec used by baselines and ablations.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict

try:
    import zstandard as zstd
    _HAVE_ZSTD = True
except ImportError:  # pragma: no cover
    _HAVE_ZSTD = False


class CodecError(ValueError):
    """Decompression failed — corrupt or truncated payload.  Backends
    normalize their library-specific errors (``zlib.error``,
    ``zstd.ZstdError``) to this so the engine's retry/fallback path can
    tell recoverable data corruption apart from programming errors."""


class Codec:
    name: str = "raw"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes, size: int) -> bytes:
        return data

    def decompress_into(self, data: bytes, out, size: int) -> int:
        """Decompress `data` directly into the writable buffer `out`
        (length >= `size`); returns bytes written.  Lets the engine write
        E-shards straight into a preallocated exponent plane at their shard
        offsets instead of materialising per-shard arrays and
        ``np.concatenate``-ing a full plane.  The base implementation
        decompresses then copies — zstd overrides with a true into-buffer
        stream read; zlib/raw keep the one copy."""
        buf = self.decompress(data, size)
        n = len(buf)
        out[:n] = buf
        return n


class ZlibCodec(Codec):
    """LZ4HC stand-in (offline container has no lz4 wheel)."""
    name = "zlib"

    def __init__(self, level: int = 9):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes, size: int) -> bytes:
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise CodecError(f"zlib: {e}") from e


class ZstdCodec(Codec):
    """(de)compressor objects are NOT thread-safe -> keep them thread-local
    (the engine decompresses concurrently from L worker threads)."""
    name = "zstd"

    def __init__(self, level: int = 10):
        import threading
        self.level = level
        self._tl = threading.local()

    def _ctx(self):
        if not hasattr(self._tl, "c"):
            self._tl.c = zstd.ZstdCompressor(level=self.level)
            self._tl.d = zstd.ZstdDecompressor()
        return self._tl

    def compress(self, data: bytes) -> bytes:
        return self._ctx().c.compress(data)

    def decompress(self, data: bytes, size: int) -> bytes:
        try:
            return self._ctx().d.decompress(data, max_output_size=size)
        except zstd.ZstdError as e:
            raise CodecError(f"zstd: {e}") from e

    def decompress_into(self, data: bytes, out, size: int) -> int:
        """Stream-read the frame straight into `out` (no intermediate
        bytes object): zstd's reader supports ``readinto`` on any writable
        buffer, so the engine's preallocated exponent plane is filled
        in place.  A frame larger than `size` raises — the plain
        ``decompress(max_output_size=size)`` path errors on oversized
        frames, and silent truncation here would hand the recovery a
        corrupt exponent plane."""
        import io
        mv = memoryview(out)
        n = 0
        try:
            with self._ctx().d.stream_reader(io.BytesIO(data)) as r:
                while n < size:
                    got = r.readinto(mv[n:size])
                    if not got:
                        break
                    n += got
                if n == size and r.read(1):
                    raise CodecError(
                        f"zstd frame decompresses past the expected "
                        f"{size} bytes")
        except zstd.ZstdError as e:
            raise CodecError(f"zstd: {e}") from e
        return n


_REGISTRY: Dict[str, Callable[[], Codec]] = {
    "raw": Codec,
    "zlib": ZlibCodec,
}
if _HAVE_ZSTD:
    _REGISTRY["zstd"] = ZstdCodec

DEFAULT_CODEC = "zstd" if _HAVE_ZSTD else "zlib"


def get_codec(name: str = None) -> Codec:
    name = name or DEFAULT_CODEC
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def compression_ratio(codec: Codec, data: bytes) -> float:
    """compressed/original size (the paper's ρ is measured on exponent bytes)."""
    if not data:
        return 1.0
    return len(codec.compress(data)) / len(data)
