"""Build and load the port's CUDA kernels (``kernels/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, from the sources in this package only, with one ``nvcc`` per
``.cu`` file started together and a final link.  The library lands in a
directory keyed by a hash of the sources (``build/kernels/<hash>/`` at the
root of the checkout, which ``.gitignore`` lists), so an edit rebuilds and
an unchanged tree reuses the library.

Each kernel wrapper counts its launches in :data:`LAUNCHES` through
:func:`count_launch` (one per kernel launch, nowhere else), so a run can show
the main path went through the kernels.  The wrappers run on the decode
thread and, with ``device_recovery``, on the engine's I/O and decompression
workers at once, so the count is taken under a lock of its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"splice": 0, "splice_admit": 0, "slab_gemm": 0,
                            "grouped_gemm": 0, "zip_gemm_grouped": 0,
                            "zip_gemm": 0}

_lock = threading.Lock()          # the build
_count_lock = threading.Lock()    # LAUNCHES: never waits on nvcc
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def count_launch(name: str) -> None:
    """Add one launch of kernel `name` to :data:`LAUNCHES`."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _compile(out_dir: Path) -> Path:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    srcs = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in srcs:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    lib = out_dir / "libzipmoe_kernels.so"
    tmp = out_dir / f"libzipmoe_kernels.{tag}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    BUILD_INFO["ptxas"] = "\n".join(logs)
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.zipmoe_splice.argtypes = [vp, vp, vp, ll, vp]
    lib.zipmoe_splice_admit.argtypes = [vp, i, ll, vp, vp, vp]
    split = [vp, i, i, vp, vp]          # bounds, slices, spread, scratch
    lib.zipmoe_slab_gemm.argtypes = [vp, vp, vp, vp, i, i, i, ll, *split,
                                     vp]
    lib.zipmoe_grouped_gemm.argtypes = [vp, vp, vp, i, i, i, i, *split, vp]
    lib.zipmoe_zip_gemm_grouped.argtypes = [vp, vp, vp, vp, i, i, i, i,
                                            *split, vp]
    lib.zipmoe_zip_gemm.argtypes = [vp, vp, vp, vp, i, i, i, *split, vp]
    for fn in (lib.zipmoe_splice, lib.zipmoe_splice_admit,
               lib.zipmoe_slab_gemm, lib.zipmoe_grouped_gemm,
               lib.zipmoe_zip_gemm_grouped, lib.zipmoe_zip_gemm):
        fn.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            out_dir = BUILD_ROOT / _source_hash()
            lib = out_dir / "libzipmoe_kernels.so"
            built = False
            if not lib.exists():
                out_dir.mkdir(parents=True, exist_ok=True)
                lib = _compile(out_dir)
                built = True
            _lib = _declare(ctypes.CDLL(str(lib)))
            BUILD_INFO.update(path=str(lib), built=built,
                              seconds=time.perf_counter() - t0)
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def require_cuda(t, dtype, name: str, device=None) -> None:
    """Validate one kernel operand: a contiguous CUDA tensor of `dtype`
    (on `device` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
