"""Fault-tolerant checkpointing: atomic writes, retention, an async
writer — the JAX package's ``training/checkpoint.py`` for trees of torch
tensors, with the same files on disk, so either package restores what
the other saved.

Layout:  ``<dir>/step_<n:010d>/`` with one ``leaf_<i:06d>.npy`` per leaf
(i counts every leaf of the flattened tree, None ones included: dicts in
insertion order, lists, tuples and NamedTuples by index), a
``manifest.json`` (``{"step", "names": {path: {"file", "dtype"} or null},
"extra", "time"}``) and a ``DONE`` marker.  bf16 is stored as its uint16
bit pattern with ``"dtype": "bfloat16"``.  Writes go to ``step_<n>.tmp``,
renamed only after ``DONE`` is written, so a crash mid-write never
corrupts the restore path (restore picks the newest directory with
``DONE``).

The async writer copies every leaf to the host before its thread starts,
so the caller may update the tensors at once; a failed write surfaces at
the next ``wait()`` or ``save()``.  ``restore(..., device=)`` places the
leaves on a device: the one-device counterpart of the JAX package's
re-mesh on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is None:
            flat["/".join(path) + "@none"] = None
        else:
            flat["/".join(path)] = node
    walk(tree, ())
    return flat


def _unflatten(flat: Dict[str, Any], template) -> Any:
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
            return type(node)(*(walk(v, path + (str(i),))
                                for i, v in enumerate(node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return flat["/".join(path)]
    return walk(template, ())


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf on any device; bf16
    as its uint16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """One stored leaf as a tensor on `device`; bf16 rebuilt from its bits
    through an int16 view."""
    arr = np.require(arr, requirements="C")     # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        # every leaf on the host first: the caller may update the tensors
        # as soon as this returns
        host = {k: (None if v is None else _to_host(v))
                for k, v in _flatten(tree).items()}
        if self.async_write:
            self.wait()

            def write():
                try:
                    self._write(step, host, extra)
                except Exception as exc:
                    # surfaced at the next wait()/save() — an async write
                    # failure must not be a silently missing checkpoint
                    self._error = exc

            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from exc

    def _write(self, step: int, host: Dict[str, Any], extra: Optional[dict]):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        names = {}
        for i, (key, val) in enumerate(host.items()):
            if val is None:
                names[key] = None
                continue
            fn = f"leaf_{i:06d}.npy"
            arr, dt = val
            np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
            names[key] = {"file": fn, "dtype": dt}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "names": names, "extra": extra or {},
                       "time": time.time()}, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "DONE")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None,
                device=None) -> tuple:
        """Returns (tree, step, extra): `template`'s structure with torch
        tensors on `device` (the CPU when None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dev = torch.device("cpu") if device is None else torch.device(device)
        flat = {}
        for key, ent in manifest["names"].items():
            if ent is None:
                flat[key] = None
                continue
            arr = np.load(os.path.join(d, ent["file"]))
            flat[key] = _from_file(arr, ent["dtype"], dev)
        tree = _unflatten(flat, template)
        return tree, step, manifest.get("extra", {})
