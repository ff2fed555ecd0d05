"""Where the port's entry points run: the card unless the caller says so."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none — an
    entry point never falls back to the CPU on its own.  Pass ``"cpu"``
    (as the tests do) to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def resolve_peer_devices(mesh_devices: int, peer_devices=None):
    """The devices of a ``mesh_devices``-wide peer tier ('ep' axis), device
    0 the compute device.  ``None`` means the cards ``cuda:0`` ..
    ``cuda:N-1`` and raises when fewer are visible — never a quiet fallback
    to fewer devices or to the CPU.  An explicit list (``["cpu"] * 4`` on
    the CPU, ``["cuda:0"] * 4`` to stand four rows on one card) must have
    ``mesh_devices`` entries."""
    n = int(mesh_devices)
    if peer_devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            names = [torch.cuda.get_device_name(i) for i in range(found)]
            raise RuntimeError(
                f"mesh_devices={n} needs {n} CUDA devices but {found} are "
                f"visible ({', '.join(names) or 'none'}); pass peer_devices "
                f"(e.g. ['cuda:0'] * {n}, or ['cpu'] * {n} on the CPU)")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [resolve_device(d) for d in peer_devices]
    if len(devs) != n:
        raise ValueError(f"mesh_devices={n} but {len(devs)} peer_devices "
                         f"{[str(d) for d in devs]}")
    return devs
