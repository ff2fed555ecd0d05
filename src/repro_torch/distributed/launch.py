"""Run one function as the N ranks of a ``torch.distributed`` process group.

The port's multi-rank code (sequence-sharded decode, the pipeline, the
re-meshed restore) takes an explicit ``DeviceMesh`` or process group, so
it runs the same whatever the ranks are: N processes on the CPU over
``gloo``, or N processes that share one card over ``gloo`` with CUDA
tensors (NCCL refuses two ranks on one GPU).

:func:`spawn_ranks` starts the processes with ``spawn`` (a parent that has
initialised CUDA cannot fork), joins them through a ``FileStore`` in a
fresh temporary directory (no fixed port, so runs side by side do not
collide) and waits for all of them under one deadline.  A rank that
raises, dies or outlives the deadline makes the call raise, after every
rank is stopped; nothing falls back to fewer ranks.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence


def _rank_main(fn, rank: int, world: int, backend: str, store_path: str,
               timeout_s: float, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout_s))
        out = fn(rank, world, *args)
    except BaseException:
        # reported before the group goes down, which fails the peers
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


# how long the others may take to report once a rank has failed (a peer
# blocked in a collective fails as soon as the failed rank's group closes)
_GRACE_S = 5.0


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]     # started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn_ranks(fn: Callable[..., Any], world: int, *, backend: str = "gloo",
                timeout_s: float = 300.0, args: Sequence = (),
                store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in `world` spawned processes that form
    the default process group (`backend`), and return each rank's result
    in rank order.

    `fn` must be importable by name (a module-level function); `args` and
    the results cross by pickling, so return numpy arrays or plain values
    rather than tensors.  Raises ``RuntimeError`` when a rank raises or
    exits without reporting, and ``TimeoutError`` when the ranks are not
    all done within `timeout_s` seconds (the process group's own timeout
    too).  The ``FileStore`` lives in a fresh directory under `store_dir`
    (the system's temporary directory when None), removed on return."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, failed = {}, {}
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, store, timeout_s,
                                   tuple(args), results), daemon=True)
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            grace = None        # after a failure: until the peers report
            while len(out) + len(failed) < world:
                now = time.monotonic()
                if grace is not None and now > grace:
                    break
                if now > deadline:
                    raise TimeoutError(
                        f"{world - len(out)} of {world} ranks not done "
                        f"after {timeout_s} s")
                try:
                    rank, ok, val = results.get(timeout=0.5)
                except queue.Empty:
                    # a rank that died without reporting: a report of its
                    # would be in the pipe before its exit code was set
                    if grace is None and results.empty() and any(
                            p.exitcode is not None and r not in out
                            and r not in failed
                            for r, p in enumerate(procs)):
                        grace = time.monotonic() + _GRACE_S
                    continue
                if ok:
                    out[rank] = val
                else:
                    failed[rank] = val
                    if grace is None:
                        grace = time.monotonic() + _GRACE_S
            silent = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode is not None and r not in out
                      and r not in failed]
            if failed or silent:
                raise RuntimeError("".join(
                    [f"ranks exited without a result (rank, exit code): "
                     f"{silent}\n" if silent else ""]
                    + [f"rank {r} of {world} failed:\n{tb}"
                       for r, tb in sorted(failed.items())]))
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks' exit codes: {codes}")
        finally:
            _stop(procs)
            results.close()
            results.join_thread()
    return [out[r] for r in range(world)]
