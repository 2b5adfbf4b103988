"""Start the ranks of a ``torch.distributed`` job on one machine and
collect what each returns.

    results = spawn(fn, world_size, args, workdir=..., transport="host")

runs ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
(``spawn``, never ``fork``), each in a process group of the transport's
backend (``comm.p2p.BACKENDS``) that meets at a ``FileStore`` in
``workdir``.  Each rank's return value comes back through a file in
``workdir``; it must be made of tensors, numbers, strings, lists and
dicts.  A rank that raises fails the call (the others are stopped) with
every failed rank's traceback, the first to fail first, and so does a
job that outlives ``timeout`` seconds: nothing hangs.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..comm.p2p import BACKENDS


def init_group(rank: int, world_size: int, transport: str, init_method: str,
               timeout: float) -> None:
    """Join the default process group of ``transport``'s backend."""
    dist.init_process_group(BACKENDS[transport], init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def _entry(rank, fn, world_size, transport, workdir, args, timeout, threads):
    if threads:
        torch.set_num_threads(threads)
    if transport == "device":
        torch.cuda.set_device(rank)
    init_group(rank, world_size, transport,
               "file://" + os.path.join(workdir, "store"), timeout)
    try:
        out = fn(rank, world_size, *args)
        path = os.path.join(workdir, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        # written before this rank leaves the group, so before a peer
        # fails for want of it
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
          workdir: str, transport: str = "host", timeout: float = 600.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn`` on ``world_size`` ranks; returns their results in rank
    order.  ``fn`` must be importable by name (a module-level function).
    ``threads`` sets ``torch.set_num_threads`` in every rank."""
    workdir = os.path.abspath(workdir)   # a file:// store needs an absolute path
    os.makedirs(workdir, exist_ok=True)
    for name in ["store"] + [f"rank{r}.{ext}" for r in range(world_size)
                             for ext in ("pt", "err")]:
        path = os.path.join(workdir, name)
        if os.path.exists(path):
            os.remove(path)
    ctx = mp.start_processes(
        _entry, args=(fn, world_size, transport, workdir, tuple(args), timeout,
                      threads),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} still "
                                   f"running after {timeout:.0f} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errs = _rank_errors(workdir, world_size)
        if not errs:
            raise
        raise RuntimeError(f"{fn.__name__} failed on rank(s) "
                           f"{', '.join(str(r) for r, _ in errs)}:\n"
                           + "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in errs)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
            for r in range(world_size)]


def _rank_errors(workdir: str, world_size: int) -> List[Tuple[int, str]]:
    """The tracebacks the failed ranks wrote, the first to fail first."""
    found = []
    for r in range(world_size):
        path = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                found.append((os.path.getmtime(path), r, f.read()))
    return [(r, tb) for _, r, tb in sorted(found)]
