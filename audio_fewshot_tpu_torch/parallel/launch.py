"""Start the ranks of a run on one host: the entry points' ``--nproc N``,
one process a card, as the reference's ``mp.spawn`` did (``torchrun
--nproc_per_node N`` starts them instead, and then nothing here runs).

``spawn(fn, n, args)`` runs ``fn(rank, init_method, *args)`` in ``n`` fresh
processes (the ``spawn`` start method: no CUDA state is inherited), with
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set as torchrun sets them, and
waits for all of them; any rank's failure, or the time limit, ends the
others and raises.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Any, Callable, Optional, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _entry(index: int, fn: Callable, nproc: int, init_method: str, args: Sequence[Any],
           threads: Optional[int]) -> None:
    os.environ.update({"RANK": str(index), "WORLD_SIZE": str(nproc),
                       "LOCAL_RANK": str(index)})
    if threads:
        import torch

        torch.set_num_threads(threads)
    fn(index, init_method, *args)


def spawn(fn: Callable, nproc: int, args: Sequence[Any] = (), *,
          init_method: Optional[str] = None, timeout: Optional[float] = None,
          threads: Optional[int] = None) -> None:
    """Run ``fn(rank, init_method, *args)`` on ``nproc`` ranks and wait.

    ``init_method``: the rendezvous (default ``tcp://127.0.0.1:<free
    port>``; a ``file://`` path needs no port).  ``timeout``: seconds until
    every rank is ended and ``TimeoutError`` raised (None: no limit).
    ``threads``: torch's CPU threads in each rank."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_entry, args=(fn, nproc, init_method, tuple(args), threads),
                             nprocs=nproc, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nproc} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish within {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
