"""Start a function in several processes joined in one process group.

What ``torchrun`` does for a command, for a function: ``spawn(fn, nproc,
device, args)`` starts ``nproc`` processes by ``spawn`` (a fork would share
the parent's threads and its CUDA state), each joins the group through a
``file://`` rendezvous under ``store_dir`` (no port to clash with another
run's) and calls ``fn(rank, nproc, *args)``. The card's ranks take ``nccl``
on ``cuda:rank``; ``device="cpu"`` takes ``gloo`` with one thread a rank. A
rank that raises makes ``spawn`` raise; the group is destroyed on each
rank's way out. With a ``timeout``, ranks still running when it passes are
ended and ``spawn`` raises ``TimeoutError``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist


def _run(rank: int, fn, nproc: int, device: str, init_file: str, args: tuple) -> None:
    cpu = torch.device(device).type == "cpu"
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=nproc)
    try:
        fn(rank, nproc, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nproc: int, device: str = "cuda", args: tuple = (), store_dir=None,
          timeout: float | None = None) -> None:
    """Run ``fn(rank, nproc, *args)`` on ``nproc`` ranks and wait for all of
    them, or for ``timeout`` seconds: then the ranks still running are ended
    and ``TimeoutError`` names ``fn`` and them. ``fn`` must be importable by
    name (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ranks = mp.start_processes(_run, args=(fn, nproc, device, init_file, args), nprocs=nproc,
                                   start_method="spawn", join=False)
        end = None if timeout is None else time.monotonic() + timeout
        while not ranks.join(None if end is None else max(end - time.monotonic(), 0.0)):
            if end is not None and time.monotonic() >= end:
                alive = [r for r, p in enumerate(ranks.processes) if p.is_alive()]
                for p in ranks.processes:  # SIGKILL: a hung rank may sit in C, deaf to SIGTERM
                    p.kill()
                for p in ranks.processes:
                    p.join()
                raise TimeoutError(f"{fn.__name__}: ranks {alive} of {nproc} still running "
                                   f"after {timeout} s, ended")
