"""A rank that hangs fails ``spawn``'s wait at its limit, and is ended.

Of two ``gloo`` ranks, rank 1 sleeps for far longer than a limit of a few
seconds. The wait must fail soon after the limit, name the case and the
ranks still running, and leave no rank's process alive.
"""

import multiprocessing
import os
import time

import pytest

from ctrlv_tpu_torch.parallel.launch import spawn

LIMIT_S = 3


def hang(rank, nproc, out):
    with open(os.path.join(out, f"rank{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if rank == 1:
        time.sleep(60)


def test_a_hung_rank_fails_at_the_limit_and_is_ended(tmp_path):
    before = set(multiprocessing.active_children())
    start = time.monotonic()
    with pytest.raises(TimeoutError, match=r"^hang: ranks \[(0, )?1\] of 2 still running"):
        spawn(hang, 2, "cpu", (str(tmp_path),), store_dir=str(tmp_path), timeout=LIMIT_S)
    assert time.monotonic() - start < 20
    assert set(multiprocessing.active_children()) <= before
    for name in os.listdir(tmp_path):  # the ranks that got as far as writing their pid
        with open(tmp_path / name) as f:
            pid = int(f.read())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
