"""CPU threads of the port's tests under pytest-xdist.

Each xdist worker is a process whose torch takes every core for its
intra-op threads by default, so 6 workers on 8 cores run 48 threads that
wait on one another: the port's tests then take about 2.5x the CPU time
they take with one thread per worker. Every ``test_torch_*`` module calls
``share_cores_with_xdist_workers`` at import; outside xdist it does
nothing.
"""
import os

import torch


def usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def share_cores_with_xdist_workers():
    """Under xdist (``PYTEST_XDIST_WORKER_COUNT`` > 1), torch's intra-op
    threads in this worker: an equal share of the usable cores, at least
    one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    if workers > 1:
        torch.set_num_threads(max(1, usable_cores() // workers))


def test_xdist_workers_share_the_cores(monkeypatch):
    before = torch.get_num_threads()
    try:
        for workers, want in ((6, max(1, usable_cores() // 6)),
                              (2, max(1, usable_cores() // 2)),
                              (10 * usable_cores(), 1)):
            monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
            share_cores_with_xdist_workers()
            assert torch.get_num_threads() == want
        # one worker, or no xdist: torch keeps what it has
        torch.set_num_threads(3)
        for value in ("1", None):
            if value is None:
                monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT",
                                   raising=False)
            else:
                monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", value)
            share_cores_with_xdist_workers()
            assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
