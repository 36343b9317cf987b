"""torch's intra-op threads for the port's CPU tests.

torch starts one intra-op thread per core in every process, so the
pytest-xdist workers that run ``tests/`` together (six on eight cores)
would each take every core for torch's kernels and oversubscribe them
several times over. Each ``tests/test_torch_*.py`` module calls
``share_cores`` when it is imported.
"""

import os

import torch


def share_cores():
    """Give torch this process's share of the cores it may run on: all of
    them in a plain run, ``cores // workers`` (at least one) in each of
    ``PYTEST_XDIST_WORKER_COUNT`` workers."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, cores // workers))
