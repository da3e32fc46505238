"""The port's test modules' share of the machine.

The tier-1 run has several workers on one machine, and its long pole is
one reference file (``tests/test_fuzz_scenarios.py``: ~11 minutes alone,
on ~1.8 cores) on one of them.  While a port module runs, its worker
takes less of the machine:

* torch on one intra-op thread: for the port's small tensors more buys
  nothing, and idle threads spinning take cores from the other workers;
* every thread of the worker (XLA's pool for the live reference runs,
  torch's, the BLAS's; and the processes a test starts) on all but two
  of the cores it may use, which stay free for the reference's workers,
  and at a lower scheduling priority (nice 10), so that where the cores
  are contended the reference's workers run first.

All three are restored after the module (the priority only where the
process may raise it again, as root may).  A module imports the fixture::

    from _port_share import port_share  # noqa: F401

A test whose numbers depend on torch's thread count (a chaotic stack's
rounding) asks for ``default_torch_threads``: the process's own count,
as it was written for.
"""
import os

import pytest
import torch

_DEFAULT_THREADS = torch.get_num_threads()  # before any test changed it
_FREE_CORES = 2
_NICE = 10


def _threads() -> list:
    return [int(t) for t in os.listdir("/proc/self/task")]


def _bind(cores, nice) -> None:
    """Every thread of this process on ``cores`` (and at ``nice``, unless
    None)."""
    for tid in _threads():
        try:
            os.sched_setaffinity(tid, cores)
            if nice is not None:
                os.setpriority(os.PRIO_PROCESS, tid, nice)
        except OSError:  # the thread ended meanwhile
            pass


@pytest.fixture(scope="module", autouse=True)
def port_share():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    bound = len(cores) > _FREE_CORES + 1 and os.path.isdir("/proc/self/task")
    nice = os.getpriority(os.PRIO_PROCESS, 0) if os.geteuid() == 0 else None
    if bound:
        _bind(cores[:-_FREE_CORES], None if nice is None
              else max(nice, _NICE))
    yield
    if bound:
        _bind(cores, nice)
    torch.set_num_threads(n)


@pytest.fixture
def default_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(_DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)
