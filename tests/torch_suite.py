"""What every test process of the port shares, loaded by each
``tests/test_torch_*.py`` as ``pytest_plugins = ["torch_suite"]`` and
imported by ``tests/torch_ranks.py``:

- one intra-op thread.  ``OMP_NUM_THREADS`` is set for the processes a
  test spawns (rank processes, the multihost launchers), which inherit
  it, and ``torch.set_num_threads(1)`` for this one.  The port's CPU
  tensors are small, and several xdist workers with a thread per CPU each
  oversubscribe the machine many times over.  It is also a numerics
  condition: a one-process run compared bitwise with rank processes needs
  the ranks' thread count.  This is the only place a test sets threads;
  :func:`threads` changes the count for a test of that count.
- a time limit for each phase (setup, call, teardown) of a test in such
  a module: past ``TIME_LIMIT_S`` the phase fails under the test's own
  name, so that a hung test does not take the whole run to its limit.

It holds no asserts, and is imported before pytest registers it:
PYTEST_DONT_REWRITE.
"""
import contextlib
import os
import signal
import time

os.environ["OMP_NUM_THREADS"] = "1"

import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

# The slowest test, a ResNet-50 comparison with lbt_tpu, takes 310-380 s
# on 8 CPUs under the suite's 6 workers; the suite's own limit is 1,470 s.
TIME_LIMIT_S = 1200


@contextlib.contextmanager
def threads(n: int):
    """``n`` intra-op threads inside the block, one again after it."""
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(1)


def _ours(item) -> bool:
    return __name__ in getattr(getattr(item, "module", None),
                               "pytest_plugins", ())


def _limited(item, phase):
    """Run one phase of ``item`` under ``TIME_LIMIT_S``; an outer timer
    and handler (a session run inside a test) are put back after it."""
    if not _ours(item):
        return (yield)

    def expired(signum, frame):
        pytest.fail(f"{item.nodeid} ({phase}) ran past its time limit of "
                    f"{TIME_LIMIT_S} s")

    outer = signal.signal(signal.SIGALRM, expired)
    left, _ = signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    t0 = time.monotonic()
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer)
        if left:
            signal.setitimer(signal.ITIMER_REAL,
                             max(left - (time.monotonic() - t0), 1e-3))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item, "teardown"))
