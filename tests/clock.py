# The per-test clock of the test suite: every test phase (setup, call,
# teardown) runs on a clock of TEST_LIMIT_S seconds. Past it, every
# thread's stack is printed and the phase fails, so a hung test fails on
# its own instead of holding its worker until the whole run's time limit.
# The repository's conftest.py registers Clock(TEST_LIMIT_S).

import contextlib
import faulthandler
import signal
import sys

import pytest

# About twice the slowest phase measured: tests/test_mesh.py's
# test_m11_refined_mesh_end_to_end, 270-280 s alone on an 8-core CPU and
# 238-325 s in runs of the whole suite in six xdist workers.
TEST_LIMIT_S = 660
# A child process a test starts must end within this many seconds, so that
# a stuck child fails its test before the test's own clock runs out.
CHILD_LIMIT_S = TEST_LIMIT_S - 60


class Clock:
    """Fails a test phase that runs past ``limit_s`` seconds.

    At the limit SIGALRM prints every thread's stack (into the phase's
    captured stderr) and raises pytest's Failed in the main thread, where
    xdist runs the tests, with the interrupted frame in its traceback.
    Code stuck in C never returns to that handler: faulthandler's own
    timer prints the stacks STUCK_S seconds later, and the child
    processes' timeouts end the wait."""

    STUCK_S = 10

    def __init__(self, limit_s):
        self.limit_s = limit_s

    def _expired(self, signum, frame):
        faulthandler.dump_traceback(sys.stderr)
        pytest.fail(f"test phase ran past its {self.limit_s} s limit")

    @contextlib.contextmanager
    def _running(self):
        faulthandler.dump_traceback_later(self.limit_s + self.STUCK_S)
        saved = signal.signal(signal.SIGALRM, self._expired)
        signal.setitimer(signal.ITIMER_REAL, self.limit_s)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, saved)
            faulthandler.cancel_dump_traceback_later()

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        with self._running():
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        with self._running():
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        with self._running():
            return (yield)
