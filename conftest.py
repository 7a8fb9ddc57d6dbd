"""Test harness rules for every test under the repository root: a time limit
on each test's call, and serial dispatch for the tests that run eager
multi-device TPU-interpret programs. Run pytest from the repository root so
that this file is loaded.

tests/conftest.py turns on JAX's persistent compile cache. An eager
(un-jitted) multi-device TPU-interpret op runs io_callbacks that dispatch
work to cpu:0, and an eager op dispatched while those callbacks are pending
deadlocks the process. A cache hit makes the next op ready at once and so
loses that race nearly every time; a cold compile usually wins it. The
tests that run such programs are listed in SERIAL_DISPATCH_TESTS, which
gives them the ``serial_dispatch`` marker.

Nothing of JAX is imported here unless a marked test runs: portbench's
tests, which must not load JAX, run under this file too.
"""

import faulthandler
import os
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent

# A backstop, not a budget: a test whose call runs longer dumps every
# thread's stack and ends its own process, so a hang costs one test and one
# xdist worker, not the suite's whole time limit. Fixtures are not timed:
# the CLI runs in test_torch_artifacts.py's module fixture took 458 s and
# 489 s under six workers. The slowest call of two cold-cache runs of
# tests/ (6 xdist workers, empty cache directory, ``--durations``) took
# 133 s and 143 s, the CLI run of test_torch_cli_dp.py; three times that is
# capped at 300 s.
TEST_TIME_LIMIT_S = 300

# Found by running each file that enters interpret mode or a mesh twice
# over one fresh compile cache: these hung in the second run, no other did.
SERIAL_DISPATCH_TESTS = {
    (ROOT / "tests" / "test_parallel.py", "test_graft_entry_dryrun"),
    (ROOT / "tests" / "test_parallel.py",
     "test_fused_dp_shard_map_matches_single_device_fused"),
}

_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "serial_dispatch: runs eager multi-device TPU-interpret programs, "
        "which deadlock when an op is dispatched while an io_callback is "
        "pending; each eager op waits for its result",
    )
    # Output capture is suspended here, so fd 2 is the real stderr; a dump
    # written to a captured stream would die with the process.
    config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


def pytest_collection_modifyitems(items):
    for item in items:
        if (item.path.resolve(), item.name) in SERIAL_DISPATCH_TESTS:
            item.add_marker("serial_dispatch")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    # faulthandler's watchdog thread fires even while the main thread is
    # blocked in C++, where a signal-based limit would wait forever.
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT_S, exit=True, file=item.config.stash[_STDERR_FD],
    )
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


def serial_dispatch():
    """Make each eager op wait for its float results before the next one.

    Under ``jax_debug_nans`` JAX reads every float result on the host before
    it goes on, so no op is dispatched while an earlier one's io_callbacks
    run. The setting is thread-local: the callbacks' own work is not
    checked. It also makes a NaN in a marked test raise FloatingPointError,
    and a jitted function that yields one is re-run op by op.
    tests/test_serial_dispatch.py fails if a JAX upgrade breaks it.
    """
    import jax

    return jax.debug_nans(True)


@pytest.fixture(autouse=True)
def _serial_dispatch(request):
    if request.node.get_closest_marker("serial_dispatch") is None:
        yield
    else:
        with serial_dispatch():
            yield
