"""The per-test time limit of the repository root conftest ends only the
test that overruns it: its xdist worker dumps every thread and exits, and
xdist runs the rest of the file on a fresh worker."""

import re
import subprocess
import sys
import time
from pathlib import Path

_CHILD_TESTS = """
import time


def test_sleeps_past_the_limit():
    time.sleep(300)


def test_runs_after_it():
    pass
"""


def test_time_limit_ends_only_the_overrunning_test(tmp_path):
    harness = (Path(__file__).resolve().parents[1] / "conftest.py").read_text()
    short = harness.replace("TEST_TIME_LIMIT_S = 300", "TEST_TIME_LIMIT_S = 2")
    assert short != harness
    (tmp_path / "conftest.py").write_text(short)
    (tmp_path / "test_child.py").write_text(_CHILD_TESTS)
    start = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-n", "1",
         "test_child.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=150,
    )
    elapsed = time.monotonic() - start
    log = run.stdout + run.stderr
    assert run.returncode != 0, log
    # The child takes ~10 s; a limit that did not fire would take the
    # whole 300 s sleep.
    assert elapsed < 60, log
    assert "Timeout (0:00:02)!" in log, log
    assert re.search(r"line \d+ in test_sleeps_past_the_limit", log), log
    assert "worker 'gw0' crashed while running " \
        "'test_child.py::test_sleeps_past_the_limit'" in log, log
    assert "1 failed, 1 passed" in log, log
