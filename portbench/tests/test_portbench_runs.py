"""A run's last line has the contract's keys; without a card the command
exits non-zero and prints no result; nothing a run loads is JAX or the JAX
package, compared by whole top-level names; the reference loads nothing of
the program."""

import json
import subprocess
import sys

import pytest

from portbench_tiny import ROOT, SERVE_CELLS, TRAIN_CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", SERVE_CELLS[:1] + TRAIN_CELLS[1:])
def test_last_line_has_the_contracts_keys(name, trace, capsys):
    from portbench.harness.result import finish

    cell = tiny_cell(name)
    out = run_tiny(cell, trace=trace)
    assert finish(cell, *out, trace) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(line) == keys | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want


def test_without_a_card_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "edge_stream_256", "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


PROBE = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
{body}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _loaded(body: str):
    code = PROBE.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"), body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(eval(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", SERVE_CELLS[:1] + TRAIN_CELLS[1:])
def test_a_run_loads_no_jax(name):
    loaded = _loaded(f"from portbench_tiny import run_tiny, tiny_cell\n"
                     f"run_tiny(tiny_cell({name!r}))")
    assert "vsnca_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "vsnca_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.nca, portbench.reference.losses, "
                     "portbench.reference.trainer, portbench.reference.serve_check, "
                     "portbench.reference.train_check, portbench.reference.control, "
                     "portbench.counts.training")
    assert not loaded & {"jax", "jaxlib", "flax", "vsnca_tpu", "vsnca_tpu_torch"}
