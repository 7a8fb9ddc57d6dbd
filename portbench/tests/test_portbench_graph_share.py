"""``graph_replay_share.serve``: the stylizer's graph replays over its
``step_frame`` calls, read from the program's counters; nothing where the
program has none (a program without the graph path, or a training run)."""

import sys
import types

import pytest

from portbench_tiny import run_tiny, tiny_cell

STYLIZE = "vsnca_tpu_torch.infer.stylize"


def _reader():
    from portbench.harness.spec import metric_reader

    return metric_reader("graph_replay_share.serve")


def _run(kind="serve"):
    from portbench.harness.run_context import RunRecord

    return RunRecord(kind=kind, model={}, config={}, traffic={}, device={})


@pytest.mark.parametrize("counters", [None, {}, {"FRAMES": 5}, {"GRAPH_REPLAYS": 5}],
                         ids=["no_module", "no_counters", "no_replays", "no_frames"])
def test_none_without_the_counters(monkeypatch, counters):
    if counters is None:
        monkeypatch.delitem(sys.modules, STYLIZE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, STYLIZE, types.SimpleNamespace(**counters))
    assert _reader()(_run()) is None


@pytest.mark.parametrize("frames,replays,share", [(200, 199, 99.5), (8, 0, 0.0), (3, 3, 100.0)])
def test_share_of_the_counters(monkeypatch, frames, replays, share):
    monkeypatch.setitem(sys.modules, STYLIZE,
                        types.SimpleNamespace(FRAMES=frames, GRAPH_REPLAYS=replays))
    assert _reader()(_run()) == pytest.approx(share)
    assert _reader()(_run("train")) is None


def test_a_tiny_serving_run_on_the_cpu_replays_nothing():
    """The plain path takes no graph: every frame counts, none is a replay."""
    rec = run_tiny(tiny_cell("edge_stream_256"), trace=True)[0]
    stylize = sys.modules[STYLIZE]
    assert stylize.FRAMES >= 3 and stylize.GRAPH_REPLAYS == 0
    assert _reader()(rec) == 0.0
