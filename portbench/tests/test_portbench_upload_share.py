"""``upload_hidden_share.serve``: the stylizer's host frame bytes copied
while an earlier chunk of the frame was queued on the card, over all it
copied, read from the program's counters; nothing where the program has
none, copied no host frame (a run on the CPU), or is training."""

import sys
import types

import pytest

from portbench_tiny import run_tiny, tiny_cell

STYLIZE = "vsnca_tpu_torch.infer.stylize"


def _reader():
    from portbench.harness.spec import metric_reader

    return metric_reader("upload_hidden_share.serve")


def _run(kind="serve"):
    from portbench.harness.run_context import RunRecord

    return RunRecord(kind=kind, model={}, config={}, traffic={}, device={})


@pytest.mark.parametrize("counters", [None, {}, {"UPLOAD_BYTES": 100},
                                      {"HIDDEN_UPLOAD_BYTES": 50},
                                      {"UPLOAD_BYTES": 0, "HIDDEN_UPLOAD_BYTES": 0}],
                         ids=["no_module", "no_counters", "no_hidden", "no_upload",
                              "nothing_uploaded"])
def test_none_without_the_counters(monkeypatch, counters):
    if counters is None:
        monkeypatch.delitem(sys.modules, STYLIZE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, STYLIZE, types.SimpleNamespace(**counters))
    assert _reader()(_run()) is None


@pytest.mark.parametrize("uploaded,hidden,share", [
    (8 * 25165824, 7 * 25165824, 87.5), (786432 * 50, 0, 0.0), (400, 300, 75.0),
    (1000, 1000, 100.0)])
def test_share_of_the_counters(monkeypatch, uploaded, hidden, share):
    monkeypatch.setitem(sys.modules, STYLIZE,
                        types.SimpleNamespace(UPLOAD_BYTES=uploaded, HIDDEN_UPLOAD_BYTES=hidden))
    assert _reader()(_run()) == pytest.approx(share)
    assert _reader()(_run("train")) is None


def test_a_tiny_serving_run_on_the_cpu_uploads_nothing():
    """On the CPU the host frame is not copied to a card: no bytes count,
    and the metric has nothing to read."""
    rec = run_tiny(tiny_cell("edge_stream_256"), trace=True)[0]
    stylize = sys.modules[STYLIZE]
    assert stylize.FRAMES >= 3 and stylize.UPLOAD_BYTES == stylize.HIDDEN_UPLOAD_BYTES == 0
    assert _reader()(rec) is None
