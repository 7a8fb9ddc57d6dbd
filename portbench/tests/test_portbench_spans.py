"""The readers of the program's spans and launch counters
(``upload_ms.serve``, ``replay_ms.serve``, ``launch_host_us.train``) and of
the traced idle by span (``loss_idle_pct.train``, ``trainer_idle_pct.train``):
nothing on a run of a program without them, and on a fabricated record the
value hand arithmetic gives."""

import sys
import types

import pytest

from portbench_tiny import run_tiny, tiny_cell

SPANS = "vsnca_tpu_torch.utils.spans"
WRAPPERS = ("vsnca_tpu_torch.ops.fused_step", "vsnca_tpu_torch.ops.fused_train",
            "vsnca_tpu_torch.ops.fused_cnca")
READERS = ("upload_ms.serve", "replay_ms.serve", "launch_host_us.train",
           "loss_idle_pct.train", "trainer_idle_pct.train")


def _reader(name):
    from portbench.harness.spec import metric_reader

    return metric_reader(name)


def _run(kind, trace=None):
    from portbench.harness.run_context import RunRecord

    return RunRecord(kind=kind, model={}, config={}, traffic={}, device={}, trace=trace)


def _trace(idle, window_s=2.0):
    return {"window_s": window_s, "busy_s": 1.0, "device_by_name": {}, "idle_by_host": idle}


def _parent(monkeypatch):
    """The program as it was before the spans: no spans module, wrapper
    modules with launch counts and no host time, a trace labelled by the
    harness's and torch's ranges only."""
    monkeypatch.delitem(sys.modules, SPANS, raising=False)
    for m in WRAPPERS:
        monkeypatch.setitem(sys.modules, m, types.SimpleNamespace(LAUNCHES=100))


PARENT_TRACE = _trace({"portbench.iteration": 0.3, "cudaLaunchKernel": 0.1,
                       "(no host op)": 0.05})


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("kind", ["serve", "train"])
def test_none_on_a_program_without_the_spans(monkeypatch, name, kind):
    _parent(monkeypatch)
    assert _reader(name)(_run(kind, PARENT_TRACE)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_the_other_kind_of_run(monkeypatch, name):
    spans = types.SimpleNamespace(HOST_NS={"stylize.upload": 10, "stylize.replay": 10},
                                  CALLS={"stylize.upload": 1, "stylize.replay": 1})
    monkeypatch.setitem(sys.modules, SPANS, spans)
    for m in WRAPPERS:
        monkeypatch.setitem(sys.modules, m, types.SimpleNamespace(LAUNCHES=2, LAUNCH_HOST_NS=8))
    trace = _trace({"vsnca.train.loss": 0.5, "vsnca.loss.content": 0.5})
    kind = "train" if name.endswith(".serve") else "serve"
    assert _reader(name)(_run(kind, trace)) is None


@pytest.mark.parametrize("name,span", [("upload_ms.serve", "stylize.upload"),
                                       ("replay_ms.serve", "stylize.replay")])
def test_span_ms_a_call(monkeypatch, name, span):
    spans = types.SimpleNamespace(HOST_NS={span: 3_000_000}, CALLS={span: 4})
    monkeypatch.setitem(sys.modules, SPANS, spans)
    assert _reader(name)(_run("serve")) == pytest.approx(0.75)
    spans.CALLS = {}  # the span never closed (no replay on this path)
    assert _reader(name)(_run("serve")) is None


def test_launch_host_us_sums_the_wrappers(monkeypatch):
    """fused_train's forward launches are fused_step's, timed there: its
    time is over its backward launches alone, so each launch counts once."""
    counters = [(300, 6_000_000), (100, 1_000_000), (600, 9_000_000)]
    for m, (n, ns) in zip(WRAPPERS, counters):
        monkeypatch.setitem(sys.modules, m, types.SimpleNamespace(LAUNCHES=n, LAUNCH_HOST_NS=ns))
    sys.modules[WRAPPERS[1]].KERNEL_LAUNCHES = {"nca_step": 50, "nca_bwd_mlp": 25,
                                                "nca_bwd_adjoint_ms": 25}
    # (6 + 1 + 9) ms over 300 + 50 + 600 launches
    assert _reader("launch_host_us.train")(_run("train")) == pytest.approx(16e3 / 950)
    # a run that loaded only the cnca wrappers' module reads them alone
    for m in WRAPPERS[:2]:
        monkeypatch.delitem(sys.modules, m)
    assert _reader("launch_host_us.train")(_run("train")) == pytest.approx(15.0)
    sys.modules[WRAPPERS[2]].LAUNCHES = 0
    assert _reader("launch_host_us.train")(_run("train")) is None


def test_idle_shares_by_label():
    idle = {"vsnca.train.iteration": 0.10, "vsnca.train.loss": 0.02,
            "vsnca.train.backward": 0.7,
            "vsnca.train.pool_gather": 0.03, "vsnca.loss.appearance": 0.05,
            "vsnca.loss.content": 0.01, "vsnca.vgg16": 0.04, "vsnca.msoe": 0.02,
            "vsnca.stylize.frame": 0.5, "portbench.iteration": 0.2, "cudaLaunchKernel": 0.3,
            "aten::add": 0.1}
    run = _run("train", _trace(idle, window_s=4.0))
    assert _reader("loss_idle_pct.train")(run) == pytest.approx(100 * 0.12 / 4.0)
    assert _reader("trainer_idle_pct.train")(run) == pytest.approx(100 * 0.15 / 4.0)
    # the backward is every layer's: no per-layer metric reads it
    only_train = _run("train", _trace({"vsnca.train.rollout": 0.4, "aten::mm": 1.0,
                                       "vsnca.train.backward": 0.3}))
    assert _reader("loss_idle_pct.train")(only_train) == 0.0
    assert _reader("trainer_idle_pct.train")(only_train) == pytest.approx(20.0)
    for name in ("loss_idle_pct.train", "trainer_idle_pct.train"):
        assert _reader(name)(_run("train")) is None  # an untraced run
        assert _reader(name)(_run("train", _trace({}, window_s=0.0))) is None


def test_a_tiny_serving_run_on_the_cpu_reads_its_upload():
    """The port's own spans: a tiny traced serving run on the CPU has an
    upload a frame and no replay."""
    rec = run_tiny(tiny_cell("edge_stream_256"), trace=True)[0]
    spans = sys.modules[SPANS]
    assert spans.CALLS["stylize.upload"] >= spans.CALLS["stylize.frame"] >= 3
    assert _reader("upload_ms.serve")(rec) > 0
    assert _reader("replay_ms.serve")(rec) is None
