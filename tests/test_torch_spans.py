"""``utils.spans``: the host-time spans at the port's layer boundaries. A
span times its body, nested spans included, as a ``with`` block or a
decorator; no profiler range opens unless a profiler records, and then each
span is a ``user_annotation`` named ``vsnca.<span>``; the trainers, the
losses and the stylizer count their spans once per part; the totals hold
under threads.

CPU only, at tiny sizes; the card's side (the served frame's bits with the
spans, the replay span, the wrappers' launch host time) is in
``test_torch_cuda.py``. This file imports neither JAX nor the JAX package.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from vsnca_tpu_torch.config import ConditionedNCAConfig, LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.data.dataset import ConditioningDataset
from vsnca_tpu_torch.infer.stylize import VideoStylizer
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.models.vgg import vgg16_random_init
from vsnca_tpu_torch.train.encoder_trainer import ConditionedNCATrainer
from vsnca_tpu_torch.train.trainer import DyNCATrainer
from vsnca_tpu_torch.utils import spans

torch.set_num_threads(1)


def _snapshot():
    return {"host_ns": dict(spans.HOST_NS), "calls": dict(spans.CALLS)}


def _delta(before, key="calls"):
    now = _snapshot()[key]
    return {k: v - before[key].get(k, 0) for k, v in now.items() if v != before[key].get(k, 0)}


@pytest.fixture(scope="module")
def vgg():
    return vgg16_random_init(torch.Generator().manual_seed(16), "cpu")


def _dynca_trainer(vgg):
    cfg = NCAConfig(c_in=12, fc_dim=16, conditioning="pos_emb", padding_mode="circular")
    train = TrainConfig(img_size=(32, 32), batch_size=2, pool_size=4, step_range=(3, 5),
                        step_buckets=(3, 5), rollout_path="xla")
    loss = LossConfig(overflow_weight=1.0, appearance_weight=1.0, appearance_loss_type="Gram")
    return DyNCATrainer(cfg, loss, train, vgg_params=vgg, seed=3, device="cpu")


def _dynca_inputs():
    style = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (1, 3, 32, 32))
                             .astype(np.float32))
    return {"target_style": style}


def _encoder_trainer(vgg, device_pool=True):
    imgs = np.random.RandomState(0).rand(5, 32, 32, 3).astype(np.float32)
    style = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 32, 32).astype(np.float32))
    cfg = ConditionedNCAConfig(image_size=32, num_hidden_channels=4, update_hidden_dim=16,
                               cell_fire_rate=1.0)
    return ConditionedNCATrainer(cfg, ConditioningDataset(imgs, "cpu"), style, vgg,
                                 nca_steps=(4, 8), step_buckets=(4, 8), pool_size=16,
                                 appearance_loss_type="Gram", device="cpu",
                                 device_pool=device_pool)


@pytest.mark.parametrize("outer,inner", [
    ((0, 100), (10, 30)), ((5, 6), (5, 6)), ((0, 1000), (999, 1000))])
def test_nested_spans_time_their_bodies(monkeypatch, outer, inner):
    """Outer [a, d) holding inner [b, c): the outer's time d - a, the
    nested span's included, and the inner's c - b."""
    clock = iter([outer[0], inner[0], inner[1], outer[1]])
    monkeypatch.setattr(spans, "_now", lambda: next(clock))
    before = _snapshot()
    with spans.span("test.outer"):
        with spans.span("test.inner"):
            pass
    host = _delta(before, "host_ns")
    assert host.get("test.outer", 0) == outer[1] - outer[0]
    assert host.get("test.inner", 0) == inner[1] - inner[0]
    assert _delta(before) == {"test.outer": 1, "test.inner": 1}


@pytest.mark.parametrize("parts", [[0], [7], [3, 4, 5], [1] * 8])
def test_a_span_timed_in_parts_is_one_call(monkeypatch, parts):
    """``add`` records one call holding the parts' nanoseconds, beside a
    span of the same name, and opens no profiler range."""
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: pytest.fail(f"a profiler range {name} opened"))
    before = _snapshot()
    spans.add("test.parts", sum(parts))
    assert _delta(before) == {"test.parts": 1}
    assert _delta(before, "host_ns").get("test.parts", 0) == sum(parts)
    clock = iter([10, 15])
    monkeypatch.setattr(spans, "_now", lambda: next(clock))
    with spans.span("test.parts"):
        pass
    assert _delta(before) == {"test.parts": 2}
    assert _delta(before, "host_ns")["test.parts"] == sum(parts) + 5


def test_a_span_that_raises_is_counted_and_unwound():
    before = _snapshot()
    with pytest.raises(KeyError):
        with spans.span("test.raises"):
            raise KeyError("x")
    with spans.span("test.after"):
        pass
    assert _delta(before) == {"test.raises": 1, "test.after": 1}


def test_a_decorated_function_is_a_span_each_call(monkeypatch):
    """A decorated function keeps its name, result and exceptions, and each
    call, a recursive one too, is a span of its own."""
    clock = iter(range(0, 1000, 10))
    monkeypatch.setattr(spans, "_now", lambda: next(clock))

    @spans.span("test.decorated")
    def depth(n):
        """Recurse n times."""
        if n < 0:
            raise ValueError(n)
        return 0 if n == 0 else 1 + depth(n - 1)

    assert depth.__name__ == "depth" and depth.__doc__ == "Recurse n times."
    before = _snapshot()
    assert depth(2) == 2
    # enters at 0, 10, 20 and exits at 30, 40, 50: 10 + 30 + 50 ns
    assert _delta(before) == {"test.decorated": 3}
    assert _delta(before, "host_ns") == {"test.decorated": 90}
    with pytest.raises(ValueError):
        depth(-1)
    assert _delta(before) == {"test.decorated": 4}


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """With no profiler recording, neither a span nor a stylized frame
    enters ``record_function``."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with spans.span("test.no_range"):
        pass
    cfg = NCAConfig(c_in=12, fc_dim=16, conditioning="edges")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = VideoStylizer(params, cfg, 16, step_n=2, device="cpu")
    st.step_frame(np.zeros((1, 16, 16, 3), np.float32))


def test_profiled_iteration_carries_the_spans_as_annotations(vgg, tmp_path):
    """Under ``torch.profiler`` on the CPU the trace holds the spans as
    ``user_annotation`` events named ``vsnca.<span>``."""
    trainer = _dynca_trainer(vgg)
    inputs = _dynca_inputs()
    trainer.train_iteration(inputs)  # lazy set-up outside the profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_iteration(inputs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"vsnca.loss.appearance", "vsnca.train.rollout", "vsnca.train.iteration",
            "vsnca.train.loss", "vsnca.vgg16"} <= names
    assert not torch.autograd._profiler_enabled()


def test_dynca_iteration_counts_each_part_once(vgg):
    trainer = _dynca_trainer(vgg)
    inputs = _dynca_inputs()
    before = _snapshot()
    trainer.train_iteration(inputs)
    calls = _delta(before)
    for name in ("train.iteration", "train.pool_gather", "train.rollout", "train.loss",
                 "train.backward", "train.optimizer", "train.pool_scatter",
                 "train.loss_read", "loss.overflow", "loss.appearance"):
        assert calls.get(name) == 1, name
    assert calls.get("vgg16", 0) >= 1
    assert not {"train.pre_roll", "train.encode", "loss.content", "msoe"} & set(calls)
    host = _delta(before, "host_ns")
    assert host["train.loss"] >= host["loss.overflow"] + host["loss.appearance"]
    assert host["loss.appearance"] > 0
    # the iteration's parts run one after another inside it
    parts = ("train.pool_gather", "train.rollout", "train.loss", "train.backward",
             "train.optimizer", "train.pool_scatter", "train.loss_read")
    assert host["train.iteration"] >= sum(host[p] for p in parts)


@pytest.mark.parametrize("device_pool", [True, False])
def test_encoder_iteration_counts_its_loss_once_a_train_step(vgg, device_pool):
    """Either pool, on the device or on the host, is gathered and written
    back once an iteration."""
    trainer = _encoder_trainer(vgg, device_pool)
    before = _snapshot()
    trainer.train_iteration(batch_size=4)
    calls = _delta(before)
    assert calls["train.iteration"] == 1
    for name in ("train.encode", "train.rollout", "train.loss", "train.backward",
                 "train.optimizer", "loss.overflow", "loss.appearance", "loss.content"):
        assert calls.get(name) == 2, name
    for name in ("train.pool_gather", "train.pool_scatter", "train.loss_read"):
        assert calls.get(name) == 1, name


def test_vector_field_pre_roll_is_a_span(vgg):
    """The vector-field term's pre-roll and MSOE passes are spans of their
    own."""
    from vsnca_tpu_torch.models.msoe import msoe_random_init

    cfg = NCAConfig(c_in=12, fc_dim=16, padding_mode="circular")
    train = TrainConfig(img_size=(32, 32), batch_size=2, pool_size=4, step_range=(3, 5),
                        step_buckets=(3, 5), rollout_path="xla")
    loss = LossConfig(overflow_weight=1.0, appearance_weight=0.0,
                      vector_field_motion_weight=1.0, motion_img_size=(32, 32))
    trainer = DyNCATrainer(cfg, loss, train, msoe_params=msoe_random_init(
        torch.Generator().manual_seed(175), "cpu"), seed=4, device="cpu")
    before = _snapshot()
    trainer.train_iteration({})
    calls = _delta(before)
    assert calls["train.pre_roll"] == 1 and calls["loss.vector_field_motion"] == 1
    assert calls.get("msoe", 0) >= 1 and "loss.appearance" not in calls


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_frame_counts_its_upload(dtype):
    """A host frame: one upload, one eager frame, no replay or capture."""
    cfg = NCAConfig(c_in=12, fc_dim=16, conditioning="edges")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = VideoStylizer(params, cfg, 16, step_n=2, device="cpu")
    frame = np.random.RandomState(0).uniform(-1, 1, (1, 16, 16, 3)).astype(dtype)
    before = _snapshot()
    st.step_frame(frame)
    assert _delta(before) == {"stylize.frame": 1, "stylize.upload": 1, "stylize.eager": 1}
    host = _delta(before, "host_ns")
    assert 0 < host["stylize.upload"] + host["stylize.eager"] <= host["stylize.frame"]


def test_totals_hold_under_threads():
    """More threads than cores, a switch every microsecond: no update is
    lost, and each span keeps its own clock."""
    n_threads, n_spans = 16, 300
    before = _snapshot()
    old = sys.getswitchinterval()
    errors = []

    def work():
        try:
            for _ in range(n_spans):
                with spans.span("test.thread_outer"):
                    with spans.span("test.thread_inner"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    try:
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    total = n_threads * n_spans
    assert _delta(before) == {"test.thread_outer": total, "test.thread_inner": total}
    host = _delta(before, "host_ns")
    assert host["test.thread_outer"] >= host["test.thread_inner"] > 0
