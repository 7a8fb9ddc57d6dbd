"""The port's benchmark harness (vsnca_tpu_torch.infer.benchmark) on the CPU
at 32², against the JAX package's (vsnca_tpu.infer.benchmark): every
function returns the JAX function's keys, with the sizes and counts it was
given, positive finite rates, and rates that agree with the times they come
from. No time here is a device time: these run PyTorch's and XLA's CPU
kernels. ``-s`` prints the port's numbers.
"""

import math
import os

import pytest
import torch

from vsnca_tpu.infer import benchmark as jbench
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.infer import benchmark as bench

torch.set_num_threads(1)

SMALL = dict(c_in=8, fc_dim=16, padding_mode="circular", conditioning="pos_emb")


def _finite_positive(d, keys):
    for k in keys:
        assert math.isfinite(d[k]) and d[k] > 0, (k, d[k])


def test_benchmark_rollout_keys_and_rates():
    got = bench.benchmark_rollout(NCAConfig(**SMALL), size=32, n_steps=4, iters=2,
                                  device="cpu")
    want = jbench.benchmark_rollout(JNCAConfig(**SMALL), size=32, n_steps=4, iters=1)
    print(f"\nport benchmark_rollout (CPU): {got}")
    assert set(got) == set(want)
    assert (got["size"], got["batch"], got["n_steps"]) == (32, 1, 4)
    _finite_positive(got, ["sec_per_rollout", "steps_per_sec", "cell_updates_per_sec"])
    assert got["cell_updates_per_sec"] == pytest.approx(got["steps_per_sec"] * 32 * 32)
    assert got["frames_per_sec"] == pytest.approx(got["steps_per_sec"] / 24)


def test_benchmark_stages_keys():
    got = bench.benchmark_stages(NCAConfig(c_in=8, fc_dim=16), size=32, iters=2,
                                 device="cpu")
    want = jbench.benchmark_stages(JNCAConfig(c_in=8, fc_dim=16), size=32, iters=1)
    print(f"\nport benchmark_stages (CPU): {got}")
    assert set(got) == set(want)
    _finite_positive(got, ["perception_ms", "fc_ms", "stochastic_update_ms"])


def test_profile_rollout_writes_a_trace(tmp_path):
    out = bench.profile_rollout(str(tmp_path), NCAConfig(c_in=8, fc_dim=16), size=32,
                                n_steps=2, device="cpu")
    assert out == str(tmp_path)
    assert os.path.getsize(os.path.join(out, "rollout_trace.json")) > 0


def test_benchmark_serving_keys_and_rates():
    got = bench.benchmark_serving(size=32, n_streams=3, step_n=2, n_frames=2, device="cpu")
    want = jbench.benchmark_serving(size=32, n_streams=2, step_n=2, n_frames=1)
    print(f"\nport benchmark_serving (CPU): {got}")
    assert set(got) == set(want)
    assert got["n_streams"] == 3
    assert got["aggregate_fps"] == pytest.approx(3 * got["per_stream_fps"])
    assert got["ms_per_batched_frame"] == pytest.approx(1000 / got["per_stream_fps"])


def test_benchmark_train_step_keys_and_unported_presets():
    got = bench.benchmark_train_step("static_texture", iters=1, step_n=4, img_size=32,
                                     precompute_targets=True, device="cpu")
    want = jbench.benchmark_train_step("static_texture", iters=1, step_n=4, img_size=32)
    print(f"\nport benchmark_train_step (CPU): {got}")
    assert set(got) == set(want)
    assert (got["preset"], got["step_n"]) == ("static_texture", 4)
    assert got["train_iters_per_sec"] == pytest.approx(1 / got["sec_per_train_iter"])
    for preset in ("edge_conditioned", "extra_channels", "vector_field_motion"):
        got = bench.benchmark_train_step(preset, iters=1, step_n=4, img_size=32, device="cpu")
        assert (got["preset"], got["step_n"]) == (preset, 4)
        _finite_positive(got, ["sec_per_train_iter"])


@pytest.mark.parametrize("step_n,reference_shape", [(66, True), (4, False)])
def test_benchmark_train_step_video_motion_taps(step_n, reference_shape):
    """The reference's tap schedule (frames after steps 1 and 65) and the
    three equal chunks, with the target's MSOE features precomputed."""
    got = bench.benchmark_train_step("video_motion", iters=1, step_n=step_n, img_size=32,
                                     precompute_targets=True,
                                     reference_shape=reference_shape, device="cpu")
    assert (got["preset"], got["step_n"]) == ("video_motion", step_n)
    _finite_positive(got, ["sec_per_train_iter"])


def test_benchmarks_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.benchmark_rollout(size=32, n_steps=1, iters=1)
