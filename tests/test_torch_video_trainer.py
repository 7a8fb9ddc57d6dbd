"""The port's video_motion training path against the JAX package on the CPU:
one ``make_train_step`` with the video-motion loss stack (overflow, OT
appearance on every tapped frame, MotionOT) in both tapped forms — the
reference tap schedule on precomputed target features, and the legacy
``(n_motion_frames, tap_every)`` form on the target window's frames — from
identical parameters, pool, inputs,
VGG16 and MSOE arrays, at update_rate 1 (so the masks do not matter) and
32^2, where neither OT term subsamples; the JAX step runs
``rollout_path="xla"``, the port's both its 'xla' route (eager steps a
chunk) and its 'fused' route (the training pair's plain version, one call
with in-kernel taps). Then ``VideoMotionProtocol``: the same iteration plan
as JAX's (step counts, tap schedules, window starts, feature windows) from
the same seed, and a warmup 2 -> calibrate -> reinit -> main 1 run whose
calibrated weight is the JAX rule's for the same median motion loss.

Tolerances: loss and logs rtol 1e-5; updated parameters atol 1e-6, 0.1 % of
one Adam update (as tests/test_torch_trainer.py, measured ~1e-8); the new
pool states rtol 1e-4 / atol 1e-5. ``-s`` prints the measured differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.config import TrainConfig as JTrainConfig
from vsnca_tpu.losses.appearance import precompute_target_style_features as j_style_feats
from vsnca_tpu.losses.orchestrator import LossState as JLossState
from vsnca_tpu.losses.orchestrator import set_loss_weight as j_set_loss_weight
from vsnca_tpu.losses.video_motion import precompute_target_motion_features as j_motion_feats
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu.train.optim import make_optimizer as jmake_optimizer
from vsnca_tpu.train.trainer import make_train_step as jmake_train_step
from vsnca_tpu.train.video_motion_protocol import VideoMotionProtocol as JProtocol
from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.convert import msoe_from_jax, params_from_jax, vgg_from_jax
from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
from vsnca_tpu_torch.losses.orchestrator import LossState
from vsnca_tpu_torch.losses.video_motion import precompute_target_motion_features
from vsnca_tpu_torch.models.dynca import tap_schedule
from vsnca_tpu_torch.train.optim import make_optimizer
from vsnca_tpu_torch.train.trainer import make_train_step
from vsnca_tpu_torch.train.video_motion_protocol import VideoMotionProtocol, synthesize_and_score

from test_torch_losses import np_vgg16

torch.set_num_threads(1)

CELL = dict(c_in=8, fc_dim=16, conditioning="pos_emb", padding_mode="circular",
            perception_scales=(0, 1), update_rate=1.0)
LOSS = dict(overflow_weight=1.0, appearance_weight=1.0, appearance_loss_type="OT",
            video_motion_weight=5.0, video_motion_loss_type="MotionOT",
            motion_img_size=(32, 32))
STEP_N, TAP_EVERY = 9, 4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _video(n_frames=6):
    """A drifting random texture, [T, 32, 32, 3] in [-1, 1]."""
    base = np.random.RandomState(5).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    return np.stack([np.roll(base, 3 * t, axis=1) for t in range(n_frames)])


@pytest.fixture(scope="module")
def arrays():
    jm = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    return np_vgg16(0), {k: np.asarray(v) for k, v in jm.items()}


def _plan(kind):
    """(train-step keywords, target input name): the reference schedule for
    step_n 9 tapped every 4 steps (frames after steps 1, 5, 9) on
    precomputed motion features, or the legacy form (3 frames every 3
    steps) on the target window's frames."""
    if kind == "schedule":
        chunks, tail = tap_schedule(STEP_N, TAP_EVERY)
        return dict(step_n=STEP_N, tap_chunks=chunks, tail_steps=tail), "target_motion_features"
    return dict(step_n=STEP_N, n_motion_frames=3, tap_every=3), "target_motion_frames"


@pytest.fixture(scope="module", params=["schedule", "legacy"])
def jax_step_result(arrays, request):
    """One JAX video_motion train step (rollout_path "xla", remat "none")
    in each tapped form."""
    kw, target = _plan(request.param)
    vgg_np, msoe_np = arrays
    jcfg = JNCAConfig(**CELL)
    jvgg = [{k: jnp.asarray(v) for k, v in d.items()} for d in vgg_np]
    jm = {k: jnp.asarray(v) for k, v in msoe_np.items()}
    params = jdynca.dynca_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    states = rng.uniform(-0.5, 0.5, (2, 32, 32, 8)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    if target == "target_motion_features":
        motion = j_motion_feats(jm, jnp.asarray(_video()), (32, 32))[1:3]
    else:
        motion = jnp.broadcast_to(jnp.asarray(_video()[1:4])[:, None], (3, 2, 32, 32, 3))
    opt = jmake_optimizer(1e-3, (1000, 2000), 0.5)
    step = jmake_train_step(jcfg, JLossState(cfg=JLossConfig(**LOSS), vgg_params=jvgg,
                                             msoe_params=jm),
                            opt, remat="none", rollout_path="xla")
    inputs = {"target_style": jnp.asarray(style),
              "target_style_features": j_style_feats(jvgg, jnp.asarray(style), "OT", (32, 32)),
              target: motion}
    p2, _, new_states, loss, logs = step(
        params, opt.init(params), jnp.asarray(states), jax.random.PRNGKey(3), inputs, **kw)
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return dict(params=np_(params), states=states, style=style, new_params=np_(p2),
                new_states=np.asarray(new_states), loss=float(loss),
                logs={k: float(v) for k, v in logs.items()}, kind=request.param)


@pytest.mark.parametrize("rollout_path", ["fused", "xla"])
def test_video_motion_train_step_matches_jax(arrays, jax_step_result, rollout_path):
    r = jax_step_result
    vgg = vgg_from_jax(arrays[0], "cpu")
    msoe = msoe_from_jax(arrays[1], "cpu")
    params = {k: v.requires_grad_() for k, v in params_from_jax(r["params"], "cpu").items()}
    opt = make_optimizer(params, 1e-3, (1000, 2000), 0.5)
    step = make_train_step(NCAConfig(**CELL),
                           LossState(cfg=LossConfig(**LOSS), vgg_params=vgg, msoe_params=msoe),
                           "none", rollout_path)
    style = _nchw(r["style"])
    kw, target = _plan(r["kind"])
    if target == "target_motion_features":
        motion = precompute_target_motion_features(msoe, _nchw(_video()), (32, 32))[1:3]
    else:
        motion = _nchw(_video()[1:4])[:, None].expand(3, 2, 3, 32, 32)
    inputs = {"target_style": style,
              "target_style_features": precompute_target_style_features(vgg, style, "OT",
                                                                        (32, 32)),
              target: motion}
    _, _, new_states, loss, logs = step(params, opt, _nchw(r["states"]), 0, inputs, **kw)
    dp = max(np.abs(v.detach().numpy() - r["new_params"][k]).max() for k, v in params.items())
    print(f"\nvideo_motion step, {r['kind']}, rollout_path={rollout_path}: loss rel diff "
          f"{abs(float(loss) - r['loss']) / r['loss']:.1e}; logs " + ", ".join(
              f"{k} {abs(float(v) - r['logs'][k]) / abs(r['logs'][k]):.1e}"
              for k, v in logs.items()) + f"; updated params max abs diff {dp:.2e}")
    assert set(logs) == {"overflow", "appearance", "video_motion"} == set(r["logs"])
    assert float(loss) == pytest.approx(r["loss"], rel=1e-5)
    assert {k: float(v) for k, v in logs.items()} == pytest.approx(r["logs"], rel=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), r["new_params"][k], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.abs(r["new_params"][k] - r["params"][k]).max() > 5e-4  # it moved
    np.testing.assert_allclose(new_states.numpy(), r["new_states"].transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


class _Stub:
    """What the protocols' iteration planner reads of a trainer."""

    def __init__(self, seed, train_cfg):
        self.rng = np.random.RandomState(seed)
        self.train_cfg = train_cfg

    def sample_step_n(self):
        lo, hi = self.train_cfg.step_range
        raw = self.rng.randint(lo, hi)
        buckets = np.asarray(self.train_cfg.step_buckets)
        return int(buckets[np.argmin(np.abs(buckets - raw))])


@pytest.mark.parametrize("reference_tap_schedule", [True, False])
def test_protocol_plans_iterations_as_jax(reference_tap_schedule):
    """From the same seed, the port's protocol and JAX's plan the same
    iterations: step counts, tap schedules, window starts, and the windows
    of precomputed motion features (or of target frames, broadcast over the
    batch)."""
    train = dict(img_size=(32, 32), batch_size=2, step_range=(6, 20), step_buckets=(6, 9, 14),
                 seed=11)
    video = _video(12)
    style = np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    kw = dict(tap_every=TAP_EVERY, reference_tap_schedule=reference_tap_schedule)
    jp = JProtocol(JNCAConfig(**CELL), JLossConfig(**LOSS), JTrainConfig(**train),
                   jnp.asarray(video), jnp.asarray(style), **kw)
    tp = VideoMotionProtocol(NCAConfig(**CELL), LossConfig(**LOSS), TrainConfig(**train),
                             _nchw(video), _nchw(style), device="cpu", **kw)
    feats = np.random.RandomState(1).randn(11, 4, 3, 3).astype(np.float32)
    for use_feats in (True, False):
        jp._motion_feats = jnp.asarray(feats.transpose(0, 2, 3, 1)) if use_feats else None
        tp._motion_feats = torch.from_numpy(feats) if use_feats else None
        js, ts = _Stub(3, jp.train_cfg), _Stub(3, tp.train_cfg)
        for _ in range(6):
            (ji, jkw), (ti, tkw) = jp._iteration_kwargs(js), tp._iteration_kwargs(ts)
            assert tkw == jkw and tp._start_idx == jp._start_idx
            if use_feats:
                np.testing.assert_array_equal(
                    ti["target_motion_features"].numpy(),
                    np.asarray(ji["target_motion_features"]).transpose(0, 3, 1, 2))
            else:
                np.testing.assert_array_equal(
                    ti["target_motion_frames"].numpy(),
                    np.asarray(ji["target_motion_frames"]).transpose(0, 1, 4, 2, 3))


def test_protocol_warmup_calibrate_reinit_main(arrays, tmp_path):
    """warmup 2 -> calibrate -> reinit -> main 1 at 32^2: the calibrated
    weight is the JAX rule's for the median warm-up motion loss, the main
    phase runs on a fresh trainer, and the final evaluation writes finite
    scores."""
    vgg = vgg_from_jax(arrays[0], "cpu")
    msoe = msoe_from_jax(arrays[1], "cpu")
    train = TrainConfig(img_size=(32, 32), batch_size=2, pool_size=4, step_range=(6, 10),
                        step_buckets=(6, 9), max_iterations=3, remat="none", seed=4)
    video = _nchw(_video())
    style = video[:1].expand(2, 3, 32, 32).contiguous()
    proto = VideoMotionProtocol(NCAConfig(**CELL), LossConfig(**LOSS), train, video, style,
                                warmup_iters=2, tap_every=TAP_EVERY, device="cpu")
    trainer = proto.run(vgg, msoe)
    assert len(proto._motion_losses) == 2 and all(np.isfinite(proto._motion_losses))
    want = j_set_loss_weight(JLossConfig(**LOSS), "video_motion",
                             medium_mt=float(np.median(proto._motion_losses)), img_size=32,
                             nca_config_key="8-16")
    assert proto.loss_cfg.video_motion_weight == pytest.approx(want.video_motion_weight,
                                                               rel=1e-12)
    assert trainer.loss_state.cfg.video_motion_weight == proto.loss_cfg.video_motion_weight
    assert trainer.iteration == 1 and len(trainer.history) == 1
    assert np.isfinite(trainer.history[0].loss)
    scores = synthesize_and_score(trainer, video, str(tmp_path), n_frames=3, step_n=4)
    assert set(scores) == {"appearance_loss_mean", "video_motion_loss_mean"}
    assert all(np.isfinite(v) for v in scores.values())
    assert (tmp_path / "final_loss_test.txt").exists()
