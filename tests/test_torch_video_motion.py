"""The port's video-motion loss stack against the JAX package on the same
numpy inputs and shared MSOE / VGG16 arrays: ``video_motion_loss`` for
MotionOT, MotionGram and MotionSlW, the precomputed target features, the
DyNCA loss function with appearance on a list of tapped frames plus the
video-motion term, ``set_loss_weight``, ``tap_schedule`` and
``get_start_frame_idx``.

At ``motion_img_size`` 32 and a 32^2 VGG16 input nothing is subsampled (OT
draws pixels only past 32 rows), so the losses are deterministic; MotionSlW
gets JAX's own projections (the port otherwise draws its own from a
``torch.Generator``). Tolerance 1e-5 relative, for float32 sums in another
order; the schedules and the window starts are exact. ``-s`` prints the
measured differences.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.data.preprocess import get_start_frame_idx as j_start_idx
from vsnca_tpu.losses import orchestrator as jorch
from vsnca_tpu.losses import video_motion as jvm
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu_torch.config import LossConfig
from vsnca_tpu_torch.convert import msoe_from_jax, vgg_from_jax
from vsnca_tpu_torch.data.preprocess import get_start_frame_idx, preprocess_video
from vsnca_tpu_torch.losses import orchestrator as orch
from vsnca_tpu_torch.losses import video_motion as vm
from vsnca_tpu_torch.models import dynca

from test_torch_losses import np_vgg16

torch.set_num_threads(1)

SIZE = (32, 32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def msoe_pair():
    jp = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    return jp, msoe_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.fixture(scope="module")
def frames():
    """Three generated frames and three target frames, [2, 32, 32, 3] in
    [-1, 1]: the target a drifting texture, the generated noise around it."""
    rng = np.random.RandomState(0)
    base = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tgt = [np.roll(base, 2 * t, axis=2) for t in range(3)]
    gen = [np.clip(t + 0.3 * rng.randn(*t.shape), -1, 1).astype(np.float32) for t in tgt]
    return gen, tgt


def _rel(a, b):
    return abs(a - b) / (abs(b) + 1e-30)


def _jax_slw_projections(key, n_pairs, proj_n=32):
    """The projections JAX's MotionSlW draws from ``key``, pair by pair."""
    out = []
    for _ in range(n_pairs):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(jax.random.normal(sub, (320, proj_n)))))
    return out


@pytest.mark.parametrize("loss_type", ["MotionOT", "MotionGram", "MotionSlW"])
@pytest.mark.parametrize("target", ["frames", "features"])
def test_video_motion_loss_matches_jax(msoe_pair, frames, loss_type, target):
    jp, tp = msoe_pair
    gen, tgt = frames
    key = jax.random.PRNGKey(3)
    j_feats = t_feats = None
    if target == "features":
        j_feats = jvm.precompute_target_motion_features(
            jp, jnp.asarray(np.stack([t[0] for t in tgt])), SIZE)
        t_feats = vm.precompute_target_motion_features(
            tp, _nchw(np.stack([t[0] for t in tgt])), SIZE)
    jl, (jflow_g, jflow_t) = jvm.video_motion_loss(
        jp, [jnp.asarray(g) for g in gen], [jnp.asarray(t) for t in tgt], loss_type, key,
        SIZE, target_features=j_feats)
    projs = _jax_slw_projections(key, 2) if loss_type == "MotionSlW" else None
    gen_t = [_nchw(g).requires_grad_() for g in gen]
    tl, (flow_g, flow_t) = vm.video_motion_loss(
        tp, gen_t, [_nchw(t) for t in tgt], loss_type, torch.Generator().manual_seed(0),
        SIZE, target_features=t_feats, projections=projs)
    print(f"\n{loss_type} ({target}): port {float(tl):.6e} JAX {float(jl):.6e} "
          f"rel {_rel(float(tl), float(jl)):.1e}")
    assert _rel(float(tl), float(jl)) <= 1e-5
    np.testing.assert_allclose(flow_g.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jflow_g), rtol=1e-4, atol=1e-5)
    assert (flow_t is None) == (jflow_t is None)
    # and the loss reaches every generated frame
    tl.backward()
    assert all(float(g.grad.abs().max()) > 0 for g in gen_t)


def test_video_motion_loss_gradient_matches_jax(msoe_pair, frames):
    """MotionOT's gradient to the generated frames: the whole MSOE VJP."""
    jp, tp = msoe_pair
    gen, tgt = frames

    def jloss(gs):
        l, _ = jvm.video_motion_loss(jp, gs, [jnp.asarray(t) for t in tgt], "MotionOT",
                                     jax.random.PRNGKey(0), SIZE)
        return l

    jg = jax.grad(jloss)([jnp.asarray(g) for g in gen])
    gen_t = [_nchw(g).requires_grad_() for g in gen]
    l, _ = vm.video_motion_loss(tp, gen_t, [_nchw(t) for t in tgt], "MotionOT", None, SIZE)
    l.backward()
    for a, b in zip(gen_t, jg):
        b = np.asarray(b)
        err = np.abs(a.grad.numpy().transpose(0, 2, 3, 1) - b).max() / np.abs(b).max()
        print(f"\nMotionOT frame gradient: {err:.1e}")
        assert err <= 1e-5


def test_precompute_target_motion_features_matches_jax(msoe_pair, frames):
    jp, tp = msoe_pair
    video = np.stack([t[1] for t in frames[1]])
    jf = np.asarray(jvm.precompute_target_motion_features(jp, jnp.asarray(video), SIZE))
    tf = vm.precompute_target_motion_features(tp, _nchw(video), SIZE)
    assert tf.shape == (2, 320, 32, 32) and not tf.requires_grad
    got = tf.numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - jf).max() / np.abs(jf).max() <= 1e-5
    # past the byte budget both return None (a pair is 320 * 32 * 32 * 4 bytes)
    assert vm.precompute_target_motion_features(tp, _nchw(video), SIZE, 320 * 1024 * 4) is None
    assert jvm.precompute_target_motion_features(jp, jnp.asarray(video), SIZE,
                                                 320 * 1024 * 4) is None
    with pytest.raises(ValueError, match=">= 2 target frames"):
        vm.precompute_target_motion_features(tp, _nchw(video[:1]), SIZE)


@pytest.mark.parametrize("appearance", ["OT", "SlW", "Gram"])
def test_loss_fn_with_tapped_frames_matches_jax(msoe_pair, frames, appearance):
    """The DyNCA loss function as the tapped trainer calls it: overflow, the
    appearance term on every tapped frame against one style target (one
    VGG16 call on the stacked frames), the video-motion term on precomputed
    target features. SlW's appearance draws differ between the packages
    (a torch.Generator against jax.random), so SlW is held to the per-frame
    loop of the same port function instead."""
    jp, tp = msoe_pair
    gen, tgt = frames
    arrays = np_vgg16(0)
    jvgg = [{k: jnp.asarray(v) for k, v in d.items()} for d in arrays]
    tvgg = vgg_from_jax(arrays, "cpu")
    kw = dict(overflow_weight=1.0, appearance_weight=1.0, appearance_loss_type=appearance,
              video_motion_weight=5.0, video_motion_loss_type="MotionOT",
              motion_img_size=SIZE)
    rng = np.random.RandomState(1)
    state = rng.uniform(-1.5, 1.5, (2, 32, 32, 8)).astype(np.float32)
    style = tgt[0]
    video = np.stack([t[0] for t in tgt])
    tfeats = vm.precompute_target_motion_features(tp, _nchw(video), SIZE)
    jfeats = jvm.precompute_target_motion_features(jp, jnp.asarray(video), SIZE)
    tstyle = _nchw(style)
    t_in = {"nca_state": _nchw(state), "generated_image_list": [_nchw(g) for g in gen],
            "generated_image_list_motion": [_nchw(g) for g in gen],
            "target_image_list": [tstyle] * 3,
            "target_motion_feature_list": [tfeats[0], tfeats[1]]}
    loss_fn = orch.make_loss_fn(orch.LossState(LossConfig(**kw), tvgg, tp))
    tl, tlogs = loss_fn(t_in, torch.Generator().manual_seed(0))
    if appearance == "SlW":
        one = orch.make_loss_fn(orch.LossState(LossConfig(**{**kw, "video_motion_weight": 0}),
                                               tvgg, tp))
        per = [one({**t_in, "generated_image_list": [g], "target_image_list": [tstyle]},
                   torch.Generator().manual_seed(0))[1]["appearance"] for g in t_in[
                       "generated_image_list"]]
        assert float(tlogs["appearance"]) > 0 and all(float(p) > 0 for p in per)
        return
    jstyle = jnp.asarray(style)
    j_in = {"nca_state": jnp.asarray(state),
            "generated_image_list": [jnp.asarray(g) for g in gen],
            "generated_image_list_motion": [jnp.asarray(g) for g in gen],
            "target_image_list": [jstyle] * 3,
            "target_motion_feature_list": [jfeats[0], jfeats[1]]}
    jfn = jorch.make_loss_fn(jorch.LossState(JLossConfig(**kw), jvgg, jp))
    jl, jlogs = jfn(j_in, jax.random.PRNGKey(0))
    print(f"\nloss_fn {appearance}: " + ", ".join(
        f"{k} {_rel(float(tlogs[k]), float(jlogs[k])):.1e}" for k in jlogs))
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert _rel(float(tlogs[k]), float(jlogs[k])) <= 1e-5, k
    assert _rel(float(tl), float(jl)) <= 1e-5


@pytest.mark.parametrize("case", [
    dict(),
    dict(medium_mt=0.3),
    dict(medium_mt=5.0),
    dict(medium_mt=1.0, img_size=128),
    dict(medium_mt=1.0, img_size=64),
    dict(medium_mt=1.0, img_name="flames"),
    dict(medium_mt=1.0, img_name="flames", nca_config_key="12-96"),
    dict(medium_mt=1.0, img_name="unknown_texture"),
    dict(loss_num=3.0),
    dict(loss_name="vector_field_motion", appearance_loss_log=[1.0, 7.0, 3.5, 100.0]),
])
def test_set_loss_weight_matches_jax(case):
    got = orch.set_loss_weight(LossConfig(), **case)
    want = jorch.set_loss_weight(JLossConfig(), **case)
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want))


def test_set_loss_weight_refuses_unknown():
    with pytest.raises(ValueError, match="unknown calibrated loss"):
        orch.set_loss_weight(LossConfig(), "content")


def test_tap_schedule_matches_jax():
    for step_n in list(range(80, 145)) + [1, 2, 9, 64, 65, 200]:
        for every in (64, 4, 1):
            got = dynca.tap_schedule(step_n, every)
            assert got == jdynca.tap_schedule(step_n, every), (step_n, every)
            assert sum(got[0]) + got[1] == step_n
    assert dynca.tap_schedule(144, 64) == ((1, 64, 64), 15)
    with pytest.raises(ValueError):
        dynca.tap_schedule(0, 64)


def test_get_start_frame_idx_matches_jax():
    """The same RandomState draws the same window starts, and leaves the
    same state behind."""
    for seed in range(5):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        for video_len, window in ((16, 3), (16, 2), (5, 5), (40, 7), (2, 2), (3, 9)):
            for _ in range(4):
                assert get_start_frame_idx(a, video_len, window) == j_start_idx(
                    b, video_len, window)
        for x, y in zip(a.get_state()[1:], b.get_state()[1:]):
            np.testing.assert_array_equal(x, y)


def test_preprocess_video_reads_a_gif(tmp_path):
    from PIL import Image

    from vsnca_tpu.data.preprocess import preprocess_video as j_preprocess_video

    rng = np.random.RandomState(2)
    imgs = [Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)) for _ in range(4)]
    path = str(tmp_path / "clip.gif")
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=40, loop=0)
    got = preprocess_video(path, (16, 16), max_frames=3)
    want = j_preprocess_video(path, (16, 16), max_frames=3)
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported video format"):
        preprocess_video(str(tmp_path / "clip.webm"))
    with pytest.raises(ValueError, match="no frames decoded"):
        preprocess_video(str(tmp_path / "missing.mp4"))
