"""The port's auxiliary, content, vector-field, style-consistency and
experimental losses, the full loss orchestrator and the data and ops helpers
they bring, against the JAX package on the CPU, on the same numpy inputs,
VGG16 arrays (``convert.vgg_from_jax``) and MSOE arrays
(``convert.msoe_from_jax``), at 32^2, where no OT term subsamples.

Tolerances: loss values and logs rtol 1e-5 (float32 sums in another order);
image gradients 1e-4 of the largest element (as the VGG16 gradients of
tests/test_torch_losses.py); MSOE flows rtol 1e-4 / atol 1e-5 of the
largest element; the target fields, the grayscale and the image folder
exactly (both numpy); ``grid_sample_bilinear`` atol 1e-5 (values in
[-1, 1]). The JAX side runs under ``jax.jit``. ``-s`` prints the measured
differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.data import preprocess as jpre
from vsnca_tpu.losses import auxiliary as jaux
from vsnca_tpu.losses import content as jcontent
from vsnca_tpu.losses import experimental as jexp
from vsnca_tpu.losses import orchestrator as jorch
from vsnca_tpu.losses import style_consistency as jsc
from vsnca_tpu.losses import vector_field as jvf
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu.ops import grid_sample as jgs
from vsnca_tpu_torch.config import LossConfig, NCAConfig
from vsnca_tpu_torch.convert import msoe_from_jax, params_from_jax, vgg_from_jax
from vsnca_tpu_torch.data import preprocess
from vsnca_tpu_torch.losses import orchestrator as orch
from vsnca_tpu_torch.losses.auxiliary import auxiliary_loss
from vsnca_tpu_torch.losses.content import content_loss
from vsnca_tpu_torch.losses.experimental import distill_style_loss
from vsnca_tpu_torch.losses.style_consistency import style_consistency_loss
from vsnca_tpu_torch.losses.vector_field import (
    get_motion_vector_field_by_name,
    vector_field_motion_loss,
)
from vsnca_tpu_torch.ops.grid_sample import grid_sample_bilinear

from test_torch_losses import np_vgg16

torch.set_num_threads(1)

FIELDS = ["0", "45", "-90", "grad_0_90", "grad_45_30", "hyperbolic", "circular", "circle",
          "converge", "diverge", "2block_x", "2block_y", "3block", "4block"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _scaled(got, want):
    """max |got - want| / max |want|."""
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _flow_field(jm, before, after):
    """The JAX MSOE flow of the first item of a pair, as a target field
    [1, H, W, 2]: a target the flow points along, so that the cosine gate
    lets the strength term through (a random pair against a synthetic
    field scores a mean cosine below 0, which closes the gate)."""
    pair = jmsoe.motion_pair_from_rgb(jnp.asarray(before), jnp.asarray(after), (32, 32))
    flow = np.asarray(jmsoe.msoe_forward(jm, pair))[:1]
    return flow + 0.1 * np.random.RandomState(11).randn(*flow.shape).astype(np.float32)


@pytest.fixture(scope="module")
def vgg_pair():
    arrays = np_vgg16(0)
    return [{k: jnp.asarray(v) for k, v in d.items()} for d in arrays], vgg_from_jax(arrays,
                                                                                   "cpu")


@pytest.fixture(scope="module")
def msoe_pair():
    jp = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    return jp, msoe_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def test_content_loss_matches_jax(vgg_pair):
    jp, tp = vgg_pair
    rng = np.random.RandomState(0)
    gen, tgt = rng.rand(2, 2, 32, 32, 3).astype(np.float32)
    f = jax.jit(jax.value_and_grad(lambda p, g, t: jcontent.content_loss(p, g, t), argnums=1))
    want, jgrad = f(jp, jnp.asarray(gen), jnp.asarray(tgt))
    x = _nchw(gen).requires_grad_()
    got = content_loss(tp, x, _nchw(tgt))
    got.backward()
    jg = np.asarray(jgrad).transpose(0, 3, 1, 2)
    print(f"\ncontent loss rel diff {_rel(got, want):.1e}, image gradient "
          f"{_scaled(x.grad.numpy(), jg):.1e}")
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert _scaled(x.grad.numpy(), jg) <= 1e-4


@pytest.mark.parametrize("tgt_size", [32, 24])
@pytest.mark.parametrize("loss_type", ["MSE", "VGG", "OT", "Gram"])
def test_auxiliary_loss_matches_jax(vgg_pair, loss_type, tgt_size):
    """Value and gradient w.r.t. the generated frames; a 24^2 target is
    resized to the generated 32^2."""
    jp, tp = vgg_pair
    rng = np.random.RandomState(1)
    gen = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, tgt_size, tgt_size, 3)).astype(np.float32)
    f = jax.jit(jax.value_and_grad(
        lambda p, g, t: jaux.auxiliary_loss(p, g, t, loss_type, jax.random.PRNGKey(0)),
        argnums=1))
    want, jgrad = f(jp, jnp.asarray(gen), jnp.asarray(tgt))
    x = _nchw(gen).requires_grad_()
    got = auxiliary_loss(tp, x, _nchw(tgt), loss_type, torch.Generator().manual_seed(0))
    got.backward()
    err = _scaled(x.grad.numpy(), np.asarray(jgrad).transpose(0, 3, 1, 2))
    print(f"\nauxiliary {loss_type} target {tgt_size}^2: value rel diff "
          f"{_rel(got, want):.1e}, image gradient {err:.1e}")
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert err <= 1e-4
    with pytest.raises(ValueError, match="unknown auxiliary loss type"):
        auxiliary_loss(tp, x, _nchw(tgt), "L1")


@pytest.mark.parametrize("size", [(16, 16), (17, 15)])
def test_motion_vector_fields_match_jax_exactly(size):
    for name in FIELDS:
        want = np.asarray(jvf.get_motion_vector_field_by_name(name, size))
        got = get_motion_vector_field_by_name(name, size)
        assert got.dtype == torch.float32 and tuple(got.shape) == (1, 2) + size
        np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2), err_msg=name)
    with pytest.raises(ValueError, match="unknown motion vector field"):
        get_motion_vector_field_by_name("spiral", size)


@pytest.mark.parametrize("strength,direction,field", [(0.5, 0.5, "circular"),
                                                      (15.0, 10.0, "flow"), (15.0, 0.0, "flow")])
def test_vector_field_motion_loss_matches_jax(msoe_pair, strength, direction, field):
    """Loss, the strength and direction logs, the flow, and the gradient
    w.r.t. the frame after the step; against the circular field (the
    centre cell's zero vector meets the eps of the cosine's denominator)
    and against a field along the flow (the strength term open)."""
    jm, tm = msoe_pair
    rng = np.random.RandomState(2)
    before = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    after = np.clip(before + 0.2 * rng.randn(2, 32, 32, 3), -1, 1).astype(np.float32)
    if field == "flow":
        jfield = jnp.asarray(_flow_field(jm, before, after))
        tfield = _nchw(np.asarray(jfield))
    else:
        jfield = jvf.get_motion_vector_field_by_name(field, (32, 32))
        tfield = get_motion_vector_field_by_name(field, (32, 32))

    def jloss(m, b, a):
        loss, logs, flow = jvf.vector_field_motion_loss(m, b, a, jfield, jnp.float32(9.0), 24,
                                                        (32, 32), strength, direction)
        return loss, (logs, flow)

    (want, (jlogs, jflow)), jgrad = jax.jit(jax.value_and_grad(jloss, argnums=2,
                                                               has_aux=True))(
        jm, jnp.asarray(before), jnp.asarray(after))
    x = _nchw(after).requires_grad_()
    got, logs, flow = vector_field_motion_loss(
        tm, _nchw(before), x, tfield, 9, 24, (32, 32), strength, direction)
    got.backward()
    err = _scaled(x.grad.numpy(), np.asarray(jgrad).transpose(0, 3, 1, 2))
    jf = np.asarray(jflow).transpose(0, 3, 1, 2)
    print(f"\nvector field ({strength}, {direction}, {field}): loss {float(want):.4f}, rel diff "
          f"{_rel(got, want):.1e}, logs {({k: float(v) for k, v in logs.items()})}, flow "
          f"{_scaled(flow.detach().numpy(), jf):.1e}, image gradient {err:.1e}")
    assert float(want) > 0
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert set(logs) == set(jlogs)
    for k in logs:
        assert float(logs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5), k
    np.testing.assert_allclose(flow.detach().numpy() / np.abs(jf).max(), jf / np.abs(jf).max(),
                               rtol=1e-4, atol=1e-5)
    assert err <= 1e-4


def _edge_cells(**kw):
    """(JAX, port) NCAConfigs of a narrow edges cell and a narrow
    ExtraChannels cell, zero seeds, update rate 1."""
    base = dict(fc_dim=16, padding_mode="circular", update_rate=1.0, seed_mode="zeros", **kw)
    cells = {"edges": dict(c_in=12, conditioning="edges", edge_transform="none"),
             "extra_channels": dict(c_in=13, seed_channels=12, conditioning=None)}
    return {k: (JNCAConfig(**base, **v), NCAConfig(**base, **v)) for k, v in cells.items()}


@pytest.mark.parametrize("cell", ["edges", "extra_channels"])
def test_style_consistency_matches_jax_and_has_no_gradient(cell):
    """A zero seed grown 32 steps (the extra channel filled with the
    content's grayscale) against the style target; the port's value carries
    no gradient although the parameters require one."""
    jcfg, cfg = _edge_cells()[cell]
    params = jdynca.dynca_init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.RandomState(3)
    style = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    gray = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    want = jax.jit(lambda p, s, c: jsc.style_consistency_loss(p, jcfg, s, jax.random.PRNGKey(5),
                                                              32, c))(
        params, jnp.asarray(style), jnp.asarray(gray))
    tp = {k: v.requires_grad_() for k, v in
          params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu").items()}
    got = style_consistency_loss(tp, cfg, _nchw(style), torch.Generator().manual_seed(5), 32,
                                 _nchw(gray))
    print(f"\nstyle consistency {cell}: rel diff {_rel(got, want):.1e}")
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert not got.requires_grad and got.grad_fn is None


def test_full_orchestrator_matches_jax(vgg_pair, msoe_pair):
    """Every term of LossConfig on at once (overflow, auxiliary VGG,
    vector-field motion, OT appearance, MotionOT video motion, content,
    style consistency), on the same input dict, through JAX's ``loss_fn``."""
    jp, tp = vgg_pair
    jm, tm = msoe_pair
    jcfg, cfg = _edge_cells()["edges"]
    weights = dict(overflow_weight=1000.0, appearance_weight=1.0, appearance_loss_type="OT",
                   auxiliary_weight=10.0, auxiliary_loss_type="VGG",
                   vector_field_motion_weight=1.0, video_motion_weight=5.0,
                   video_motion_loss_type="MotionOT", content_weight=2.0,
                   style_consistency_weight=3.0, motion_img_size=(32, 32))
    params = jdynca.dynca_init(jax.random.PRNGKey(6), jcfg)
    rng = np.random.RandomState(7)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    arrays = dict(state=1.2 * u(2, 32, 32, 12), gen=u(2, 32, 32, 3), before=u(2, 32, 32, 3),
                  style=u(2, 32, 32, 3), aux=u(2, 32, 32, 3), m0=u(2, 32, 32, 3),
                  t0=u(2, 32, 32, 3), t1=u(2, 32, 32, 3))
    gray = arrays["aux"].mean(-1, keepdims=True)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jinputs = {"nca_state": j["state"], "generated_image_list": [j["gen"]],
               "target_image_list": [j["style"]], "auxillary_image_list": [j["aux"]],
               "content_image": j["aux"], "generated_image_before_nca": j["before"],
               "generated_image_after_nca": j["gen"], "step_n": jnp.float32(9.0),
               "generated_image_list_motion": [j["m0"], j["gen"]],
               "target_motion_image_list": [j["t0"], j["t1"]], "nca_params": params,
               "style_consistency_cond_img": jnp.asarray(gray)}
    field = _flow_field(jm, arrays["before"], arrays["gen"])
    jfn = jorch.make_loss_fn(jorch.LossState(cfg=JLossConfig(**weights), vgg_params=jp,
                                             msoe_params=jm, target_field=jnp.asarray(field),
                                             nca_cfg=jcfg))
    want, jlogs = jax.jit(jfn)(jinputs, jax.random.PRNGKey(0))
    t = {k: _nchw(v) for k, v in arrays.items()}
    inputs = {"nca_state": t["state"], "generated_image_list": [t["gen"]],
              "target_image_list": [t["style"]], "auxillary_image_list": [t["aux"]],
              "content_image": t["aux"], "generated_image_before_nca": t["before"],
              "generated_image_after_nca": t["gen"], "step_n": 9,
              "generated_image_list_motion": [t["m0"], t["gen"]],
              "target_motion_image_list": [t["t0"], t["t1"]],
              "nca_params": params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
              "style_consistency_cond_img": _nchw(gray)}
    state = orch.LossState(cfg=LossConfig(**weights), vgg_params=tp, msoe_params=tm,
                           target_field=_nchw(field), nca_cfg=cfg)
    got, logs = orch.make_loss_fn(state)(inputs, torch.Generator().manual_seed(0))
    print("\nfull orchestrator: total rel diff "
          f"{_rel(got, want):.1e}; logs " + ", ".join(
              f"{k} {float(v):.4g} ({_rel(v, jlogs[k]):.1e})" for k, v in logs.items()))
    assert all(float(v) > 0 for v in logs.values())
    assert set(logs) == set(jlogs) == {
        "overflow", "auxillary", "vector_field_motion", "vector_field_motion-strength",
        "vector_field_motion-direction", "appearance", "video_motion", "content",
        "style_consistency"}
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for k in logs:
        assert float(logs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5), k


def test_distill_style_loss_matches_jax(vgg_pair):
    """Without a subsample (every tap's pixels) against JAX; with one, the
    same value for the same generator and a finite value."""
    jp, tp = vgg_pair
    rng = np.random.RandomState(8)
    gen, tgt = rng.rand(2, 2, 32, 32, 3).astype(np.float32)
    want = jax.jit(lambda p, g, t: jexp.distill_style_loss(p, g, t, jax.random.PRNGKey(0),
                                                           4096))(
        jp, jnp.asarray(gen), jnp.asarray(tgt))
    got = distill_style_loss(tp, _nchw(gen), _nchw(tgt), torch.Generator().manual_seed(0), 4096)
    print(f"\ndistill style loss: rel diff {_rel(got, want):.1e}")
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    sub = [float(distill_style_loss(tp, _nchw(gen), _nchw(tgt),
                                    torch.Generator().manual_seed(1), 300)) for _ in range(2)]
    assert sub[0] == sub[1] and np.isfinite(sub[0])


def test_grid_sample_bilinear_matches_jax_and_torch():
    rng = np.random.RandomState(9)
    imgs = rng.uniform(-1, 1, (2, 7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    want = np.asarray(jgs.grid_sample_bilinear(jnp.asarray(imgs), jnp.asarray(grid)))
    got = grid_sample_bilinear(_nchw(imgs), torch.from_numpy(grid))
    ref = F.grid_sample(_nchw(imgs), torch.from_numpy(grid), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    assert tuple(got.shape) == (2, 3, 5, 6)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_preprocess_helpers_match_jax(tmp_path, vgg_pair, msoe_pair):
    """``preprocess_target_images`` on a folder of PNGs, the channel-mean
    grayscale, the flow strengths, the VGG-median frame and the
    appearance-frame choice."""
    from PIL import Image

    rng = np.random.RandomState(10)
    paths = []
    for i, shape in enumerate(((20, 24, 3), (24, 20, 3), (16, 16, 3))):
        p = tmp_path / f"frame{i}.png"
        Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8)).save(p)
        paths.append(str(p))
    got = preprocess.preprocess_target_images(paths, (16, 16))
    np.testing.assert_array_equal(got, jpre.preprocess_target_images(paths, (16, 16)))
    np.testing.assert_array_equal(preprocess.preprocess_target_images(paths, (16, 16), True),
                                  jpre.preprocess_target_images(paths, (16, 16), True))
    np.testing.assert_array_equal(preprocess.rgb_to_grayscale_mean(got),
                                  jpre.rgb_to_grayscale_mean(got))

    jp, tp = vgg_pair
    jm, tm = msoe_pair
    base = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    video = np.stack([np.roll(base, s, axis=1) for s in (0, 1, 4, 5)])
    want = jpre.compute_flow_strengths(jm, video)
    strengths = preprocess.compute_flow_strengths(tm, _nchw(video))
    np.testing.assert_allclose(strengths, want, rtol=1e-4)
    assert preprocess.select_appearance_frame(strengths) == jpre.select_appearance_frame(want)
    seq = np.concatenate([video[:2], rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)])
    assert (preprocess.select_frame_by_vgg_median(tp, _nchw(seq))
            == jpre.select_frame_by_vgg_median(jp, seq))
