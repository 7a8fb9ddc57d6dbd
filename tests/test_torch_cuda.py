"""The CUDA kernels on the card, against their plain PyTorch versions: the
rollout step (``csrc/nca_step.cu``), the two backward kernels of the
training pair (``csrc/nca_train.cu``), the whole pair, and a train step;
the ConditionedNCA kernels (``csrc/nca_cnca.cu``), their pair, the grow
routes and the grower.

Needs a CUDA device and nvcc; every test skips without a card (the kernels
have no CPU mode). This file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-4 / atol 1e-5 (summation order of the MLP);
bfloat16 rtol 1e-3 / atol 1e-3 (same rounding places; one float32 ulp can
flip a bf16 rounding). Masks are bit-identical, so rate < 1 is held to the
same tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.infer.stylize import VideoStylizer
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda

TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "edges", "pos_emb"])
@pytest.mark.parametrize("pad_mode", ["circular", "replicate", "zeros"])
def test_kernel_matches_plain(cuda, pad_mode, conditioning, compute_dtype):
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode=pad_mode, conditioning=conditioning)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((2, 12, 19, 37), generator=g) - 0.5).to(cuda)
    cond = None
    if conditioning:
        cond = (torch.rand((2, cfg.c_cond, 19, 37), generator=g) - 0.5).to(cuda)
    before = fs.LAUNCHES
    got = fs.fused_rollout_chw(params, x, 3, cfg, 5, cond, 0.5, compute_dtype)
    assert fs.LAUNCHES == before + 5
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 5, cond, 0.5, compute_dtype)
    torch.testing.assert_close(got, want, **TOL[compute_dtype])


@pytest.mark.parametrize("c_in,fc_dim", [(1, 4), (16, 128), (5, 30)])
def test_kernel_widths(cuda, c_in, fc_dim):
    """The smallest and largest widths the kernel takes, and an odd pair
    (F padded to a multiple of 4)."""
    cfg = NCAConfig(c_in=c_in, fc_dim=fc_dim, padding_mode="circular")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    x = (torch.rand((1, c_in, 33, 17), generator=torch.Generator().manual_seed(1))
         - 0.5).to(cuda)
    got = fs.fused_rollout_chw(params, x, 9, cfg, 3)
    want = fs.fused_rollout_chw_reference(params, x, 9, cfg, 3)
    torch.testing.assert_close(got, want, **TOL["float32"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernel_at_c13_without_conditioning_matches_plain(cuda, compute_dtype):
    """The trainers' vector-field pre-roll at the extra_channels cell: 13
    channels (a percept of 52 rows, not a multiple of the tensor-core
    form's depth blocks of 16), no conditioning, batch 2."""
    cfg = NCAConfig(c_in=13, seed_channels=12, fc_dim=96, padding_mode="circular")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    x = (torch.rand((2, 13, 40, 72), generator=torch.Generator().manual_seed(1))
         - 0.5).to(cuda)
    got = fs.fused_rollout_chw(params, x, 3, cfg, 4, None, 0.5, compute_dtype)
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 4, None, 0.5, compute_dtype)
    torch.testing.assert_close(got, want, **TOL[compute_dtype])


def test_kernel_refuses_sizes_past_its_limits(cuda):
    cfg = NCAConfig(c_in=17, fc_dim=8)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    with pytest.raises(ValueError, match="kernel limits"):
        fs.fused_rollout_chw(params, torch.zeros((1, 17, 8, 8), device=cuda), 0, cfg, 1)


def _train_case(cuda, conditioning, shape, seed=0):
    cfg = NCAConfig(c_in=shape[1], fc_dim=96, padding_mode="circular",
                    conditioning=conditioning)
    params = dynca.dynca_init(torch.Generator().manual_seed(seed), cfg, device=cuda)
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.rand(shape, generator=g) - 0.5).to(cuda)
    gy = torch.randn(shape, generator=g).to(cuda)
    cond = None
    if conditioning:
        b, _, h, w = shape
        cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(cuda)
    return cfg, params, x, gy, cond


# Backward tolerances, relative to the largest element of the plain
# version's output: float32 1e-5 (summation order: the kernel sums the
# weight gradients per 256-pixel block, then over blocks); bfloat16 5e-3
# (one float32 ulp before a bf16 rounding moves the value by 2^-8, as on
# the CPU against JAX).
TRAIN_TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _close(got, want, tol):
    scale = float(want.abs().max()) + 1e-12
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "edges", "pos_emb"])
def test_backward_kernels_match_plain(cuda, conditioning, compute_dtype):
    """One step of each backward kernel at rate 0.5, ragged 19 x 37."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gx, cond = _train_case(cuda, conditioning, (2, 12, 19, 37))
    packed = fs.pack_weights(params, 12, cfg.c_cond, compute_dtype)
    args = (packed, x, cond, gx, 3, 5, 0.5, compute_dtype, cond is not None)
    before = dict(ft.KERNEL_LAUNCHES)
    got = ft.nca_bwd_mlp(*args)
    want = ft.nca_bwd_mlp_reference(*args)
    assert ft.KERNEL_LAUNCHES["nca_bwd_mlp"] == before["nca_bwd_mlp"] + 1
    for a, b in zip(got, want):
        if b is not None:
            _close(a, b, TRAIN_TOL[compute_dtype])
    _close(ft.nca_bwd_adjoint(want[0], gx), ft.nca_bwd_adjoint_reference(want[0], gx),
           TRAIN_TOL["float32"])
    assert ft.KERNEL_LAUNCHES["nca_bwd_adjoint"] == before["nca_bwd_adjoint"] + 1


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_training_pair_matches_plain(cuda, compute_dtype):
    """The whole pair (forward through nca_step, backward through both
    kernels) against its plain version: 4 steps at rate 0.5, pos_emb with
    its cotangent, launches n + 2n."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gy, cond = _train_case(cuda, "pos_emb", (2, 12, 24, 40))
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, cr = x.clone().requires_grad_(), cond.clone().requires_grad_()
    before = ft.LAUNCHES
    y = ft.fused_rollout_train(p, xr, 9, cfg, 4, cr, compute_dtype=compute_dtype)
    (y * gy).sum().backward()
    assert ft.LAUNCHES == before + 12
    want_y, grads, dx0, dcond = ft.fused_rollout_train_reference(
        params, x, 9, cfg, 4, cond, gy, compute_dtype=compute_dtype, need_dcond=True)
    tol = TRAIN_TOL[compute_dtype]
    _close(y.detach(), want_y, TOL[compute_dtype]["atol"])
    for k in grads:
        _close(p[k].grad, grads[k], tol)
    _close(xr.grad, dx0, tol)
    _close(cr.grad, dcond, tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 13, 24, 40), (2, 13, 40, 72)])
def test_training_pair_at_c13_without_conditioning_matches_plain(cuda, shape, compute_dtype):
    """The extra_channels cell's pair: 13 channels (a percept of 52 rows,
    not a multiple of nca_bwd_mlp's depth blocks of 16), no conditioning,
    4 steps at rate 0.5; launches n + 2n."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg = NCAConfig(c_in=13, seed_channels=12, fc_dim=96, padding_mode="circular")
    params = dynca.dynca_init(torch.Generator().manual_seed(3), cfg, device=cuda)
    g = torch.Generator().manual_seed(4)
    x = (torch.rand(shape, generator=g) - 0.5).to(cuda)
    gy = torch.randn(shape, generator=g).to(cuda)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr = x.clone().requires_grad_()
    before = ft.LAUNCHES
    y = ft.fused_rollout_train(p, xr, 9, cfg, 4, None, 0.5, compute_dtype)
    (y * gy).sum().backward()
    assert ft.LAUNCHES == before + 12
    want_y, grads, dx0, _ = ft.fused_rollout_train_reference(
        params, x, 9, cfg, 4, None, gy, 0.5, compute_dtype)
    tol = TRAIN_TOL[compute_dtype]
    _close(y.detach(), want_y, TOL[compute_dtype]["atol"])
    for k in grads:
        _close(p[k].grad, grads[k], tol)
    _close(xr.grad, dx0, tol)


def test_dynca_rollout_takes_the_kernels_on_the_card(cuda):
    """``dynca_rollout`` on a CUDA tensor: with a gradient the training pair
    (n forward + 2n backward launches), without one the rollout kernel (n
    launches, no pair), both equal to the plain version; a circular
    multiscale config with a gradient raises instead of running plain
    steps on the card."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gy, cond = _train_case(cuda, "pos_emb", (2, 12, 24, 40))
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = (ft.LAUNCHES, fs.LAUNCHES)
    y, _ = dynca.dynca_rollout(p, x, 9, cfg, 4, cond)
    (y * gy).sum().backward()
    assert (ft.LAUNCHES, fs.LAUNCHES) == (before[0] + 12, before[1] + 4)
    with torch.no_grad():
        y2, _ = dynca.dynca_rollout(p, x, 9, cfg, 4, cond)
    assert (ft.LAUNCHES, fs.LAUNCHES) == (before[0] + 12, before[1] + 8)
    want = fs.fused_rollout_chw_reference(params, x, 9, cfg, 4, cond)
    _close(y.detach(), want, TOL["float32"]["atol"])
    _close(y2, want, TOL["float32"]["atol"])
    ms = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", perception_scales=(0, 1))
    pm = {k: v.requires_grad_() for k, v in
          dynca.dynca_init(torch.Generator().manual_seed(0), ms, device=cuda).items()}
    before = dict(ft.KERNEL_LAUNCHES)
    y3, _ = dynca.dynca_rollout(pm, x, 9, ms, 4)
    y3.square().sum().backward()
    assert ft.KERNEL_LAUNCHES["nca_step_ms"] == before["nca_step_ms"] + 4
    assert ft.KERNEL_LAUNCHES["nca_bwd_adjoint_ms"] == before["nca_bwd_adjoint_ms"] + 4
    _close(y3.detach(), fs.fused_rollout_chw_reference(
        {k: v.detach() for k, v in pm.items()}, x, 9, ms, 4), TOL["float32"]["atol"])


def test_train_kernel_limits_match_the_python_rule(cuda):
    from vsnca_tpu_torch.ops import fused_train as ft

    assert ft.train_kernel_limits() == (ft.C_MAX, ft.CC_MAX, ft.F_MAX) == fs.kernel_limits()


def test_train_step_on_card_matches_cpu(cuda):
    """One static_texture-shaped train step (overflow + Gram on full VGG16)
    through the kernels against the same step on the CPU, float32, 32^2,
    update rate 1: loss rtol 1e-4, updated parameters atol 5e-5 (5 % of one
    Adam update, whose first step lr * g / (|g| + 1e-8) amplifies rounding
    where a normalized gradient is near 1e-8; see tests/test_torch_trainer.py)."""
    from vsnca_tpu_torch.config import LossConfig
    from vsnca_tpu_torch.losses.orchestrator import LossState
    from vsnca_tpu_torch.models.vgg import vgg16_random_init
    from vsnca_tpu_torch.train.optim import make_optimizer
    from vsnca_tpu_torch.train.trainer import make_train_step

    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="pos_emb",
                    update_rate=1.0)
    loss_cfg = LossConfig(overflow_weight=100.0, appearance_weight=1.0,
                          appearance_loss_type="Gram")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    vgg = vgg16_random_init(torch.Generator().manual_seed(16), device="cpu")
    g = torch.Generator().manual_seed(1)
    states = torch.rand((2, 12, 32, 32), generator=g) - 0.5
    style = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    out = {}
    for dev in ("cpu", cuda):
        p = {k: v.detach().clone().to(dev).requires_grad_() for k, v in params.items()}
        vg = [{k: v.to(dev) for k, v in d.items()} for d in vgg]
        step = make_train_step(cfg, LossState(cfg=loss_cfg, vgg_params=vg), "none", "auto")
        _, _, new_states, loss, _ = step(p, make_optimizer(p, 1e-3), states.to(dev), 4,
                                         {"target_style": style.to(dev)}, step_n=8)
        out[str(dev)] = (float(loss), {k: v.detach().cpu() for k, v in p.items()},
                         new_states.cpu())
    (lc, pc, sc), (lg, pg, sg) = out["cpu"], out["cuda"]
    assert lg == pytest.approx(lc, rel=1e-4)
    for k in pc:
        torch.testing.assert_close(pg[k], pc[k], rtol=0, atol=5e-5)
    torch.testing.assert_close(sg, sc, **TOL["float32"])


def test_edge_conditioned_train_step_on_card_matches_cpu(cuda):
    """One edge_conditioned train step at full width (c12/fc96, edges; OT
    appearance, auxiliary VGG, vector-field motion, overflow; full VGG16 and
    MSOE from their seeded fallbacks) through the kernels against the same
    step on the CPU, float32, 32^2, update rate 1, with the tolerances of
    test_train_step_on_card_matches_cpu; on the card the training pair
    runs step_n steps and the pre-roll one launch of the tensor-core step.
    The target field lies along the MSOE flow of the first item's frames
    (scaled by 1 + 0.2 x noise), so that the cosine gate lets the
    vector-field term's strength part through and its value and gradient
    are held too."""
    from vsnca_tpu_torch.losses.orchestrator import LossState
    from vsnca_tpu_torch.models.msoe import (
        motion_pair_from_rgb,
        msoe_forward,
        msoe_random_init,
    )
    from vsnca_tpu_torch.models.vgg import vgg16_random_init
    from vsnca_tpu_torch.ops import fused_train as ft
    from vsnca_tpu_torch.train.optim import make_optimizer
    from vsnca_tpu_torch.train.presets import edge_conditioned
    from vsnca_tpu_torch.train.trainer import make_train_step

    nca, loss_cfg, _ = edge_conditioned(32)
    cfg = dataclasses.replace(nca, update_rate=1.0)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    vgg = vgg16_random_init(torch.Generator().manual_seed(16), device="cpu")
    msoe = msoe_random_init(torch.Generator().manual_seed(175), device="cpu")
    g = torch.Generator().manual_seed(1)
    states = torch.rand((2, 12, 32, 32), generator=g) - 0.5
    style = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    aux = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    cond = dynca.make_conditioning(cfg, (32, 32), cond_img=aux.mean(dim=1, keepdim=True),
                                   batch=2, device="cpu")
    with torch.no_grad():
        pre, _ = dynca.dynca_rollout(params, states, 0, cfg, 1, cond, rollout_path="xla")
        _, after = dynca.dynca_rollout(params, states, 0, cfg, 8, cond, rollout_path="xla")
        flow = msoe_forward(msoe, motion_pair_from_rgb(dynca.to_rgb(pre), after, (32, 32)))[:1]
    noise = np.random.RandomState(11).randn(*flow.shape).astype(np.float32)
    field = flow * (1.0 + 0.2 * torch.from_numpy(noise))
    out = {}
    for dev in ("cpu", cuda):
        p = {k: v.detach().clone().to(dev).requires_grad_() for k, v in params.items()}
        state = LossState(cfg=loss_cfg, vgg_params=[{k: v.to(dev) for k, v in d.items()}
                                                    for d in vgg],
                          msoe_params={k: v.to(dev) for k, v in msoe.items()},
                          target_field=field.to(dev))
        step = make_train_step(cfg, state, "none", "auto")
        inputs = {"target_style": style.to(dev), "aux_imgs": aux.to(dev),
                  "aux_gs": aux.to(dev).mean(dim=1, keepdim=True)}
        before = (dict(ft.KERNEL_LAUNCHES), dict(fs.KERNEL_LAUNCHES))
        _, _, new_states, loss, logs = step(p, make_optimizer(p, 1e-3), states.to(dev), 4,
                                            inputs, step_n=8)
        out[str(dev)] = (float(loss), {k: v.detach().cpu() for k, v in p.items()},
                         new_states.cpu(), {k: float(v) for k, v in logs.items()})
    assert {k: ft.KERNEL_LAUNCHES[k] - before[0][k]
            for k in ("nca_step", "nca_bwd_mlp", "nca_bwd_adjoint")} == dict.fromkeys(
        ("nca_step", "nca_bwd_mlp", "nca_bwd_adjoint"), 8)
    assert fs.KERNEL_LAUNCHES["nca_step"] - before[1]["nca_step"] == 1
    (lc, pc, sc, gc), (lg, pg, sg, gg) = out["cpu"], out["cuda"]
    assert set(gg) == set(gc) >= {"auxillary", "vector_field_motion", "appearance"}
    assert gc["vector_field_motion-strength"] > 0
    assert lg == pytest.approx(lc, rel=1e-4)
    assert gg == pytest.approx(gc, rel=1e-4, abs=1e-6)
    for k in pc:
        torch.testing.assert_close(pg[k], pc[k], rtol=0, atol=5e-5)
    torch.testing.assert_close(sg, sc, **TOL["float32"])


def test_stylizer_on_card_matches_cpu(cuda):
    """The whole stylizer through the kernel against the CPU path, float32."""
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    frames = np.random.RandomState(3).uniform(-1, 1, (2, 1, 40, 24, 3)).astype(np.float32)
    on = VideoStylizer(params, cfg, (40, 24), step_n=8, device=cuda,
                       compute_dtype="float32")
    off = VideoStylizer(params, cfg, (40, 24), step_n=8, device="cpu",
                        compute_dtype="float32")
    for f in frames:
        torch.testing.assert_close(on.step_frame(f).cpu(), off.step_frame(f), **TOL["float32"])
    torch.testing.assert_close(on.state.cpu(), off.state, **TOL["float32"])


# ---------------------------------------------------------------- ConditionedNCA


def _cnca_case(cuda, rate=0.5, use_life=True, shape=(2, 24, 40), hidden=16, d=64, seed=0):
    from vsnca_tpu_torch.config import ConditionedNCAConfig
    from vsnca_tpu_torch.models import conditioned_nca as cn

    b, h, w = shape
    cfg = ConditionedNCAConfig(image_size=w, num_hidden_channels=hidden, update_hidden_dim=d,
                               cell_fire_rate=rate, use_living_channel=use_life)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(seed), cfg, device=cuda)
    g = torch.Generator().manual_seed(seed + 1)
    c = cfg.num_channels
    x = torch.zeros((b, c, h, w))
    x[:, cfg.alive_channel:, h // 2, w // 2] = 1.0
    x = (x + 0.3 * torch.randn((b, c, h, w), generator=g)).to(cuda)
    goal = (0.3 * torch.randn((b, c, h, w), generator=g)).to(cuda)
    return cfg, params, x, goal


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,use_life", [(1.0, True), (0.5, True), (0.5, False)])
def test_cnca_rollout_kernels_match_plain(cuda, rate, use_life, compute_dtype):
    """cnca_update + cnca_gate, 6 steps on a ragged 24 x 40 grid, against the
    plain version; two launches a step."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    cfg, params, x, goal = _cnca_case(cuda, rate, use_life)
    before = dict(fc.KERNEL_LAUNCHES)
    got = fc.fused_cnca_rollout(params, x, goal, 3, cfg, 6, compute_dtype)
    want = fc.fused_cnca_rollout_reference(params, x, goal, 3, cfg, 6, compute_dtype)
    assert fc.KERNEL_LAUNCHES["cnca_update"] == before["cnca_update"] + 6
    assert fc.KERNEL_LAUNCHES["cnca_gate"] == before["cnca_gate"] + 6
    _close(got, want, TRAIN_TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_life", [True, False])
def test_cnca_backward_kernels_match_plain(cuda, use_life, compute_dtype):
    """One launch each of cnca_bwd_mlp and cnca_bwd_adjoint at rate 0.5 on a
    ragged 19 x 37 grid, against their plain versions."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    cfg, params, x, goal = _cnca_case(cuda, 0.5, use_life, shape=(2, 19, 37))
    packed = fc.pack_weights(params, cfg, compute_dtype)
    _, life = fc.cnca_step_reference(x, goal, packed, cfg, compute_dtype, 3, 5, 0.5)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    args = (packed, x, goal, life, gy, cfg, compute_dtype, 3, 5, 0.5)
    g_xn, gp, sums = fc.cnca_bwd_mlp(*args)
    w_xn, w_gp, w_sums = fc.cnca_bwd_mlp_reference(*args)
    for a, b in zip((g_xn, gp, *sums), (w_xn, w_gp, *w_sums)):
        _close(a, b, TRAIN_TOL[compute_dtype])
    got = fc.cnca_bwd_adjoint(x, w_gp, w_xn, packed[0], cfg)
    want = fc.cnca_bwd_adjoint_reference(x, w_gp, w_xn, packed[0], cfg)
    for a, b in zip(got, want):
        _close(a, b, TRAIN_TOL["float32"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cnca_training_pair_matches_plain(cuda, compute_dtype):
    """The whole pair at the reference widths, 64^2 batch 2, 7 steps, rate
    0.5: state, every gradient, x's and the goal's; launches 2n + 2n."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    cfg, params, x, goal = _cnca_case(cuda, 0.5, True, shape=(2, 64, 64))
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)).to(cuda)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, gr = x.clone().requires_grad_(), goal.clone().requires_grad_()
    before = fc.LAUNCHES
    y = fc.fused_cnca_train(p, xr, gr, 9, cfg, 7, compute_dtype)
    (y * gy).sum().backward()
    assert fc.LAUNCHES == before + 28
    want_y, grads, dx0, dgoal = fc.fused_cnca_train_reference(params, x, goal, 9, cfg, 7, gy,
                                                              compute_dtype)
    tol = TRAIN_TOL[compute_dtype]
    _close(y.detach(), want_y, tol)
    for k in fc.WEIGHT_KEYS:
        _close(p[k].grad, grads[k], tol)
    _close(xr.grad, dx0, tol)
    _close(gr.grad, dgoal, tol)


def test_cnca_grow_and_grower_take_the_kernels_on_the_card(cuda):
    """conditioned_nca_grow on a CUDA tensor: the pair with a gradient, the
    rollout kernels without; the grower's step(n) launches 2n for n = 1 and
    n = 5, and matches the grower on the CPU."""
    from vsnca_tpu_torch.infer.grower import InteractiveGrower
    from vsnca_tpu_torch.models import conditioned_nca as cn
    from vsnca_tpu_torch.ops import fused_cnca as fc

    cfg, params, x, _ = _cnca_case(cuda, 0.5, True, shape=(2, 32, 32))
    goal_img = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(4)).to(cuda)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    k0 = dict(fc.KERNEL_LAUNCHES)
    cn.conditioned_nca_grow(p, x, goal_img, 5, cfg, 4).square().sum().backward()
    assert fc.KERNEL_LAUNCHES["cnca_bwd_mlp"] == k0["cnca_bwd_mlp"] + 4
    assert all(v.grad is not None for v in p.values())
    with torch.no_grad():
        cn.conditioned_nca_grow(p, x, goal_img, 5, cfg, 4)
    assert fc.KERNEL_LAUNCHES["cnca_update"] == k0["cnca_update"] + 8
    assert fc.KERNEL_LAUNCHES["cnca_bwd_mlp"] == k0["cnca_bwd_mlp"] + 4

    goal = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    on = InteractiveGrower(params, cfg, goal, size=32, device=cuda)
    off = InteractiveGrower({k: v.cpu() for k, v in params.items()}, cfg, goal, size=32,
                            device="cpu")
    for n in (1, 5):
        before = fc.KERNEL_LAUNCHES["cnca_update"]
        a, b = on.step(n), off.step(n)
        assert fc.KERNEL_LAUNCHES["cnca_update"] == before + n
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_cnca_kernel_limits_match_the_python_rule(cuda):
    from vsnca_tpu_torch.ops import fused_cnca as fc

    assert fc.kernel_limits() == (fc.C_MAX, fc.D_MAX)


# ------------------------------------------------ multiscale kernels and taps


def _ms_case(cuda, conditioning, shape, pad="circular", seed=0, rate=0.5):
    cfg = NCAConfig(c_in=shape[1], fc_dim=32, padding_mode=pad, conditioning=conditioning,
                    perception_scales=(0, 1), update_rate=rate)
    params = dynca.dynca_init(torch.Generator().manual_seed(seed), cfg, device=cuda)
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.rand(shape, generator=g) - 0.5).to(cuda)
    gy = torch.randn(shape, generator=g).to(cuda)
    cond = None
    if conditioning:
        b, _, h, w = shape
        cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(cuda)
    return cfg, params, x, gy, cond


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "pos_emb"])
@pytest.mark.parametrize("pad_mode", ["circular", "replicate", "zeros"])
def test_multiscale_kernel_matches_plain(cuda, pad_mode, conditioning, compute_dtype):
    """nca_step_ms (perception_scales (0, 1)) against its plain version,
    5 steps at rate 0.5 on a ragged, even 22 x 38 grid (partial blocks and
    half-resolution halos at every edge); one launch a step."""
    cfg, params, x, _, cond = _ms_case(cuda, conditioning, (2, 8, 22, 38), pad_mode)
    before = fs.KERNEL_LAUNCHES["nca_step_ms"]
    got = fs.fused_rollout_chw(params, x, 3, cfg, 5, cond, None, compute_dtype)
    assert fs.KERNEL_LAUNCHES["nca_step_ms"] == before + 5
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 5, cond, None, compute_dtype)
    torch.testing.assert_close(got, want, **TOL[compute_dtype])


def test_multiscale_kernel_refuses_odd_sizes(cuda):
    cfg, params, x, _, _ = _ms_case(cuda, None, (1, 4, 10, 12))
    with pytest.raises(ValueError, match="even H and W"):
        fs.fused_rollout_chw(params, x[..., :11], 0, cfg, 1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_multiscale_backward_kernels_match_plain(cuda, compute_dtype):
    """One launch each of nca_bwd_mlp_ms and nca_bwd_adjoint_ms (with a tap
    cotangent) at rate 0.5 on a ragged 22 x 38 grid."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gx, cond = _ms_case(cuda, "pos_emb", (2, 8, 22, 38))
    packed = fs.pack_weights(params, 8, 2, compute_dtype)
    args = (packed, x, cond, gx, 3, 5, 0.5, compute_dtype, True, True)
    before = dict(ft.KERNEL_LAUNCHES)
    got = ft.nca_bwd_mlp(*args)
    want = ft.nca_bwd_mlp_reference(*args)
    assert ft.KERNEL_LAUNCHES["nca_bwd_mlp_ms"] == before["nca_bwd_mlp_ms"] + 1
    for a, b in zip(got, want):
        _close(a, b, TRAIN_TOL[compute_dtype])
    gtap = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)).to(cuda)
    _close(ft.nca_bwd_adjoint(want[0], gx, gtap, True),
           ft.nca_bwd_adjoint_reference(want[0], gx, gtap, True), TRAIN_TOL["float32"])
    assert ft.KERNEL_LAUNCHES["nca_bwd_adjoint_ms"] == before["nca_bwd_adjoint_ms"] + 1


@pytest.mark.parametrize("scales", [(0,), (0, 1)])
def test_tapped_pair_matches_plain(cuda, scales):
    """The pair with taps after steps 1 and 3 of 5: state, taps and every
    gradient against the plain version; n forward and 2n backward launches,
    whatever the taps."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gy, cond = _ms_case(cuda, "pos_emb", (2, 8, 24, 40))
    cfg = dataclasses.replace(cfg, perception_scales=scales)
    g = torch.Generator().manual_seed(4)
    gtaps = [torch.randn(x.shape, generator=g).to(cuda) for _ in range(2)]
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr = x.clone().requires_grad_()
    before = ft.LAUNCHES
    y, taps = ft.fused_rollout_train(p, xr, 9, cfg, 5, cond, tap_steps=(1, 3))
    ((y * gy).sum() + sum((t * q).sum() for t, q in zip(taps, gtaps))).backward()
    assert ft.LAUNCHES == before + 15
    want_y, want_taps, grads, dx0, _ = ft.fused_rollout_train_reference(
        params, x, 9, cfg, 5, cond, gy, tap_steps=(1, 3), gtaps=gtaps)
    _close(y.detach(), want_y, TOL["float32"]["atol"])
    for a, b in zip(taps, want_taps):
        _close(a.detach(), b, TOL["float32"]["atol"])
    for k in grads:
        _close(p[k].grad, grads[k], TRAIN_TOL["float32"])
    _close(xr.grad, dx0, TRAIN_TOL["float32"])


def test_multiscale_stylizer_on_card_matches_cpu(cuda):
    """A multiscale model through VideoStylizer: one nca_step_ms launch a
    step, the same frames as the CPU path, float32."""
    cfg = NCAConfig(c_in=8, fc_dim=32, padding_mode="circular", conditioning="pos_emb",
                    perception_scales=(0, 1))
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    frames = np.random.RandomState(3).uniform(-1, 1, (2, 1, 40, 24, 3)).astype(np.float32)
    on = VideoStylizer(params, cfg, (40, 24), step_n=8, device=cuda, compute_dtype="float32")
    off = VideoStylizer(params, cfg, (40, 24), step_n=8, device="cpu", compute_dtype="float32")
    before = fs.KERNEL_LAUNCHES["nca_step_ms"]
    for f in frames:
        torch.testing.assert_close(on.step_frame(f).cpu(), off.step_frame(f), **TOL["float32"])
    assert fs.KERNEL_LAUNCHES["nca_step_ms"] == before + 16


# ---------------------------------------------------------------------------
# The TPU-layout rollout forms: the folded-stencil step (nca_step_mat), the
# bf16-state step, the streaming entry, the registry, and the
# segment-checkpointed CHW training pair.

# The bf16 state: both round the new state to bf16 on store, so one float32
# ulp of summation-order difference in the MLP can flip a stored value by one
# bf16 ulp (2^-8 relative) and the next steps carry it.
BF16_STATE_TOL = dict(rtol=1e-2, atol=1e-2)


def _rollout_case(cuda, pad_mode, conditioning, c_in=12, fc_dim=96, shape=(2, 19, 37)):
    cfg = NCAConfig(c_in=c_in, fc_dim=fc_dim, padding_mode=pad_mode,
                    conditioning=conditioning)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    g = torch.Generator().manual_seed(1)
    b, h, w = shape
    x = (torch.rand((b, c_in, h, w), generator=g) - 0.5).to(cuda)
    cond = None
    if conditioning:
        cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(cuda)
    return cfg, params, x, cond


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "edges", "pos_emb"])
@pytest.mark.parametrize("pad_mode", ["circular", "replicate", "zeros"])
def test_mat_kernel_matches_plain(cuda, pad_mode, conditioning, compute_dtype):
    cfg, params, x, cond = _rollout_case(cuda, pad_mode, conditioning)
    # the tensor-core form under float32 compute, the chain form under bf16
    # (fused_step.chain_form)
    name = "nca_step_mat_chain" if compute_dtype == "bfloat16" else "nca_step_mat"
    before = fs.KERNEL_LAUNCHES[name]
    got = fs.fused_rollout_chw(params, x, 3, cfg, 5, cond, 0.5, compute_dtype, algo="mat")
    assert fs.KERNEL_LAUNCHES[name] == before + 5
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 5, cond, 0.5, compute_dtype,
                                          algo="mat")
    torch.testing.assert_close(got, want, **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mat_kernel_at_its_widest(cuda, compute_dtype):
    """c16/fc128 with edges: W_eff is 147 x 128 floats (73.5 KB of shared
    memory, past the 48 KB default)."""
    cfg, params, x, cond = _rollout_case(cuda, "circular", "edges", 16, 128, (1, 40, 24))
    got = fs.fused_rollout_chw(params, x, 4, cfg, 3, cond, 0.5, compute_dtype, algo="mat")
    want = fs.fused_rollout_chw_reference(params, x, 4, cfg, 3, cond, 0.5, compute_dtype,
                                          algo="mat")
    torch.testing.assert_close(got, want, **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "edges", "pos_emb"])
@pytest.mark.parametrize("pad_mode", ["circular", "replicate", "zeros"])
def test_bf16_state_kernel_matches_plain(cuda, pad_mode, conditioning, compute_dtype):
    cfg, params, x, cond = _rollout_case(cuda, pad_mode, conditioning)
    before = fs.KERNEL_LAUNCHES["nca_step_bf16_state"]
    got = fs.fused_rollout_chw(params, x, 3, cfg, 5, cond, 0.5, compute_dtype,
                               state_dtype="bfloat16", algo="padded")
    assert fs.KERNEL_LAUNCHES["nca_step_bf16_state"] == before + 5
    assert got.dtype == torch.bfloat16
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 5, cond, 0.5, compute_dtype,
                                          state_dtype="bfloat16", algo="padded")
    torch.testing.assert_close(got.float(), want.float(), **BF16_STATE_TOL)


def test_stream_and_registry_entries_launch_nca_step(cuda):
    """The streaming entry past the TPU's resident cap (and an odd width),
    and every registry entry the policy picks, launch nca_step (its chain
    form under bf16 compute, fused_step.chain_form; or nca_step_ms) and
    equal the plain version; fused_rollout (NHWC) too."""
    cfg, params, x, cond = _rollout_case(cuda, "circular", "edges", shape=(1, 520, 300))
    before = fs.KERNEL_LAUNCHES["nca_step_chain"]
    got = fs.fused_rollout_stream_chw(params, x, 2, cfg, 3, cond, compute_dtype="bfloat16")
    assert fs.KERNEL_LAUNCHES["nca_step_chain"] == before + 3
    want = fs.fused_rollout_chw_reference(params, x, 2, cfg, 3, cond,
                                          compute_dtype="bfloat16")
    torch.testing.assert_close(got, want, **TOL["bfloat16"])
    assert fs.select_rollout_kernel(cfg, 520, 300) == "flat"
    for name in ("flat", "roll", "stream_flat"):
        out = fs.ROLLOUT_KERNELS[name](params, x, 2, cfg, 3, cond, compute_dtype="bfloat16")
        torch.testing.assert_close(out, want, **TOL["bfloat16"])
    ms = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", perception_scales=(0, 1))
    pm = dynca.dynca_init(torch.Generator().manual_seed(0), ms, device=cuda)
    xs = x[:, :, :64, :48].contiguous()
    before = fs.KERNEL_LAUNCHES["nca_step_ms"]
    state, rgb = fs.fused_rollout(pm, xs.permute(0, 2, 3, 1), 5, ms, 2)
    assert fs.KERNEL_LAUNCHES["nca_step_ms"] == before + 2
    want = fs.fused_rollout_chw_reference(pm, xs, 5, ms, 2).permute(0, 2, 3, 1)
    torch.testing.assert_close(state, want, **TOL["float32"])
    torch.testing.assert_close(rgb, want[..., :3] * 2, **TOL["float32"])


def _segment_run(ft, cfg, params, x, cond, gy, k, n_steps=16):
    p = {n: v.clone().requires_grad_() for n, v in params.items()}
    xr, cr = x.clone().requires_grad_(), cond.clone().requires_grad_()
    y = ft.fused_rollout_train_chw(p, xr, cr, 9, cfg, n_steps, k)
    (y * gy).sum().backward()
    return [y.detach(), xr.grad, cr.grad] + [p[n].grad for n in sorted(p)]


def test_segment_pair_matches_every_step_checkpoint_and_plain(cuda):
    """The CHW pair at K = 4 and 16 against K = 1 on the card: bit-identical
    (the same kernels, masks and sums); against the plain segment walk within
    the pair's tolerances; launches n forward + (n - n/K) recompute + 2n
    backward."""
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gy, cond = _train_case(cuda, "pos_emb", (2, 12, 24, 40))
    cfg = dataclasses.replace(cfg, update_rate=0.5)
    want = _segment_run(ft, cfg, params, x, cond, gy, 1)
    for k in (4, 16):
        before = dict(ft.KERNEL_LAUNCHES)
        got = _segment_run(ft, cfg, params, x, cond, gy, k)
        assert ft.KERNEL_LAUNCHES["nca_step"] - before["nca_step"] == 16 + 16 - 16 // k
        assert ft.KERNEL_LAUNCHES["nca_bwd_mlp"] - before["nca_bwd_mlp"] == 16
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    y, grads, dx0, dcond = ft.fused_rollout_train_reference(
        params, x, 9, cfg, 16, cond, gy, need_dcond=True, segment=4)
    _close(want[0], y, TOL["float32"]["atol"])
    _close(want[1], dx0, TRAIN_TOL["float32"])
    _close(want[2], dcond, TRAIN_TOL["float32"])
    for got_g, n in zip(want[3:], sorted(params)):
        _close(got_g, grads[n], TRAIN_TOL["float32"])


def test_segment_pair_nhwc_wrapper_on_card(cuda):
    from vsnca_tpu_torch.ops import fused_train as ft

    cfg, params, x, gy, cond = _train_case(cuda, "pos_emb", (1, 12, 32, 32))
    p = {n: v.clone().requires_grad_() for n, v in params.items()}
    state, rgb = ft.fused_rollout_train_nhwc(p, x.permute(0, 2, 3, 1), 3, cfg, 24,
                                             cond.permute(0, 2, 3, 1))
    rgb.square().sum().backward()
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 24, cond)
    _close(state.detach(), want.permute(0, 2, 3, 1), TOL["float32"]["atol"])
    assert all(torch.isfinite(v.grad).all() and v.grad.abs().max() > 0 for v in p.values())


# ----------------------------------------- the tensor-core backward kernels


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multiscale", [False, True])
@pytest.mark.parametrize("c_in,c_cond,fc_dim", [(1, 0, 4), (5, 1, 30), (12, 3, 96),
                                                (16, 4, 128), (16, 2, 128)])
def test_backward_mlp_kernel_widths_are_exact_and_repeatable(cuda, c_in, c_cond, fc_dim,
                                                             multiscale, compute_dtype):
    """nca_bwd_mlp (and its MS form) at the width limits (C 1..16, cc 0..4,
    F 4..128) on a ragged 40 x 72 grid at rate 0.5: within the backward
    tolerance of the plain version, and two launches on the same inputs give
    the same bits."""
    from vsnca_tpu_torch.ops import fused_train as ft

    g = torch.Generator().manual_seed(c_in * 131 + fc_dim)
    p = 4 * c_in + c_cond
    params = {"w1": 0.3 * torch.randn((p, fc_dim), generator=g),
              "b1": 0.1 * torch.randn(fc_dim, generator=g),
              "w2": 0.2 * torch.randn((fc_dim, c_in), generator=g),
              "b2": torch.zeros(c_in)}
    shape = (2, c_in, 40, 72)
    x = (torch.rand(shape, generator=g) - 0.5).to(cuda)
    gx = torch.randn(shape, generator=g).to(cuda)
    cond = ((torch.rand((2, c_cond, 40, 72), generator=g) - 0.5).to(cuda)
            if c_cond else None)
    packed = fs.pack_weights({k: v.to(cuda) for k, v in params.items()}, c_in, c_cond,
                             compute_dtype)
    args = (packed, x, cond, gx, 3, 5, 0.5, compute_dtype, cond is not None, multiscale)
    got = ft.nca_bwd_mlp(*args)
    again = ft.nca_bwd_mlp(*args)
    want = ft.nca_bwd_mlp_reference(*args)
    for a, b in zip(got, want):
        if b is not None:
            _close(a, b, TRAIN_TOL[compute_dtype])
    assert _same_bits(got, again)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,d", [(1, 4), (16, 64), (20, 64), (7, 36)])
def test_cnca_backward_mlp_widths_are_exact_and_repeatable(cuda, hidden, d, compute_dtype):
    """cnca_bwd_mlp at the width limits (C 5..24, D 4..64) on a ragged
    40 x 72 grid: within the backward tolerance of the plain version, and two
    launches on the same inputs give the same bits."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    cfg, params, x, goal = _cnca_case(cuda, 0.5, True, shape=(2, 40, 72), hidden=hidden, d=d)
    packed = fc.pack_weights(params, cfg, compute_dtype)
    _, life = fc.cnca_step_reference(x, goal, packed, cfg, compute_dtype, 3, 5, 0.5)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    args = (packed, x, goal, life, gy, cfg, compute_dtype, 3, 5, 0.5)
    g_xn, gp, sums = fc.cnca_bwd_mlp(*args)
    g2, gp2, sums2 = fc.cnca_bwd_mlp(*args)
    w_xn, w_gp, w_sums = fc.cnca_bwd_mlp_reference(*args)
    for a, b in zip((g_xn, gp, *sums), (w_xn, w_gp, *w_sums)):
        _close(a, b, TRAIN_TOL[compute_dtype])
    assert _same_bits((g_xn, gp, *sums), (g2, gp2, *sums2))


# -------------------------------------- the tensor-core step and its chain form

# (form, state dtype, compute dtype, scales) of nca_step_kernel and its
# tolerance against the plain version (the existing ones of each form)
STEP_FORMS = [
    ("nca_step", "float32", "float32", (0,), TOL["float32"]),
    ("nca_step_chain", "float32", "bfloat16", (0,), TOL["bfloat16"]),
    ("nca_step_bf16_state", "bfloat16", "float32", (0,), BF16_STATE_TOL),
    ("nca_step_ms", "float32", "float32", (0, 1), TOL["float32"]),
    ("nca_step_ms", "float32", "bfloat16", (0, 1), TOL["bfloat16"]),
]


@pytest.mark.parametrize("form,state_dtype,compute_dtype,scales,tol", STEP_FORMS)
def test_step_forms_at_full_width_match_plain_and_repeat(cuda, form, state_dtype,
                                                         compute_dtype, scales, tol):
    """Each form of the step a rollout launches (the tensor-core forms; the
    chain form for scales (0,) under bf16 compute) at the served
    (c12/fc96/edges) or video_motion (c16/fc128/pos_emb) widths, 6 steps at
    rate 0.5 on a ragged 66 x 98 grid: within the form's tolerance of the
    plain version, and two launches give the same bits."""
    c, f, cond_kind = (16, 128, "pos_emb") if scales == (0, 1) else (12, 96, "edges")
    cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="replicate", conditioning=cond_kind,
                    perception_scales=scales, update_rate=0.5)
    params = dynca.dynca_init(torch.Generator().manual_seed(4), cfg, device=cuda)
    g = torch.Generator().manual_seed(5)
    x = (torch.rand((2, c, 66, 98), generator=g) - 0.5).to(cuda)
    cond = (torch.rand((2, cfg.c_cond, 66, 98), generator=g) - 0.5).to(cuda)
    kw = dict(state_dtype=state_dtype, algo="padded" if state_dtype == "bfloat16" else "roll")
    before = fs.KERNEL_LAUNCHES[form]
    got = fs.fused_rollout_chw(params, x, 3, cfg, 6, cond, None, compute_dtype, **kw)
    again = fs.fused_rollout_chw(params, x, 3, cfg, 6, cond, None, compute_dtype, **kw)
    assert fs.KERNEL_LAUNCHES[form] == before + 12
    want = fs.fused_rollout_chw_reference(params, x, 3, cfg, 6, cond, None, compute_dtype,
                                          **kw)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


def test_tensor_core_step_under_bf16_compute(cuda):
    """The tensor-core scales-(0,) step under bf16 compute, which no rollout
    entry launches (fused_step.chain_form): one step at the served widths
    against the plain step within TOL['bfloat16'], two launches the same
    bits."""
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((1, 12, 80, 112), generator=g) - 0.5).to(cuda)
    cond = (torch.rand((1, 3, 80, 112), generator=g) - 0.5).to(cuda)
    packed = fs.pack_weights(params, 12, 3, "bfloat16")
    outs = [torch.empty_like(x) for _ in range(2)]
    before = fs.KERNEL_LAUNCHES["nca_step"]
    for o in outs:
        fs.launch_step(x, o, cond, packed, "circular", "bfloat16", 3, 4, fs.uniform_threshold(0.5))
    assert fs.KERNEL_LAUNCHES["nca_step"] == before + 2
    want = fs.reference_step(x, cond, packed, "circular", "bfloat16", 3, 4, 0.5)
    torch.testing.assert_close(outs[0], want, **TOL["bfloat16"])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", [(0,), (0, 1)])
def test_chain_form_is_the_plain_step_bit_for_bit(cuda, scales, compute_dtype):
    """The training pair's forward (the chain form: float32 FMAs in the plain
    version's order) reproduces the plain step's bits, so the pair's relu
    gates are the plain pair's; one launch a step."""
    c, f = (16, 128) if scales == (0, 1) else (12, 96)
    cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="circular", conditioning="pos_emb",
                    perception_scales=scales, update_rate=0.5)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((2, c, 64, 96), generator=g) - 0.5).to(cuda)
    cond = (torch.rand((2, 2, 64, 96), generator=g) - 0.5).to(cuda)
    packed = fs.pack_weights(params, c, 2, compute_dtype)
    name = "nca_step_ms_chain" if scales == (0, 1) else "nca_step_chain"
    src, dst = x, torch.empty_like(x)
    for step in range(3):
        before = fs.KERNEL_LAUNCHES[name]
        fs.launch_step(src, dst, cond, packed, "circular", compute_dtype, 9, step,
                       fs.uniform_threshold(0.5), scales == (0, 1), chain=True)
        assert fs.KERNEL_LAUNCHES[name] == before + 1
        want = fs.reference_step(src, cond, packed, "circular", compute_dtype, 9, step, 0.5,
                                 scales == (0, 1))
        assert torch.equal(dst, want)
        src, dst = dst.clone(), torch.empty_like(x)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multiscale", [False, True])
@pytest.mark.parametrize("c_in,c_cond,fc_dim", [(1, 0, 4), (5, 1, 30), (16, 4, 128)])
def test_chain_form_widths_match_plain_and_repeat(cuda, c_in, c_cond, fc_dim, multiscale,
                                                  compute_dtype):
    """The chain form at the width limits (C 1..16, cc 0..4, F 4..128, F
    padded to a multiple of 4) on a ragged even 38 x 70 grid, 3 steps at
    rate 0.5: within the float32 / bf16 tolerance of the plain step (at these
    widths the plain version's matrix products may sum in another order),
    and two launches give the same bits."""
    g = torch.Generator().manual_seed(c_in * 131 + fc_dim)
    p = 4 * c_in + c_cond
    params = {"w1": 0.3 * torch.randn((p, fc_dim), generator=g),
              "b1": 0.1 * torch.randn(fc_dim, generator=g),
              "w2": 0.2 * torch.randn((fc_dim, c_in), generator=g),
              "b2": 0.01 * torch.randn(c_in, generator=g)}
    x = (torch.rand((2, c_in, 38, 70), generator=g) - 0.5).to(cuda)
    cond = ((torch.rand((2, c_cond, 38, 70), generator=g) - 0.5).to(cuda)
            if c_cond else None)
    packed = fs.pack_weights({k: v.to(cuda) for k, v in params.items()}, c_in, c_cond,
                             compute_dtype)
    thr = fs.uniform_threshold(0.5)
    runs = []
    for _ in range(2):
        src = x
        for step in range(3):
            dst = torch.empty_like(x)
            fs.launch_step(src, dst, cond, packed, "circular", compute_dtype, 4, step, thr,
                           multiscale, chain=True)
            src = dst
        runs.append(src)
    want = x
    for step in range(3):
        want = fs.reference_step(want, cond, packed, "circular", compute_dtype, 4, step, 0.5,
                                 multiscale)
    torch.testing.assert_close(runs[0], want, **TOL[compute_dtype])
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("preset", ["static_texture", "video_motion"])
def test_gate_stress_pair_matches_plain(cuda, preset):
    """The static_texture (c12/fc96, scales (0,)) and video_motion (c16/fc128,
    scales (0, 1)) pairs with b1 set so that about a tenth of the first
    step's z1 lies within 1e-6 of zero (a constant patch of state and
    conditioning shares one percept; b1 leaves its z1 between 1e-7 and 1e-6
    from zero, either side): every one of those goes through the
    backward's certificate, which recomputes it as the forward's chain, and
    the gradients stay within TRAIN_TOL of the plain pair's. 4 steps at
    rate 0.5, 64^2 b1."""
    from vsnca_tpu_torch.ops import fused_train as ft
    from vsnca_tpu_torch.ops.perception import perceive

    ms = preset == "video_motion"
    c, f = (16, 128) if ms else (12, 96)
    cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="circular", conditioning="pos_emb",
                    perception_scales=(0, 1) if ms else (0,), update_rate=0.5)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, c, 64, 64)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 2, 64, 64)).astype(np.float32))
    x[..., 4:36, 4:36] = torch.from_numpy(rng.uniform(-0.5, 0.5, (c, 1, 1)).astype(np.float32))
    cond[..., 4:36, 4:36] = 0.25
    x, cond = x.to(cuda), cond.to(cuda)
    p = torch.cat([fs.multiscale_percept(x, "circular") if ms else perceive(x, "circular"),
                   cond], dim=1)
    z_patch = torch.einsum("p,pf->f", p[0, :, 20, 20], params["w1"])  # z1 - b1 in the patch
    offset = rng.uniform(1e-7, 1e-6, f) * rng.choice([-1.0, 1.0], f)
    params["b1"] = torch.from_numpy(offset.astype(np.float32)).to(cuda) - z_patch
    z1 = torch.einsum("bphw,pf->bfhw", p, params["w1"]) + params["b1"][:, None, None]
    near = float((z1.abs() <= 1e-6).float().mean())
    assert near >= 0.09
    gy = torch.from_numpy(rng.randn(1, c, 64, 64).astype(np.float32)).to(cuda)
    pr = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, cr = x.clone().requires_grad_(), cond.clone().requires_grad_()
    y = ft.fused_rollout_train(pr, xr, 7, cfg, 4, cr)
    (y * gy).sum().backward()
    want_y, grads, dx0, dcond = ft.fused_rollout_train_reference(
        params, x, 7, cfg, 4, cond, gy, need_dcond=True)
    _close(y.detach(), want_y, TOL["float32"]["atol"])
    for k in grads:
        _close(pr[k].grad, grads[k], TRAIN_TOL["float32"])
    _close(xr.grad, dx0, TRAIN_TOL["float32"])
    _close(cr.grad, dcond, TRAIN_TOL["float32"])


# ----------- the redesigned CUDA-core kernels: nca_bwd_adjoint_ms, cnca_update

# grids whose footprint wraps (16^2: more than once at half resolution) or
# is ragged against 16 x 16 blocks; rows of 18 and 66 floats take the
# kernel's 4-byte staging
ADJ_GRIDS = [(16, 16), (18, 18), (40, 72), (34, 66)]
MS_STATE_TOL = 1e-6  # chip_smoke.py's, relative to the largest element


@pytest.mark.parametrize("c", [1, 2, 5, 16])
def test_multiscale_adjoint_widths_and_wrapping_grids(cuda, c):
    """nca_bwd_adjoint_ms at C 1..16 on ADJ_GRIDS, b2, with a tap and
    without, and once on a gp that is not 16-byte aligned (4-byte staging
    at W % 4 == 0): within MS_STATE_TOL of the plain version, and two
    launches on the same inputs give the same bits."""
    from vsnca_tpu_torch.ops import fused_train as ft

    g = torch.Generator().manual_seed(c)
    for h, w in ADJ_GRIDS:
        gp = torch.randn((2, 4 * c, h, w), generator=g).to(cuda)
        gx = torch.randn((2, c, h, w), generator=g).to(cuda)
        gtap = torch.randn((2, c, h, w), generator=g).to(cuda)
        for tap in (None, gtap):
            got = ft.nca_bwd_adjoint(gp, gx, tap, True)
            again = ft.nca_bwd_adjoint(gp, gx, tap, True)
            _close(got, ft.nca_bwd_adjoint_reference(gp, gx, tap, True), MS_STATE_TOL)
            assert torch.equal(got, again)
    n = 2 * 4 * c * 40 * 72
    gp = torch.randn(n + 1, generator=g).to(cuda)[1:].view(2, 4 * c, 40, 72)
    assert gp.data_ptr() % 16 != 0
    gx = torch.randn((2, c, 40, 72), generator=g).to(cuda)
    _close(ft.nca_bwd_adjoint(gp, gx, None, True),
           ft.nca_bwd_adjoint_reference(gp, gx, None, True), MS_STATE_TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,d", [(1, 4), (16, 64), (20, 64), (7, 36)])
def test_cnca_update_widths_and_grids_are_exact_and_repeatable(cuda, hidden, d,
                                                                compute_dtype):
    """cnca_update at the width limits (C 5..24, D 4..64) on 8^2 b2, 24 x 40
    b2 and 64^2 b1 and b8, living channel on and off, rates 1 and 0.5:
    within TRAIN_TOL of the plain version, and two launches on the same
    inputs give the same bits."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    for shape in ((2, 8, 8), (2, 24, 40), (1, 64, 64), (8, 64, 64)):
        for use_life, rate in ((True, 1.0), (True, 0.5), (False, 0.5)):
            cfg, params, x, goal = _cnca_case(cuda, rate, use_life, shape=shape, hidden=hidden,
                                              d=d)
            packed = fc.pack_weights(params, cfg, compute_dtype)
            thr = fs.uniform_threshold(rate)
            got, again = torch.empty_like(x), torch.empty_like(x)
            fc.launch_update(x, goal, got, packed, cfg, compute_dtype, 3, 5, thr)
            fc.launch_update(x, goal, again, packed, cfg, compute_dtype, 3, 5, thr)
            want = fc.cnca_update_reference(x, goal, packed, cfg, compute_dtype, 3, 5, rate)
            _close(got, want, TRAIN_TOL[compute_dtype])
            assert torch.equal(got, again)


def test_cnca_gate_stress_pair_matches_plain(cuda):
    """The ConditionedNCA pair with b1 and b2 set so that about a tenth of
    the first step's h1 and h2 pre-activations lie within 1e-6 of zero (a
    24 x 24 patch of constant state and goal shares one percept; b1, then b2
    from the patch's h1, leaves each unit's pre-activation there between
    1e-7 and 1e-6 from zero, either side): the forward (cnca_update) and the
    backward's recompute (cnca_bwd_mlp) share their bits, so no gate flips
    and the state and gradients stay within 1e-6 of the largest element of
    the plain pair's. 12 steps at rate 0.5, 64^2 b2, f32."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    cfg, params, x, goal = _cnca_case(cuda, 0.5, True, shape=(2, 64, 64), hidden=16, d=64)
    rng = np.random.RandomState(7)
    c, d = cfg.num_channels, cfg.update_hidden_dim
    x[..., 20:44, 20:44] = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (c, 1, 1)).astype(np.float32)).to(cuda)
    x[:, cfg.alive_channel, 20:44, 20:44] = 0.5
    goal[..., 20:44, 20:44] = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (c, 1, 1)).astype(np.float32)).to(cuda)
    packed = fc.pack_weights(params, cfg, "float32")
    p = fc.depthwise_perceive(x + goal * fc._alive(x, cfg), packed[0].reshape(c, 3, 3, 3))
    pp = p[0, :, 32, 32]
    off = [rng.uniform(1e-7, 1e-6, d) * rng.choice([-1.0, 1.0], d) for _ in range(2)]
    b1 = torch.from_numpy(off[0].astype(np.float32)).to(cuda) - pp @ params["update1.w"]
    h1p = torch.relu(pp @ params["update1.w"] + b1)
    b2 = torch.from_numpy(off[1].astype(np.float32)).to(cuda) - h1p @ params["update2.w"]
    params = dict(params, **{"update1.b": b1, "update2.b": b2})
    z1 = torch.einsum("bkhw,kf->bfhw", p, params["update1.w"]) + b1[:, None, None]
    z2 = torch.einsum("bfhw,fe->behw", torch.relu(z1), params["update2.w"]) + b2[:, None, None]
    assert float((z1.abs() <= 1e-6).float().mean()) >= 0.09
    assert float((z2.abs() <= 1e-6).float().mean()) >= 0.09
    gy = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(cuda)
    pr = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, gr = x.clone().requires_grad_(), goal.clone().requires_grad_()
    y = fc.fused_cnca_train(pr, xr, gr, 9, cfg, 12, "float32")
    (y * gy).sum().backward()
    want_y, grads, dx0, dgoal = fc.fused_cnca_train_reference(params, x, goal, 9, cfg, 12, gy,
                                                              "float32")
    _close(y.detach(), want_y, 1e-6)
    _close(xr.grad, dx0, 1e-6)
    _close(gr.grad, dgoal, 1e-6)
    for k in fc.WEIGHT_KEYS:
        _close(pr[k].grad, grads[k], 1e-6)


# ------------------------- the redesigned single-scale stencil adjoints

# nca_bwd_adjoint's grids: 8^2 (the footprint wraps more than once), 18^2 and
# 34 x 66 (rows not a multiple of 4 floats: the 4-byte staging), 40 x 72
# (ragged against 32 x 16 tiles), b2; 128^2 b4 the static_texture shape
SA_GRIDS = [(2, 8, 8), (2, 18, 18), (2, 34, 66), (2, 40, 72), (4, 128, 128)]
# cnca_bwd_adjoint's: 8^2, 24 x 40 and 34 x 66 b2 (ragged, zero padding),
# 64^2 b8 the encoder trainer's shape
CA_GRIDS = [(2, 8, 8), (2, 24, 40), (2, 34, 66), (8, 64, 64)]


@pytest.mark.parametrize("c", [5, 12])
def test_adjoint_kernel_grids_and_widths(cuda, c):
    """The scales-(0,) nca_bwd_adjoint at C 5 and 12 on SA_GRIDS, with a tap
    and without, and once on gp, gx and gtap that are not 16-byte aligned:
    within TRAIN_TOL (f32) of the plain version, and two launches on the
    same inputs give the same bits."""
    from vsnca_tpu_torch.ops import fused_train as ft

    g = torch.Generator().manual_seed(c)
    for b, h, w in SA_GRIDS:
        gp = torch.randn((b, 4 * c, h, w), generator=g).to(cuda)
        gx = torch.randn((b, c, h, w), generator=g).to(cuda)
        gtap = torch.randn((b, c, h, w), generator=g).to(cuda)
        for tap in (None, gtap):
            got = ft.nca_bwd_adjoint(gp, gx, tap)
            again = ft.nca_bwd_adjoint(gp, gx, tap)
            _close(got, ft.nca_bwd_adjoint_reference(gp, gx, tap), TRAIN_TOL["float32"])
            assert torch.equal(got, again)
    shape = (2, c, 40, 72)
    gp = torch.randn(2 * 4 * c * 40 * 72 + 1, generator=g).to(cuda)[1:].view(2, 4 * c, 40, 72)
    gtap = torch.randn(2 * c * 40 * 72 + 1, generator=g).to(cuda)[1:].view(shape)
    assert gp.data_ptr() % 16 != 0 and gtap.data_ptr() % 16 != 0
    gx = torch.randn(shape, generator=g).to(cuda)
    _close(ft.nca_bwd_adjoint(gp, gx, gtap), ft.nca_bwd_adjoint_reference(gp, gx, gtap),
           TRAIN_TOL["float32"])


@pytest.mark.parametrize("hidden", [3, 16])
def test_cnca_adjoint_kernel_grids_and_widths(cuda, hidden):
    """cnca_bwd_adjoint at C 7 (a channel pair's tail) and 20 on CA_GRIDS,
    living channel on (a sparse alpha plane) and off: g + g_xg and
    g_xg * pre within 1e-6 of the largest element of the plain version's,
    and two launches on the same inputs give the same bits."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    for shape in CA_GRIDS:
        for use_life in (True, False):
            cfg, params, x, goal = _cnca_case(cuda, 0.5, use_life, shape=shape, hidden=hidden)
            c = cfg.num_channels
            x[:, cfg.alive_channel] *= 0.15  # a sparse living channel: the mask has holes
            g = torch.Generator().manual_seed(shape[1] + c)
            gp = torch.randn((shape[0], 3 * c, *shape[1:]), generator=g).to(cuda)
            g_xn = torch.randn(x.shape, generator=g).to(cuda)
            wcol = params["perception_w"].reshape(c, 27).contiguous()
            got = fc.cnca_bwd_adjoint(x, gp, g_xn, wcol, cfg)
            again = fc.cnca_bwd_adjoint(x, gp, g_xn, wcol, cfg)
            want = fc.cnca_bwd_adjoint_reference(x, gp, g_xn, wcol, cfg)
            for a, r, s in zip(got, want, again):
                _close(a, r, 1e-6)
                assert torch.equal(a, s)


# ------------------------------- the redesigned nca_step_mat and cnca_gate

# the folded-stencil step's grids: 8^2 (the halo wraps), 18^2 and 34 x 66
# (rows not a multiple of 4 floats), 40 x 72 (ragged against 16 x 16 tiles)
MAT_GRIDS = [(2, 8, 8), (2, 18, 18), (2, 34, 66), (2, 40, 72)]


@pytest.mark.parametrize("conditioning", [None, "edges"])
@pytest.mark.parametrize("c_in", [5, 12])
@pytest.mark.parametrize("pad_mode", ["circular", "replicate", "zeros"])
def test_mat_forms_at_the_staging_grids(cuda, pad_mode, c_in, conditioning):
    """nca_step_mat, one step at rate 0.5 on MAT_GRIDS: the tensor-core form
    (float32 compute, and bf16 compute by ``tc``) within TOL of the plain
    step; the chain form (bf16 compute) the plain step's bits over 2^16
    pixels (``kernel_diff.plain_over_rows``: the same function with the
    matrix products of a 256^2 step, where the plain version's bits are the
    chain's; at a few hundred pixels its products may round otherwise) and
    within TOL of the plain step at the grid; two launches of each give the
    same bits."""
    from vsnca_tpu_torch.ops.kernel_diff import plain_over_rows

    for b, h, w in MAT_GRIDS:
        cfg, params, x, cond = _rollout_case(cuda, pad_mode, conditioning, c_in, 96, (b, h, w))
        cc = cond.shape[1] if cond is not None else 0
        for cdt in ("float32", "bfloat16"):
            packed = fs.pack_weights(params, c_in, cc, cdt, True)
            want = fs.reference_step(x, cond, packed, pad_mode, cdt, 3, 4, 0.5, mat=True)
            for chain in ((False,) if cdt == "float32" else (False, True)):
                outs = [torch.empty_like(x) for _ in range(2)]
                for o in outs:
                    fs.launch_step(x, o, cond, packed, pad_mode, cdt, 3, 4,
                                   fs.uniform_threshold(0.5), mat=True, chain=chain)
                assert torch.equal(outs[0], outs[1])
                torch.testing.assert_close(outs[0], want, **TOL[cdt])
                if chain:
                    assert torch.equal(outs[0], plain_over_rows(
                        fs, x, cond, packed, pad_mode, cdt, 3, 4, 0.5))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mat_forms_fit_two_blocks_an_sm(cuda, compute_dtype):
    """At the served widths (c12/fc96/edges) nca_step_mat, in the form its
    compute type takes (fused_step.chain_form), keeps at least two blocks an
    SM."""
    blocks, smem = fs.step_occupancy(12, 3, 96, compute_dtype, False, "mat")
    assert blocks >= 2, (blocks, smem)


def _gate_inputs(cuda, shape, hidden, use_life, seed):
    """A ConditionedNCA config and x, xn whose alpha planes hold values on the
    threshold and one ulp either side of it (and xn past the clamp)."""
    from vsnca_tpu_torch.config import ConditionedNCAConfig

    b, h, w = shape
    cfg = ConditionedNCAConfig(image_size=w, num_hidden_channels=hidden,
                               use_living_channel=use_life)
    c, a = cfg.num_channels, cfg.alive_channel
    thr = np.float32(cfg.alpha_living_threshold)
    near = np.array([np.nextafter(thr, np.float32(-1)), thr, np.nextafter(thr, np.float32(1)),
                     np.float32(0.7)], np.float32)
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w).astype(np.float32)
    xn = (12 * rng.randn(b, c, h, w)).astype(np.float32)
    for arr in (x, xn):
        arr[:, a] = np.where(rng.rand(b, h, w) < 0.7, np.float32(-0.2),
                             near[rng.randint(0, len(near), (b, h, w))])
    return cfg, torch.from_numpy(x).to(cuda), torch.from_numpy(xn).to(cuda)


@pytest.mark.parametrize("use_life", [True, False])
@pytest.mark.parametrize("hidden", [3, 16])
def test_cnca_gate_is_the_plain_gate_bit_for_bit(cuda, hidden, use_life):
    """cnca_gate at C 7 and 20 on CA_GRIDS and 64^2 b1, alpha on and one ulp
    around the threshold: out and life are the plain version's bits; without
    the living channel life is not written; once more on x, xn and out that
    are not 16-byte aligned (the 4-byte path)."""
    from vsnca_tpu_torch.ops import fused_cnca as fc

    for shape in CA_GRIDS + [(1, 64, 64)]:
        cfg, x, xn = _gate_inputs(cuda, shape, hidden, use_life, sum(shape) + hidden)
        out = torch.empty_like(x)
        life = torch.full((shape[0], *shape[1:]), 7, dtype=torch.uint8, device=cuda)
        fc.launch_gate(x, xn, out, life, cfg)
        want, want_life = fc.cnca_gate_reference(x, xn, cfg)
        assert torch.equal(out, want)
        if use_life:
            assert torch.equal(life, want_life)
        else:
            assert bool((life == 7).all())
    b, c, h, w = x.shape
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    ns = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(xn)
    out = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    assert xs.data_ptr() % 16 != 0
    fc.launch_gate(xs, ns, out, None, cfg)
    assert torch.equal(out, fc.cnca_gate_reference(x, xn, cfg)[0])


# ------------------------------------------------------ the export and the CLI lifecycle

@pytest.mark.parametrize("case", ["edges", "multiscale"])
def test_validate_export_on_card_matches_cpu(cuda, tmp_path, case):
    """validate_export at 64^2 x 8 steps on the card: both rollouts through
    the rollout kernel (nca_step for scales (0,), nca_step_ms for (0, 1)),
    each step one launch; the weights within half a uint8 step; the state
    and rgb differences within 1e-4 of the same call on the CPU."""
    import json

    from vsnca_tpu_torch.export.webgl import save_webgl_model
    from vsnca_tpu_torch.export.webgl_sim import validate_export

    if case == "edges":
        cfg = NCAConfig(c_in=12, fc_dim=96, conditioning="edges", padding_mode="circular")
        flags, kernel = dict(edge_conditioning=True), "nca_step"
    else:
        cfg = NCAConfig(c_in=16, fc_dim=128, conditioning="pos_emb", padding_mode="circular",
                        perception_scales=(0, 1))
        flags, kernel = dict(pos_emb=True, n_perception_scales=2), "nca_step_ms"
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = str(tmp_path / "model.json")
    save_webgl_model(path, [params], ["m"], **flags)
    with open(path) as f:
        bound = max(layer["scale"] for layer in json.load(f)["layers"]) / 510.0 + 1e-6
    before = dict(fs.KERNEL_LAUNCHES)
    got = validate_export(path, params, cfg, size=64, n_steps=8, seed=3, device="cuda")
    after = dict(fs.KERNEL_LAUNCHES)
    want = validate_export(path, params, cfg, size=64, n_steps=8, seed=3, device="cpu")
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {kernel: 16}
    assert got["weight_max_abs_diff"] <= bound and want["weight_max_abs_diff"] <= bound
    for k in ("state_max_abs_diff", "rgb_mean_abs_diff"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got, want)


def test_cli_checkpoint_round_trip_on_card(cuda, tmp_path):
    """The training CLI on the card (edge_conditioned, 32^2, batch 1, 1
    iteration, save_every 1, control videos): its checkpoint holds the
    trained params and the NHWC pool, loads back onto the card exactly,
    and --video-only on it writes the same control-video frames."""
    import cv2

    from vsnca_tpu_torch.convert import load_params_pickle, pool_from_jax
    from vsnca_tpu_torch.export.checkpoint import load_checkpoint
    from vsnca_tpu_torch.train import cli

    def frames(path):
        cap, out = cv2.VideoCapture(path), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            out.append(f)
        cap.release()
        return np.stack(out)

    out, again = str(tmp_path / "run"), str(tmp_path / "again")
    common = ["--preset", "edge_conditioned", "--img-size", "32", "--device", "cuda"]
    cli.main(common + ["--batch-size", "1", "--max-iterations", "1", "--save-every", "1",
                       "--make-videos", "--out", out])
    cli.main(common + ["--video-only", "--checkpoint", f"{out}/checkpoint", "--out", again])
    state = load_checkpoint(f"{out}/checkpoint")
    assert state["pool"].shape == (256, 32, 32, 12) and int(state["iteration"]) == 1
    params = load_params_pickle(f"{out}/checkpoint", "cuda")
    for k, v in params.items():
        assert v.device.type == "cuda"
        np.testing.assert_array_equal(v.cpu().numpy(), state["params"][k])
    pool = pool_from_jax(state["pool"], "cuda")
    assert pool.shape == (256, 12, 32, 32) and bool(torch.isfinite(pool).all())
    for name in ("style_img.mp4", "black_img.mp4"):
        a, b = frames(f"{out}/videos/{name}"), frames(f"{again}/videos/{name}")
        assert a.shape == (64, 32, 32, 3) and np.array_equal(a, b)


def _two_ranks_on_the_card(fn, arg):
    """``fn(arg)`` in 2 gloo ranks sharing cuda:0 (NCCL takes one rank a
    card), the kernels built here first so that the ranks only load them."""
    from vsnca_tpu_torch.ops import _build
    from vsnca_tpu_torch.parallel.mesh import run_ranks

    _build.build(_build.SOURCES)
    return run_ranks(fn, 2, "gloo", ["cuda:0", "cuda:0"], args=(arg,), timeout=600)


def test_fused_dp_pair_on_card_matches_the_whole_batch(cuda):
    """Each rank runs the training pair's kernels on its half of the batch:
    the states and (scaled by the rank count) the x gradient equal the
    whole batch's bits; the averaged parameter gradient is within
    TRAIN_TOL of the whole batch's (the slots sum in another order)."""
    from vsnca_tpu_torch.ops import fused_train as ft
    from vsnca_tpu_torch.parallel.ranks import fused_dp_rank

    cfg = NCAConfig(c_in=12, fc_dim=96, conditioning="pos_emb", padding_mode="circular",
                    update_rate=0.5)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((4, 12, 32, 32), generator=g) - 0.5
    gy = torch.randn((4, 12, 32, 32), generator=g)
    cond = dynca.make_conditioning(cfg, (32, 32), batch=4, device="cpu")
    ranks = _two_ranks_on_the_card(fused_dp_rank, dict(
        cfg=cfg, params={k: v.numpy() for k, v in params.items()}, x=x.numpy(),
        gy=gy.numpy(), cond=cond.numpy(), seed=77, n_steps=8))
    pc = {k: v.cuda().requires_grad_() for k, v in params.items()}
    xc = x.cuda().requires_grad_()
    state = ft.fused_rollout_train(pc, xc, 77, cfg, 8, cond.cuda(), cond_no_grad=True)
    ((state * gy.cuda()).sum() / 4).backward()
    np.testing.assert_array_equal(ranks[0]["state"], state.detach().cpu().numpy())
    np.testing.assert_array_equal(ranks[0]["grad_x"] / 2, xc.grad.cpu().numpy())
    for k, v in pc.items():
        want = v.grad.cpu().numpy()
        assert np.abs(ranks[0]["grads"][k] - want).max() <= 1e-4 * np.abs(want).max(), k
    for rank in ranks:
        c = rank["launches"]
        assert c["train:nca_step"] == c["train:nca_bwd_mlp"] == c["train:nca_bwd_adjoint"] == 8


def test_dp_trainer_on_card_matches_one_process(cuda):
    """``DyNCATrainer(mesh=...)`` in 2 ranks on the card (static_texture's
    cell at 32^2, batch 4, Gram + overflow, VGG16's fallback, 2
    iterations): each rank launches the pair's kernels sum(step_n) times;
    the first write-back is the one-process one; losses and parameters
    within TRAIN_TOL (1e-4)."""
    import dataclasses

    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.parallel.ranks import dp_train_rank
    from vsnca_tpu_torch.train import presets
    from vsnca_tpu_torch.train.trainer import DyNCATrainer

    nca, loss, train = presets.static_texture(img_size=32)
    train = dataclasses.replace(train, pool_size=8)
    style = np.random.RandomState(3).rand(4, 3, 32, 32).astype(np.float32) * 2 - 1
    steps = (8, 16)
    ranks = _two_ranks_on_the_card(dp_train_rank, [dict(
        nca=nca, loss=loss, train=train, inputs={"target_style": style},
        iterations=[{"step_n": n} for n in steps], keep_pools=True)])
    one = DyNCATrainer(nca, loss, train, vgg_params=load_vgg16(device="cuda")[0],
                       device="cuda")
    losses, first = [], None
    for n in steps:
        losses.append(one.train_iteration({"target_style": torch.from_numpy(style).cuda()},
                                          step_n=n).loss)
        first = one.pool.states.cpu().numpy() if first is None else first
    got = ranks[0][0]
    np.testing.assert_array_equal(got["pools"][0], first)
    np.testing.assert_allclose([log["loss"] for log in got["logs"]], losses, rtol=1e-4)
    for k, v in one.params.items():
        want = v.detach().cpu().numpy()
        assert np.abs(got["params"][k] - want).max() <= 1e-4 * np.abs(want).max(), k
    for rank in ranks:
        c = rank[0]["launches"]
        assert c["train:nca_step"] == c["train:nca_bwd_mlp"] == c["train:nca_bwd_adjoint"] \
            == sum(steps)


@pytest.mark.parametrize("cell", ["edges", "video_motion"])
def test_spatial_rollout_on_card_matches_the_dense_rollout(cuda, cell):
    """2 ranks of 32 rows on the card (a 1-row halo for the edges cell, 6
    for the video_motion cell's scales (0, 1)), 8 steps at rate 0.5, within
    TOL of the dense plain rollout on the card, with no kernel launched."""
    from vsnca_tpu_torch.parallel.ranks import spatial_rank
    from vsnca_tpu_torch.train import presets

    cfg = (presets.edge_conditioned() if cell == "edges" else presets.video_motion())[0]
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, cfg.c_in, 64, 48), generator=g) - 0.5
    cond = torch.rand((2, cfg.c_cond, 64, 48), generator=g) - 0.5
    ranks = _two_ranks_on_the_card(spatial_rank, [dict(
        cfg=cfg, params={k: v.numpy() for k, v in params.items()}, x=x.numpy(),
        cond=cond.numpy(), seed=5, n_steps=8, update_rate=0.5)])
    with torch.no_grad():
        want, _ = dynca.dynca_rollout({k: v.cuda() for k, v in params.items()}, x.cuda(), 5,
                                      cfg, 8, cond.cuda(), update_rate=0.5,
                                      rollout_path="xla")
    np.testing.assert_allclose(ranks[0][0]["state"], want.cpu().numpy(), rtol=0, atol=1e-4)


def test_fleet_on_card_takes_the_kernels(cuda):
    """``MultiStyleTrainer`` with 2 models on the card: each model through
    the pair's kernels, 2 x sum(step_n) launches of each."""
    import dataclasses

    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.ops import fused_train as ft
    from vsnca_tpu_torch.train import presets
    from vsnca_tpu_torch.train.multi import MultiStyleTrainer

    nca, loss, train = presets.static_texture(img_size=32)
    train = dataclasses.replace(train, pool_size=8)
    fleet = MultiStyleTrainer(nca, loss, train, (0, 1),
                              vgg_params=load_vgg16(device="cuda")[0], device="cuda")
    style = torch.rand((2, 4, 3, 32, 32), generator=torch.Generator().manual_seed(1)) * 2 - 1
    before = dict(ft.KERNEL_LAUNCHES)
    for n in (8, 16):
        log = fleet.train_iteration({"target_style": style.cuda()}, step_n=n)
        assert np.isfinite(log.losses).all()
    for k in ("nca_step", "nca_bwd_mlp", "nca_bwd_adjoint"):
        assert ft.KERNEL_LAUNCHES[k] - before[k] == 2 * 24, k
