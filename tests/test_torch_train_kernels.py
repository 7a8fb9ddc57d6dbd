"""The port's training pair (vsnca_tpu_torch.ops.fused_train) on the CPU —
its plain versions — against the JAX package: ``jax.grad`` through the flat
custom-VJP pair ``pallas_train.fused_rollout_train_flat`` in interpret mode
(as tests/test_pallas_train.py runs it), for each backward the TPU planner
can pick ('gather', 'scatter', 'tiled'), at update_rate=1 so that the masks
do not matter. Also each backward plain version against torch autograd of
one eager ``dynca_step``, and the hash masks at rate 0.5 replayed by the
backward.

Tolerances (gradients scaled by the largest element of the reference, as
test_pallas_train.py::_grads_match does): float32 1e-5, for summation
order (measured at most 3.8e-7); bfloat16 5e-3 — both round the percept,
hid, gdx, gz1 and the weights to bf16 at the same places, but one float32
ulp of difference before a rounding moves a value by one bf16 ulp (2^-8
relative), and the reverse walk carries such steps on (measured at most
1.0e-3, on the conditioning cotangent; 1.7e-4 on x, 6e-6 on the weights).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py. ``-s`` prints the measured
differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops.pallas_train import fused_rollout_train_flat, plan_flat_train
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import params_from_jax
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops import fused_train as ft

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _scaled_close(got, want, tol, name):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol, err_msg=name)


def _inputs(conditioning, h, seed=0):
    kw = dict(c_in=12, fc_dim=16, padding_mode="circular", conditioning=conditioning,
              update_rate=1.0)
    jcfg = JNCAConfig(**kw)
    params = {k: np.asarray(v) for k, v in
              jdynca.dynca_init(jax.random.PRNGKey(seed), jcfg).items()}
    rng = np.random.RandomState(seed + 1)
    x = rng.uniform(-0.5, 0.5, (2, h, 128, 12)).astype(np.float32)
    cond = None
    if conditioning == "edges":
        gray = jnp.asarray(rng.uniform(0, 1, (2, h, 128, 1)).astype(np.float32))
        cond = np.asarray(jdynca.make_conditioning(jcfg, (h, 128), cond_img=gray))
    elif conditioning == "pos_emb":
        cond = np.asarray(jdynca.make_conditioning(jcfg, (h, 128), batch=2))
    return kw, jcfg, params, x, cond


def _jax_grads(jcfg, params, x, cond, n_steps, mode, cdt, cond_no_grad):
    def loss(p, x, c):
        s, rgb = fused_rollout_train_flat(p, x, 5.0, jcfg, n_steps, cond_nhwc=c,
                                          compute_dtype=cdt, interpret=True,
                                          force_mode=mode, cond_no_grad=cond_no_grad)
        return jnp.sum(rgb ** 2) + 0.1 * jnp.sum(s ** 2)

    args = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            None if cond is None else jnp.asarray(cond))
    with pltpu.force_tpu_interpret_mode():
        g = jax.grad(loss, argnums=(0, 1) if cond is None else (0, 1, 2))(*args)
    return jax.tree_util.tree_map(np.asarray, g)


def _port_grads(kw, params, x, cond, n_steps, cdt, cond_no_grad):
    p = {k: v.requires_grad_() for k, v in params_from_jax(params, "cpu").items()}
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    ct = None
    if cond is not None:
        ct = torch.from_numpy(cond.transpose(0, 3, 1, 2).copy()).requires_grad_()
    before = ft.LAUNCHES
    s = ft.fused_rollout_train(p, xt, 5, NCAConfig(**kw), n_steps, ct, compute_dtype=cdt,
                               cond_no_grad=cond_no_grad)
    rgb = dynca.to_rgb(s)
    (torch.sum(rgb ** 2) + 0.1 * torch.sum(s ** 2)).backward()
    assert ft.LAUNCHES == before  # the CPU path launches no kernel
    nhwc = lambda t: t.grad.numpy().transpose(0, 2, 3, 1)  # noqa: E731
    return ({k: v.grad.numpy() for k, v in p.items()}, nhwc(xt),
            None if ct is None or ct.grad is None else nhwc(ct))


# (mode, conditioning, compute dtype, cond_no_grad, H): every backward the
# TPU planner picks, each conditioning, both dtypes and both cond_no_grad
# settings; 'scatter' needs two row tiles of at most 16 rows at W = 128.
CASES = [
    ("gather", "pos_emb", "float32", False, 8),
    ("gather", "edges", "bfloat16", True, 8),
    ("scatter", "pos_emb", "float32", False, 32),
    ("tiled", "edges", "float32", False, 8),
    ("tiled", "pos_emb", "bfloat16", False, 8),
    ("tiled", None, "float32", True, 8),
]


@pytest.mark.parametrize("mode,conditioning,cdt,cond_no_grad,h", CASES)
def test_pair_matches_jax_grad_through_interpret_kernels(mode, conditioning, cdt,
                                                         cond_no_grad, h):
    kw, jcfg, params, x, cond = _inputs(conditioning, h)
    assert plan_flat_train(jcfg, h, 128, 4, force_mode=mode) is not None
    jg = _jax_grads(jcfg, params, x, cond, 4, mode, cdt, cond_no_grad)
    pg, px, pc = _port_grads(kw, params, x, cond, 4, cdt, cond_no_grad)
    pairs = {k: (pg[k], jg[0][k]) for k in ("w1", "b1", "w2", "b2")}
    pairs["x"] = (px, jg[1])
    if cond is not None and not cond_no_grad:
        pairs["cond"] = (pc, jg[2])
    print(f"\n{mode} {conditioning} {cdt} cond_no_grad={cond_no_grad} {h}x128, "
          "max |port - JAX| / max |JAX|: " + ", ".join(
              f"{k} {np.abs(a - b).max() / np.abs(b).max():.1e}" for k, (a, b) in pairs.items()))
    for k in ("w1", "b1", "w2", "b2"):
        _scaled_close(pg[k], jg[0][k], TOL[cdt], k)
    _scaled_close(px, jg[1], TOL[cdt], "x")
    if cond is not None:
        if cond_no_grad:
            assert pc is None and not jg[2].any()
        else:
            _scaled_close(pc, jg[2], TOL[cdt], "cond")


@pytest.mark.parametrize("conditioning", [None, "pos_emb"])
def test_backward_plain_versions_match_autograd_of_one_step(conditioning):
    """nca_bwd_mlp_reference + nca_bwd_adjoint_reference of one step at rate
    0.5 (absolute step 6) equal torch autograd through dynca_step with the
    same hash mask; float32, rtol 1e-5 / atol 1e-6, ragged 11 x 19."""
    cfg = NCAConfig(c_in=5, fc_dim=10, padding_mode="circular", conditioning=conditioning)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 5, 11, 19), generator=g) - 0.5
    gx = torch.randn((2, 5, 11, 19), generator=g)
    cond = None if conditioning is None else dynca.make_conditioning(cfg, (11, 19), batch=2,
                                                                     device="cpu")
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr = x.clone().requires_grad_()
    cr = None if cond is None else cond.clone().requires_grad_()
    mask = fs.batch_mask(3, 6, x.shape, 0.5, "cpu")
    assert 0.3 < float(mask.mean()) < 0.7
    (dynca.dynca_step(p, xr, mask, cfg, cr) * gx).sum().backward()

    packed = fs.pack_weights(params, 5, cfg.c_cond, "float32")
    gp, dcond, dw1, db1, dw2, db2 = ft.nca_bwd_mlp(packed, x, cond, gx, 3, 6, 0.5,
                                                   need_dcond=cond is not None)
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ft.nca_bwd_adjoint(gp, gx), xr.grad, **tol)
    torch.testing.assert_close(dw1[:, :10], p["w1"].grad, **tol)
    torch.testing.assert_close(db1[:10], p["b1"].grad, **tol)
    torch.testing.assert_close(dw2[:10], p["w2"].grad, **tol)
    torch.testing.assert_close(db2, p["b2"].grad, **tol)
    if cond is not None:
        torch.testing.assert_close(dcond, cr.grad, **tol)


def test_masks_replay_in_the_backward_at_half_rate():
    """At rate 0.5 the pair's gradients equal autograd through the eager
    steps with the same hash masks, and another seed gives other gradients:
    the backward redraws the forward's masks, step for step."""
    cfg = NCAConfig(c_in=6, fc_dim=12, padding_mode="circular", conditioning="pos_emb")
    params = dynca.dynca_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    x = torch.rand((2, 6, 9, 13), generator=torch.Generator().manual_seed(3)) - 0.5
    cond = dynca.make_conditioning(cfg, (9, 13), batch=2, device="cpu")

    def grads(fn, seed):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        fn(p, seed).square().sum().backward()
        return torch.cat([p[k].grad.flatten() for k in ("w1", "b1", "w2", "b2")])

    pair = lambda p, s: ft.fused_rollout_train(p, x, s, cfg, 6, cond)  # noqa: E731

    def eager(p, s):
        return dynca.dynca_rollout(p, x, s, cfg, 6, cond, rollout_path="xla")[0]

    torch.testing.assert_close(grads(pair, 11), grads(eager, 11), rtol=1e-5, atol=1e-6)
    assert (grads(pair, 11) - grads(pair, 12)).abs().max() > 1e-3


@pytest.mark.parametrize("remat", ["per_step", "segment:2", "segment:4"])
def test_eager_rollout_remat_policies_give_the_same_gradients(remat):
    """The remat policies change what the backward recomputes, never the
    values (segment:4 does not divide 6 steps: per-step, as in JAX)."""
    cfg = NCAConfig(c_in=4, fc_dim=8, padding_mode="replicate", perception_scales=(0, 1))
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.rand((1, 4, 8, 8), generator=torch.Generator().manual_seed(1)) - 0.5

    def grads(policy):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        s, _ = dynca.dynca_rollout(p, x, 0, cfg, 6, remat=policy)
        s.square().sum().backward()
        return [p[k].grad for k in ("w1", "b1", "w2", "b2")]

    for a, b in zip(grads(remat), grads("none")):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", ["padding", "scales", "steps"])
def test_pair_refuses_what_it_does_not_compute(bad):
    kw = dict(c_in=4, fc_dim=8, padding_mode="circular")
    if bad == "padding":
        kw["padding_mode"] = "replicate"
    elif bad == "scales":
        kw["perception_scales"] = (0, 1, 2)
    cfg = NCAConfig(**kw)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    n_steps = 0 if bad == "steps" else 2
    assert not ft.fused_train_supported(cfg, n_steps)
    with pytest.raises(ValueError, match="training pair|perception_scales"):
        ft.fused_rollout_train(params, torch.zeros((1, 4, 8, 8)), 0, cfg, n_steps)


def test_rollout_route_runs_kernels_on_the_card_wherever_jax_runs_pallas():
    """``dynca_rollout``'s one routing rule, for a CUDA tensor: the pair
    for a trainable circular config at scales (0,) or (0, 1), the rollout
    kernels without a gradient under any padding, eager steps where the JAX
    trainer scans (other paddings under a gradient, other scales),
    NotImplementedError for a circular config past the kernels' size
    limits; on the CPU 'auto' is eager and 'fused' the pair."""
    route = dynca.rollout_route
    circ = dict(padding_mode="circular")
    st = NCAConfig(c_in=12, fc_dim=96, conditioning="pos_emb", **circ)
    assert route(st, 8, "cuda", True) == "pair"
    assert route(st, 8, "cuda", False) == "step"
    assert route(st, 8, "cpu", True) == "eager"
    assert route(st, 8, "cpu", True, "fused") == "pair"
    assert route(st, 8, "cuda", True, "xla") == "eager"
    assert route(NCAConfig(padding_mode="replicate"), 8, "cuda", True) == "eager"
    assert route(NCAConfig(perception_scales=(0, 1, 2), **circ), 8, "cuda", True) == "eager"
    assert route(NCAConfig(perception_scales=(0, 1, 2), **circ), 8, "cuda", False) == "eager"
    for pad in ("circular", "replicate", "zeros"):
        ms = NCAConfig(perception_scales=(0, 1), padding_mode=pad)
        assert route(ms, 8, "cuda", False) == "step"
        assert route(ms, 8, "cuda", True) == ("pair" if pad == "circular" else "eager")
    with pytest.raises(NotImplementedError, match="kernels take C <= 16"):
        route(NCAConfig(c_in=20, **circ), 8, "cuda", True)
    with pytest.raises(ValueError, match="rollout_path"):
        route(st, 8, "cuda", True, "scan")


def test_dynca_rollout_routes_cpu_calls_as_asked():
    """On a CPU tensor 'fused' runs the pair's plain version (no kernel
    launch) and 'auto' the eager steps; both give the same state."""
    cfg = NCAConfig(c_in=6, fc_dim=12, conditioning="pos_emb", padding_mode="circular")
    params = dynca.dynca_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    x = torch.rand((1, 6, 8, 10), generator=torch.Generator().manual_seed(5)) - 0.5
    cond = dynca.make_conditioning(cfg, (8, 10), batch=1, device="cpu")
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = (ft.LAUNCHES, fs.LAUNCHES)
    fused, _ = dynca.dynca_rollout(p, x, 2, cfg, 5, cond, rollout_path="fused")
    eager, _ = dynca.dynca_rollout(p, x, 2, cfg, 5, cond)
    assert (ft.LAUNCHES, fs.LAUNCHES) == before
    assert fused.grad_fn is not None and eager.grad_fn is not None
    torch.testing.assert_close(fused, eager, rtol=1e-5, atol=1e-6)
