"""The port's ConditionedNCA training pair (vsnca_tpu_torch.ops.fused_cnca)
on the CPU — its plain versions — against the JAX package:
``jax.value_and_grad`` through the XLA scan of ``conditioned_nca_step`` and
through the custom-VJP ``fused_cnca_train`` in interpret mode (as
tests/test_pallas_cnca.py:71-116 runs them), at fire rate 1 so that the
masks do not matter. Every gradient is compared: the UpdateNet's, the
perception's, x's and the ImageEncoder's, which reach the encoder through
the pair's goal cotangent. Then the pair against torch autograd of the eager
steps at fire rate 0.5 with the same hash masks, and each backward pass
against autograd of one step.

Tolerances: the output rtol 1e-5 / atol 1e-6, the loss (a sum of 10240
squares, summed in another order than XLA's) rtol 1e-5; gradients rtol 1e-4 /
atol 1e-5, as test_pallas_cnca.py holds the JAX pair to the JAX scan
(measured at most ~1e-6, printed with ``-s``); against torch autograd
rtol 1e-5 / atol 1e-6 (summation order only). The CUDA kernels are held
against these plain versions by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import ConditionedNCAConfig as JCfg
from vsnca_tpu.models import conditioned_nca as jcn
from vsnca_tpu.ops.pallas_cnca import fused_cnca_train as j_fused_train
from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.convert import cnca_params_from_jax
from vsnca_tpu_torch.models import conditioned_nca as cn
from vsnca_tpu_torch.ops import fused_cnca as fc
from vsnca_tpu_torch.ops import fused_step as fs

torch.set_num_threads(1)

N_STEPS = 5  # odd, as test_pallas_cnca.py: the TPU kernel's buffer parity


def _nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32).transpose(0, 3, 1, 2).copy())


def _flat_jax_grads(g):
    """The JAX gradient tree, keyed and laid out as the port's params."""
    g = jax.tree_util.tree_map(np.asarray, g)
    out = {"perception_w": g["perception_w"]}
    for name in ("update1", "update2", "update3"):
        out[f"{name}.w"] = g[name]["w"][0, 0]
        if "b" in g[name]:
            out[f"{name}.b"] = g[name]["b"]
    enc = g["encoder"]
    out["encoder.embed1.w"] = enc["embed1"]["w"].transpose(3, 2, 0, 1)
    out["encoder.embed1.b"] = enc["embed1"]["b"]
    out["encoder.embed2.w"] = enc["embed2"]["w"].transpose(3, 2, 0, 1)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """value_and_grad of sum(y^2) through the XLA scan and through the
    interpret-mode fused pair, 16^2, batch 2, 5 steps, the reference widths."""
    jcfg = JCfg(image_size=16, cell_fire_rate=1.0)
    params = jcn.conditioned_nca_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    x = np.zeros((2, 16, 16, jcfg.num_channels), np.float32)
    x[:, 8, 8, jcfg.alive_channel:] = 1.0
    x += 0.05 * rng.randn(*x.shape).astype(np.float32)
    goal = rng.rand(2, 16, 16, 3).astype(np.float32)
    goal_j = jnp.asarray(goal)

    def loss_xla(p, xx):
        genc = jcn.encode_goal(p, jcfg, goal_j)

        def body(carry, k):
            return jcn.conditioned_nca_step(p, carry, genc, k, jcfg), None

        y, _ = jax.lax.scan(body, xx, jax.random.split(jax.random.PRNGKey(3), N_STEPS))
        return jnp.sum(y ** 2), y

    def loss_fused(p, xx):
        y = j_fused_train(p, xx, jcn.encode_goal(p, jcfg, goal_j), jnp.float32(7.0), jcfg,
                          N_STEPS)
        return jnp.sum(y ** 2), y

    vg = lambda f: jax.value_and_grad(f, argnums=(0, 1), has_aux=True)  # noqa: E731
    (lx, yx), gx = vg(loss_xla)(params, jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        (lf, yf), gf = vg(loss_fused)(params, jnp.asarray(x))
    runs = {"xla": (float(lx), np.asarray(yx), _flat_jax_grads(gx[0]), np.asarray(gx[1])),
            "interpret pair": (float(lf), np.asarray(yf), _flat_jax_grads(gf[0]),
                               np.asarray(gf[1]))}
    return dict(params=jax.tree_util.tree_map(np.asarray, params), x=x, goal=goal, runs=runs)


def _port_grads(r, rollout_path, cfg=None):
    cfg = cfg or ConditionedNCAConfig(image_size=16, cell_fire_rate=1.0)
    p = {k: v.requires_grad_() for k, v in cnca_params_from_jax(r["params"], "cpu").items()}
    x = _nchw(r["x"]).requires_grad_()
    before = fc.LAUNCHES
    y = cn.conditioned_nca_grow(p, x, _nchw(r["goal"]), 7, cfg, N_STEPS, remat="none",
                                rollout_path=rollout_path)
    loss = torch.sum(y ** 2)
    loss.backward()
    assert fc.LAUNCHES == before  # the CPU path launches no kernel
    return float(loss.detach()), y.detach(), {k: v.grad for k, v in p.items()}, x.grad


@pytest.mark.parametrize("against", ["xla", "interpret pair"])
def test_pair_matches_jax_value_and_grad(jax_run, against):
    """The pair's plain version (rollout_path 'fused'): output, loss and all
    gradients, the encoder's included."""
    loss, y, grads, gx = _port_grads(jax_run, "fused")
    jl, jy, jg, jgx = jax_run["runs"][against]
    diffs = {k: float(np.abs(grads[k].numpy() - jg[k]).max() / np.abs(jg[k]).max())
             for k in jg}
    print(f"\npair vs JAX {against}: y {np.abs(y.numpy().transpose(0, 2, 3, 1) - jy).max():.1e}"
          ", grads max |port - JAX| / max |JAX|: "
          + ", ".join(f"{k} {v:.1e}" for k, v in diffs.items()))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), jy, rtol=1e-5, atol=1e-6)
    assert loss == pytest.approx(jl, rel=1e-5)
    assert set(grads) == set(jg)
    for k in jg:
        assert np.abs(jg[k]).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), jg[k], rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(gx.numpy().transpose(0, 2, 3, 1), jgx, rtol=1e-4, atol=1e-5)


def test_eager_grow_matches_jax_value_and_grad(jax_run):
    """The eager route (rollout_path 'xla', the JAX scan's counterpart)."""
    _, y, grads, gx = _port_grads(jax_run, "xla")
    _, jy, jg, jgx = jax_run["runs"]["xla"]
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), jy, rtol=1e-5, atol=1e-6)
    for k in jg:
        np.testing.assert_allclose(grads[k].numpy(), jg[k], rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(gx.numpy().transpose(0, 2, 3, 1), jgx, rtol=1e-4, atol=1e-5)


def _small(rate, use_life=True, seed=0):
    cfg = ConditionedNCAConfig(image_size=12, num_hidden_channels=4, update_hidden_dim=12,
                               cell_fire_rate=rate, use_living_channel=use_life)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(seed), cfg, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    x = cn.conditioned_nca_seed(cfg, 2, 12, "cpu")
    x = x + 0.2 * torch.randn(x.shape, generator=g)
    goal = torch.rand((2, 3, 12, 12), generator=g)
    return cfg, params, x, goal


@pytest.mark.parametrize("use_life", [True, False])
def test_pair_matches_autograd_of_eager_steps_at_half_rate(use_life):
    """At fire rate 0.5 the pair's gradients (all params, x) equal autograd
    through the eager steps with the same hash masks, and another seed
    gives other gradients: the backward replays the forward's masks."""
    cfg, params, x, goal = _small(0.5, use_life)

    def grads(path, seed):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr = x.clone().requires_grad_()
        y = cn.conditioned_nca_grow(p, xr, goal, seed, cfg, 6, rollout_path=path)
        y.square().sum().backward()
        return torch.cat([p[k].grad.flatten() for k in sorted(p)] + [xr.grad.flatten()])

    torch.testing.assert_close(grads("fused", 11), grads("xla", 11), rtol=1e-5, atol=1e-6)
    assert (grads("fused", 11) - grads("fused", 12)).abs().max() > 1e-3


def test_backward_passes_match_autograd_of_one_step():
    """cnca_bwd_mlp + cnca_bwd_adjoint (plain) of one step at rate 0.5,
    absolute step 3, against autograd through conditioned_nca_step with the
    same mask: the update weights', x's and the goal encoding's gradients."""
    cfg, params, x, goal = _small(0.5)
    genc = cn.encode_goal(params, cfg, goal).detach()
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    mask = fs.batch_mask(5, 3, x.shape, 0.5, "cpu")
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, gr = x.clone().requires_grad_(), genc.clone().requires_grad_()
    y = cn.conditioned_nca_step(p, xr, gr, mask, cfg)
    (y * gy).sum().backward()

    packed = fc.pack_weights(params, cfg, "float32")
    _, life = fc.cnca_step_reference(x, genc, packed, cfg, "float32", 5, 3, 0.5)
    g_xn, gp, sums = fc.cnca_bwd_mlp(packed, x, genc, life, gy, cfg, "float32", 5, 3, 0.5)
    dx, dgoal = fc.cnca_bwd_adjoint(x, gp, g_xn, packed[0], cfg)
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx, xr.grad, **tol)
    torch.testing.assert_close(dgoal, gr.grad, **tol)
    for k, v in fc._unpack_grads(sums, cfg).items():
        torch.testing.assert_close(v, p[k].grad, **tol)


def test_pair_bf16_rounds_at_the_kernel_places():
    """bf16: the pair's plain version against JAX's interpret-mode pair at
    bf16 — output and gradients within 5e-3 of their largest element (the
    same rounding places; one float32 ulp before a rounding moves a value
    by one bf16 ulp)."""
    jcfg = JCfg(image_size=8, num_hidden_channels=4, update_hidden_dim=16, cell_fire_rate=1.0)
    cfg = ConditionedNCAConfig(image_size=8, num_hidden_channels=4, update_hidden_dim=16,
                               cell_fire_rate=1.0)
    jp = jcn.conditioned_nca_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.RandomState(3)
    x = (0.3 * rng.randn(1, 8, 8, cfg.num_channels) + 0.2).astype(np.float32)
    genc = (0.3 * rng.randn(1, 8, 8, cfg.num_channels)).astype(np.float32)

    def loss(p, xx, gg):
        return jnp.sum(j_fused_train(p, xx, gg, jnp.float32(1.0), jcfg, 3,
                                     compute_dtype="bfloat16") ** 2)

    with pltpu.force_tpu_interpret_mode():
        jg = jax.grad(loss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(genc))
    want = _flat_jax_grads(jg[0])
    p = {k: v.requires_grad_() for k, v in
         cnca_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu").items()}
    xr, gr = _nchw(x).requires_grad_(), _nchw(genc).requires_grad_()
    fc.fused_cnca_train(p, xr, gr, 1, cfg, 3, "bfloat16").square().sum().backward()
    pairs = {k: (p[k].grad.numpy(), want[k]) for k in fc.WEIGHT_KEYS}
    pairs["x"] = (xr.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jg[1]))
    pairs["goal"] = (gr.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jg[2]))
    for k, (a, b) in pairs.items():
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, rtol=5e-3, atol=5e-3, err_msg=k)


def test_route_rule():
    """grow's one routing rule: on a card the pair with a gradient and the
    rollout kernels without; eager steps on the CPU under 'auto' and
    everywhere under 'xla'; 'fused' the kernels' plain versions on the CPU."""
    r = cn.cnca_route
    assert r("cuda", True) == "pair" and r("cuda", False) == "rollout"
    assert r("cpu", True) == "eager" and r("cpu", False) == "eager"
    assert r("cpu", True, "fused") == "pair" and r("cpu", False, "fused") == "rollout"
    assert r("cuda", True, "xla") == "eager"
    with pytest.raises(ValueError, match="rollout_path"):
        r("cuda", True, "scan")
