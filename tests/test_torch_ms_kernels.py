"""The port's multiscale (perception_scales (0, 1)) rollout and training
pair, and the pair's frame taps, on the CPU — the plain versions of
``nca_step_ms``, ``nca_bwd_mlp_ms``, ``nca_bwd_adjoint_ms`` and the tap
injection — against the JAX package on the same numpy inputs, c8/f16 at
update_rate 1 so that the masks do not matter:

- the rollout against ``pallas_step.fused_rollout_chw`` (its multiscale
  builder ``_make_kernel_roll_ms``) in interpret mode and against the XLA
  scan ``dynca_rollout``, 16 x 128, 4 steps, every padding mode, with and
  without pos_emb;
- the pair's gradients (params, x0, cond) against ``jax.grad`` through the
  interpret-mode tiled pair ``fused_rollout_train_flat`` (8 x 128 b1, the
  tile-rows-4 geometry of test_pallas_train.py) and through the XLA scan
  (16 x 128 b2);
- the tapped pair, scales (0,) and (0, 1), taps after steps 1 and 3 of 4,
  against ``fused_rollout_train_flat(..., tap_steps=...)`` in interpret mode.

Then the plain versions against torch autograd of the eager steps at rate
0.5, with the same hash masks, on a ragged even grid.

Tolerances relative to the largest element of JAX's value: the states 1e-6,
the gradients 1e-4 (measured at most ~1e-6; ``-s`` prints them).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops.pallas_step import fused_rollout_chw as j_fused_rollout_chw
from vsnca_tpu.ops.pallas_train import fused_rollout_train_flat, plan_flat_train
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import params_from_jax
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops import fused_train as ft

torch.set_num_threads(1)

STATE_TOL, GRAD_TOL = 1e-6, 1e-4


def _err(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _case(pad="circular", conditioning=None, shape=(1, 16, 128), scales=(0, 1), seed=0):
    kw = dict(c_in=8, fc_dim=16, padding_mode=pad, conditioning=conditioning,
              perception_scales=scales, update_rate=1.0)
    jcfg = JNCAConfig(**kw)
    params = {k: np.asarray(v) for k, v in
              jdynca.dynca_init(jax.random.PRNGKey(seed), jcfg).items()}
    b, h, w = shape
    x = np.random.RandomState(seed + 1).uniform(-0.5, 0.5, (b, h, w, 8)).astype(np.float32)
    cond = None
    if conditioning == "pos_emb":
        cond = np.asarray(jdynca.make_conditioning(jcfg, (h, w), batch=b))
    return kw, jcfg, params, x, cond


@pytest.mark.parametrize("conditioning", [None, "pos_emb"])
@pytest.mark.parametrize("pad", ["circular", "replicate", "zeros"])
def test_ms_rollout_matches_jax_interpret_kernel_and_scan(pad, conditioning):
    kw, jcfg, params, x, cond = _case(pad, conditioning)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jcond = None if cond is None else jnp.asarray(cond)
    with pltpu.force_tpu_interpret_mode():
        jk = np.asarray(j_fused_rollout_chw(
            jp, jnp.asarray(x.transpose(0, 3, 1, 2)), jnp.int32(0), jcfg, 4,
            None if cond is None else jcond.transpose(0, 3, 1, 2)))
    js, _ = jdynca.dynca_rollout(jp, jnp.asarray(x), jax.random.PRNGKey(2), jcfg, 4,
                                 cond=jcond, remat="none")
    tp = params_from_jax(params, "cpu")
    before = fs.LAUNCHES
    got = fs.fused_rollout_chw(tp, _nchw(x), 5, NCAConfig(**kw), 4,
                               None if cond is None else _nchw(cond))
    assert fs.LAUNCHES == before  # the CPU path launches no kernel
    e_kernel, e_scan = _err(got.numpy(), jk), _err(_nhwc(got), np.asarray(js))
    print(f"\nms rollout {pad} {conditioning}: vs interpret kernel {e_kernel:.1e}, "
          f"vs XLA scan {e_scan:.1e}")
    assert e_kernel <= STATE_TOL and e_scan <= STATE_TOL


def test_ms_rollout_refuses_odd_sizes_and_other_scales():
    kw, _, params, x, _ = _case()
    tp, xt = params_from_jax(params, "cpu"), _nchw(x)
    with pytest.raises(ValueError, match="even H and W"):
        fs.fused_rollout_chw(tp, xt[..., :127], 0, NCAConfig(**kw), 1)
    with pytest.raises(ValueError, match=r"\(0,\) or \(0, 1\)"):
        fs.fused_rollout_chw(tp, xt, 0, NCAConfig(**{**kw, "perception_scales": (0, 1, 2)}),
                             1)


def _port_pair_grads(kw, params, x, cond, n_steps, tap_steps=(), tap_w=()):
    p = {k: v.requires_grad_() for k, v in params_from_jax(params, "cpu").items()}
    xt = _nchw(x).requires_grad_()
    ct = None if cond is None else _nchw(cond).requires_grad_()
    out = ft.fused_rollout_train(p, xt, 5, NCAConfig(**kw), n_steps, ct, tap_steps=tap_steps)
    s, taps = out if tap_steps else (out, [])
    loss = torch.sum(dynca.to_rgb(s) ** 2) + 0.1 * torch.sum(s ** 2)
    for t, w in zip(taps, tap_w):
        loss = loss + w * torch.sum(dynca.to_rgb(t) ** 2)
    loss.backward()
    grads = {k: v.grad.numpy() for k, v in p.items()}
    grads["x"] = _nhwc(xt.grad)
    if ct is not None:
        grads["cond"] = _nhwc(ct.grad)
    return _nhwc(s), [_nhwc(t) for t in taps], grads


def _jax_pair_grads(jcfg, params, x, cond, n_steps, route):
    def loss(p, xx, c):
        if route == "xla":
            s, rgb = jdynca.dynca_rollout(p, xx, jax.random.PRNGKey(2), jcfg, n_steps,
                                          cond=c, remat="none")
        else:
            s, rgb = fused_rollout_train_flat(p, xx, 5.0, jcfg, n_steps, cond_nhwc=c,
                                              interpret=True)
        return jnp.sum(rgb ** 2) + 0.1 * jnp.sum(s ** 2)

    args = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            None if cond is None else jnp.asarray(cond))
    with pltpu.force_tpu_interpret_mode():
        g = jax.grad(loss, argnums=(0, 1) if cond is None else (0, 1, 2))(*args)
    g = jax.tree_util.tree_map(np.asarray, g)
    out = dict(g[0])
    out["x"] = g[1]
    if cond is not None:
        out["cond"] = g[2]
    return out


@pytest.mark.parametrize("route,shape,conditioning", [
    ("interpret tiled pair", (1, 8, 128), None),
    ("interpret tiled pair", (1, 8, 128), "pos_emb"),
    ("xla", (2, 16, 128), "pos_emb"),
])
def test_ms_pair_gradients_match_jax(route, shape, conditioning):
    kw, jcfg, params, x, cond = _case(conditioning=conditioning, shape=shape)
    if route != "xla":
        assert plan_flat_train(jcfg, shape[1], 128, 4, need_dcond=cond is not None)[1:] == (
            "tiled", 4)
    jg = _jax_pair_grads(jcfg, params, x, cond, 4, route)
    _, _, pg = _port_pair_grads(kw, params, x, cond, 4)
    errs = {k: _err(pg[k], jg[k]) for k in jg}
    print(f"\nms pair vs JAX {route} {shape} {conditioning}: " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items()))
    assert set(pg) == set(jg)
    assert max(errs.values()) <= GRAD_TOL
    assert all(float(np.abs(v).max()) > 0 for v in jg.values())


@pytest.mark.parametrize("scales", [(0,), (0, 1)])
def test_tapped_pair_matches_jax_interpret_taps(scales):
    """Taps after steps 1 and 3 of 4: the tap frames, the final state and
    every gradient (each tap's loss weighted differently, so a cotangent
    injected at the wrong step shows)."""
    kw, jcfg, params, x, cond = _case(conditioning="pos_emb", shape=(1, 8, 128),
                                      scales=scales)
    taps, tap_w = (1, 3), (0.7, 1.3)

    def loss(p, xx):
        s, rgb, trgbs = fused_rollout_train_flat(p, xx, 5.0, jcfg, 4,
                                                 cond_nhwc=jnp.asarray(cond),
                                                 interpret=True, cond_no_grad=True,
                                                 tap_steps=taps)
        total = jnp.sum(rgb ** 2) + 0.1 * jnp.sum(s ** 2)
        for t, w in zip(trgbs, tap_w):
            total = total + w * jnp.sum(t ** 2)
        return total, (s, trgbs)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    with pltpu.force_tpu_interpret_mode():
        (_, (js, jtaps)), jg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jp, jnp.asarray(x))
    jg = {**{k: np.asarray(v) for k, v in jg[0].items()}, "x": np.asarray(jg[1])}
    s, tap_states, pg = _port_pair_grads(kw, params, x, _nchw(cond).numpy().transpose(
        0, 2, 3, 1), 4, taps, tap_w)
    e_state = max([_err(s, np.asarray(js))] + [
        _err(2.0 * t[..., :3], np.asarray(j)) for t, j in zip(tap_states, jtaps)])
    errs = {k: _err(pg[k], jg[k]) for k in jg}
    print(f"\ntapped pair {scales}: states {e_state:.1e}; grads " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items()))
    assert e_state <= STATE_TOL
    assert max(errs.values()) <= GRAD_TOL


def test_tap_steps_are_checked():
    kw, _, params, x, _ = _case(shape=(1, 8, 16))
    tp, xt = params_from_jax(params, "cpu"), _nchw(x)
    for bad in ((0,), (4,), (2, 2), (3, 1)):
        with pytest.raises(ValueError, match="tap_steps"):
            ft.fused_rollout_train(tp, xt, 0, NCAConfig(**kw), 4, tap_steps=bad)


@pytest.mark.parametrize("scales", [(0,), (0, 1)])
def test_tapped_pair_matches_autograd_at_half_rate(scales):
    """The plain pair with taps at rate 0.5 on a ragged even 12 x 20 grid
    equals torch autograd through the eager steps with the same hash masks:
    the final state, the taps and every gradient (dcond too), within 1e-5
    of each tensor's largest element (sums over pixels in another order)."""
    cfg = NCAConfig(c_in=5, fc_dim=12, padding_mode="circular", perception_scales=scales,
                    conditioning="pos_emb", update_rate=0.5)
    params = dynca.dynca_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 5, 12, 20), generator=g) - 0.5
    cond = dynca.make_conditioning(cfg, (12, 20), batch=2, device="cpu")
    gy = torch.randn(x.shape, generator=g)
    gt = [torch.randn(x.shape, generator=g) for _ in range(2)]

    def run(pair):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr, cr = x.clone().requires_grad_(), cond.clone().requires_grad_()
        if pair:
            y, taps = ft.fused_rollout_train(p, xr, 3, cfg, 5, cr, tap_steps=(1, 3))
        else:
            xs, taps = xr, []
            for s in range(5):
                if s in (1, 3):
                    taps.append(xs)
                xs = dynca.dynca_step(p, xs, fs.batch_mask(3, s, xs.shape, 0.5, "cpu"), cfg,
                                      cr)
            y = xs
        ((y * gy).sum() + sum((t * q).sum() for t, q in zip(taps, gt))).backward()
        return [y.detach(), *[t.detach() for t in taps], xr.grad, cr.grad,
                *[p[k].grad for k in ("w1", "b1", "w2", "b2")]]

    for a, b in zip(run(True), run(False)):
        assert _err(a.numpy(), b.numpy()) <= 1e-5


def test_ms_backward_plain_versions_match_autograd_of_one_step():
    """nca_bwd_mlp_reference + nca_bwd_adjoint_reference (multiscale, with a
    tap cotangent) of one step at rate 0.5 equal torch autograd through
    dynca_step with the same mask, float64 to 1e-12: the adjoint is the
    exact transpose of the percept, edge clamps and half-resolution wrap
    included."""
    cfg = NCAConfig(c_in=5, fc_dim=10, padding_mode="circular", perception_scales=(0, 1),
                    conditioning="pos_emb")
    params = {k: v.double() for k, v in
              dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu").items()}
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 5, 10, 14), generator=g, dtype=torch.float64) - 0.5
    gx = torch.randn((2, 5, 10, 14), generator=g, dtype=torch.float64)
    gtap = torch.randn((2, 5, 10, 14), generator=g, dtype=torch.float64)
    cond = dynca.make_conditioning(cfg, (10, 14), batch=2, device="cpu").double()
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, cr = x.clone().requires_grad_(), cond.clone().requires_grad_()
    mask = fs.batch_mask(3, 6, x.shape, 0.5, "cpu").double()
    (dynca.dynca_step(p, xr, mask, cfg, cr) * gx).sum().backward()
    packed = [t.double() for t in fs.pack_weights(params, 5, 2, "float32")]
    gp, dcond, dw1, db1, dw2, db2 = ft.nca_bwd_mlp_reference(packed, x, cond, gx, 3, 6, 0.5,
                                                             need_dcond=True, multiscale=True)
    tol = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ft.nca_bwd_adjoint(gp, gx, gtap, True), xr.grad + gtap, **tol)
    torch.testing.assert_close(dw1[:, :10], p["w1"].grad, **tol)
    torch.testing.assert_close(db1[:10], p["b1"].grad, **tol)
    torch.testing.assert_close(dw2[:10], p["w2"].grad, **tol)
    torch.testing.assert_close(db2, p["b2"].grad, **tol)
    torch.testing.assert_close(dcond, cr.grad, **tol)


@pytest.mark.parametrize("pad", ["circular", "replicate", "zeros"])
def test_multiscale_percept_is_perceive_multiscale(pad):
    """The kernels' percept order (fused_step.multiscale_percept) against
    the port's eager ``perceive_multiscale``, float64 to 1e-12."""
    from vsnca_tpu_torch.ops.perception import perceive_multiscale

    x = torch.rand((2, 5, 12, 20), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64) - 0.5
    torch.testing.assert_close(fs.multiscale_percept(x, pad),
                               perceive_multiscale(x, (0, 1), pad), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rollout_path", ["xla", "fused"])
def test_tapped_rollouts_match_jax(rollout_path):
    """``dynca_rollout_with_taps`` and ``dynca_rollout_schedule`` with a
    gradient, on the eager route ('xla', one rollout a chunk) and the pair
    ('fused', one call with in-kernel taps), against the JAX functions:
    the frames, the final state and the parameters' gradient of a loss on
    every frame."""
    kw, jcfg, params, x, cond = _case(conditioning="pos_emb", shape=(2, 8, 16))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    key = jax.random.PRNGKey(2)

    def jloss(p, which):
        if which == "segments":
            s, frames = jdynca.dynca_rollout_with_taps(p, jnp.asarray(x), key, jcfg, 3, 2,
                                                       cond=jnp.asarray(cond), remat="none")
        else:
            s, frames = jdynca.dynca_rollout_schedule(p, jnp.asarray(x), key, jcfg, (1, 3), 2,
                                                      cond=jnp.asarray(cond), remat="none")
            frames = jnp.stack(frames)
        return jnp.sum(frames ** 2) + 0.1 * jnp.sum(s ** 2), (s, frames)

    cfg = NCAConfig(**kw)
    for which in ("segments", "schedule"):
        (_, (js, jframes)), jg = jax.value_and_grad(jloss, has_aux=True)(jp, which)
        tp = {k: v.requires_grad_() for k, v in params_from_jax(params, "cpu").items()}
        if which == "segments":
            s, frames = dynca.dynca_rollout_with_taps(tp, _nchw(x), 0, cfg, 3, 2, _nchw(cond),
                                                      remat="none", rollout_path=rollout_path)
        else:
            s, frames = dynca.dynca_rollout_schedule(tp, _nchw(x), 0, cfg, (1, 3), 2,
                                                     _nchw(cond), remat="none",
                                                     rollout_path=rollout_path)
            frames = torch.stack(frames)
        (torch.sum(frames ** 2) + 0.1 * torch.sum(s ** 2)).backward()
        assert frames.shape == (3 if which == "segments" else 2, 2, 3, 8, 16)
        assert _err(_nhwc(s), np.asarray(js)) <= STATE_TOL
        assert _err(frames.detach().numpy().transpose(0, 1, 3, 4, 2),
                    np.asarray(jframes)) <= STATE_TOL
        for k in jg:
            assert _err(tp[k].grad.numpy(), np.asarray(jg[k])) <= GRAD_TOL, (which, k)
