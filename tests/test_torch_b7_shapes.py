"""The plain versions that the card holds the redesigned ``nca_bwd_adjoint_ms``
and ``cnca_update`` kernels to, against the JAX package, at the shapes the
kernels' new staging must get right.

- ``fused_train.nca_bwd_adjoint_reference(gp, gx, gtap, True)`` against
  ``gx + vjp(gp) + gtap``, the VJP taken by ``jax.vjp`` of
  ``vsnca_tpu/ops/perception.py::perceive_multiscale`` (circular, scales
  (0, 1)), at 16^2 (the half-resolution footprint wraps more than once), 18^2
  (odd half size), 34x66 and 40x72 (ragged against 16 x 16 blocks), batch 2,
  C 8, with a tap and without. Tolerance: 1e-6 of the largest element (the
  two sum the same terms in other orders; measured at most ~2.5e-7, printed
  with ``-s``).
- ``fused_cnca.cnca_update_reference`` at fire rate 1 against
  ``vsnca_tpu/models/conditioned_nca.py::conditioned_nca_step`` at 8^2,
  24x40 and 64^2, batch 2, C 20 / D 64 (the reference widths). The JAX step
  does not split before its gate: without the living channel the gate is the
  clamp alone, which these states do not reach, so the update is compared
  with the step; with it, the update and ``cnca_gate_reference`` (that is
  ``cnca_step_reference``) are. Tolerance: rtol 1e-5 / atol 1e-6, as
  tests/test_torch_cnca.py holds the step (measured at most ~1e-7).

The JAX side runs on the CPU under ``jax.jit``, as the JAX package's tests
run it; inputs come from numpy with fixed seeds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import ConditionedNCAConfig as JCfg
from vsnca_tpu.models import conditioned_nca as jcn
from vsnca_tpu.ops.perception import perceive_multiscale
from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.convert import cnca_params_from_jax
from vsnca_tpu_torch.ops import fused_cnca as fc
from vsnca_tpu_torch.ops import fused_train as ft

torch.set_num_threads(1)

ADJ_TOL = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@jax.jit
def _percept_vjp(x, gp):
    _, vjp = jax.vjp(lambda v: perceive_multiscale(v, (0, 1), "circular"), x)
    return vjp(gp)[0]


@pytest.mark.parametrize("tap", [False, True])
@pytest.mark.parametrize("h,w", [(16, 16), (18, 18), (34, 66), (40, 72)])
def test_multiscale_adjoint_plain_version_is_the_percept_vjp(h, w, tap):
    c = 8
    rng = np.random.RandomState(h * 131 + w)
    x = rng.uniform(-0.5, 0.5, (2, h, w, c)).astype(np.float32)
    gp = rng.randn(2, h, w, 4 * c).astype(np.float32)
    gx = rng.randn(2, h, w, c).astype(np.float32)
    gtap = rng.randn(2, h, w, c).astype(np.float32)
    want = gx + np.asarray(_percept_vjp(jnp.asarray(x), jnp.asarray(gp)))
    if tap:
        want = want + gtap
    got = ft.nca_bwd_adjoint_reference(_nchw(gp), _nchw(gx), _nchw(gtap) if tap else None, True)
    err = float(np.abs(_nhwc(got) - want).max()) / float(np.abs(want).max())
    print(f"\nnca_bwd_adjoint_reference {h}x{w} tap {tap}: {err:.2e} of max (tol {ADJ_TOL:.0e})")
    assert err <= ADJ_TOL


def _cnca_case(h, w, use_life, seed=0):
    kw = dict(image_size=w, cell_fire_rate=1.0, use_living_channel=use_life)
    jcfg, cfg = JCfg(**kw), ConditionedNCAConfig(**kw)
    jp = jcn.conditioned_nca_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + h * 7 + w)
    c = cfg.num_channels
    x = np.zeros((2, h, w, c), np.float32)
    x[:, h // 2, w // 2, cfg.alive_channel:] = 1.0
    x += 0.3 * rng.randn(*x.shape).astype(np.float32)
    goal = (0.3 * rng.randn(2, h, w, c)).astype(np.float32)
    params = cnca_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, params, x, goal


@pytest.mark.parametrize("use_life", [True, False])
@pytest.mark.parametrize("h,w", [(8, 8), (24, 40), (64, 64)])
def test_cnca_update_plain_version_matches_the_jax_step(h, w, use_life):
    jcfg, cfg, jp, params, x, goal = _cnca_case(h, w, use_life)
    step = jax.jit(lambda p, a, g: jcn.conditioned_nca_step(p, a, g, jax.random.PRNGKey(3),
                                                            jcfg))
    want = np.asarray(step(jp, jnp.asarray(x), jnp.asarray(goal)))
    packed = fc.pack_weights(params, cfg, "float32")
    xn = fc.cnca_update_reference(_nchw(x), _nchw(goal), packed, cfg, "float32", 3, 5, 1.0)
    if use_life:
        got, _ = fc.cnca_gate_reference(_nchw(x), xn, cfg)
    else:
        assert float(xn.abs().max()) < cfg.clamp_value  # the gate is the identity here
        got = xn
    err = float(np.abs(_nhwc(got) - want).max())
    print(f"\ncnca_update_reference {h}x{w} living {use_life}: max|port-jax| {err:.2e}")
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)
