"""The plain versions that the card holds the redesigned single-scale stencil
adjoints ``nca_bwd_adjoint`` and ``cnca_bwd_adjoint`` to, against the JAX
package, at the shapes the kernels' new staging must get right.

- ``fused_train.nca_bwd_adjoint_reference(gp, gx, gtap, False)`` against
  ``gx + vjp(gp)`` (``+ gtap``), the VJP taken by ``jax.vjp`` of
  ``vsnca_tpu/ops/perception.py::perceive`` (circular), at 8^2 (the
  footprint wraps more than once), 18^2 and 34x66 (rows not a multiple of 4
  floats) and 40x72 (ragged against 32 x 16 tiles), batch 2, C 5 and 12,
  with a tap and without.
- ``fused_cnca.cnca_bwd_adjoint_reference(x, gp, g, wcol, cfg)`` against
  ``g + vjp(gp)`` and ``vjp(gp) * alive_mask(x)``, the VJP taken by
  ``jax.vjp`` of ``vsnca_tpu/models/conditioned_nca.py::_depthwise_perceive``
  at xg, at 8^2, 24x40 and 34x66, batch 2, C 20 / D 64 (the reference
  widths) and C 7 (a tail of the kernel's channel pairs), living channel on
  (a sparse alpha plane, so that the mask has holes) and off.

Tolerance: 1e-6 of the largest element, as ``tests/test_torch_b7_shapes.py``
holds the multiscale adjoint (the two sides sum the same terms in other
orders; the measured value is printed with ``-s``). The JAX side runs on
the CPU under ``jax.jit``; inputs come from numpy with fixed seeds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import ConditionedNCAConfig as JCfg
from vsnca_tpu.models import conditioned_nca as jcn
from vsnca_tpu.ops.perception import perceive
from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.ops import fused_cnca as fc
from vsnca_tpu_torch.ops import fused_train as ft

torch.set_num_threads(1)

ADJ_TOL = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _scaled(got, want) -> float:
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@jax.jit
def _percept_vjp(x, gp):
    _, vjp = jax.vjp(lambda v: perceive(v, "circular"), x)
    return vjp(gp)[0]


@pytest.mark.parametrize("tap", [False, True])
@pytest.mark.parametrize("c", [5, 12])
@pytest.mark.parametrize("h,w", [(8, 8), (18, 18), (34, 66), (40, 72)])
def test_adjoint_plain_version_is_the_percept_vjp(h, w, c, tap):
    rng = np.random.RandomState(h * 131 + w + c)
    x = rng.uniform(-0.5, 0.5, (2, h, w, c)).astype(np.float32)
    gp = rng.randn(2, h, w, 4 * c).astype(np.float32)
    gx = rng.randn(2, h, w, c).astype(np.float32)
    gtap = rng.randn(2, h, w, c).astype(np.float32)
    want = gx + np.asarray(_percept_vjp(jnp.asarray(x), jnp.asarray(gp)))
    if tap:
        want = want + gtap
    got = ft.nca_bwd_adjoint_reference(_nchw(gp), _nchw(gx), _nchw(gtap) if tap else None)
    err = _scaled(_nhwc(got), want)
    print(f"\nnca_bwd_adjoint_reference {h}x{w} C{c} tap {tap}: {err:.2e} of max "
          f"(tol {ADJ_TOL:.0e})")
    assert err <= ADJ_TOL


@jax.jit
def _depthwise_vjp(xg, w, gp):
    _, vjp = jax.vjp(lambda v: jcn._depthwise_perceive(v, w), xg)
    return vjp(gp)[0]


@pytest.mark.parametrize("use_life", [True, False])
@pytest.mark.parametrize("hidden,h,w", [(16, 8, 8), (16, 24, 40), (16, 34, 66), (3, 24, 40)])
def test_cnca_adjoint_plain_version_is_the_depthwise_vjp(hidden, h, w, use_life):
    kw = dict(image_size=w, num_hidden_channels=hidden, use_living_channel=use_life)
    jcfg, cfg = JCfg(**kw), ConditionedNCAConfig(**kw)
    c = cfg.num_channels
    rng = np.random.RandomState(hidden * 17 + h * 7 + w)
    x = np.zeros((2, h, w, c), np.float32)
    x[:, h // 2, w // 2, cfg.alive_channel:] = 1.0
    x += 0.3 * rng.randn(*x.shape).astype(np.float32)
    x[..., cfg.alive_channel] *= 0.15  # a sparse living channel: the mask has holes
    xg = x + 0.3 * rng.randn(*x.shape).astype(np.float32)
    wk = (0.3 * rng.randn(c, 3, 3, 3)).astype(np.float32)
    gp = rng.randn(2, h, w, 3 * c).astype(np.float32)
    g = rng.randn(2, h, w, c).astype(np.float32)
    g_xg = np.asarray(_depthwise_vjp(jnp.asarray(xg), jnp.asarray(wk), jnp.asarray(gp)))
    pre = np.asarray(jcn.alive_mask(jnp.asarray(x), jcfg), np.float32)
    got_g, got_dgoal = fc.cnca_bwd_adjoint_reference(
        _nchw(x), _nchw(gp), _nchw(g), torch.from_numpy(wk.reshape(c, 27)), cfg)
    errs = (_scaled(_nhwc(got_g), g + g_xg), _scaled(_nhwc(got_dgoal), g_xg * pre))
    print(f"\ncnca_bwd_adjoint_reference {h}x{w} C{c} living {use_life}: g {errs[0]:.2e}, "
          f"dgoal {errs[1]:.2e} of max (tol {ADJ_TOL:.0e}); alive share {pre.mean():.3f}")
    assert max(errs) <= ADJ_TOL
    assert 0.05 < pre.mean() < 0.5 if use_life else pre.mean() == 1.0
