"""The plain versions that the card holds the redesigned ``nca_step_mat``
and ``cnca_gate`` to, against the JAX package, at the shapes the kernels'
new staging must get right.

- ``fused_step.fused_rollout_chw_reference(..., algo="mat")`` (one
  ``reference_step(..., mat=True)`` a step) against the JAX folded-stencil
  step: the TPU kernel's function (``pallas_step._make_kernel_roll`` with
  ``mat_stencil=True``) composed from the JAX package's own pieces — the
  raw 3x3 taps of ``vsnca_tpu/ops/padding.py::pad2d``, W_eff from
  ``pallas_step.stencil_folded_w1`` and the kernel's MLP tail
  ``pallas_step._mlp_dx`` — since the Pallas kernel itself takes only
  W % 128 == 0 and H % 8 == 0. Shapes 8^2 (the halo wraps), 18^2 and 34x66
  (rows not a multiple of 4 floats), 40x72 (ragged against 16 x 16 tiles),
  batch 2, C 12 and 5, all three paddings, conditioning none and edges,
  float32 and bf16 compute, 2 steps at update rate 1. One more test holds
  that composition to the interpret-mode Pallas kernel at 8 x 128.
- ``fused_cnca.cnca_gate_reference(x, xn, cfg)`` against the JAX gate:
  ``models/conditioned_nca.py``'s ``alive_mask`` of x and of xn (the
  reference's -inf-padded pool) and, beside it, the TPU kernel's
  ``alive_from`` rule (a zero-filled 3x3 max, pallas_cnca.py:82), then
  ``jnp.clip(xn * (pre & post))``; alpha values on ``athr`` and one float32
  ulp either side of it, at 8^2, 24x40 and 34x66, batch 2, C 20 and 7,
  living channel on and off. Held exactly.

Tolerances: float32 1e-6 of the largest element (both sides sum the same
float32 products, in other orders); bf16 compute rtol 1e-3 / atol 1e-3, as
tests/test_torch_rollout_algos.py holds 'mat' (the same rounding places;
one float32 ulp before a rounding moves a value by one bf16 ulp). ``-s``
prints the measured differences. Inputs come from numpy with fixed seeds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import ConditionedNCAConfig as JCfg
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import conditioned_nca as jcn
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops import pallas_step
from vsnca_tpu.ops.padding import pad2d
from vsnca_tpu_torch.config import ConditionedNCAConfig, NCAConfig
from vsnca_tpu_torch.convert import params_from_jax
from vsnca_tpu_torch.ops import fused_cnca as fc
from vsnca_tpu_torch.ops import fused_step as fs

torch.set_num_threads(1)

F32_TOL = 1e-6
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
STEPS = 2


def _jax_mat_step(params, x, cond, pad: str, cdt: str):
    """One folded-stencil step at update rate 1 in the JAX package's
    arithmetic: x [B, C, H, W], cond [B, cc, H, W] or None, numpy."""
    b, c, h, w = x.shape
    f = params["w1"].shape[1]
    dt = jnp.dtype(cdt)
    p = pad2d(jnp.asarray(x.transpose(0, 2, 3, 1)), 1, pad)  # NHWC
    taps = [p[:, di:di + h, dj:dj + w, :] for di in range(3) for dj in range(3)]
    if cond is not None:
        taps.append(jnp.asarray(cond.transpose(0, 2, 3, 1)))
    percept = jnp.concatenate(taps, axis=-1)  # [B, H, W, 9C + cc], rows (di*3 + dj)*C + c
    w1 = params["w1"][: percept.shape[-1] - 9 * c + 4 * c]
    w1t = pallas_step.stencil_folded_w1(jnp.asarray(w1), c).T.astype(dt)
    w2t = jnp.asarray(params["w2"]).T.astype(dt)
    b1 = jnp.asarray(params["b1"], jnp.float32)
    b2 = jnp.asarray(params["b2"], jnp.float32)
    out = []
    for i in range(b):
        flat = percept[i].reshape(h * w, -1).T.astype(dt)  # [P, H*W]
        dx = pallas_step._mlp_dx(flat, w1t, b1, w2t, b2, c, f, h, w, dt)
        out.append(jnp.asarray(x[i]) + dx)
    return np.asarray(jnp.stack(out))


def _mat_inputs(c, conditioning, h, w, seed):
    jcfg = JNCAConfig(c_in=c, fc_dim=16, conditioning=conditioning)
    params = {k: np.asarray(v) for k, v in jdynca.dynca_init(jax.random.PRNGKey(seed),
                                                             jcfg).items()}
    rng = np.random.RandomState(seed + 1)
    x = rng.uniform(-0.5, 0.5, (2, c, h, w)).astype(np.float32)
    cond = None
    if conditioning:
        cond = rng.uniform(-0.5, 0.5, (2, jcfg.c_cond, h, w)).astype(np.float32)
    return params, x, cond


def _port_mat(params, x, cond, c, conditioning, pad, cdt, n_steps):
    cfg = NCAConfig(c_in=c, fc_dim=16, padding_mode=pad, conditioning=conditioning,
                    update_rate=1.0)
    out = fs.fused_rollout_chw_reference(
        params_from_jax(params, "cpu"), torch.from_numpy(x), 0, cfg, n_steps,
        None if cond is None else torch.from_numpy(cond), compute_dtype=cdt, algo="mat")
    return out.numpy()


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "edges"])
@pytest.mark.parametrize("pad", ["circular", "replicate", "zeros"])
@pytest.mark.parametrize("c", [5, 12])
@pytest.mark.parametrize("h,w", [(8, 8), (18, 18), (34, 66), (40, 72)])
def test_mat_plain_version_is_the_jax_folded_step(h, w, c, pad, conditioning, cdt):
    params, x, cond = _mat_inputs(c, conditioning, h, w, seed=h + w + c)
    want = x
    for _ in range(STEPS):
        want = _jax_mat_step(params, want, cond, pad, cdt)
    got = _port_mat(params, x, cond, c, conditioning, pad, cdt, STEPS)
    err = float(np.abs(got - want).max())
    print(f"\nmat {h}x{w} C{c} {pad} {conditioning} {cdt}: max diff {err:.2e} "
          f"({err / float(np.abs(want).max()):.2e} of max)")
    if cdt == "float32":
        assert err <= F32_TOL * float(np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.abs(got - x).max() > 1e-3  # the steps moved the state


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_jax_folded_step_is_the_interpret_kernel(cdt):
    """The composition above is the Pallas kernel's function: held to
    ``fused_rollout_chw(algo="mat")`` in interpret mode at 8 x 128 (H is one
    row tile, so the halo rows wrap), replicate padding, edges."""
    c, pad = 5, "replicate"
    params, x, cond = _mat_inputs(c, "edges", 8, 128, seed=5)
    jcfg = JNCAConfig(c_in=c, fc_dim=16, padding_mode=pad, conditioning="edges",
                      update_rate=1.0)
    with pltpu.force_tpu_interpret_mode():
        kern = pallas_step.fused_rollout_chw(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.int32(0),
            jcfg, STEPS, cond=jnp.asarray(cond), interpret=True, compute_dtype=cdt,
            algo="mat")
    kern = np.asarray(kern)
    comp = x
    for _ in range(STEPS):
        comp = _jax_mat_step(params, comp, cond, pad, cdt)
    err = float(np.abs(comp - kern).max())
    print(f"\ncomposition vs interpret kernel {cdt}: max diff {err:.2e}")
    if cdt == "float32":
        assert err <= F32_TOL * float(np.abs(kern).max())
    else:
        np.testing.assert_allclose(comp, kern, **BF16_TOL)


def _jax_gate(x, xn, jcfg):
    """(out, life, life by the zero-filled pool) of the JAX gate on NCHW
    numpy arrays."""
    xj, nj = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(xn.transpose(0, 2, 3, 1))
    life = jcn.alive_mask(xj, jcfg) & jcn.alive_mask(nj, jcfg)
    out = jnp.clip(nj * life.astype(nj.dtype), -jcfg.clamp_value, jcfg.clamp_value)
    zero = None
    if jcfg.use_living_channel:
        a = jcfg.alive_channel

        def alive_from(v):  # pallas_cnca.py:82: the 3x3 max with zero edge fill
            p = jnp.pad(v[..., a], ((0, 0), (1, 1), (1, 1)))
            hh, ww = v.shape[1:3]
            m = jnp.max(jnp.stack([p[:, i:i + hh, j:j + ww] for i in range(3)
                                   for j in range(3)]), axis=0)
            return m > jcfg.alpha_living_threshold

        zero = np.asarray(alive_from(xj) & alive_from(nj))
    return (np.asarray(out).transpose(0, 3, 1, 2), np.asarray(life)[..., 0], zero)


@pytest.mark.parametrize("use_life", [True, False])
@pytest.mark.parametrize("hidden", [16, 3])
@pytest.mark.parametrize("h,w", [(8, 8), (24, 40), (34, 66)])
def test_gate_plain_version_is_the_jax_gate(h, w, hidden, use_life):
    cfg = ConditionedNCAConfig(image_size=w, num_hidden_channels=hidden,
                               use_living_channel=use_life)
    jcfg = JCfg(image_size=w, num_hidden_channels=hidden, use_living_channel=use_life)
    c, a = cfg.num_channels, cfg.alive_channel
    thr = np.float32(cfg.alpha_living_threshold)
    near = np.array([np.nextafter(thr, np.float32(-1)), thr, np.nextafter(thr, np.float32(1)),
                     np.float32(0), np.float32(-0.5), np.float32(0.7)], np.float32)
    rng = np.random.RandomState(h * w + c)
    x = rng.randn(2, c, h, w).astype(np.float32)
    xn = (12 * rng.randn(2, c, h, w)).astype(np.float32)  # past the clamp of 10 too
    # alpha planes mostly below the threshold, with values on it and one ulp
    # around it, so that single pixels decide a 3x3 neighbourhood
    for arr in (x, xn):
        arr[:, a] = np.where(rng.rand(2, h, w) < 0.7, np.float32(-0.2),
                             near[rng.randint(0, len(near), (2, h, w))])
    got, life = fc.cnca_gate_reference(torch.from_numpy(x), torch.from_numpy(xn), cfg)
    want, want_life, zero_life = _jax_gate(x, xn, jcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    if use_life:
        assert life.dtype == torch.uint8
        np.testing.assert_array_equal(life.numpy(), want_life.astype(np.uint8))
        np.testing.assert_array_equal(want_life, zero_life)  # thr > 0: zero fill == -inf
        share = float(want_life.mean())
        print(f"\ngate {h}x{w} C{c}: alive share {share:.3f}")
        assert 0.0 < share < 1.0
    else:
        assert life is None
