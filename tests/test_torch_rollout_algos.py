"""The port's CHW rollout forms (vsnca_tpu_torch.ops.fused_step) against the
JAX package on the CPU: ``stencil_folded_w1`` against JAX's, and the plain
``fused_rollout_chw`` at ``algo="roll"`` and ``algo="mat"`` (the folded
stencil, K = 9C + c_cond) against JAX's ``fused_rollout_chw`` run in
interpret mode (as tests/test_pallas.py runs it) — 16 x 128, c8/fc16, 3
steps, ``update_rate=1`` so the masks do not matter.

Tolerances: the fold is held bit for bit (both sum the same float32 terms
in the same order). float32 rollouts rtol 1e-4 / atol 1e-5, as the JAX
package holds its own kernels against its scan (summation order of the
MLP; measured at most 1.2e-7); bfloat16 compute rtol 1e-3 / atol 1e-3 (both
round the taps or the percept, the hidden activations and the weights —
W_eff after the float32 fold — at the same places, but one float32 ulp of
difference before a rounding moves a value by one bf16 ulp; measured at
most 8.5e-5, 'mat' with edges). ``-s`` prints the measured differences.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops import pallas_step
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import params_from_jax
from vsnca_tpu_torch.ops import fused_step as fs

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}


def inputs(kw, h=16, w=128, seed=0):
    """JAX params, x [1, C, H, W] and cond [1, cc, H, W] (or None), numpy."""
    jcfg = JNCAConfig(**kw)
    jp = jdynca.dynca_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + 1)
    x = rng.uniform(-0.5, 0.5, (1, jcfg.c_in, h, w)).astype(np.float32)
    cond = None
    if jcfg.conditioning == "edges":
        gray = rng.uniform(-1, 1, (1, h, w, 1)).astype(np.float32)
        c = jdynca.make_conditioning(jcfg, (h, w), cond_img=jnp.asarray(gray))
        cond = np.asarray(c).transpose(0, 3, 1, 2).copy()
    elif jcfg.conditioning == "pos_emb":
        c = jdynca.make_conditioning(jcfg, (h, w), batch=1)
        cond = np.asarray(c).transpose(0, 3, 1, 2).copy()
    return jcfg, {k: np.asarray(v) for k, v in jp.items()}, x, cond


def port(kw, params, x, cond, n_steps, **opts):
    out = fs.fused_rollout_chw(
        params_from_jax(params, "cpu"), torch.from_numpy(x), 0, NCAConfig(**kw), n_steps,
        cond=None if cond is None else torch.from_numpy(cond), **opts)
    return out.float().numpy()


def interpret(jcfg, params, x, cond, n_steps, **opts):
    with pltpu.force_tpu_interpret_mode():
        out = pallas_step.fused_rollout_chw(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jnp.int32(0), jcfg, n_steps,
            cond=None if cond is None else jnp.asarray(cond), interpret=True, **opts)
    return np.asarray(out.astype(jnp.float32))


def kw_of(pad, conditioning, c_in=8, fc_dim=16):
    return dict(c_in=c_in, fc_dim=fc_dim, padding_mode=pad, conditioning=conditioning,
                update_rate=1.0)


@pytest.mark.parametrize("conditioning,c_in", [(None, 8), ("pos_emb", 8), ("edges", 12)])
def test_stencil_folded_w1_matches_jax(conditioning, c_in):
    jcfg, params, _, _ = inputs(kw_of("circular", conditioning, c_in, 96))
    got = fs.stencil_folded_w1(torch.from_numpy(params["w1"].copy()), c_in).numpy()
    want = np.asarray(pallas_step.stencil_folded_w1(jnp.asarray(params["w1"]), c_in))
    assert got.shape == (9 * c_in + jcfg.c_cond, 96)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "pos_emb"])
@pytest.mark.parametrize("pad", ["circular", "replicate", "zeros"])
def test_roll_matches_jax_interpret(pad, conditioning, cdt):
    kw = kw_of(pad, conditioning)
    jcfg, params, x, cond = inputs(kw)
    got = port(kw, params, x, cond, 3, compute_dtype=cdt, algo="roll")
    want = interpret(jcfg, params, x, cond, 3, compute_dtype=cdt, algo="roll")
    print(f"\nroll {pad} {conditioning} {cdt}: max diff {np.abs(got - want).max():.1e}")
    np.testing.assert_allclose(got, want, **TOL[cdt])
    assert np.abs(got - x).max() > 1e-3  # the rollout moved the state


MAT_CASES = [(pad, cond, cdt) for cond in (None, "pos_emb", "edges")
             for cdt in ("float32", "bfloat16") for pad in ("circular",)]
MAT_CASES += [("replicate", "pos_emb", "float32"), ("zeros", "edges", "bfloat16")]


@pytest.mark.parametrize("pad,conditioning,cdt", MAT_CASES)
def test_mat_matches_jax_interpret(pad, conditioning, cdt):
    """The folded-stencil rollout: the same function as 'roll' up to the
    fold's rounding, and under bf16 compute rounded where JAX rounds it."""
    kw = kw_of(pad, conditioning)
    jcfg, params, x, cond = inputs(kw, seed=3)
    got = port(kw, params, x, cond, 3, compute_dtype=cdt, algo="mat")
    want = interpret(jcfg, params, x, cond, 3, compute_dtype=cdt, algo="mat")
    print(f"\nmat {pad} {conditioning} {cdt}: max diff {np.abs(got - want).max():.1e}")
    np.testing.assert_allclose(got, want, **TOL[cdt])
    roll = port(kw, params, x, cond, 3, compute_dtype=cdt)
    if cdt == "float32":  # the fold only reorders float32 sums
        np.testing.assert_allclose(got, roll, **TOL[cdt])
    else:  # bf16 rounds the raw taps, not the percept: another function
        assert np.abs(got - roll).max() > 1e-5


def test_mat_percept_times_w_eff_is_the_percept_times_w1():
    """The fold's identity in float64: taps x W_eff == percept x W1."""
    cfg = NCAConfig(c_in=5, fc_dim=7, padding_mode="replicate", conditioning="pos_emb")
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 5, 6, 9), generator=g, dtype=torch.float64) - 0.5
    cond = torch.rand((2, 2, 6, 9), generator=g, dtype=torch.float64)
    w1 = torch.randn((cfg.perception_dim, 7), generator=g, dtype=torch.float64)
    percept = torch.cat([fs.perceive(x, "replicate"), cond], 1)
    taps = torch.cat([fs.mat_taps(x, "replicate"), cond], 1)
    w_eff = fs.stencil_folded_w1(w1, 5).double()
    a = torch.einsum("bphw,pf->bfhw", percept, w1)
    b = torch.einsum("bphw,pf->bfhw", taps, w_eff)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
