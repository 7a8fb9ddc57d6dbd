"""The port's bf16-state rollout, streaming entry, kernel registry and NHWC
wrapper (vsnca_tpu_torch.ops.fused_step) against the JAX package on the CPU:

- the plain ``fused_rollout_chw`` at ``algo="padded"`` with a bfloat16 state
  against JAX's interpret-mode ``_make_kernel`` (16 x 128, c8/fc16, 3 steps,
  ``update_rate=1``), three paddings, cond none and pos_emb, f32 and bf16
  compute;
- the plain streaming entry against ``fused_rollout_stream_chw`` in
  interpret mode (c4/fc8, 16 x 128, 2 steps: JAX's DMA interpreter is slow);
- ``select_rollout_kernel``'s H100 policy, the entries' scopes and argument
  errors, and ``fused_rollout`` (NHWC) against ``dynca_rollout``.

Tolerances: float32 rtol 1e-4 / atol 1e-5, as tests/test_torch_rollout.py.
The bf16 state: atol 1e-2 / rtol 1e-2 — both packages compute the stencils
in bf16 arithmetic (every product and partial sum rounded, as JAX computes a
bf16 array) and round the new state to bf16 on store, so a float32 ulp of
difference in the MLP's sums flips a stored value by one bf16 ulp (2^-8
relative, 0.004 at 1) and the next steps carry it (measured at most 2.0e-3,
at float32 compute; 0.0 at bf16 compute).
``-s`` prints the measured differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.ops import pallas_step
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import params_from_jax
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_step as fs

from test_torch_rollout_algos import inputs, interpret, kw_of, port

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_STATE = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditioning", [None, "pos_emb"])
@pytest.mark.parametrize("pad", ["circular", "replicate", "zeros"])
def test_padded_bf16_state_matches_jax_interpret(pad, conditioning, cdt):
    kw = kw_of(pad, conditioning)
    jcfg, params, x, cond = inputs(kw, seed=5)
    opts = dict(compute_dtype=cdt, state_dtype="bfloat16", algo="padded")
    got_t = fs.fused_rollout_chw(params_from_jax(params, "cpu"), torch.from_numpy(x), 0,
                                 NCAConfig(**kw), 3,
                                 None if cond is None else torch.from_numpy(cond), **opts)
    assert got_t.dtype == torch.bfloat16
    got = got_t.float().numpy()
    want = interpret(jcfg, params, x, cond, 3, **opts)
    print(f"\npadded bf16 state {pad} {conditioning} {cdt}: max diff "
          f"{np.abs(got - want).max():.1e}")
    np.testing.assert_allclose(got, want, **BF16_STATE)
    # the state really is rounded: the float32-state rollout differs
    assert np.abs(port(kw, params, x, cond, 3, compute_dtype=cdt) - got).max() > 1e-4


def test_bf16_state_stencils_round_every_operation():
    """One step of JAX's bf16-state kernel computes the stencils in bf16
    arithmetic (every product and partial sum rounded): the port's plain
    step matches it exactly at bf16 compute, and stencils computed in
    float32 and rounded once do not."""
    kw = kw_of("circular", None)
    jcfg, params, x, _ = inputs(kw, seed=1)
    opts = dict(compute_dtype="bfloat16", state_dtype="bfloat16", algo="padded")
    want = interpret(jcfg, params, x, None, 1, **opts)
    tp = params_from_jax(params, "cpu")
    got = fs.fused_rollout_chw(tp, torch.from_numpy(x), 0, NCAConfig(**kw), 1, **opts)
    xb = torch.from_numpy(x).bfloat16()
    packed = fs.pack_weights(tp, 8, 0, "bfloat16")
    once = fs.perceive(xb.float(), "circular").bfloat16().float()
    hid = torch.relu(torch.einsum("bphw,pf->bfhw", once, packed[0])
                     + packed[1][:, None, None]).bfloat16().float()
    dx = torch.einsum("bfhw,fc->bchw", hid, packed[2]) + packed[3][:, None, None]
    rounded_once = (xb.float() + dx).bfloat16().float().numpy()
    np.testing.assert_array_equal(got.float().numpy(), want)
    print(f"\nbf16 state, one step: stencils rounded once differ by "
          f"{np.abs(rounded_once - want).max():.1e}, every operation 0.0")
    assert np.abs(rounded_once - want).max() > 1e-3


def test_padded_float32_state_is_roll():
    kw = kw_of("replicate", "pos_emb")
    _, params, x, cond = inputs(kw, seed=6)
    np.testing.assert_array_equal(port(kw, params, x, cond, 3, algo="padded"),
                                  port(kw, params, x, cond, 3, algo="roll"))


@pytest.mark.parametrize("conditioning", [None, "edges"])
def test_stream_matches_jax_interpret(conditioning):
    kw = kw_of("circular", conditioning, c_in=4, fc_dim=8)
    jcfg, params, x, cond = inputs(kw, seed=2)
    got = fs.fused_rollout_stream_chw(
        params_from_jax(params, "cpu"), torch.from_numpy(x), 0, NCAConfig(**kw), 2,
        None if cond is None else torch.from_numpy(cond)).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_step.fused_rollout_stream_chw(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.int32(0),
            jcfg, 2, cond=None if cond is None else jnp.asarray(cond), interpret=True))
    print(f"\nstream {conditioning}: max diff {np.abs(got - want).max():.1e}")
    np.testing.assert_allclose(got, want, **F32)


def _cfg(**kw):
    base = dict(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    return NCAConfig(**{**base, **kw})


@pytest.mark.parametrize("cfg,h,w,want", [
    (_cfg(), 256, 256, "flat"),
    (_cfg(), 1024, 1024, "flat"),            # no resident cap: no streaming
    (_cfg(padding_mode="replicate"), 100, 37, "flat"),  # any padding and size
    (_cfg(perception_scales=(0, 1), conditioning="pos_emb", c_in=16, fc_dim=128),
     256, 256, "roll"),
    (_cfg(perception_scales=(0, 1)), 255, 256, None),   # odd H at (0, 1)
    (_cfg(perception_scales=(0, 1, 2)), 256, 256, None),
    (_cfg(c_in=20), 256, 256, None),                    # past C <= 16
    (_cfg(fc_dim=256), 256, 256, None),                 # past fc_dim <= 128
])
def test_select_rollout_kernel_policy(cfg, h, w, want):
    assert fs.select_rollout_kernel(cfg, h, w) == want
    if want is not None:
        assert want in fs.ROLLOUT_KERNELS


def test_support_predicates():
    cfg, ms = _cfg(), _cfg(perception_scales=(0, 1))
    assert fs.fused_flat_supported(cfg, 8, 8) and not fs.fused_flat_supported(ms, 8, 8)
    assert fs.fused_stream_supported(cfg, 1024, 100)          # no W % 128 rule
    assert not fs.fused_stream_supported(_cfg(padding_mode="zeros"), 1024, 1024)
    assert fs.fused_stream_flat_supported(cfg, 16, 16)       # no >= 2 bands rule
    assert fs.fused_rollout_supported(ms, 64, 64)
    assert not fs.fused_rollout_supported(ms, 64, 64, state_dtype="bfloat16")
    assert fs.fused_rollout_supported(cfg, 64, 64, state_dtype="bfloat16")


def test_argument_errors():
    cfg = _cfg(conditioning=None)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.zeros((1, 12, 8, 8))
    with pytest.raises(ValueError, match="unknown kernel algo"):
        fs.fused_rollout_chw(params, x, 0, cfg, 1, algo="stencil")
    with pytest.raises(ValueError, match="requires a float32 state"):
        fs.fused_rollout_chw(params, x, 0, cfg, 1, algo="mat", state_dtype="bfloat16")
    with pytest.raises(ValueError, match="state_dtype"):
        fs.fused_rollout_chw(params, x, 0, cfg, 1, state_dtype="float16")
    ms = _cfg(conditioning=None, perception_scales=(0, 1))
    with pytest.raises(ValueError, match="float32 state only"):
        fs.fused_rollout_chw(params, x, 0, ms, 1, state_dtype="bfloat16")
    with pytest.raises(ValueError, match="circular-only"):
        fs.fused_rollout_stream_chw(params, x, 0, _cfg(conditioning=None,
                                                       padding_mode="zeros"), 1)
    with pytest.raises(ValueError, match=r"\(0,\) only"):
        fs.fused_rollout_flat_chw(params, x, 0, ms, 1)
    with pytest.raises(ValueError, match="no kernel for device"):  # no quiet fallback
        fs.check_card_inputs(x)


def test_multiscale_ignores_algo_as_jax_does():
    """JAX runs its multiscale kernel whatever algo says (pallas_step.py:690)."""
    cfg = NCAConfig(c_in=4, fc_dim=8, padding_mode="circular", perception_scales=(0, 1))
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.rand((1, 4, 8, 12), generator=torch.Generator().manual_seed(1)) - 0.5
    roll = fs.fused_rollout_chw(params, x, 3, cfg, 2)
    for algo in ("mat", "padded"):
        torch.testing.assert_close(fs.fused_rollout_chw(params, x, 3, cfg, 2, algo=algo),
                                   roll, rtol=0, atol=0)


@pytest.mark.parametrize("cfg,h,w", [
    (NCAConfig(c_in=6, fc_dim=16, padding_mode="zeros", conditioning="pos_emb"), 10, 14),
    (NCAConfig(c_in=6, fc_dim=16, padding_mode="circular", perception_scales=(0, 1)),
     12, 16),
    (NCAConfig(c_in=6, fc_dim=16, padding_mode="circular", perception_scales=(0, 1)),
     11, 16),  # odd H: no kernel, eager steps
])
def test_fused_rollout_nhwc_matches_dynca_rollout(cfg, h, w):
    """(state, rgb) NHWC through the registry, or the eager steps where it
    returns None; the same hash masks at rate 0.5 either way."""
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, cfg.c_in, h, w), generator=g) - 0.5
    cond = dynca.make_conditioning(cfg, (h, w), batch=2, device="cpu")
    state, rgb = fs.fused_rollout(params, x.permute(0, 2, 3, 1), 9, cfg, 4,
                                  None if cond is None else cond.permute(0, 2, 3, 1))
    want, want_rgb = dynca.dynca_rollout(params, x, 9, cfg, 4, cond)
    assert state.shape == (2, h, w, cfg.c_in) and rgb.shape == (2, h, w, 3)
    torch.testing.assert_close(state, want.permute(0, 2, 3, 1), **F32)
    torch.testing.assert_close(rgb, want_rgb.permute(0, 2, 3, 1), **F32)
