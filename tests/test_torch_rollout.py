"""The port's rollout (vsnca_tpu_torch.ops.fused_step) against the JAX
package on the CPU: the plain version against the flat Pallas kernel in
interpret mode (as tests/test_pallas.py runs it) and against the scan
rollout, the mask hash, the weight packing and the wrapper's checks.

Tolerances: float32 rtol 1e-4 / atol 1e-5 (as the JAX package holds its own
kernel against its scan); bfloat16 against the interpret-mode kernel at
bfloat16, rtol 1e-3 / atol 1e-3 (both round the percept, the hidden
activations and the weights to bf16 at the same places; a one-ulp float32
difference in a percept can flip one bf16 rounding).

On the CPU the wrapper runs the plain version; the kernel itself is held
against it on the card by tests/test_torch_cuda.py.
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
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops.perception import perceive

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-3, atol=1e-3)


def _inputs(kw, h, w, seed=0):
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


def _port(kw, params, x, cond, n_steps, compute_dtype="float32", seed=0):
    out = fs.fused_rollout_chw(
        params_from_jax(params, "cpu"), torch.from_numpy(x), seed, NCAConfig(**kw),
        n_steps, cond=None if cond is None else torch.from_numpy(cond),
        compute_dtype=compute_dtype,
    )
    return out.numpy()


def _interpret(jcfg, params, x, cond, n_steps, compute_dtype="float32"):
    with pltpu.force_tpu_interpret_mode():
        out = pallas_step.fused_rollout_flat_chw(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jnp.int32(0), jcfg, n_steps,
            cond=None if cond is None else jnp.asarray(cond),
            interpret=True, compute_dtype=compute_dtype,
        )
    return np.asarray(out)


@pytest.mark.parametrize("conditioning", [None, "pos_emb", "edges"])
@pytest.mark.parametrize("pad_mode", ["circular", "replicate", "zeros"])
def test_plain_rollout_matches_jax_kernel_and_scan(pad_mode, conditioning):
    """update_rate=1, 8x128 (the TPU kernel's smallest lane-aligned grid),
    3 steps: the port's rollout against the interpret-mode flat kernel and
    against dynca_rollout."""
    kw = dict(c_in=12, fc_dim=16, padding_mode=pad_mode, conditioning=conditioning,
              update_rate=1.0)
    jcfg, params, x, cond = _inputs(kw, 8, 128)
    got = _port(kw, params, x, cond, 3)
    np.testing.assert_allclose(got, _interpret(jcfg, params, x, cond, 3), **F32)
    scan, _ = jdynca.dynca_rollout(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x.transpose(0, 2, 3, 1)), jax.random.PRNGKey(3), jcfg, 3,
        cond=None if cond is None else jnp.asarray(cond.transpose(0, 2, 3, 1)),
        remat="none",
    )
    np.testing.assert_allclose(got, np.asarray(scan).transpose(0, 3, 1, 2), **F32)


def test_plain_rollout_bf16_matches_jax_kernel_bf16():
    kw = dict(c_in=12, fc_dim=16, padding_mode="circular", conditioning="edges",
              update_rate=1.0)
    jcfg, params, x, cond = _inputs(kw, 8, 128, seed=2)
    got = _port(kw, params, x, cond, 3, "bfloat16")
    want = _interpret(jcfg, params, x, cond, 3, "bfloat16")
    np.testing.assert_allclose(got, want, **BF16)
    # bf16 rounding is really applied: the f32 rollout differs beyond f32 noise
    assert np.abs(_port(kw, params, x, cond, 3) - got).max() > 1e-5


@pytest.mark.parametrize("scales", [(0,), (0, 1)])
def test_port_dynca_rollout_matches_jax_scan(scales):
    kw = dict(c_in=8, fc_dim=16, padding_mode="circular", perception_scales=scales,
              update_rate=1.0)
    jcfg, params, _, _ = _inputs(kw, 8, 8)
    x = np.random.RandomState(4).uniform(-0.5, 0.5, (2, 8, 12, 16)).astype(np.float32)
    got, rgb = dynca.dynca_rollout(params_from_jax(params, "cpu"), torch.from_numpy(x),
                                   0, NCAConfig(**kw), 4)
    want, wrgb = jdynca.dynca_rollout(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x.transpose(0, 2, 3, 1)), jax.random.PRNGKey(0), jcfg, 4,
        remat="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), **F32)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(wrgb).transpose(0, 3, 1, 2), **F32)


def test_fused_plain_equals_dynca_rollout_at_half_rate():
    """Same hash masks: at rate 0.5 the fused plain version and the model's
    rollout agree, with a ragged grid and batch 2."""
    cfg = NCAConfig(c_in=12, fc_dim=32, padding_mode="replicate", conditioning="pos_emb")
    params = dynca.dynca_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.rand((2, 12, 11, 19), generator=torch.Generator().manual_seed(2)) - 0.5
    cond = dynca.make_conditioning(cfg, (11, 19), batch=2, device="cpu")
    a = fs.fused_rollout_chw(params, x, 5, cfg, 6, cond)
    b, _ = dynca.dynca_rollout(params, x, 5, cfg, 6, cond)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # and the masks matter: another seed gives another rollout
    c = fs.fused_rollout_chw(params, x, 6, cfg, 6, cond)
    assert (a - c).abs().max() > 1e-3


# ---------------------------------------------------------------- masks

def _fmix32_np(h):
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def test_mask_bits_match_uint32_arithmetic():
    """The int64 emulation equals native wrapping uint32 arithmetic (the
    CUDA kernel's)."""
    for seed, b, step in [(0, 0, 0), (12345, 1, 23), (2**31 + 7, 3, 95)]:
        key = _fmix32_np(np.array([(seed + b + step * 7919) % 2**32]))
        pix = np.arange(37 * 53, dtype=np.uint32)
        want = _fmix32_np(pix ^ key[0])
        got = fs.mask_bits(seed, b, step, 37, 53).numpy().ravel()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_mask_properties():
    m = lambda s, b, t, r=0.5: fs.update_mask(s, b, t, 64, 64, r)  # noqa: E731
    assert torch.equal(m(1, 0, 0), m(1, 0, 0))
    for other in (m(2, 0, 0), m(1, 1, 0), m(1, 0, 1)):
        assert not torch.equal(m(1, 0, 0), other)
    assert float(m(1, 0, 0, 0.0).max()) == 0.0
    assert float(m(1, 0, 0, 1.0).min()) == 1.0
    frac = float(fs.update_mask(7, 0, 3, 256, 256, 0.5).mean())
    assert abs(frac - 0.5) < 0.01


def test_uniform_threshold_matches_jax():
    for rate in (0.0, 0.25, 0.5, 0.9, 1.0, 1.5, -0.5):
        assert fs.uniform_threshold(rate) == pallas_step._uniform_threshold(rate)


# -------------------------------------------------------- weight packing

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pack_weights_matches_flat_pad_weights(compute_dtype):
    """Same values as the TPU wrapper's packing, once its channel padding
    (C → ceil8(C)) and transposes are undone."""
    jcfg = JNCAConfig(c_in=12, fc_dim=30, conditioning="edges")
    jp = jdynca.dynca_init(jax.random.PRNGKey(3), jcfg)
    w1t, b1, w2t, b2 = pallas_step._flat_pad_weights(jp, 12, 16, 3, 8, compute_dtype)
    rows = [r for k in range(4) for r in range(16 * k, 16 * k + 12)] + [64, 65, 66]
    want_w1 = np.asarray(w1t.astype(jnp.float32)).T[rows]
    pw1, pb1, pw2, pb2 = fs.pack_weights(params_from_jax(jp, "cpu"), 12, 3, compute_dtype)
    assert pw1.shape == (51, 32) and pw2.shape == (32, 12)  # F padded 30 -> 32
    np.testing.assert_array_equal(pw1[:, :30].numpy(), want_w1)
    np.testing.assert_array_equal(pw2[:30].numpy(),
                                  np.asarray(w2t.astype(jnp.float32)).T[:, :12])
    np.testing.assert_array_equal(pb1[:30].numpy(), np.asarray(b1))
    np.testing.assert_array_equal(pb2.numpy(), np.asarray(b2)[:12])
    assert not pw1[:, 30:].any() and not pb1[30:].any() and not pw2[30:].any()


def _bf16_bits_survive(t: torch.Tensor) -> bool:
    return torch.equal(t.to(torch.bfloat16).float().view(torch.int32), t.view(torch.int32))


@pytest.mark.parametrize("c_in,conditioning", [(12, "edges"), (12, "pos_emb"), (13, None)])
def test_served_step_operands_are_bf16_values(c_in, conditioning):
    """The premise of the served kernel's operands (nca_step_kernel_served,
    at the widths it is built for): under bf16 compute, pack_weights' W1 and
    W2, and the plain step's rounded percept and hidden activations
    (rounder('bfloat16'), where reference_step applies it), are bf16 values,
    so a round trip through torch.bfloat16 keeps every bit."""
    cfg = NCAConfig(c_in=c_in, fc_dim=96, conditioning=conditioning)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, c_in, 24, 40), generator=g) - 0.5
    cond = torch.rand((2, cfg.c_cond, 24, 40), generator=g) - 0.5 if cfg.c_cond else None
    w1, b1, w2, _ = fs.pack_weights(params, c_in, cfg.c_cond, "bfloat16")
    assert _bf16_bits_survive(w1) and _bf16_bits_survive(w2)
    rnd = fs.rounder("bfloat16")
    p = perceive(x, cfg.padding_mode)
    p = p if cond is None else torch.cat([p, cond], dim=1)
    assert not _bf16_bits_survive(p)  # the rounding is what makes them bf16 values
    p = rnd(p)
    hid = rnd(torch.relu(torch.einsum("bphw,pf->bfhw", p, w1) + b1[:, None, None]))
    assert _bf16_bits_survive(p) and _bf16_bits_survive(hid)
    assert hid.count_nonzero() > 0


# ------------------------------------------------------ wrapper contract

def _setup(**kw):
    cfg = NCAConfig(c_in=6, fc_dim=8, **kw)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params, torch.rand((1, 6, 5, 7))


@pytest.mark.parametrize("bad", ["dtype", "channels", "cond_shape", "scales",
                                 "compute_dtype", "padding"])
def test_wrapper_rejects(bad):
    cfg, params, x = _setup(conditioning="pos_emb")
    cond = dynca.make_conditioning(cfg, (5, 7), device="cpu")
    kw = dict(cond=cond)
    if bad == "dtype":
        x = x.double()
    elif bad == "channels":
        x = torch.rand((1, 5, 5, 7))
    elif bad == "cond_shape":
        kw["cond"] = cond[:, :1]
    elif bad == "scales":
        cfg = NCAConfig(c_in=6, fc_dim=8, conditioning="pos_emb", perception_scales=(0, 1))
    elif bad == "compute_dtype":
        kw["compute_dtype"] = "float16"
    elif bad == "padding":
        cfg = NCAConfig(c_in=6, fc_dim=8, conditioning="pos_emb", padding_mode="reflect")
    with pytest.raises(ValueError):
        fs.fused_rollout_chw(params, x, 0, cfg, 2, **kw)


def test_build_names_library_by_source_and_fails_clearly_without_nvcc(
        tmp_path, monkeypatch):
    from vsnca_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first  # an edited source is rebuilt
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["k"])


def test_wrapper_leaves_input_and_counts_no_cpu_launch():
    cfg, params, x = _setup()
    x0 = x.clone()
    before = fs.LAUNCHES
    out = fs.fused_rollout_chw(params, x, 0, cfg, 3)
    assert torch.equal(x, x0) and not torch.equal(out, x0)
    assert torch.equal(fs.fused_rollout_chw(params, x, 0, cfg, 0), x0)
    assert fs.LAUNCHES == before  # the CPU path launches no kernel
