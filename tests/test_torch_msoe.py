"""The port's MSOE network (vsnca_tpu_torch.models.msoe) against the JAX
package's on shared parameters (``convert.msoe_from_jax`` carries the JAX
seed-175 fallback over), and against the torch activations frozen in
tests/fixtures/golden_msoe.npz.

Tolerances, relative to the largest element: the flow, the 320-channel
feature and the feature's input gradient 1e-5 against JAX (float32 convs
summed in another order), the gradient also 1e-10 in float64; the golden
torch activations 1e-5 as well (``-s`` prints the measured differences).
The fallback draws from a ``torch.Generator`` (the RNG differs from
``jax.random``), so its kernels' std is held to JAX's within 5 %.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu_torch.convert import msoe_from_jax
from vsnca_tpu_torch.models import msoe

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _scaled_err(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


@pytest.fixture(scope="module")
def shared():
    jp = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.RandomState(0)
    pair = rng.uniform(0, 1, (2, 32, 32, 2)).astype(np.float32)
    return jp, np_params, msoe_from_jax(np_params, "cpu"), pair


def test_msoe_forward_matches_jax(shared):
    jp, _, tp, pair = shared
    jflow, jfeats = jmsoe.msoe_forward(jp, jnp.asarray(pair), return_features=True)
    flow, feats = msoe.msoe_forward(tp, _nchw(pair), return_features=True)
    assert feats[0].shape == (2, 320, 32, 32) and flow.shape == (2, 2, 32, 32)
    e_flow = _scaled_err(_nhwc(flow), np.asarray(jflow))
    e_feat = _scaled_err(_nhwc(feats[0]), np.asarray(jfeats[0]))
    print(f"\nmsoe vs JAX: flow {e_flow:.1e}, feature {e_feat:.1e}")
    assert e_flow <= 1e-5 and e_feat <= 1e-5


def test_msoe_matches_golden_torch_activations():
    fx = np.load("tests/fixtures/golden_msoe.npz")
    jp = jmsoe.msoe_random_init(jax.random.PRNGKey(int(fx["seed"])))
    tp = msoe_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    flow, feats = msoe.msoe_forward(tp, _nchw(fx["input"]), return_features=True)
    e_flow = _scaled_err(_nhwc(flow), fx["flow"])
    e_feat = _scaled_err(_nhwc(feats[0]), fx["motion_feature"])
    print(f"\nmsoe vs golden torch activations: flow {e_flow:.1e}, feature {e_feat:.1e}")
    assert e_flow <= 1e-5 and e_feat <= 1e-5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_feature_input_gradient_matches_jax_grad(shared, dtype):
    """The 320-channel feature's VJP to the frame pair: the pool's tie rule,
    the symmetric pads' adjoints, the pyramid's strided blur and the
    upsample matrices, all in one chain. float64 on both sides holds the
    function (measured 1e-15); float32 at 1e-5 uses an input with no near
    tie in a pool window: on the shared fixture's input one window at
    level 1 holds two values a float32 ulp apart, which the packages' last
    bits order differently, so the tie mask sends that cotangent elsewhere
    (a 1.3e-2 difference that float64 removes)."""
    jp, np_params, _, _ = shared
    rng = np.random.RandomState(1)
    pair = rng.uniform(0, 1, (2, 32, 32, 2)).astype(dtype)
    w = rng.randn(2, 32, 32, 320).astype(dtype)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        jpp = {k: jnp.asarray(v, jdt) for k, v in np_params.items()}

        def jloss(p):
            _, feats = jmsoe.msoe_forward(jpp, p, return_features=True)
            return jnp.sum(feats[0] * jnp.asarray(w, jdt))

        jg = np.asarray(jax.grad(jloss)(jnp.asarray(pair, jdt)))
    finally:
        jax.config.update("jax_enable_x64", False)
    tdt = getattr(torch, dtype)
    tp = {k: v.to(tdt) for k, v in msoe_from_jax(np_params, "cpu").items()}
    x = torch.from_numpy(pair.transpose(0, 3, 1, 2).astype(dtype)).requires_grad_()
    _, feats = msoe.msoe_forward(tp, x, return_features=True)
    (feats[0] * torch.from_numpy(w.transpose(0, 3, 1, 2).astype(dtype))).sum().backward()
    err = _scaled_err(_nhwc(x.grad), jg)
    print(f"\nfeature input gradient vs jax.grad, {dtype}: {err:.1e}")
    assert err <= (1e-10 if dtype == "float64" else 1e-5) and np.abs(jg).max() > 0


def test_fallback_weights_match_jax_distribution():
    """Seed-175 fallbacks: same names and HWIO->OIHW shapes, both inside
    +-1/sqrt(fan_in), and each kernel's std within 5 % of JAX's. The biases
    (2 to 64 values, a std known to about 1/sqrt(2n)) are held to the
    uniform law's std, bound/sqrt(3), within 30 %."""
    jp = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    tp, pretrained = msoe.load_msoe("weights/no_such_msoe.npz", device="cpu")
    assert not pretrained
    again = msoe.msoe_random_init(torch.Generator().manual_seed(175), "cpu")
    assert set(tp) == set(jp)
    for k, v in jp.items():
        v = np.asarray(v)
        want_shape = v.shape if v.ndim == 1 else (v.shape[3], v.shape[2], v.shape[0], v.shape[1])
        assert tuple(tp[k].shape) == want_shape, k
        torch.testing.assert_close(tp[k], again[k], rtol=0, atol=0)
        bound = 1.0 / np.sqrt(msoe._SHAPES[k][1])
        assert float(tp[k].abs().max()) <= bound and float(np.abs(v).max()) <= bound, k
        if v.size >= 1000:
            ratio = float(tp[k].std()) / float(v.std())
            assert 0.95 <= ratio <= 1.05, (k, ratio)
        elif v.size >= 32:
            ratio = float(tp[k].std()) / (bound / np.sqrt(3.0))
            assert 0.7 <= ratio <= 1.3, (k, ratio)


def test_load_msoe_reads_an_npz(tmp_path, shared):
    _, np_params, tp, _ = shared
    path = tmp_path / "msoe.npz"
    np.savez(path, **np_params)
    got, pretrained = msoe.load_msoe(str(path), device="cpu")
    assert pretrained
    for k in tp:
        torch.testing.assert_close(got[k], tp[k], rtol=0, atol=0)


def test_contrast_norm_and_grayscale_match_jax():
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 1, (3, 16, 16, 2)).astype(np.float32)
    err = _scaled_err(_nhwc(msoe.contrast_norm(_nchw(x))),
                      np.asarray(jmsoe.contrast_norm(jnp.asarray(x))))
    assert err <= 1e-6
    rgb = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(msoe.rgb_to_grayscale(_nchw(rgb))),
                               np.asarray(jmsoe.rgb_to_grayscale(jnp.asarray(rgb))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("size", [(16, 16), (12, 12)])
def test_motion_pairs_match_jax(size):
    """Frames in [-1, 1] to MSOE pairs, resized (24 -> 16 or 12), pairs
    stacked on the batch; and the single pair of ``motion_pair_from_rgb``."""
    rng = np.random.RandomState(3)
    frames = [rng.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32) for _ in range(3)]
    got = _nhwc(msoe.motion_pairs_from_frames([_nchw(f) for f in frames], size))
    want = np.asarray(jmsoe.motion_pairs_from_frames([jnp.asarray(f) for f in frames], size))
    assert got.shape == want.shape == (4,) + size + (2,)
    assert _scaled_err(got, want) <= 1e-6
    one = _nhwc(msoe.motion_pair_from_rgb(_nchw(frames[0]), _nchw(frames[1]), size))
    np.testing.assert_allclose(one, got[:2], rtol=0, atol=1e-6)
