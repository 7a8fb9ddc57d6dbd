"""The port's 2x2/2 max pool and VGG16 against the JAX package where pool
windows tie, and the motion precompute's JAX keyword.

JAX pools VGG16 by ``_max_pool_2d_nonoverlap_eq`` (vsnca_tpu/ops/conv.py:193),
whose VJP splits a tie's cotangent evenly over the tied elements; the port's
``ops.conv.max_pool_2d`` does the same for stride == window. Inputs are made
with numpy and shared (NHWC for JAX, NCHW for the port); VGG16 weights are
carried across with ``convert.vgg_from_jax``. Tolerance: the image gradient
within 1e-5 of the largest element of ``jax.grad`` (float32 convolutions
summed in another order; the pool's own gradient is exact). ``-s`` prints the
measured differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.losses import video_motion as jvm
from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu.models import vgg as jvgg
from vsnca_tpu.ops import conv as jconv
from vsnca_tpu_torch.convert import msoe_from_jax, vgg_from_jax
from vsnca_tpu_torch.losses import video_motion as vm
from vsnca_tpu_torch.models import vgg
from vsnca_tpu_torch.ops.conv import max_pool_2d

from test_torch_losses import np_vgg16

torch.set_num_threads(1)

TOL = 1e-5


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _pool_inputs(kind: str) -> np.ndarray:
    rng = np.random.RandomState(3)
    if kind == "constant":
        return np.full((2, 32, 32, 4), 0.375, np.float32)
    if kind == "flat_patch":
        x = rng.rand(2, 32, 32, 4).astype(np.float32)
        x[:, 8:24, 8:24] = 0.5
        return x
    x = rng.rand(2, 33, 35, 4).astype(np.float32)  # odd: a VALID tail row and column
    x[:, 4:12, 6:14] = 0.25
    return x


_jax_pool_grad = jax.jit(jax.grad(
    lambda x, g: jnp.sum(jconv.max_pool_2d(x, 2, 2) * g)), static_argnums=())


@pytest.mark.parametrize("kind", ["constant", "flat_patch", "odd_size"])
def test_nonoverlapping_pool_splits_ties_as_jax(kind):
    x = _pool_inputs(kind)
    b, h, w, c = x.shape
    g = np.random.RandomState(4).randn(b, h // 2, w // 2, c).astype(np.float32)
    want_y = np.asarray(jconv.max_pool_2d(jnp.asarray(x), 2, 2))
    want = np.asarray(_jax_pool_grad(jnp.asarray(x), jnp.asarray(g)))
    xt = _nchw(x).requires_grad_()
    y = max_pool_2d(xt, 2, 2)
    (y * _nchw(g)).sum().backward()
    got = xt.grad.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(y.detach().numpy().transpose(0, 2, 3, 1), want_y)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"\n  2x2/2 pool gradient, {kind}: max|port - jax.grad| / max {err:.1e}")
    assert err <= TOL
    if kind == "odd_size":
        assert not got[:, -1].any() and not got[:, :, -1].any()


def _blob() -> np.ndarray:
    """A 64^2 image, zero but for a textured disc: what a ConditionedNCA's
    dead cells around a living blob look like to VGG16."""
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[:64, :64]
    disc = ((yy - 30) ** 2 + (xx - 34) ** 2 <= 14 ** 2)[None, :, :, None]
    return (rng.rand(1, 64, 64, 3) * disc).astype(np.float32)


@pytest.fixture(scope="module")
def vgg_pair():
    arrays = np_vgg16(16)
    return ([{k: jnp.asarray(v) for k, v in d.items()} for d in arrays],
            vgg_from_jax(arrays, "cpu"))


@pytest.mark.parametrize("taps", ["style", "content"])
def test_vgg16_image_gradient_on_a_blob_matches_jax(vgg_pair, taps):
    """d/d image of the sum of squares of the style taps, or of the content
    tap, on the blob image (0.24 / 0.32 of the largest element apart when
    the port pooled with F.max_pool2d)."""
    jp, tp = vgg_pair
    layers = vgg.STYLE_LAYERS if taps == "style" else (vgg.CONTENT_LAYER,)
    img = _blob()

    def jloss(x):
        return sum(jnp.sum(f * f) for f in jvgg.vgg16_features(jp, x, layers))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(img)))
    x = _nchw(img).requires_grad_()
    sum(f.square().sum() for f in vgg.vgg16_features(tp, x, layers)).backward()
    got = x.grad.numpy().transpose(0, 2, 3, 1)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"\n  VGG16 {taps} image gradient on the blob: max|port - jax.grad| / max {err:.1e}")
    assert err <= TOL


def test_precompute_takes_the_jax_budget_keyword():
    jp = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    tp = msoe_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    video = np.random.RandomState(6).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    size = (32, 32)
    for budget in (4 * 2**30, 320 * 1024 * 4):  # room for both pairs; for one
        want = jvm.precompute_target_motion_features(jp, jnp.asarray(video), size,
                                                     hbm_budget_bytes=budget)
        got = vm.precompute_target_motion_features(tp, _nchw(video), size,
                                                   hbm_budget_bytes=budget)
        if want is None:
            assert got is None
            continue
        want = np.asarray(want)
        err = np.abs(got.numpy().transpose(0, 2, 3, 1) - want).max() / np.abs(want).max()
        assert err <= TOL
