"""The port's MSOE building blocks (vsnca_tpu_torch.ops: padding, filters,
grid_sample, conv, resize, and the multiscale percept's resampling in
fused_step) against the JAX package on the same numpy inputs, NCHW in the
port and NHWC in JAX.

Tolerances: the symmetric pad and the Gaussian kernel are exact (index
arithmetic, the same float64 formula); the upsample, the convolutions and
the resampling 1e-6 of the largest element (float32 products summed in
another order); the max pool's forward is exact and its VJP 1e-6 on an
input with deliberate ties, where ``F.max_pool2d``'s backward is a
different function (it sends a tie's cotangent to one element). ``-s``
prints the measured differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.ops import conv as jconv
from vsnca_tpu.ops import filters as jfilters
from vsnca_tpu.ops import grid_sample as jgrid
from vsnca_tpu.ops import padding as jpadding
from vsnca_tpu_torch.ops import conv, filters, grid_sample, padding
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops import fused_train as ft
from vsnca_tpu_torch.ops.resize import _bilinear_matrix

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _scaled_close(got, want, tol, name=""):
    scale = float(np.abs(want).max()) + 1e-12
    err = float(np.abs(got - want).max()) / scale
    print(f"\n{name}: max |port - JAX| / max |JAX| {err:.1e}")
    assert err <= tol, name


@pytest.mark.parametrize("pads", [(5, 5, 5, 5), (2, 2, 2, 2), (1, 0, 0, 3), (0, 0, 0, 0),
                                  (9, 12, 7, 11)])
def test_symmetric_pad_matches_jax(pads):
    """Within one period (flips and concatenations) and past it (the
    triangular-wave gather): bit-identical."""
    x = np.random.RandomState(0).randn(2, 7, 9, 3).astype(np.float32)
    got = _nhwc(padding.symmetric_pad_2d(_nchw(x), pads))
    want = np.asarray(jpadding.symmetric_pad_2d(jnp.asarray(x), pads))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,sigma", [((5, 5), 2.0), ((3, 3), 0.5), ((7, 5), 1.3),
                                         ((9, 9), 0.4)])
def test_matlab_gaussian_kernel_matches_jax(shape, sigma):
    got = filters.matlab_gaussian_kernel_2d(shape, sigma)
    want = jfilters.matlab_gaussian_kernel_2d(shape, sigma)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [2.0, 4.0, 8.0, 16.0])
def test_tf_consistent_upsample_matches_jax(scale):
    """The MSOE pyramid's upsample from a level of 32 / scale pixels back to
    32, as msoe_forward calls it."""
    n = int(32 / scale)
    x = np.random.RandomState(1).randn(2, n, n, 5).astype(np.float32)
    got = _nhwc(grid_sample.tf_consistent_bilinear_upsample(_nchw(x), scale))
    want = np.asarray(jgrid.tf_consistent_bilinear_upsample(jnp.asarray(x), scale))
    assert got.shape == want.shape == (2, 32, 32, 5)
    _scaled_close(got, want, 1e-6, f"upsample x{scale:g}")
    np.testing.assert_array_equal(grid_sample._interp_matrix(np.linspace(-1, 1, 7), n),
                                  jgrid._interp_matrix(np.linspace(-1, 1, 7), n))


def test_tf_consistent_upsample_refuses_non_square():
    with pytest.raises(ValueError, match="square"):
        grid_sample.tf_consistent_bilinear_upsample(torch.zeros((1, 1, 4, 6)), 2.0)


@pytest.mark.parametrize("kw", [
    dict(padding="SAME"),
    dict(padding="VALID"),
    dict(padding=2),
    dict(padding="VALID", stride=2),
    dict(padding="VALID", stride=2, groups=2),
])
def test_conv2d_matches_jax(kw):
    """HWIO kernels carried to OIHW, full float32 on both sides."""
    rng = np.random.RandomState(2)
    groups = kw.get("groups", 1)
    x = rng.randn(2, 13, 13, 4).astype(np.float32)
    w = rng.randn(5, 5, 4 // groups, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    got = _nhwc(conv.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                            torch.from_numpy(b), stride=kw.get("stride", 1),
                            padding=kw["padding"], groups=groups))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       stride=kw.get("stride", 1), padding=kw["padding"],
                                       feature_group_count=groups))
    assert got.shape == want.shape
    _scaled_close(got, want, 1e-6, f"conv2d {kw}")


def _tied_input():
    """Values on a coarse grid (many ties inside each 5x5 window), plus
    MSOE's square-then-pool ties (x and -x square to the same value)."""
    rng = np.random.RandomState(3)
    x = rng.randint(-3, 4, (2, 12, 11, 3)).astype(np.float32)
    return np.square(x) * 0.25


@pytest.mark.parametrize("window,pad", [(5, 2), (3, 1), (3, 0)])
def test_max_pool_forward_and_tie_vjp_match_jax(window, pad):
    x = _tied_input()
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    g = g[:, : x.shape[1] + 2 * pad - window + 1, : x.shape[2] + 2 * pad - window + 1]
    xt = _nchw(x).requires_grad_()
    y = conv.max_pool_2d(xt, window, 1, pad)
    (y * _nchw(g)).sum().backward()
    jy, vjp = jax.vjp(lambda v: jconv.max_pool_2d(v, window, 1, pad), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(_nhwc(y), np.asarray(jy))
    _scaled_close(_nhwc(xt.grad), np.asarray(jgx), 1e-6, f"pool {window}/{pad} VJP")
    # the ties are real: torch's own pool backward computes another function
    xl = _nchw(x).requires_grad_()
    (torch.nn.functional.max_pool2d(xl, window, 1, pad) * _nchw(g)).sum().backward()
    assert not torch.allclose(xl.grad, xt.grad)
    # and the cotangent is conserved: each output's g is split, not copied
    np.testing.assert_allclose(float(xt.grad.sum()), float(g.sum()), rtol=1e-5)


def test_max_pool_other_strides_are_torch():
    x = torch.from_numpy(_tied_input()).permute(0, 3, 1, 2)
    torch.testing.assert_close(conv.max_pool_2d(x, 2, 2), torch.nn.functional.max_pool2d(x, 2, 2))


@pytest.mark.parametrize("n", [8, 22, 64])
def test_resize_matrix_is_the_port_bilinear_matrix(n):
    """``resize_matrix`` (grid_sample.py:60) is the port's
    ``ops.resize._bilinear_matrix``: the exact pair average down, the
    0.75/0.25 edge-clamped rule up."""
    for a, b in ((n // 2, n), (n, n // 2), (n, n), (3, n)):
        np.testing.assert_allclose(_bilinear_matrix(a, b), jgrid.resize_matrix(a, b),
                                   rtol=0, atol=1e-7)


def test_multiscale_resampling_is_the_resize_matrices():
    """The multiscale percept's half state and upsample (fused_step) are
    ``resize_matrix(h/2, h)`` and ``resize_matrix(h, h/2)`` applied over W
    and H, and the adjoint's U^T (fused_train) is the transposed matrix."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, 10, 14).astype(np.float32))
    h, w = x.shape[-2:]
    dh, dw = (torch.from_numpy(jgrid.resize_matrix(m // 2, m)) for m in (h, w))
    uh, uw = (torch.from_numpy(jgrid.resize_matrix(m, m // 2)) for m in (h, w))
    half = torch.einsum("iu,bcuv,jv->bcij", dh, x, dw)
    torch.testing.assert_close(fs.half_state(x), half, rtol=0, atol=1e-6)
    s = fs.half_state(x)
    up = torch.einsum("iu,bcuv,jv->bcij", uh, s, uw)
    torch.testing.assert_close(fs.upsample2(fs.upsample2(s, -1), -2), up, rtol=0, atol=1e-6)
    g = torch.from_numpy(rng.randn(2, 3, 10, 14).astype(np.float32))
    gt = torch.einsum("iu,bcij,jv->bcuv", uh, g, uw)
    torch.testing.assert_close(ft.upsample2_adjoint(ft.upsample2_adjoint(g, -1), -2), gt,
                               rtol=0, atol=1e-5)
