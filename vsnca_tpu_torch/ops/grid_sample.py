"""Bilinear grid sampling and the MSOE pyramid's TF-consistent bilinear
upsample — the port's copy of ``vsnca_tpu/ops/grid_sample.py`` on NCHW
tensors. The upsample runs as two separable products with a static
interpolation matrix.

``resize_matrix`` (grid_sample.py:60), the edge-clamped bilinear resize
matrix, is ``ops.resize._bilinear_matrix`` in the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def grid_sample_bilinear(imgs: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NCHW images at normalized grid locations (grid_sample.py:17):
    imgs [B, C, H, W]; grid [B, Ho, Wo, 2] with grid[..., 0] = x (width)
    and grid[..., 1] = y (height) in [-1, 1]; taps outside the image
    contribute zero. Returns [B, C, Ho, Wo]."""
    return F.grid_sample(imgs, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def _interp_matrix(xs: np.ndarray, size: int) -> np.ndarray:
    """Row-stochastic [N, size] bilinear interpolation matrix for normalized
    coordinates ``xs`` (align_corners=False), zero out of range: each row
    has at most two nonzeros."""
    g = (xs + 1.0) * size / 2.0 - 0.5
    lo = np.floor(g).astype(np.int64)
    frac = g - lo
    mat = np.zeros((len(xs), size), np.float32)
    for i in range(len(xs)):
        for tap, wgt in ((lo[i], 1.0 - frac[i]), (lo[i] + 1, frac[i])):
            if 0 <= tap < size:
                mat[i, tap] += wgt
    return mat


def tf_consistent_bilinear_upsample(imgs: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """The reference's TF-style bilinear upsample between MSOE pyramid
    levels (MSOEmultiscale.py:26-44): imgs [B, C, H, W] with H == W; the
    sampling grid is an (N - p)-point linspace in [-1 + 1/H, 1 - 1/H]
    replicate-padded by p = int(scale) - 1 at the high end, on both axes.
    Full float32 products (TF32 off)."""
    h, w = imgs.shape[-2:]
    if h != w:
        raise ValueError(f"the TF-consistent upsample needs square inputs, got {h} x {w}")
    n = int(h * scale_factor)
    delta = 1.0 / h
    p = int(scale_factor) - 1
    xs = np.linspace(-1.0 + delta, 1.0 - delta, n - p, dtype=np.float64)
    if p > 0:
        xs = np.concatenate([xs, np.full(p, xs[-1])])
    a = torch.from_numpy(_interp_matrix(xs, h)).to(imgs.device, imgs.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.einsum("iu,bcuv,jv->bcij", a, imgs, a)
