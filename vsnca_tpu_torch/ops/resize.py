"""Bilinear resize with torch ``F.interpolate(align_corners=False)`` semantics."""

from __future__ import annotations

import numpy as np
import torch


def _bilinear_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] half-pixel-center bilinear sampling matrix
    (align_corners=False, edge-clamped), as in ``vsnca_tpu/ops/resize.py``."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src)
    w_hi = src - lo
    a = np.zeros((n_out, n_in), np.float64)
    i0 = np.clip(lo.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(lo.astype(np.int64) + 1, 0, n_in - 1)
    rows = np.arange(n_out)
    np.add.at(a, (rows, i0), 1.0 - w_hi)
    np.add.at(a, (rows, i1), w_hi)
    return a.astype(np.float32)


def resize_nearest_1d(x: torch.Tensor, n: int) -> torch.Tensor:
    """Nearest-neighbour resize along the last axis of a [..., N] tensor,
    with torch ``F.interpolate(mode='nearest')``'s index rule
    src = floor(dst * N_in / N_out)."""
    n_in = x.shape[-1]
    if n_in == n:
        return x
    idx = np.minimum(np.floor(np.arange(n) * (n_in / n)).astype(np.int64), n_in - 1)
    return x.index_select(-1, torch.from_numpy(idx).to(x.device))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (H, W) = ``size``, without
    antialiasing, as two separable products with static sampling matrices
    (the JAX package's lowering). The products run in full float32: TF32
    would round the operands to about three decimal digits."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    a_h = torch.from_numpy(_bilinear_matrix(size[0], h)).to(x.device, x.dtype)
    a_w = torch.from_numpy(_bilinear_matrix(size[1], w)).to(x.device, x.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.einsum("iu,bcuv,jv->bcij", a_h, x, a_w)
