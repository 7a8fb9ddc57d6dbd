"""Fixed perception filter constants (own copy of ``vsnca_tpu/ops/filters.py``).

Filters are applied as cross-correlations (torch ``F.conv2d`` semantics).
"""

from __future__ import annotations

import numpy as np

# Sobel-x responds to horizontal gradients (left/right neighbors), Sobel-y is
# its transpose. Laplacian uses the 8-neighbor stencil with -12 center.
SOBEL_X = np.array(
    [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], dtype=np.float32
)
SOBEL_Y = SOBEL_X.T.copy()
LAPLACIAN = np.array(
    [[1.0, 2.0, 1.0], [2.0, -12.0, 2.0], [1.0, 2.0, 1.0]], dtype=np.float32
)


def gaussian_kernel_2d(size: int, sigma: float) -> np.ndarray:
    """Normalized 2-D Gaussian (the ImageEncoder's blur kernel): un-truncated,
    evaluated on the integer grid centered at ``size // 2``, summing to 1."""
    c = size // 2
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    k = np.exp(-(((ii - c) ** 2) + ((jj - c) ** 2)) / (2.0 * sigma**2))
    k = k / k.sum()
    return k.astype(np.float32)


def matlab_gaussian_kernel_2d(shape=(3, 3), sigma: float = 0.5) -> np.ndarray:
    """fspecial('gaussian')-style kernel (the MSOE pyramid blur,
    MSOEmultiscale.py:71-83): values below eps * max are zeroed before the
    normalization to sum 1."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0.0
    s = h.sum()
    if s != 0:
        h /= s
    return h.astype(np.float32)
