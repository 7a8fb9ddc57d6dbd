"""NCA perception: fixed 3x3 stencils as shifted-slice sums on NCHW tensors.

Counterpart of ``vsnca_tpu/ops/perception.py``: pad once, slice the shifted
neighborhoods, and sum the nonzero taps in the same order as the JAX
package, so the float32 results agree to rounding. No convolution library
call is involved (cuDNN would run a float32 convolution in TF32).
"""

from __future__ import annotations

from typing import Sequence

import torch

from vsnca_tpu_torch.ops.filters import LAPLACIAN, SOBEL_X, SOBEL_Y
from vsnca_tpu_torch.ops.padding import pad2d
from vsnca_tpu_torch.ops.resize import resize_bilinear


def stencil_3x3(x: torch.Tensor, kernels: Sequence, pad_mode: str) -> list:
    """Apply several fixed 3x3 cross-correlation kernels to every channel.

    x: [B, C, H, W]; each kernel is a 3x3 array. Returns a list of
    [B, C, H, W] responses, one per kernel, from one padded buffer.
    """
    return stencil_sums(pad2d(x, 1, pad_mode), kernels)


def stencil_sums(p: torch.Tensor, kernels: Sequence) -> list:
    """``stencil_3x3`` on a grid already padded by one cell on each side
    ([B, C, H + 2, W + 2] → [B, C, H, W] responses), in the same order of
    taps, so a padded slab gives a whole grid's bits."""
    h, w = p.shape[-2] - 2, p.shape[-1] - 2
    outs = []
    for k in kernels:
        acc = None
        for di in range(3):
            for dj in range(3):
                kv = float(k[di][dj])
                if kv == 0.0:
                    continue
                tap = p[..., di : di + h, dj : dj + w]
                term = tap * kv if kv != 1.0 else tap
                acc = term if acc is None else acc + term
        outs.append(acc)
    return outs


def perceive(x: torch.Tensor, pad_mode: str = "replicate") -> torch.Tensor:
    """Single-scale DyNCA perception: [x | sobel_x(x) | sobel_y(x) | lap(x)]
    concatenated along channels in the reference's block order."""
    return perceive_padded(pad2d(x, 1, pad_mode))


def perceive_padded(p: torch.Tensor) -> torch.Tensor:
    """``perceive`` of the grid inside a one-cell padding ``p``."""
    y1, y2, y3 = stencil_sums(p, [SOBEL_X, SOBEL_Y, LAPLACIAN])
    return torch.cat([p[..., 1:-1, 1:-1], y1, y2, y3], dim=1)


def perceive_multiscale(
    x: torch.Tensor,
    perception_scales: Sequence[int] = (0,),
    pad_mode: str = "replicate",
) -> torch.Tensor:
    """Perception averaged over scales; scale s > 0 perceives the state
    bilinearly downsampled to (H // 2^s, W // 2^s) and upsamples back."""
    h, w = x.shape[-2:]
    acc = None
    for scale in perception_scales:
        if scale == 0:
            z = perceive(x, pad_mode)
        else:
            xs = resize_bilinear(x, (h // (2**scale), w // (2**scale)))
            z = resize_bilinear(perceive(xs, pad_mode), (h, w))
        acc = z if acc is None else acc + z
    return acc / float(len(perception_scales))


def edge_extract(gray: torch.Tensor, transform: str = "none") -> torch.Tensor:
    """Edge conditioning map: gray [B, 1, H, W] → [B, 3, H, W] =
    [sobel_x, sobel_y, laplacian] with zero padding, optionally tanh'd."""
    out = torch.cat(stencil_3x3(gray, [SOBEL_X, SOBEL_Y, LAPLACIAN], "zeros"), dim=1)
    if transform == "tanh":
        out = torch.tanh(out)
    return out
