"""MSOE multiscale two-stream motion-energy network (the frozen flow
backend of the video-motion loss) — the port's copy of
``vsnca_tpu/models/msoe.py`` on NCHW tensors with OIHW kernels.

A 5-level Gaussian pyramid of motion-energy units (11x11x2 conv → square →
5x5 stride-1 max pool → 1x1 → L1 norm), TF-consistent bilinear upsampling
back to full resolution, a 320-channel motion feature and a small decoder
to 2-channel flow. All padding is the half-sample symmetric scheme.

Weights: ``weights/msoe.npz`` (HWIO arrays, the JAX package's layout, from
``scripts/convert_msoe.py``) when present; otherwise a seeded fallback
drawn from ``torch.Generator().manual_seed(175)`` with torch's default
init bounds — the same distribution as the JAX package's
``PRNGKey(175)`` fallback, not the same numbers. ``convert.msoe_from_jax``
carries the JAX package's arrays over.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.ops.conv import conv2d, max_pool_2d
from vsnca_tpu_torch.ops.filters import matlab_gaussian_kernel_2d
from vsnca_tpu_torch.ops.grid_sample import tf_consistent_bilinear_upsample
from vsnca_tpu_torch.ops.padding import symmetric_pad_2d
from vsnca_tpu_torch.ops.resize import resize_bilinear

N_SCALES = 5

# name: (OIHW shape, fan_in) of the JAX package's arrays (msoe.py:37)
_SHAPES = {
    "conv1_w": ((32, 2, 11, 11), 11 * 11 * 2),
    "conv1_b": ((32,), 11 * 11 * 2),
    "conv2_w": ((64, 32, 1, 1), 32),
    "conv2_b": ((64,), 32),
    "decode1_w": ((64, 64 * N_SCALES, 3, 3), 64 * N_SCALES * 9),
    "decode1_b": ((64,), 64 * N_SCALES * 9),
    "decode2_w": ((2, 64, 1, 1), 64),
    "decode2_b": ((2,), 64),
}


def msoe_random_init(generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """Fallback weights, uniform in ±1/sqrt(fan_in) (torch's default
    bounds), drawn on the CPU from ``generator``."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, fan_in) in _SHAPES.items():
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = ((torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound).to(dev)
    return out


def msoe_from_npz(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Weights from a converted npz (HWIO kernels, ``scripts/convert_msoe.py``)."""
    from vsnca_tpu_torch.convert import msoe_from_jax

    with np.load(path) as data:
        return msoe_from_jax(dict(data.items()), device)


DEFAULT_MSOE_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "weights", "msoe.npz")


def load_msoe(path: Optional[str] = None, device=None) -> Tuple[dict, bool]:
    """(params, pretrained): ``path`` or the repo's ``weights/msoe.npz``
    when it exists, else the seed-175 fallback. Nothing is downloaded."""
    p = path or DEFAULT_MSOE_PATH
    if os.path.exists(p):
        return msoe_from_npz(p, device), True
    return msoe_random_init(torch.Generator().manual_seed(175), device), False


def contrast_norm(x: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit (unbiased) std over every non-batch dim
    (MSOEmultiscale.py:127-136)."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    n = int(np.prod([x.shape[d] for d in dims]))
    var = ((x - mean) ** 2).sum(dim=dims, keepdim=True) / max(n - 1, 1)
    return (x - mean) / torch.sqrt(var + 1e-12)


def _msoenet(params: dict, pair: torch.Tensor) -> torch.Tensor:
    """Motion-energy unit: frame pair [B, 2, H, W] → [B, 64, H, W]; the
    2-tap temporal Conv3d is one 2-channel 2-D convolution."""
    x = symmetric_pad_2d(pair, (5, 5, 5, 5))
    y = conv2d(x, params["conv1_w"], params["conv1_b"], padding="VALID")
    y = max_pool_2d(y.square(), 5, 1, 2)
    y = conv2d(y, params["conv2_w"], params["conv2_b"])
    norm = y.abs().sum(dim=1, keepdim=True)
    return y / torch.clamp(norm, min=1e-12)


def _pyramid_blur(pair: torch.Tensor) -> torch.Tensor:
    """5x5 sigma-2 Gaussian blur and stride-2 decimation of each frame, with
    symmetric padding (MSOEmultiscale.py:46-69)."""
    k = torch.from_numpy(matlab_gaussian_kernel_2d((5, 5), 2.0)).to(pair.device, pair.dtype)
    kw = k[None, None].repeat(2, 1, 1, 1)  # depthwise over the 2 frames
    return conv2d(symmetric_pad_2d(pair, (2, 2, 2, 2)), kw, stride=2, padding="VALID",
                  groups=2)


def msoe_forward(params: dict, pair: torch.Tensor, return_features: bool = False):
    """Frame pair [B, 2, H, W] (grayscale in [0, 1], H == W) → flow
    [B, 2, H, W], channel 1 negated as in the reference
    (MSOEmultiscale.py:170); with ``return_features`` also ``[z]``, the
    320-channel motion feature [B, 320, H, W]."""
    levels = [contrast_norm(pair)]
    for _ in range(N_SCALES - 1):
        levels.append(_pyramid_blur(levels[-1]))
    hs = [_msoenet(params, lv) for lv in levels]
    zs = [hs[0]] + [tf_consistent_bilinear_upsample(hs[i], float(2**i))
                    for i in range(1, N_SCALES)]
    z = torch.cat(zs, dim=1)
    d = conv2d(symmetric_pad_2d(z, (1, 1, 1, 1)), params["decode1_w"], params["decode1_b"],
               padding="VALID")
    flow = conv2d(torch.relu(d), params["decode2_w"], params["decode2_b"])
    flow = flow * torch.tensor([1.0, -1.0], device=flow.device, dtype=flow.dtype)[:, None, None]
    if return_features:
        return flow, [z]
    return flow


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma with torchvision's coefficients (0.2989, 0.587,
    0.114): [B, 3, H, W] → [B, 1, H, W]."""
    w = torch.tensor([0.2989, 0.587, 0.114], device=x.device, dtype=x.dtype)
    return (x * w[:, None, None]).sum(dim=1, keepdim=True)


def motion_pair_from_rgb(image1: torch.Tensor, image2: torch.Tensor, size) -> torch.Tensor:
    """Two RGB frames [B, 3, H, W] in [-1, 1] → the MSOE input pair
    [B, 2, h, w]: resize, to [0, 1], grayscale, stack."""
    if tuple(image1.shape[-2:]) != tuple(size):
        image1 = resize_bilinear(image1, size)
    if tuple(image2.shape[-2:]) != tuple(size):
        image2 = resize_bilinear(image2, size)
    g1 = rgb_to_grayscale((image1 + 1.0) / 2.0)
    g2 = rgb_to_grayscale((image2 + 1.0) / 2.0)
    return torch.cat([g1, g2], dim=1)


def motion_pairs_from_frames(frames: Sequence[torch.Tensor], size) -> torch.Tensor:
    """The consecutive pairs of a frame sequence, stacked on the batch:
    [(len(frames) - 1) * B, 2, h, w]; each frame is resized and
    grayscaled once."""
    t = len(frames)
    if t < 2:
        raise ValueError("motion pairs need at least 2 frames")
    x = torch.cat(list(frames), dim=0)
    if tuple(x.shape[-2:]) != tuple(size):
        x = resize_bilinear(x, size)
    g = rgb_to_grayscale((x + 1.0) / 2.0)
    b = frames[0].shape[0]
    return torch.cat([torch.cat([g[i * b:(i + 1) * b], g[(i + 1) * b:(i + 2) * b]], dim=1)
                      for i in range(t - 1)], dim=0)
