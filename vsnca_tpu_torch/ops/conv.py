"""Learnable-convolution helpers for the ConditionedNCA family — the port's
own copy of what it needs from ``vsnca_tpu/ops/conv.py``: the torch-default
initializer, the depthwise 3x3 perception and the alive pool.

Weights are OIHW (torch's layout); the JAX package keeps HWIO, and
``convert.cnca_params_from_jax`` transposes. ``max_pool_2d(a, 3, 1, 1)``
of the JAX package pads with -inf, which is ``F.max_pool2d``'s padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def torch_conv_init(generator: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
                    groups: int = 1, bias: bool = True, zero_bias: bool = False) -> dict:
    """torch.nn.Conv2d's default init, drawn on the CPU from ``generator``:
    weight [c_out, c_in / groups, kh, kw] and bias [c_out] uniform in
    ±1/sqrt(fan_in), fan_in = (c_in / groups) * kh * kw (kaiming-uniform
    with a = sqrt(5) reduces to that bound)."""
    bound = 1.0 / math.sqrt((c_in // groups) * kh * kw)
    shape = (c_out, c_in // groups, kh, kw)
    p = {"w": (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound}
    if bias:
        p["b"] = (torch.zeros(c_out) if zero_bias
                  else (torch.rand(c_out, generator=generator) * 2.0 - 1.0) * bound)
    return p


def depthwise_perceive(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Learnable depthwise 3x3 perception with zero padding: x [B, C, H, W],
    w [C, 3 (slots), 3, 3] → [B, 3C, H, W] in torch grouped-conv order (row
    c*3 + s). Written as 9 shifted taps summed in tap order (di*3 + dj), a
    product and a sum each, so the CUDA kernels can round as it does;
    differentiable in x and w."""
    b, c, h, wd = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    wk = w.reshape(c, 3, 9)
    acc = None
    for t in range(9):
        di, dj = divmod(t, 3)
        term = p[:, :, None, di : di + h, dj : dj + wd] * wk[None, :, :, t, None, None]
        acc = term if acc is None else acc + term
    return acc.reshape(b, c * 3, h, wd)


def alive_pool(alpha: torch.Tensor, threshold: float) -> torch.Tensor:
    """maxpool3x3(alpha) > threshold (stride 1, -inf padding) — bool, no
    gradient; ``alpha`` is [B, 1, H, W]."""
    return F.max_pool2d(alpha.detach(), 3, 1, 1) > threshold
