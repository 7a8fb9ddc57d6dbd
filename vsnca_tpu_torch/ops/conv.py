"""Learnable-convolution helpers for the ConditionedNCA family — the port's
own copy of what it needs from ``vsnca_tpu/ops/conv.py``: the torch-default
initializer, the depthwise 3x3 perception and the alive pool.

Weights are OIHW (torch's layout); the JAX package keeps HWIO, and
``convert.cnca_params_from_jax`` transposes. ``max_pool_2d(a, 3, 1, 1)``
of the JAX package pads with -inf, which is ``F.max_pool2d``'s padding;
``max_pool_2d`` keeps the JAX package's tie-splitting gradients.
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


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, padding="SAME",
           groups: int = 1) -> torch.Tensor:
    """Cross-correlation on NCHW input with an OIHW kernel — the port of
    ``vsnca_tpu/ops/conv.py::conv2d`` (:18), whose kernels are HWIO.
    ``padding`` is 'SAME' (stride 1), 'VALID' or an int (zeros). Full
    float32 (TF32 off), as the JAX package computes it at 'highest'."""
    torch.backends.cudnn.allow_tf32 = False
    if isinstance(padding, str):
        padding = padding.lower()
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def _max_1d(x: torch.Tensor, window: int, padding: int, dim: int) -> torch.Tensor:
    """Stride-1 max over ``window`` along ``dim``, padded with -inf."""
    n_out = x.shape[dim] + 2 * padding - window + 1
    xp = _pad_dim(x, dim, padding, padding, float("-inf"))
    y = xp.narrow(dim, 0, n_out)
    for d in range(1, window):
        y = torch.maximum(y, xp.narrow(dim, d, n_out))
    return y


def _pad_dim(x: torch.Tensor, dim: int, lo: int, hi: int, value: float) -> torch.Tensor:
    shape = list(x.shape)
    parts = []
    if lo:
        shape[dim] = lo
        parts.append(x.new_full(shape, value))
    parts.append(x)
    if hi:
        shape[dim] = hi
        parts.append(x.new_full(shape, value))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _eq_bwd_1d(x, y, g, window: int, padding: int, dim: int) -> torch.Tensor:
    """The VJP of a stride-1 1-D max pool by equality masks (conv.py:130):
    with T[o] the number of window elements equal to y[o],
    gx[i] = sum over the windows o holding i of (g[o] / T[o]) [x[i] == y[o]]
    — a tie's cotangent split evenly."""
    w, p = window, padding
    n_out, n_in = y.shape[dim], x.shape[dim]
    xp = _pad_dim(x, dim, p, p, float("-inf"))
    ties = None
    for d in range(w):
        eq = (xp.narrow(dim, d, n_out) == y).to(x.dtype)
        ties = eq if ties is None else ties + eq
    gs = g / ties
    yp = _pad_dim(y, dim, w - 1 - p, w - 1 - p, float("-inf"))
    gp = _pad_dim(gs, dim, w - 1 - p, w - 1 - p, 0.0)
    gx = None
    for s in range(w):
        term = gp.narrow(dim, s, n_in) * (x == yp.narrow(dim, s, n_in)).to(x.dtype)
        gx = term if gx is None else gx + term
    return gx


class _MaxPoolEq(torch.autograd.Function):
    """Stride-1 max pool, W then H (separable: the 2-D window's values),
    with the equality-mask backward of ``_max_pool_2d_eq`` (conv.py:160):
    the H pass, then the W pass."""

    @staticmethod
    def forward(ctx, x, window: int, padding: int):
        y1 = _max_1d(x, window, padding, -1)
        y = _max_1d(y1, window, padding, -2)
        ctx.save_for_backward(x, y1, y)
        ctx.window, ctx.padding = window, padding
        return y

    @staticmethod
    def backward(ctx, g):
        x, y1, y = ctx.saved_tensors
        g1 = _eq_bwd_1d(y1, y, g, ctx.window, ctx.padding, -2)
        return _eq_bwd_1d(x, y1, g1, ctx.window, ctx.padding, -1), None, None


class _MaxPoolNonOverlapEq(torch.autograd.Function):
    """Non-overlapping max pool (stride == window, no padding, VALID: the
    tail rows and columns past the last whole window are dropped) with the
    equality-mask VJP of ``_max_pool_2d_nonoverlap_eq`` (conv.py:193): each
    input lies in one window, so gx = eq * up(g / ties) with eq = (x ==
    up(y)), ties the window sum of eq and up the nearest ×window upsample
    (here a broadcast over each window's rows and columns); the tail rows
    and columns get zero."""

    @staticmethod
    def forward(ctx, x, window: int):
        y = F.max_pool2d(x, window, window)
        ctx.save_for_backward(x, y)
        ctx.window = window
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        w = ctx.window
        b, c, h, wd = y.shape
        win = x[..., : h * w, : wd * w].reshape(b, c, h, w, wd, w)
        eq = (win == y[:, :, :, None, :, None]).to(x.dtype)
        ties = eq.sum(dim=(3, 5), keepdim=True)  # exact: at most w*w ones
        gx = (eq * (g[:, :, :, None, :, None] / ties)).reshape(b, c, h * w, wd * w)
        return F.pad(gx, (0, x.shape[-1] - wd * w, 0, x.shape[-2] - h * w)), None


def max_pool_2d(x: torch.Tensor, window: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Max pool on NCHW with -inf padding (``vsnca_tpu/ops/conv.py::max_pool_2d``
    :237). A float pool of stride 1, or of stride == window without padding
    (VGG's 2x2/2), splits a tie's gradient evenly over the tied elements, as
    the JAX package's custom VJPs do (``F.max_pool2d`` sends it to one of
    them; MSOE's square-then-pool and VGG on flat images make real ties);
    other pools are ``F.max_pool2d``."""
    if stride == 1 and window > 1 and x.is_floating_point():
        return _MaxPoolEq.apply(x, window, padding)
    if stride == window and padding == 0 and window > 1 and x.is_floating_point():
        return _MaxPoolNonOverlapEq.apply(x, window)
    return F.max_pool2d(x, window, stride, padding)
