"""The DyNCA cell in plain PyTorch: the benchmark's reference for the rollout.

Written from the model's definition (Pajouheshgar et al., DyNCA, CVPR 2023;
the ConditioneDyNCA edge conditioning), not from the port: perception is the
state and its Sobel x, Sobel y and 8-neighbour Laplacian responses under the
padding mode, averaged over the perception scales (scale 1 perceives the
state bilinearly halved and upsamples the percept back); the conditioning
(an edge map of the content's grayscale, or a positional grid) is appended;
a two-layer ReLU MLP gives the update, applied where a per-pixel stochastic
mask is 1. Parameters are input-major: ``w1 [P, F]``, ``b1 [F]``,
``w2 [F, C]``, ``b2 [C]``, with the percept in block order
``[C raw | C sobel_x | C sobel_y | C lap | cond]``.

The update mask is part of the model's definition in this system: a murmur3
``fmix32`` chain of (seed, batch index, absolute step, pixel), 1 where the
top 24 bits reach ``round((1 - rate) * 2^24)``. It is restated here from
that definition.

``operand`` rounds the MLP's operands (the percept with its conditioning,
the weights, the hidden activations) to a lower type, as a served model
computes its products: None keeps float32, else a torch dtype such as
``torch.bfloat16`` or ``torch.float8_e4m3fn``. The products accumulate in
float32, in TF32 where the caller turned it on (the training control does;
the comparisons turn it off).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = tuple(tuple(SOBEL_X[j][i] for j in range(3)) for i in range(3))
LAPLACIAN = ((1.0, 2.0, 1.0), (2.0, -12.0, 2.0), (1.0, 2.0, 1.0))

_M32 = 0xFFFFFFFF
_STEP_MUL = 7919


def _fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def update_mask(seed: int, step: int, batch: int, h: int, w: int, rate: float,
                device) -> torch.Tensor:
    """float32 [B, 1, H, W] of 0/1: the masks of absolute step ``step``."""
    thr = max(0, min(int(round((1.0 - rate) * (1 << 24))), 1 << 24))
    pix = torch.arange(h * w, dtype=torch.int64, device=device)
    out = []
    for b in range(batch):
        key = _fmix32_int((seed & _M32) + b + step * _STEP_MUL)
        out.append(((_fmix32(pix ^ key) >> 8) >= thr).float().reshape(h, w))
    return torch.stack(out)[:, None]


def _pad(x: torch.Tensor, mode: str) -> torch.Tensor:
    return F.pad(x, (1, 1, 1, 1), mode={"circular": "circular", "zeros": "constant",
                                        "replicate": "replicate"}[mode])


def stencils(x: torch.Tensor, mode: str):
    """(sobel_x, sobel_y, laplacian) of every channel of NCHW ``x``."""
    p = _pad(x, mode)
    h, w = x.shape[-2:]
    out = []
    for k in (SOBEL_X, SOBEL_Y, LAPLACIAN):
        acc = torch.zeros_like(x)
        for di in range(3):
            for dj in range(3):
                if k[di][dj] != 0.0:
                    acc = acc + k[di][dj] * p[..., di:di + h, dj:dj + w]
        out.append(acc)
    return out


def perceive(x: torch.Tensor, mode: str, scales: Sequence[int]) -> torch.Tensor:
    def one(z):
        return torch.cat([z, *stencils(z, mode)], dim=1)

    h, w = x.shape[-2:]
    acc = None
    for s in scales:
        if s == 0:
            z = one(x)
        else:
            small = F.interpolate(x, size=(h >> s, w >> s), mode="bilinear",
                                  align_corners=False)
            z = F.interpolate(one(small), size=(h, w), mode="bilinear",
                              align_corners=False)
        acc = z if acc is None else acc + z
    return acc / float(len(scales))


def edge_map(gray: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] grayscale -> [B, 3, H, W] Sobel x, Sobel y, Laplacian
    with zero padding."""
    return torch.cat(stencils(gray, "zeros"), dim=1)


def positional_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """[B, 2, H, W]: channel 0 runs over rows, 1 over columns, each
    2 * (i / n - 0.5 + 0.5 / n)."""
    ys = 2.0 * (torch.arange(h, device=device, dtype=torch.float32) / h - 0.5 + 0.5 / h)
    xs = 2.0 * (torch.arange(w, device=device, dtype=torch.float32) / w - 0.5 + 0.5 / w)
    grid = torch.stack([ys[:, None].expand(h, w), xs[None, :].expand(h, w)])
    return grid[None].expand(b, 2, h, w).contiguous()


def conditioning(model: dict, b: int, h: int, w: int, gray: Optional[torch.Tensor],
                 device) -> Optional[torch.Tensor]:
    if model["conditioning"] == "edges":
        return edge_map(gray)
    if model["conditioning"] == "pos_emb":
        return positional_grid(b, h, w, device)
    return None


def _round(t: torch.Tensor, operand) -> torch.Tensor:
    return t if operand is None else t.to(operand).float()


def step(params: dict, x: torch.Tensor, cond: Optional[torch.Tensor], model: dict,
         seed: int, step_index: int, operand=None) -> torch.Tensor:
    """One step of absolute index ``step_index``: x + MLP(percept) * mask."""
    p = perceive(x, model["padding_mode"], model["perception_scales"])
    if cond is not None:
        p = torch.cat([p, cond], dim=1)
    w1 = _round(params["w1"], operand)
    w2 = _round(params["w2"], operand)
    hid = torch.relu(torch.einsum("bphw,pf->bfhw", _round(p, operand), w1)
                     + params["b1"][:, None, None])
    dx = (torch.einsum("bfhw,fc->bchw", _round(hid, operand), w2)
          + params["b2"][:, None, None])
    b, _, h, w = x.shape
    mask = update_mask(seed, step_index, b, h, w, model["update_rate"], x.device)
    return x + dx * mask


def rollout(params: dict, x: torch.Tensor, cond: Optional[torch.Tensor], model: dict,
            seed: int, n_steps: int, first_step: int = 0, operand=None) -> torch.Tensor:
    for i in range(n_steps):
        x = step(params, x, cond, model, seed, first_step + i, operand)
    return x


def to_rgb01(x: torch.Tensor) -> torch.Tensor:
    """The served readout: NHWC [B, H, W, 3] in [0, 1] from 2 x the first
    three channels, clipped to [-1, 1]."""
    return (x[:, :3].permute(0, 2, 3, 1) * 2.0).clamp(-1.0, 1.0) * 0.5 + 0.5
