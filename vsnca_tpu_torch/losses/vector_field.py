"""Vector-field motion loss and the synthetic target-field library — the
port's copy of ``vsnca_tpu/losses/vector_field.py``
(vector_field_loss.py:9-328).

The fields are built in numpy float64, once a run, with the reference's
quirks: pi = 3.1416, the centre cell skipped, the last row and column zero
where the reference's half-open ranges stop short, the +0.2 minimum
strength of the gradient fields. They are returned as NCHW float32 tensors
[1, 2, H, W], channel 0 the x-component.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vsnca_tpu_torch.models.msoe import motion_pair_from_rgb, msoe_forward

_TORCH_PI = 3.1416  # the reference uses torch.FloatTensor([3.1416]), not np.pi


def _grids(img_size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, j, in_range): each cell's row and column offset from the centre
    over the whole H x W grid, and the cells the reference's range(-c, c)
    loops cover (for odd sizes the last row and column stay zero)."""
    h, w = img_size
    cx, cy = h // 2, w // 2
    rows = np.arange(h) - cx
    cols = np.arange(w) - cy
    i = np.broadcast_to(rows[:, None], (h, w)).astype(np.float64)
    j = np.broadcast_to(cols[None, :], (h, w)).astype(np.float64)
    in_range = (rows[:, None] < cx) & (cols[None, :] < cy)
    return i, j, in_range


def _normalize_by_mean_strength(vec: np.ndarray) -> np.ndarray:
    avg = np.mean(np.sqrt(vec[..., 0] ** 2 + vec[..., 1] ** 2))
    return vec / avg


def _as_nchw(vec: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(vec.transpose(2, 0, 1)[None]
                                                 .astype(np.float32)))


def get_motion_vector_field_by_name(name: str, img_size=(128, 128)) -> torch.Tensor:
    """The target motion field [1, 2, H, W] of a name
    (vector_field_loss.py:135-328): an integer string (a uniform direction
    in degrees), 'grad_θ_φ', 'hyperbolic', 'circular', 'circle', 'converge',
    'diverge', '2block_x', '2block_y', '3block' or '4block'."""
    h, w = img_size
    try:
        rad = int(name) / 180.0 * _TORCH_PI
    except ValueError:
        pass
    else:
        vec = np.zeros((h, w, 2), np.float64)
        vec[..., 0] = np.cos(rad)
        vec[..., 1] = np.sin(rad)
        return _as_nchw(vec)

    i, j, in_range = _grids(img_size)
    r = np.sqrt(i**2 + j**2)
    vec = np.zeros((h, w, 2), np.float64)
    off_centre = in_range & (r != 0)
    rs = np.where(r == 0, 1.0, r)
    maxr = ((h // 2) ** 2 + (w // 2) ** 2) ** 0.5

    if name.startswith("grad"):
        theta = int(name.split("_")[1]) / 180.0 * _TORCH_PI
        phi = int(name.split("_")[2]) / 180.0 * _TORCH_PI
        alpha = np.where(in_range, j * np.cos(phi) + i * np.sin(phi), 0.0)
        vec[..., 0] = alpha
        vec[..., 1] = alpha
        vec = vec - vec.min() + 0.2
        vec[..., 0] *= np.cos(theta)
        vec[..., 1] *= np.sin(theta)
        vec = _normalize_by_mean_strength(vec)
    elif name == "hyperbolic":
        vec[..., 0] = np.where(off_centre, 4.0 * i / maxr, 0.0)
        vec[..., 1] = np.where(off_centre, 4.0 * j / maxr, 0.0)
        vec = _normalize_by_mean_strength(vec)
    elif name == "circular":
        vec[..., 0] = np.where(off_centre, 4.0 * i / maxr, 0.0)
        vec[..., 1] = np.where(off_centre, -4.0 * j / maxr, 0.0)
        vec = _normalize_by_mean_strength(vec)
    elif name == "circle":
        vec[..., 0] = np.where(off_centre, i / rs, 0.0)
        vec[..., 1] = np.where(off_centre, -j / rs, 0.0)
    elif name == "converge":
        vec[..., 0] = np.where(off_centre, -j / rs, 0.0)
        vec[..., 1] = np.where(off_centre, -i / rs, 0.0)
    elif name == "diverge":
        vec[..., 0] = np.where(off_centre, j / rs, 0.0)
        vec[..., 1] = np.where(off_centre, i / rs, 0.0)
    elif name in ("2block_x", "2block_y", "3block", "4block"):
        if name == "2block_x":
            deg = np.where(i >= 0, 0.0, 180.0)
        elif name == "2block_y":
            deg = np.where(i >= 0, 90.0, -90.0)
        elif name == "3block":
            deg = np.where(i >= 0, 0.0, np.where(j < 0, 90.0, 180.0))
        else:
            deg = np.where(i >= 0, np.where(j >= 0, 0.0, 90.0),
                           np.where(j < 0, 180.0, 270.0))
        rad = deg / 180.0 * _TORCH_PI
        vec[..., 0] = np.where(in_range, np.cos(rad), 0.0)
        vec[..., 1] = np.where(in_range, np.sin(rad), 0.0)
    else:
        raise ValueError(f"unknown motion vector field {name!r}")
    return _as_nchw(vec)


def _cos_sim(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-pixel cosine similarity over the channel axis of NCHW tensors,
    with torch ``CosineSimilarity``'s denominator max(|a| |b|, eps)."""
    num = torch.sum(a * b, dim=1)
    den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1)
    return num / torch.clamp_min(den, eps)


def vector_field_motion_loss(
    msoe_params,
    image_before: torch.Tensor,
    image_after: torch.Tensor,
    target_field: torch.Tensor,
    step_n,
    nca_base_num_steps: int = 24,
    motion_img_size=(128, 128),
    strength_weight: float = 0.5,
    direction_weight: float = 0.5,
):
    """Direction and gated strength of the MSOE flow between two frames
    against a target field (vector_field_loss.py:50-132).

    image_before/after: NCHW RGB in [-1, 1]; target_field [1, 2, H, W]. The
    flow's magnitude is rescaled by base_steps / step_n, and each item's
    strength term is gated by its mean cosine similarity, without a gradient
    through the gate. Returns (loss, logs, flow [B, 2, H, W])."""
    pair = motion_pair_from_rgb(image_before, image_after, motion_img_size)
    flow = msoe_forward(msoe_params, pair)
    target_field = target_field.to(flow.device, flow.dtype)
    logs = {}
    loss = 0.0
    cos = _cos_sim(flow, target_field)  # [B, H, W]
    if strength_weight > 0:
        strength = torch.linalg.vector_norm(flow, dim=1) * (nca_base_num_steps / step_n)
        sl = torch.abs(strength - torch.linalg.vector_norm(target_field, dim=1))
        cos_loss_b = 1.0 - torch.mean(cos, dim=(1, 2), keepdim=True)
        alpha = (1.0 - torch.clamp(cos_loss_b, 0.0, 1.0)).detach()
        sl = torch.mean(sl * alpha)
        logs["strength"] = sl
        loss = loss + strength_weight * sl
    if direction_weight > 0:
        dl = 1.0 - torch.mean(cos)
        logs["direction"] = dl
        loss = loss + direction_weight * dl
    return loss, logs, flow
