"""Spatial padding of NCHW tensors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_PAD_MODES = {"zeros": "constant", "replicate": "replicate", "circular": "circular"}


def pad2d(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad the two spatial dims of an NCHW tensor by ``pad`` on each side.

    ``mode`` is one of the reference's names: replicate (corners from the
    nearest corner, as numpy's ``mode="edge"``), circular or zeros.
    """
    return F.pad(x, (pad, pad, pad, pad), mode=_PAD_MODES[mode])


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Half-sample symmetric reflection of indices into [0, n): the
    triangular wave around -0.5 and n - 0.5 of the reference's
    ``symmetric_padding`` (MSOEmultiscale.py:4-24), edge samples
    duplicated."""
    minx, maxx = -0.5, n - 0.5
    rng = maxx - minx
    double_rng = 2 * rng
    mod = np.fmod(idx - minx, double_rng)
    normed = np.where(mod < 0, mod + double_rng, mod)
    out = np.where(normed >= rng, double_rng - normed, normed) + minx
    return out.astype(np.int64)


def symmetric_pad_2d(x: torch.Tensor, padding) -> torch.Tensor:
    """Half-sample symmetric (edge-duplicating) padding of the spatial dims
    of an NCHW tensor; ``padding`` is (left, right, top, bottom), as in
    ``vsnca_tpu/ops/padding.py::symmetric_pad_2d``. Pads within one period
    are flips and concatenations; longer ones gather along the triangular
    wave."""
    left, right, top, bottom = padding
    h, w = x.shape[-2:]
    if max(left, right) <= w and max(top, bottom) <= h:
        rows = [x]
        if top:
            rows.insert(0, x[..., :top, :].flip(-2))
        if bottom:
            rows.append(x[..., h - bottom:, :].flip(-2))
        x = torch.cat(rows, dim=-2) if len(rows) > 1 else x
        cols = [x]
        if left:
            cols.insert(0, x[..., :left].flip(-1))
        if right:
            cols.append(x[..., w - right:].flip(-1))
        return torch.cat(cols, dim=-1) if len(cols) > 1 else x
    y_idx = torch.from_numpy(_reflect_index(np.arange(-top, h + bottom), h)).to(x.device)
    x_idx = torch.from_numpy(_reflect_index(np.arange(-left, w + right), w)).to(x.device)
    return x.index_select(-2, y_idx).index_select(-1, x_idx)
