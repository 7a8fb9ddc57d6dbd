"""Optic-flow visualization: Middlebury colorwheel images + vector-field
streamplots — the port's copy of ``vsnca_tpu/utils/flow_viz.py`` (parity
with ExtraChannels/utils/misc/flow_viz.py:26-196; the colorwheel is the
standard Baker et al. Middlebury scheme). Arrays in, arrays out: a flow
tensor [1, 2, H, W] from MSOE becomes ``flow[0].permute(1, 2, 0)``.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """Standard 55-color Middlebury wheel [55, 3] uint8 ranges."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, clip_flow: Optional[float] = None) -> np.ndarray:
    """[H, W, 2] flow → [H, W, 3] uint8 colorwheel rendering, normalized by
    the max magnitude (flow_viz.py:90-196 behavior)."""
    u = np.asarray(flow[..., 0], dtype=np.float64)
    v = np.asarray(flow[..., 1], dtype=np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u = u / rad_max
    v = v / rad_max
    rad = np.sqrt(u**2 + v**2)

    ncols = _COLORWHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = _COLORWHEEL[k0, i] / 255.0
        col1 = _COLORWHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., i] = np.floor(255 * col)
    return img


def plot_vec_field(vec: np.ndarray, name: str = "", density: float = 1.0):
    """Streamplot PNG of a [2, H, W] or [H, W, 2] vector field; returns an
    [h, w, 3] uint8 array (flow_viz.py:26-87)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if vec.shape[0] == 2 and vec.ndim == 3:
        u, v = vec[0], vec[1]
    else:
        u, v = vec[..., 0], vec[..., 1]
    h, w = u.shape
    x, y = np.meshgrid(np.arange(w), np.arange(h))

    fig, ax = plt.subplots(figsize=(4, 4), dpi=100)
    ax.streamplot(x, y, u, v, density=density)
    ax.invert_yaxis()
    ax.set_title(name)
    ax.set_xticks([])
    ax.set_yticks([])
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    from PIL import Image

    return np.asarray(Image.open(buf).convert("RGB"))
