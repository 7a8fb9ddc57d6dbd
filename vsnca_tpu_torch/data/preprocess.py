"""Style-image preprocessing — the port's own copy of the parts of
``vsnca_tpu/data/preprocess.py`` the trainers use (numpy and PIL only):
center-crop to a square, resize, [0, 1]; NHWC float32 numpy arrays, as the
JAX package returns them (the trainer moves them to the device as NCHW).
"""

from __future__ import annotations

import os

import numpy as np


def _center_crop_square(arr: np.ndarray) -> np.ndarray:
    h, w = arr.shape[:2]
    if h == w:
        return arr
    cut = abs(w - h) // 2
    if w > h:
        return arr[:, cut : w - cut, :]
    return arr[cut : h - cut, :, :]


def preprocess_pil_image(img, img_size=(128, 128)) -> np.ndarray:
    """PIL image → [1, H, W, 3] float32 in [0, 1]."""
    from PIL import Image

    arr = _center_crop_square(np.asarray(img.convert("RGB")))
    img = Image.fromarray(arr.astype(np.uint8)).resize((img_size[0], img_size[1]))
    return (np.float32(img) / 255.0)[None]


def preprocess_style_image(path_or_img, img_size=(128, 128),
                           batch_size: int = 4) -> np.ndarray:
    """Style image file or PIL image → [batch, H, W, 3] in [0, 1]."""
    from PIL import Image

    img = (Image.open(path_or_img) if isinstance(path_or_img, (str, os.PathLike))
           else path_or_img)
    return np.repeat(preprocess_pil_image(img, img_size), batch_size, axis=0)


def synthetic_style_image(img_size=(128, 128), batch_size: int = 4,
                          seed: int = 0) -> np.ndarray:
    """Deterministic colorful test texture in [0, 1], [B, H, W, 3]."""
    h, w = img_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.5 + 0.5 * np.sin(2 * np.pi * (xx / w * 3 + yy / h))
    g = 0.5 + 0.5 * np.cos(2 * np.pi * (yy / h * 2 - xx / w))
    b = 0.5 + 0.5 * np.sin(2 * np.pi * ((xx + yy) / (h + w) * 4 + seed))
    img = np.stack([r, g, b], axis=-1)[None]
    return np.repeat(img, batch_size, axis=0).astype(np.float32)


def synthetic_video(img_size=(128, 128), n_frames: int = 8, seed: int = 0) -> np.ndarray:
    """Deterministic drifting texture in [-1, 1], [T, H, W, 3]: the synthetic
    style image rolled 2 pixels a frame along the width."""
    h, w = img_size
    base = synthetic_style_image(img_size, 1, seed)[0]
    frames = [np.roll(base, int(t * 2) % w, axis=1) for t in range(n_frames)]
    return (np.stack(frames) * 2.0 - 1.0).astype(np.float32)
