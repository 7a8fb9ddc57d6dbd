"""Image and video preprocessing — the port's own copy of the parts of
``vsnca_tpu/data/preprocess.py`` the trainers use (numpy and PIL only):
center-crop to a square, resize, [0, 1]; NHWC float32 numpy arrays, as the
JAX package returns them (the trainer moves them to the device as NCHW).
GIF videos decode through PIL; mp4/avi (OpenCV in the JAX package) are not
ported.
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


def preprocess_video(path: str, img_size=(128, 128), normal_rgb=False,
                     max_frames=None) -> np.ndarray:
    """GIF → [T, H, W, 3] in [-1, 1] ([0, 1] with ``normal_rgb``), each
    frame center-cropped and resized (preprocess.py:73)."""
    from PIL import Image, ImageSequence

    if not path.endswith(".gif"):
        raise ValueError(f"unsupported video format: {path} (GIF only; mp4/avi decode "
                         "is not ported)")
    frames = []
    for frame in ImageSequence.Iterator(Image.open(path)):
        frames.append(preprocess_pil_image(frame, img_size)[0])
        if max_frames and len(frames) >= max_frames:
            break
    seq = np.stack(frames)
    return seq if normal_rgb else seq * 2.0 - 1.0


def get_start_frame_idx(rng: np.random.RandomState, video_len: int, window: int) -> int:
    """Window start of a target-video frame window (preprocess.py:164;
    misc.py:4-30): a uniform anchor frame, then the window grown around it
    by random left/right steps, clamped at the video's ends. Draws from
    ``rng`` exactly as the JAX package does."""
    idx_vid = int(rng.randint(0, max(video_len - 1, 1)))
    start = idx_vid
    left_add, right_add = 1, 1
    remaining = window - 2
    while remaining > 0:
        left_expand = idx_vid - left_add
        right_expand = idx_vid + right_add + 1
        if left_expand < 0:
            go_left = False
        elif right_expand > video_len - 1:
            go_left = True
        else:
            go_left = bool(rng.randint(0, 2))
        if go_left:
            left_add += 1
            start -= 1
        else:
            right_add += 1
        remaining -= 1
    return int(max(start, 0))
