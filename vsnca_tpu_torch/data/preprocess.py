"""Image and video preprocessing — the port's own copy of
``vsnca_tpu/data/preprocess.py``: center-crop to a square, resize, [0, 1];
NHWC float32 numpy arrays, as the JAX package returns them (the trainer
moves them to the device as NCHW). GIF videos decode through PIL, mp4/avi
through OpenCV, as in the JAX package. The appearance-frame helpers
(``compute_flow_strengths``, ``select_frame_by_vgg_median``) take NCHW
tensors, as the port's models do.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch


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


def preprocess_target_images(paths: Sequence[str], img_size=(128, 128),
                             normal_rgb=False) -> np.ndarray:
    """Image files → [T, H, W, 3] in [-1, 1] ([0, 1] with ``normal_rgb``),
    each center-cropped and resized (preprocess.py:62)."""
    frames = []
    for p in paths:
        f = preprocess_style_image(p, img_size, batch_size=1)[0]
        frames.append(f if normal_rgb else f * 2.0 - 1.0)
    return np.stack(frames)


def rgb_to_grayscale_mean(x: np.ndarray) -> np.ndarray:
    """Channel-mean grayscale of NHWC frames, keepdim — the reference's
    RGBToGrayscale (preprocess.py:104), not the luma MSOE uses."""
    return np.mean(x, axis=-1, keepdims=True)


def compute_flow_strengths(msoe_params, video: torch.Tensor) -> List[float]:
    """The mean MSOE flow magnitude of each consecutive frame pair of a
    [T, 3, H, W] video in [-1, 1] (preprocess.py:111;
    preprocess_texture.py:116-149)."""
    from vsnca_tpu_torch.models.msoe import motion_pair_from_rgb, msoe_forward

    size = tuple(video.shape[-2:])
    out = []
    with torch.no_grad():
        for t in range(video.shape[0] - 1):
            pair = motion_pair_from_rgb(video[t:t + 1], video[t + 1:t + 2], size)
            flow = msoe_forward(msoe_params, pair)
            out.append(float(torch.linalg.vector_norm(flow, dim=1).mean()))
    return out


def select_frame_by_vgg_median(vgg_params, image_seq: torch.Tensor) -> int:
    """The frame whose relu4_1 VGG16 features lie closest to the sequence's
    mean (preprocess.py:134; the reference's ``select_frame``).
    image_seq: [T, 3, H, W] in [-1, 1]."""
    from vsnca_tpu_torch.models.vgg import vgg16_features

    with torch.no_grad():
        feats = vgg16_features(vgg_params, (image_seq + 1.0) / 2.0, layers=(18,))[0]
        dists = torch.linalg.vector_norm((feats - feats.mean(dim=0)).flatten(1), dim=1)
    return int(torch.argmin(dists))


def select_appearance_frame(flow_strengths: Sequence[float]) -> int:
    """The frame pair with the largest mean flow magnitude
    (preprocess.py:155; preprocess_texture.py:116-149)."""
    total = float(sum(flow_strengths))
    return int(np.argmax([s / total for s in flow_strengths]))


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
    """GIF/mp4/avi → [T, H, W, 3] in [-1, 1] ([0, 1] with ``normal_rgb``),
    each frame center-cropped and resized (preprocess.py:73). GIFs decode
    through PIL, mp4 and avi through OpenCV, as in the JAX package."""
    from PIL import Image, ImageSequence

    frames = []
    if path.endswith(".gif"):
        for frame in ImageSequence.Iterator(Image.open(path)):
            frames.append(preprocess_pil_image(frame, img_size)[0])
            if max_frames and len(frames) >= max_frames:
                break
    elif path.endswith((".avi", ".mp4")):
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            while cap.isOpened():
                ret, frame = cap.read()
                if not ret:
                    break
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(preprocess_pil_image(Image.fromarray(frame), img_size)[0])
                if max_frames and len(frames) >= max_frames:
                    break
        finally:
            cap.release()
    else:
        raise ValueError(f"unsupported video format: {path}")
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
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
