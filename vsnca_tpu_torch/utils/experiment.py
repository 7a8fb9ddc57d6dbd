"""Experiment-directory helpers — the port's copy of
``vsnca_tpu/utils/experiment.py`` (parity: ExtraChannels/helper.py:20-73)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def ensure_dir(path: str):
    os.makedirs(path, exist_ok=True)


def get_next_experiment_index(base_dir: str) -> int:
    """Next experiment_N index under base_dir (helper.py:20-28)."""
    ensure_dir(base_dir)
    idxs = []
    for name in os.listdir(base_dir):
        if name.startswith("experiment_"):
            try:
                idxs.append(int(name.split("_")[-1]))
            except ValueError:
                pass
    return max(idxs) + 1 if idxs else 0


def find_image_by_name(folder: str, name: str) -> Optional[str]:
    """First image whose stem matches ``name`` (helper.py:30-40)."""
    for f in sorted(os.listdir(folder)):
        stem, ext = os.path.splitext(f)
        if stem == name and ext.lower() in IMG_EXTS:
            return os.path.join(folder, f)
    return None


def scan_folder_for_images(folder: str) -> List[str]:
    return sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith(IMG_EXTS)
    )


def save_setup_images(out_dir: str, **named_images):
    """Dump the run's input images (helper.py:51-73). Values are [B, H, W, C]
    or [H, W, C] floats in [0, 1] (or [-1, 1], auto-rescaled)."""
    from PIL import Image

    ensure_dir(out_dir)
    for name, img in named_images.items():
        arr = np.asarray(img)
        if arr.ndim == 4:
            arr = arr[0]
        if arr.min() < 0:
            arr = (arr + 1.0) / 2.0
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        Image.fromarray(np.uint8(np.clip(arr, 0, 1) * 255)).save(
            os.path.join(out_dir, f"{name}.png")
        )
