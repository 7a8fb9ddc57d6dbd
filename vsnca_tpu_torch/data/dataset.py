"""Device-resident conditioning-image dataset — the port's copy of
``vsnca_tpu/data/dataset.py``: a folder of images loaded once into one NCHW
tensor on the device, sampled in random batches."""

from __future__ import annotations

import os

import numpy as np
import torch

from vsnca_tpu_torch.data.preprocess import preprocess_style_image
from vsnca_tpu_torch.device import resolve_device

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class ConditioningDataset:
    def __init__(self, images: np.ndarray, device=None):
        """images: [N, H, W, 3] in [0, 1] (the EncoderConditioning stack works
        in [0, 1] throughout), kept as float32 [N, 3, H, W] on ``device``."""
        arr = np.asarray(images, dtype=np.float32).transpose(0, 3, 1, 2)
        self.images = torch.from_numpy(arr.copy()).to(resolve_device(device))

    @classmethod
    def from_folder(cls, folder: str, image_size: int = 64, device=None) -> "ConditioningDataset":
        paths = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                       if f.lower().endswith(IMG_EXTS))
        imgs = [preprocess_style_image(p, (image_size, image_size), 1)[0] for p in paths]
        return cls(np.stack(imgs).astype(np.float32), device)

    def __len__(self) -> int:
        return int(self.images.shape[0])

    def sample(self, rng: np.random.RandomState, batch: int) -> torch.Tensor:
        """``batch`` images drawn with replacement by ``rng.randint``, as the
        JAX package draws them: [batch, 3, H, W]."""
        idx = rng.randint(0, len(self), size=batch)
        return self.images[torch.from_numpy(idx).to(self.images.device)]

    def __getitem__(self, idx) -> torch.Tensor:
        return self.images[idx]
