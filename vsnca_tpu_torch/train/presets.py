"""Preset (NCAConfig, LossConfig, TrainConfig) triples — the port's copy of
``vsnca_tpu/train/presets.py`` for the presets it can train.

Only ``static_texture`` so far: the other four need losses the port does
not have yet (OT appearance, auxiliary VGG, vector-field and video motion;
ROADMAP.md queue A6 and A7).
"""

from __future__ import annotations

from typing import Tuple

from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig

Preset = Tuple[NCAConfig, LossConfig, TrainConfig]


def static_texture(img_size=128) -> Preset:
    """Config 1: single style image, Gram-only appearance."""
    nca = NCAConfig(c_in=12, fc_dim=96, conditioning="pos_emb",
                    padding_mode="circular")
    loss = LossConfig(overflow_weight=100.0, appearance_weight=1.0,
                      appearance_loss_type="Gram")
    train = TrainConfig(img_size=(img_size, img_size), batch_size=4,
                        pool_size=256, step_range=(32, 128),
                        max_iterations=2000, lr_decay_steps=(1000, 2000),
                        lr_decay_gamma=0.5, remat="none")
    return nca, loss, train


PRESETS = {
    "static_texture": static_texture,
}
