"""Preset (NCAConfig, LossConfig, TrainConfig) triples — the port's copy of
``vsnca_tpu/train/presets.py`` for the presets it can train.

``static_texture`` and ``video_motion`` so far: the other three need losses
the port does not have yet (auxiliary VGG, content, vector-field motion;
ROADMAP.md queue A6).
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


def video_motion(img_size=256) -> Preset:
    """Config 3: dynamic-texture video fit with the two-stream motion loss
    (fit_video_motion defaults: c_in 16, fc 128, scales (0, 1), 256px,
    batch 3, steps 80-144, overflow 1, appearance OT 1, video-motion
    MotionOT warm-up weight 5)."""
    nca = NCAConfig(c_in=16, fc_dim=128, conditioning="pos_emb",
                    padding_mode="circular", perception_scales=(0, 1))
    loss = LossConfig(
        overflow_weight=1.0,
        appearance_weight=1.0,
        appearance_loss_type="OT",
        video_motion_weight=5.0,
        video_motion_loss_type="MotionOT",
        motion_img_size=(img_size, img_size),
    )
    train = TrainConfig(img_size=(img_size, img_size), batch_size=3,
                        pool_size=256, step_range=(80, 144),
                        max_iterations=5000, lr_decay_steps=(1000, 2000),
                        lr_decay_gamma=0.3,
                        step_buckets=(80, 96, 128, 144),
                        remat="segment:8")
    return nca, loss, train


PRESETS = {
    "static_texture": static_texture,
    "video_motion": video_motion,
}
