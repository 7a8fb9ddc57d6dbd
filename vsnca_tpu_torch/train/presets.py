"""The five BASELINE configurations as (NCAConfig, LossConfig, TrainConfig)
preset triples — the port's copy of ``vsnca_tpu/train/presets.py``, field
for field.

The ``remat`` fields are the JAX package's (a TPU memory plan); the port's
trainer keeps every state of its training pair on the card whatever they
say (``models.dynca.rollout_route``).
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


def vector_field_motion(img_size=128, field="circular") -> Preset:
    """Config 2: DyNCA + synthetic vector-field motion
    (fit_vector_field_motion defaults: c_in 12, fc 96, 128px, batch 4,
    overflow 100, appearance OT 1, motion 4 w/ strength 15 / direction 10)."""
    nca = NCAConfig(c_in=12, fc_dim=96, conditioning="pos_emb",
                    padding_mode="circular")
    loss = LossConfig(
        overflow_weight=100.0,
        appearance_weight=1.0,
        appearance_loss_type="OT",
        vector_field_motion_weight=4.0,
        motion_strength_weight=15.0,
        motion_direction_weight=10.0,
        motion_vector_field_name=field,
        motion_img_size=(img_size, img_size),
        nca_base_num_steps=24,
    )
    train = TrainConfig(img_size=(img_size, img_size), batch_size=4,
                        pool_size=256, step_range=(32, 128),
                        max_iterations=2000, lr_decay_steps=(1000, 2000),
                        remat="none")
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


def extra_channels(img_size=256) -> Preset:
    """Config 4: ExtraChannels variant — grayscale content appended as an
    extra state channel (experiments.py: c_in 12+1, fc 96, batch 2,
    overflow 1000, appearance OT 1, auxiliary VGG 10, vf-motion 1 w/ .5/.5)."""
    nca = NCAConfig(c_in=13, seed_channels=12, fc_dim=96, conditioning=None,
                    padding_mode="circular")
    loss = LossConfig(
        overflow_weight=1000.0,
        appearance_weight=1.0,
        appearance_loss_type="OT",
        auxiliary_weight=10.0,
        auxiliary_loss_type="VGG",
        vector_field_motion_weight=1.0,
        motion_strength_weight=0.5,
        motion_direction_weight=0.5,
        motion_img_size=(img_size, img_size),
    )
    train = TrainConfig(img_size=(img_size, img_size), batch_size=2,
                        pool_size=256, step_range=(32, 128),
                        max_iterations=2000, lr_decay_steps=(500, 1000),
                        remat="segment:8")
    return nca, loss, train


def edge_conditioned(img_size=256) -> Preset:
    """Config 4b: ConditioneDyNCA — Sobel/Laplacian edge map fed to the
    update MLP (ConditioneDyNCA/experiments.py defaults)."""
    nca = NCAConfig(c_in=12, fc_dim=96, conditioning="edges",
                    edge_transform="none", padding_mode="circular")
    loss = LossConfig(
        overflow_weight=1000.0,
        appearance_weight=1.0,
        appearance_loss_type="OT",
        auxiliary_weight=10.0,
        auxiliary_loss_type="VGG",
        vector_field_motion_weight=1.0,
        motion_strength_weight=0.5,
        motion_direction_weight=0.5,
        motion_img_size=(img_size, img_size),
    )
    train = TrainConfig(img_size=(img_size, img_size), batch_size=2,
                        pool_size=256, step_range=(32, 128),
                        max_iterations=2000, lr_decay_steps=(500, 1000),
                        remat="segment:8")
    return nca, loss, train


PRESETS = {
    "static_texture": static_texture,
    "vector_field_motion": vector_field_motion,
    "video_motion": video_motion,
    "extra_channels": extra_channels,
    "edge_conditioned": edge_conditioned,
}
