"""Typed, immutable configuration — the port's own copy of
``vsnca_tpu/config.py`` (same fields, defaults and properties, so a config
built for one package means the same thing in the other)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NCAConfig:
    """DyNCA cell configuration.

    ``c_in``/``c_out``/``fc_dim``/``padding_mode``/``seed_mode``/
    ``conditioning``/``edge_transform``/``perception_scales`` as in the
    reference DyNCA constructor; ``seed_channels`` expresses the
    ExtraChannels variant whose seed carries one fewer channel than the cell
    consumes (the grayscale content channel is appended per frame).
    """

    c_in: int = 12
    c_out: int = 3
    fc_dim: int = 96
    padding_mode: str = "replicate"  # replicate | circular | zeros
    seed_mode: str = "zeros"  # zeros | center_on | random
    conditioning: Optional[str] = None  # None | 'pos_emb' | 'edges'
    edge_transform: str = "none"  # 'none' | 'tanh'
    perception_scales: Tuple[int, ...] = (0,)
    update_rate: float = 0.5
    seed_channels: Optional[int] = None  # defaults to c_in
    dtype: str = "float32"

    @property
    def c_cond(self) -> int:
        if self.conditioning == "pos_emb":
            return 2
        if self.conditioning == "edges":
            return 3
        return 0

    @property
    def expand(self) -> int:
        return 4

    @property
    def perception_dim(self) -> int:
        return self.c_in * self.expand + self.c_cond

    @property
    def n_seed_channels(self) -> int:
        return self.seed_channels if self.seed_channels is not None else self.c_in


@dataclasses.dataclass(frozen=True)
class ConditionedNCAConfig:
    """EncoderConditioning ConditionedNCA configuration (same fields,
    defaults and properties as ``vsnca_tpu.config.ConditionedNCAConfig``):
    3 target + 16 hidden + 1 alive = 20 channels, an update MLP 64 wide."""

    num_target_channels: int = 3
    num_hidden_channels: int = 16
    use_living_channel: bool = True
    living_channel_dim: Optional[int] = None  # defaults to num_target_channels
    alpha_living_threshold: float = 0.1
    cell_fire_rate: float = 0.5
    update_hidden_dim: int = 64
    image_size: int = 64
    clamp_value: float = 10.0

    @property
    def num_channels(self) -> int:
        return self.num_target_channels + self.num_hidden_channels + 1

    @property
    def alive_channel(self) -> int:
        return (
            self.living_channel_dim
            if self.living_channel_dim is not None
            else self.num_target_channels
        )


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Weights and metric selections for the loss orchestrator (same fields
    and defaults as ``vsnca_tpu.config.LossConfig``; the terms are computed by
    ``losses.orchestrator.make_loss_fn``)."""

    overflow_weight: float = 0.0
    appearance_weight: float = 0.0
    appearance_loss_type: str = "OT"  # OT | SlW | Gram
    auxiliary_weight: float = 0.0
    auxiliary_loss_type: str = "VGG"  # MSE | VGG | OT | SlW | Gram
    vector_field_motion_weight: float = 0.0
    motion_strength_weight: float = 0.5
    motion_direction_weight: float = 0.5
    motion_vector_field_name: str = "circular"
    video_motion_weight: float = 0.0
    video_motion_loss_type: str = "MotionOT"  # MotionOT | MotionSlW | MotionGram
    style_consistency_weight: float = 0.0
    content_weight: float = 0.0
    motion_img_size: Tuple[int, int] = (256, 256)
    nca_base_num_steps: int = 24
    ot_subsample: int = 1000
    slw_projections: int = 32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-harness knobs (same fields and defaults as
    ``vsnca_tpu.config.TrainConfig``). ``rollout_path``: "auto" trains
    through the fused kernel pair (``ops/fused_train.py``) where it applies
    on a card, else through eager steps; "fused" forces the pair (its plain
    version on the CPU); "xla" forces the eager steps, the counterpart of
    the JAX package's XLA scan."""

    img_size: Tuple[int, int] = (256, 256)
    batch_size: int = 2
    pool_size: int = 256
    step_range: Tuple[int, int] = (32, 128)
    inject_seed_every: int = 8
    max_iterations: int = 2000
    lr: float = 1e-3
    lr_decay_steps: Tuple[int, ...] = (500, 1000)
    lr_decay_gamma: float = 0.5
    save_every: int = 50
    seed: int = 42
    step_buckets: Tuple[int, ...] = (32, 48, 64, 96, 128)
    remat: str = "per_step"  # per_step | none | segment:K
    rollout_path: str = "auto"  # auto | fused | xla


def edge_conditioned() -> NCAConfig:
    """The ``edge_conditioned`` preset's cell (ConditioneDyNCA defaults): the
    model the stylizer and the server ship."""
    return NCAConfig(c_in=12, fc_dim=96, conditioning="edges",
                     edge_transform="none", padding_mode="circular")
