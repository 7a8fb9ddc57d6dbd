"""Vector-field-motion training protocol — the port's copy of
``vsnca_tpu/train/vector_field_protocol.py`` (fit_vector_field_motion.py
:198-334, SURVEY.md C18):

1. train with the appearance, vector-field-motion and overflow losses;
2. every ``recalibrate_every`` iterations (``i % recalibrate_every == 0 and
   i > 0``), reset the vector-field-motion weight to the median of the
   appearance log so far over 50 (``losses.orchestrator.set_loss_weight``),
   in place: unlike the video-motion protocol, no model, pool or optimizer
   is re-initialized;
3. the NaN abort is the trainer's.

The artifact dumps (1x and 2x control videos, the flow image and the
vector-field plots, fit_vector_field_motion.py:285-298) and
``synthesize_texture_video`` need the video writer and the display helpers,
which are not ported yet (ROADMAP.md A9): ``save_every`` with an
``out_dir`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.losses.orchestrator import set_loss_weight
from vsnca_tpu_torch.train.trainer import DyNCATrainer


@dataclasses.dataclass
class VectorFieldProtocol:
    """The run loop of BASELINE config 2 (synthetic vector fields)."""

    nca_cfg: NCAConfig
    loss_cfg: LossConfig
    train_cfg: TrainConfig
    target_style: torch.Tensor  # [B, 3, H, W] in [-1, 1]
    recalibrate_every: int = 500  # motion_weight_change_interval
    save_every: int = 0  # 0: no artifact dumps
    out_dir: Optional[str] = None
    video_frames: int = 8
    precompute_features: bool = True
    device: Optional[str] = None

    def __post_init__(self):
        if self.save_every and self.out_dir:
            raise NotImplementedError(
                "the vector-field protocol's artifact dumps need the video writer, which is "
                "not ported yet (ROADMAP.md A9); pass save_every=0 or out_dir=None")
        self._appearance_log: list = []
        self.recalibrations: list = []  # (iteration, new weight)
        self._style_feats = None

    def run(self, vgg_params, msoe_params, log_every: int = 50,
            callback=None) -> DyNCATrainer:
        """The whole protocol; returns the trainer."""
        if self.precompute_features and self.loss_cfg.appearance_weight:
            from vsnca_tpu_torch.losses.appearance import precompute_target_style_features

            self._style_feats = precompute_target_style_features(
                vgg_params, self.target_style, self.loss_cfg.appearance_loss_type,
                self.train_cfg.img_size)
        trainer = DyNCATrainer(self.nca_cfg, self.loss_cfg, self.train_cfg,
                               vgg_params=vgg_params, msoe_params=msoe_params,
                               device=self.device)
        inputs = {"target_style": self.target_style}
        if self._style_feats is not None:
            inputs["target_style_features"] = self._style_feats

        for i in range(self.train_cfg.max_iterations):
            log = trainer.train_iteration(inputs)
            if "appearance" in log.logs and self.loss_cfg.appearance_weight:
                # the orchestrator logs weighted terms; the reference
                # calibrates on raw values (loss.py:66-84,108)
                self._appearance_log.append(
                    log.logs["appearance"] / self.loss_cfg.appearance_weight)
            if self.recalibrate_every and i % self.recalibrate_every == 0 and i > 0:
                self.loss_cfg = set_loss_weight(self.loss_cfg, "vector_field_motion",
                                                appearance_loss_log=self._appearance_log)
                self.recalibrations.append((i, self.loss_cfg.vector_field_motion_weight))
                trainer.rebuild_loss(self.loss_cfg)
            if callback and i % log_every == 0:
                callback("train", i, log)
        return trainer
