"""Video-motion training protocol — the port's copy of
``vsnca_tpu/train/video_motion_protocol.py`` (fit_video_motion.py:216-355):

1. warm-up: ``warmup_iters`` iterations at the initial video-motion weight;
2. calibrate: the video-motion weight from the median warm-up motion loss
   (``losses.orchestrator.set_loss_weight``);
3. re-init: a fresh trainer (model, pool, optimizer) trains to
   ``max_iterations`` with the calibrated weight;
4. anomaly recovery: the slots of a batch whose appearance loss passes a
   threshold are reseeded;
5. target windows start where ``data.preprocess.get_start_frame_idx``'s
   bounded random walk says;
6. ``synthesize_and_score`` rolls a video from a fresh seed and scores it.

Videos and frames are NCHW tensors in [-1, 1]: the target video
[T, 3, H, W], the appearance frame [B, 3, H, W].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.data.preprocess import get_start_frame_idx
from vsnca_tpu_torch.losses.orchestrator import set_loss_weight
from vsnca_tpu_torch.train.trainer import DyNCATrainer


@dataclasses.dataclass
class VideoMotionProtocol:
    nca_cfg: NCAConfig
    loss_cfg: LossConfig
    train_cfg: TrainConfig
    target_video: torch.Tensor  # [T, 3, H, W] in [-1, 1]
    appearance_frame: torch.Tensor  # [B, 3, H, W] (the selected style frame)
    warmup_iters: int = 1000
    n_motion_frames: int = 3
    tap_every: int = 64
    # the reference's schedule (fit_video_motion.py:230-235): frames after
    # steps 1, 1 + tap_every, ... <= step_n and a frameless tail; False is
    # the legacy shape, n_motion_frames equal chunks of tap_every steps
    reference_tap_schedule: bool = True
    anomaly_appearance_threshold: float = 50.0
    img_name: Optional[str] = None
    # the target's VGG16 and MSOE features once, not every iteration
    precompute_features: bool = True
    device: Optional[str] = None

    def __post_init__(self):
        self._motion_losses: list = []
        self._start_idx = 0
        self._rng = np.random.RandomState(self.train_cfg.seed)
        self._style_feats = None
        self._motion_feats = None

    def _build_trainer(self, vgg, msoe) -> DyNCATrainer:
        return DyNCATrainer(self.nca_cfg, self.loss_cfg, self.train_cfg, vgg_params=vgg,
                            msoe_params=msoe, device=self.device)

    def _window_inputs(self, batch: int, n_frames: int = 0) -> Dict[str, torch.Tensor]:
        n_frames = n_frames or self.n_motion_frames
        t = int(self.target_video.shape[0])
        self._start_idx = get_start_frame_idx(self._rng, t, n_frames)
        inputs = {"target_style": self.appearance_frame}
        if self._style_feats is not None:
            inputs["target_style_features"] = self._style_feats
        s = self._start_idx
        if self._motion_feats is not None:
            inputs["target_motion_features"] = self._motion_feats[s:s + n_frames - 1]
        else:
            window = self.target_video[s:s + n_frames]
            inputs["target_motion_frames"] = window[:, None].expand(
                (n_frames, batch) + tuple(window.shape[1:]))
        return inputs

    def _iteration_kwargs(self, trainer: DyNCATrainer):
        """(inputs, train_iteration keywords) of one iteration: the
        reference schedule takes its frame count from the sampled step_n,
        bumped past the first tap interval so there are >= 2 frames."""
        if not self.reference_tap_schedule:
            inputs = self._window_inputs(self.train_cfg.batch_size)
            return inputs, dict(n_motion_frames=self.n_motion_frames,
                                tap_every=self.tap_every)
        from vsnca_tpu_torch.models.dynca import tap_schedule

        step_n = max(trainer.sample_step_n(), self.tap_every + 1)
        chunks, tail = tap_schedule(step_n, self.tap_every)
        inputs = self._window_inputs(self.train_cfg.batch_size, n_frames=len(chunks))
        return inputs, dict(step_n=step_n, tap_chunks=chunks, tail_steps=tail)

    def run(self, vgg_params, msoe_params, log_every: int = 50, callback=None):
        """The whole protocol; returns the final trainer."""
        if self.precompute_features:
            from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
            from vsnca_tpu_torch.losses.video_motion import (
                precompute_target_motion_features,
            )

            if self.loss_cfg.appearance_weight:
                self._style_feats = precompute_target_style_features(
                    vgg_params, self.appearance_frame, self.loss_cfg.appearance_loss_type,
                    self.train_cfg.img_size)
            if self.loss_cfg.video_motion_weight and msoe_params is not None:
                self._motion_feats = precompute_target_motion_features(
                    msoe_params, self.target_video, self.loss_cfg.motion_img_size)
        trainer = self._build_trainer(vgg_params, msoe_params)

        for i in range(self.warmup_iters):
            inputs, kw = self._iteration_kwargs(trainer)
            log = trainer.train_iteration(inputs, **kw)
            if "video_motion" in log.logs and self.loss_cfg.video_motion_weight:
                self._motion_losses.append(
                    log.logs["video_motion"] / self.loss_cfg.video_motion_weight)
            self._maybe_anomaly_reseed(trainer, log)
            if callback and i % log_every == 0:
                callback("warmup", i, log)

        medium_mt = float(np.median(self._motion_losses)) if self._motion_losses else None
        self.loss_cfg = set_loss_weight(
            self.loss_cfg, "video_motion", medium_mt=medium_mt,
            img_size=self.train_cfg.img_size[0],
            nca_config_key=f"{self.nca_cfg.c_in}-{self.nca_cfg.fc_dim}",
            img_name=self.img_name)
        trainer = self._build_trainer(vgg_params, msoe_params)
        trainer.rebuild_loss(self.loss_cfg)

        for i in range(max(self.train_cfg.max_iterations - self.warmup_iters, 0)):
            inputs, kw = self._iteration_kwargs(trainer)
            log = trainer.train_iteration(inputs, **kw)
            self._maybe_anomaly_reseed(trainer, log)
            if callback and i % log_every == 0:
                callback("main", i, log)
        return trainer

    def _maybe_anomaly_reseed(self, trainer: DyNCATrainer, log):
        """Fresh seeds into the slots of a diverged batch
        (fit_video_motion.py:316-327)."""
        app = log.logs.get("appearance")
        if app is not None and app > self.anomaly_appearance_threshold:
            trainer.reseed_pool_slots(trainer.last_batch_idx)


def synthesize_and_score(
    trainer: DyNCATrainer,
    target_video: torch.Tensor,
    out_dir: str,
    n_frames: int = 40,
    step_n: int = 32,
    seed: int = 0,
    texture_frames: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """The final evaluation (video_motion_protocol.py:197;
    fit_video_motion.py:374-421): roll ``n_frames`` frames, ``step_n``
    steps apart, from a fresh seed; score each frame's appearance loss
    against every texture frame (``target_video`` by default) and each
    consecutive generated pair's video-motion loss against every consecutive
    target pair; write the means to ``out_dir/final_loss_test.txt``. Each
    generated frame (pair) meets all texture frames (target pairs) in one
    batched loss call."""
    from vsnca_tpu_torch.losses.appearance import appearance_loss
    from vsnca_tpu_torch.losses.video_motion import video_motion_loss
    from vsnca_tpu_torch.models.dynca import (
        dynca_rollout_with_taps,
        dynca_seed,
        make_conditioning,
    )

    cfg = trainer.nca_cfg
    hw = trainer.train_cfg.img_size
    dev = trainer.device
    gen = torch.Generator().manual_seed(seed)
    x = dynca_seed(cfg, 1, hw, generator=gen, device=dev)
    if cfg.n_seed_channels < cfg.c_in:
        x = torch.cat([x, x.new_zeros((1, cfg.c_in - cfg.n_seed_channels) + tuple(hw))], 1)
    cond_img = torch.zeros((1, 1) + tuple(hw), device=dev) if cfg.conditioning == "edges" else None
    cond = make_conditioning(cfg, hw, cond_img=cond_img, batch=1, device=dev)
    params = {k: v.detach() for k, v in trainer.params.items()}
    loss_cfg = trainer.loss_state.cfg
    vgg, msoe = trainer.loss_state.vgg_params, trainer.loss_state.msoe_params
    texture = target_video if texture_frames is None else texture_frames
    n_tex = int(texture.shape[0])
    with torch.no_grad():
        _, frames = dynca_rollout_with_taps(params, x, seed, cfg, n_frames, step_n, cond,
                                            remat="none")
        app = []
        for f in frames:
            l = appearance_loss(vgg, f.expand((n_tex,) + tuple(f.shape[1:])), texture,
                                loss_cfg.appearance_loss_type, generator=gen,
                                subsample=loss_cfg.ot_subsample,
                                proj_n=loss_cfg.slw_projections)
            app.append(float(l) / (n_tex if loss_cfg.appearance_loss_type == "SlW" else 1))
        result = {"appearance_loss_mean": float(np.mean(app))}
        if msoe is not None and loss_cfg.video_motion_weight != 0 and n_frames > 1:
            t_pairs = int(target_video.shape[0]) - 1
            mot = []
            for g0, g1 in zip(frames[:-1], frames[1:]):
                big = lambda f: f.expand((t_pairs,) + tuple(f.shape[1:]))  # noqa: E731
                l, _ = video_motion_loss(msoe, [big(g0), big(g1)],
                                         [target_video[:-1], target_video[1:]],
                                         loss_cfg.video_motion_loss_type, gen,
                                         loss_cfg.motion_img_size, loss_cfg.ot_subsample,
                                         loss_cfg.slw_projections)
                mot.append(float(l) / (t_pairs if loss_cfg.video_motion_loss_type
                                       == "MotionSlW" else 1))
            result["video_motion_loss_mean"] = float(np.mean(mot))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "final_loss_test.txt"), "w") as f:
        f.write(repr(result))
    return result
