"""Vector-field-motion training protocol — the port's copy of
``vsnca_tpu/train/vector_field_protocol.py`` (fit_vector_field_motion.py
:198-334, SURVEY.md C18):

1. train with the appearance, vector-field-motion and overflow losses;
2. every ``recalibrate_every`` iterations (``i % recalibrate_every == 0 and
   i > 0``), reset the vector-field-motion weight to the median of the
   appearance log so far over 50 (``losses.orchestrator.set_loss_weight``),
   in place: unlike the video-motion protocol, no model, pool or optimizer
   is re-initialized;
3. every ``save_every`` iterations (``(i + 1) % save_every == 0``) with an
   ``out_dir``, dump artifacts (fit_vector_field_motion.py:285-298): the
   texture synthesized at 1x and 2x size (``video_last.mp4``,
   ``video_large_last.mp4``), the MSOE flow of its last two frames as a
   colorwheel image (``flow_gen<i>.jpg``) and, where matplotlib is
   installed, the generated and target fields' streamplots
   (``vec_field_gen<i>.png``, ``vec_field_target.png``);
4. the NaN abort is the trainer's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.losses.orchestrator import set_loss_weight
from vsnca_tpu_torch.train.trainer import DyNCATrainer


def synthesize_texture_video(
    params: dict,
    nca_cfg: NCAConfig,
    img_size,
    path: str,
    n_frames: int = 30,
    step_n: int = 24,
    size_factor: float = 1.0,
    fps: float = 30.0,
    seed: int = 0,
    device=None,
):
    """Roll the learned dynamic texture from a fresh seed state, emitting one
    frame every ``step_n`` steps (fit_vector_field_motion.py:172-187's
    save_video: pure synthesis, no content conditioning; the state persists
    across frames). ``size_factor`` scales the grid (the reference saves 1x
    and 2x videos). ``seed`` draws the seed state and keys the masks of one
    continuous rollout (frame i's steps are absolute steps i * step_n ...),
    in place of the JAX function's split keys. Returns the frames, [H, W, 3]
    in [0, 1]."""
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning
    from vsnca_tpu_torch.utils.video_writer import VideoWriter

    dev = resolve_device(device)
    h = int(img_size[0] * size_factor)
    w = int(img_size[1] * size_factor)
    state = dynca_seed(nca_cfg, 1, (h, w), torch.Generator().manual_seed(seed), dev)
    if nca_cfg.n_seed_channels < nca_cfg.c_in:
        state = torch.cat([state, torch.zeros((1, nca_cfg.c_in - nca_cfg.n_seed_channels, h, w),
                                              device=dev)], dim=1)
    cond = make_conditioning(nca_cfg, (h, w), batch=1, device=dev)
    frames = []
    with VideoWriter(path, fps=fps) as vw, torch.no_grad():
        for i in range(n_frames):
            state, rgb = dynca_rollout(params, state, seed, nca_cfg, step_n, cond,
                                       first_step=i * step_n)
            frame = (rgb[0].clamp(-1.0, 1.0).permute(1, 2, 0).cpu().numpy()) * 0.5 + 0.5
            vw.add(frame)
            frames.append(frame)
    return frames


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
            if self.save_every and self.out_dir and (i + 1) % self.save_every == 0:
                self._dump_artifacts(trainer, msoe_params, i)
            if callback and i % log_every == 0:
                callback("train", i, log)
        return trainer

    def _dump_artifacts(self, trainer: DyNCATrainer, msoe_params, i: int):
        """1x/2x videos + flow image + generated/target vector-field
        streamplots (fit_vector_field_motion.py:285-298); the streamplots
        only where matplotlib is installed."""
        from PIL import Image

        from vsnca_tpu_torch.losses.vector_field import get_motion_vector_field_by_name
        from vsnca_tpu_torch.models.msoe import motion_pair_from_rgb, msoe_forward
        from vsnca_tpu_torch.utils.display import plotting_available, save_image_grid
        from vsnca_tpu_torch.utils.flow_viz import flow_to_image, plot_vec_field

        os.makedirs(self.out_dir, exist_ok=True)
        kw = dict(n_frames=self.video_frames, step_n=self.loss_cfg.nca_base_num_steps,
                  device=trainer.device)
        frames = synthesize_texture_video(
            trainer.params, self.nca_cfg, self.train_cfg.img_size,
            os.path.join(self.out_dir, "video_last.mp4"), size_factor=1.0, **kw)
        synthesize_texture_video(
            trainer.params, self.nca_cfg, self.train_cfg.img_size,
            os.path.join(self.out_dir, "video_large_last.mp4"), size_factor=2.0, **kw)
        plots = plotting_available()
        if msoe_params is not None and len(frames) >= 2:
            a, b = (torch.from_numpy(f * 2.0 - 1.0).permute(2, 0, 1)[None].to(trainer.device)
                    for f in frames[-2:])
            with torch.no_grad():
                pair = motion_pair_from_rgb(a, b, self.loss_cfg.motion_img_size)
                flow = msoe_forward(msoe_params, pair)[0].permute(1, 2, 0).cpu().numpy()
            save_image_grid(flow_to_image(flow)[None].astype(np.float32) / 255.0,
                            os.path.join(self.out_dir, f"flow_gen{i}.jpg"))
            if plots:
                Image.fromarray(plot_vec_field(flow, name="generated")).save(
                    os.path.join(self.out_dir, f"vec_field_gen{i}.png"))
        if plots:
            target = get_motion_vector_field_by_name(self.loss_cfg.motion_vector_field_name,
                                                     self.loss_cfg.motion_img_size)[0].numpy()
            Image.fromarray(plot_vec_field(target, name="target")).save(
                os.path.join(self.out_dir, "vec_field_target.png"))
