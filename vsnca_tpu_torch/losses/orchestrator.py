"""Loss orchestrator: the weighted objective from a LossConfig — the port's
copy of ``vsnca_tpu/losses/orchestrator.py`` for the terms it has.

``make_loss_fn`` returns ``loss_fn(input_dict, generator=None) -> (total,
logs)``; ``generator`` (a ``torch.Generator``) keys the OT subsample and the
SlW projections, where the JAX function splits a key. The overflow,
appearance ("Gram", "OT", "SlW", on one frame or a list of tapped frames)
and video-motion terms are ported; any other term with a non-zero weight
raises when the function is built (ROADMAP.md queue A6).
``set_loss_weight`` is the video-motion calibration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import LossConfig
from vsnca_tpu_torch.losses.appearance import appearance_loss
from vsnca_tpu_torch.losses.overflow import overflow_loss
from vsnca_tpu_torch.losses.video_motion import video_motion_loss

_NOT_PORTED = {
    "auxiliary_weight": "A6",
    "vector_field_motion_weight": "A6",
    "style_consistency_weight": "A6",
    "content_weight": "A6",
}


@dataclasses.dataclass
class LossState:
    """The LossConfig with what its terms need: the VGG16 and MSOE
    parameters."""

    cfg: LossConfig
    vgg_params: Optional[list] = None
    msoe_params: Optional[dict] = None


def make_loss_fn(state: LossState) -> Callable:
    """The composite loss of the enabled terms."""
    cfg = state.cfg
    for name, item in _NOT_PORTED.items():
        if getattr(cfg, name) != 0:
            raise NotImplementedError(
                f"loss term {name} is not ported yet (ROADMAP.md {item})"
            )
    if cfg.appearance_weight != 0 and state.vgg_params is None:
        raise ValueError("the appearance loss needs VGG params")
    if cfg.video_motion_weight != 0 and state.msoe_params is None:
        raise ValueError("the video-motion loss needs MSOE params")

    def loss_fn(input_dict: Dict, generator: Optional[torch.Generator] = None):
        total = torch.zeros((), device=input_dict["nca_state"].device)
        logs: Dict[str, torch.Tensor] = {}
        if cfg.overflow_weight != 0:
            l = overflow_loss(input_dict["nca_state"])
            logs["overflow"] = l * cfg.overflow_weight
            total = total + cfg.overflow_weight * l
        if cfg.appearance_weight != 0:
            gen_list = input_dict["generated_image_list"]
            tgt_list = input_dict["target_image_list"]
            tgt_feats = input_dict.get("target_style_features")
            kw = dict(target_features=tgt_feats, generator=generator,
                      subsample=cfg.ot_subsample, proj_n=cfg.slw_projections)
            one_target = all(t is tgt_list[0] for t in tgt_list[1:]) and all(
                g.shape == gen_list[0].shape for g in gen_list)
            if len(gen_list) > 1 and one_target:
                # tapped frames against one style target: one VGG16 call on
                # the frames stacked over the batch (the per-item metrics
                # then average over frames x batch; SlW sums over items)
                l = appearance_loss(state.vgg_params, torch.cat(gen_list, dim=0),
                                    tgt_list[0], cfg.appearance_loss_type, **kw)
                if cfg.appearance_loss_type == "SlW":
                    l = l / len(gen_list)
            else:
                l = 0.0
                for g, t in zip(gen_list, tgt_list):
                    l = l + appearance_loss(state.vgg_params, g, t,
                                            cfg.appearance_loss_type, **kw)
                l = l / len(gen_list)
            logs["appearance"] = l * cfg.appearance_weight
            total = total + cfg.appearance_weight * l
        if cfg.video_motion_weight != 0:
            l, _ = video_motion_loss(
                state.msoe_params, input_dict["generated_image_list_motion"],
                input_dict.get("target_motion_image_list"), cfg.video_motion_loss_type,
                generator, cfg.motion_img_size, cfg.ot_subsample, cfg.slw_projections,
                target_features=input_dict.get("target_motion_feature_list"))
            logs["video_motion"] = l * cfg.video_motion_weight
            total = total + cfg.video_motion_weight * l
        return total, logs

    return loss_fn


# Manual per-texture motion weights (loss.py:117-126).
_MANUAL_WEIGHTS = {
    "12-96": {
        "ants": 0.2, "fur": 1.0, "sea_2": 4.0, "flames": 3.0,
        "sky_clouds_1": 0.25, "smoke_2": 0.1, "smoke_3": 0.5, "sea_3": 2.0,
        "calm_water_4": 1.0, "calm_water_2": 1.0,
    },
    "16-128": {
        "ants": 0.2, "fur": 1.0, "sea_2": 4.0, "flames": 2.0,
        "sky_clouds_1": 0.25, "smoke_2": 0.1, "smoke_3": 1.0, "sea_3": 2.0,
        "calm_water_4": 1.0, "calm_water_2": 1.0,
    },
}


def set_loss_weight(
    cfg: LossConfig,
    loss_name: str = "video_motion",
    appearance_loss_log=None,
    loss_num: float = 10.0,
    medium_mt: Optional[float] = None,
    img_size: int = 256,
    nca_config_key: str = "16-128",
    img_name: Optional[str] = None,
) -> LossConfig:
    """Dynamic weight calibration (orchestrator.py:205; loss.py:66-84);
    returns a new LossConfig.

    - video_motion: a linear fit of the median warm-up motion loss, clamped
      to [2, 10], overridden by the hand-tuned per-texture table.
    - vector_field_motion: median(appearance_loss_log) / 50.
    """
    if loss_name == "video_motion":
        w = loss_num
        if medium_mt is not None:
            if img_size == 256:
                w = min(10.0, max(medium_mt * 6.04 - 2.17, 2.0))
            elif img_size == 128:
                w = min(10.0, max(medium_mt * 5.82 - 1.05, 2.0))
            table = _MANUAL_WEIGHTS.get(nca_config_key, {})
            if img_name is not None and img_name in table:
                w = table[img_name]
        return dataclasses.replace(cfg, video_motion_weight=float(w))
    if loss_name == "vector_field_motion":
        w = float(np.median(np.asarray(appearance_loss_log)) / 50.0)
        return dataclasses.replace(cfg, vector_field_motion_weight=w)
    raise ValueError(f"unknown calibrated loss {loss_name}")
