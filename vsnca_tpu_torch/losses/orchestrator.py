"""Loss orchestrator: the weighted objective from a LossConfig — the port's
copy of ``vsnca_tpu/losses/orchestrator.py`` for the terms it has.

``make_loss_fn`` returns ``loss_fn(input_dict) -> (total, logs)``. The
overflow and appearance ("Gram") terms are ported; any other term with a
non-zero weight raises when the function is built (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from vsnca_tpu_torch.config import LossConfig
from vsnca_tpu_torch.losses.appearance import appearance_loss
from vsnca_tpu_torch.losses.overflow import overflow_loss

_NOT_PORTED = {
    "auxiliary_weight": "A6",
    "vector_field_motion_weight": "A6",
    "video_motion_weight": "A7",
    "style_consistency_weight": "A6",
    "content_weight": "A6",
}


@dataclasses.dataclass
class LossState:
    """The LossConfig with what its terms need: the VGG16 parameters."""

    cfg: LossConfig
    vgg_params: Optional[list] = None


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

    def loss_fn(input_dict: Dict):
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
            l = 0.0
            for g, t in zip(gen_list, tgt_list):
                l = l + appearance_loss(state.vgg_params, g, t, cfg.appearance_loss_type,
                                        target_features=tgt_feats)
            l = l / len(gen_list)
            logs["appearance"] = l * cfg.appearance_weight
            total = total + cfg.appearance_weight * l
        return total, logs

    return loss_fn
