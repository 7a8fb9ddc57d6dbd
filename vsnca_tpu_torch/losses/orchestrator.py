"""Loss orchestrator: the weighted objective from a LossConfig — the port's
copy of ``vsnca_tpu/losses/orchestrator.py``.

``make_loss_fn`` returns ``loss_fn(input_dict, generator=None) -> (total,
logs)``; ``generator`` (a ``torch.Generator``) keys the OT subsample, the
SlW projections and the style-consistency seed, where the JAX function
splits a key. The terms, in the JAX function's order: overflow, auxiliary,
vector-field motion, appearance ("Gram", "OT", "SlW", on one frame or a
list of tapped frames), video motion, content and style consistency, each a
span of ``utils.spans`` (``loss.overflow``, ``loss.auxiliary``, …).
``set_loss_weight`` is the video-motion and vector-field calibration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import LossConfig, NCAConfig
from vsnca_tpu_torch.losses.appearance import appearance_loss
from vsnca_tpu_torch.losses.auxiliary import auxiliary_loss
from vsnca_tpu_torch.losses.content import content_loss
from vsnca_tpu_torch.losses.overflow import overflow_loss
from vsnca_tpu_torch.losses.style_consistency import style_consistency_loss
from vsnca_tpu_torch.losses.vector_field import (
    get_motion_vector_field_by_name,
    vector_field_motion_loss,
)
from vsnca_tpu_torch.losses.video_motion import video_motion_loss
from vsnca_tpu_torch.utils import spans


@dataclasses.dataclass
class LossState:
    """The LossConfig with what its terms need: the VGG16 and MSOE
    parameters, the vector-field term's target field (built once by
    ``make_loss_fn``) and the model config the style-consistency term grows
    a seed with."""

    cfg: LossConfig
    vgg_params: Optional[list] = None
    msoe_params: Optional[dict] = None
    target_field: Optional[torch.Tensor] = None
    nca_cfg: Optional[NCAConfig] = None


def _needs(what: str, terms) -> str:
    return (f"the {terms[0]} loss needs {what}" if len(terms) == 1
            else f"the {', '.join(terms[:-1])} and {terms[-1]} losses need {what}")


def make_loss_fn(state: LossState) -> Callable:
    """The composite loss of the enabled terms."""
    cfg = state.cfg
    vgg_terms = [name for name, on in (
        ("appearance", cfg.appearance_weight != 0),
        ("auxiliary", cfg.auxiliary_weight != 0 and cfg.auxiliary_loss_type != "MSE"),
        ("content", cfg.content_weight != 0)) if on]
    msoe_terms = [name for name, on in (
        ("vector-field motion", cfg.vector_field_motion_weight != 0),
        ("video-motion", cfg.video_motion_weight != 0)) if on]
    if vgg_terms and state.vgg_params is None:
        raise ValueError(_needs("VGG params", vgg_terms))
    if msoe_terms and state.msoe_params is None:
        raise ValueError(_needs("MSOE params", msoe_terms))
    if cfg.style_consistency_weight != 0 and state.nca_cfg is None:
        raise ValueError(_needs("the model config (LossState.nca_cfg)", ["style-consistency"]))
    if cfg.vector_field_motion_weight != 0 and state.target_field is None:
        dev = next(iter(state.msoe_params.values())).device
        state.target_field = get_motion_vector_field_by_name(
            cfg.motion_vector_field_name, cfg.motion_img_size).to(dev)

    def loss_fn(input_dict: Dict, generator: Optional[torch.Generator] = None):
        total = torch.zeros((), device=input_dict["nca_state"].device)
        logs: Dict[str, torch.Tensor] = {}
        if cfg.overflow_weight != 0:
            with spans.span("loss.overflow"):
                l = overflow_loss(input_dict["nca_state"])
                logs["overflow"] = l * cfg.overflow_weight
                total = total + cfg.overflow_weight * l
        if cfg.auxiliary_weight != 0:
            with spans.span("loss.auxiliary"):
                gen_list = input_dict["generated_image_list"]
                l = 0.0
                for g, a in zip(gen_list, input_dict["auxillary_image_list"]):
                    l = l + auxiliary_loss(state.vgg_params, g, a, cfg.auxiliary_loss_type,
                                           generator, cfg.ot_subsample, cfg.slw_projections)
                l = l / len(gen_list)
                logs["auxillary"] = l * cfg.auxiliary_weight
                total = total + cfg.auxiliary_weight * l
        if cfg.vector_field_motion_weight != 0:
            with spans.span("loss.vector_field_motion"):
                l, sub_logs, _ = vector_field_motion_loss(
                    state.msoe_params, input_dict["generated_image_before_nca"],
                    input_dict["generated_image_after_nca"], state.target_field,
                    input_dict["step_n"], cfg.nca_base_num_steps, cfg.motion_img_size,
                    cfg.motion_strength_weight, cfg.motion_direction_weight)
                for k, v in sub_logs.items():
                    logs[f"vector_field_motion-{k}"] = v
                logs["vector_field_motion"] = l * cfg.vector_field_motion_weight
                total = total + cfg.vector_field_motion_weight * l
        if cfg.appearance_weight != 0:
            with spans.span("loss.appearance"):
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
            with spans.span("loss.video_motion"):
                l, _ = video_motion_loss(
                    state.msoe_params, input_dict["generated_image_list_motion"],
                    input_dict.get("target_motion_image_list"), cfg.video_motion_loss_type,
                    generator, cfg.motion_img_size, cfg.ot_subsample, cfg.slw_projections,
                    target_features=input_dict.get("target_motion_feature_list"))
                logs["video_motion"] = l * cfg.video_motion_weight
                total = total + cfg.video_motion_weight * l
        if cfg.content_weight != 0:
            with spans.span("loss.content"):
                gen = (input_dict["generated_image_list"][0] + 1.0) / 2.0
                tgt = (input_dict["content_image"] + 1.0) / 2.0
                l = content_loss(state.vgg_params, gen, tgt)
                logs["content"] = l * cfg.content_weight
                total = total + cfg.content_weight * l
        if cfg.style_consistency_weight != 0:
            with spans.span("loss.style_consistency"):
                # min_steps 32: the reference's step-range minimum (the fit
                # scripts' nca_step_range[0])
                l = style_consistency_loss(
                    input_dict["nca_params"], state.nca_cfg, input_dict["target_image_list"][0],
                    generator if generator is not None else torch.default_generator,
                    min_steps=32, cond_img=input_dict.get("style_consistency_cond_img"))
                logs["style_consistency"] = l * cfg.style_consistency_weight
                total = total + cfg.style_consistency_weight * l
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
