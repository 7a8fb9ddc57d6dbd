"""Model operations of one DyNCA training iteration at a cell's shapes: the
NCA forward and backward at the step count drawn (plus the vector-field
term's one-step pre-roll and the edge map where the configuration has them),
VGG16 on the images the appearance and auxiliary terms feed it, MSOE on the
frame pairs of the motion terms. A pass that carries a gradient counts its
forward twice (``counts.losses``); the style image's and the target video's
features are computed once at set-up and not counted."""

from __future__ import annotations

from portbench.counts import losses, nca


def iteration_flops(model: dict, loss: dict, batch: int, h: int, w: int, step_n: int,
                    n_frames: int) -> float:
    px = batch * h * w
    flops = step_n * (nca.step_flops(model, px) + nca.step_backward_flops(model, px))
    if model.get("conditioning") == "edges":
        flops += nca.edge_map_flops(px)
    if loss.get("vector_field_motion_weight"):
        flops += nca.step_flops(model, px)
    if loss.get("appearance_weight"):
        flops += 2 * n_frames * batch * losses.vgg16_flops(h, w, losses.STYLE_LAST)
    if loss.get("auxiliary_weight"):
        flops += 3 * batch * losses.vgg16_flops(h, w, losses.CONTENT_LAST)
    motion = loss["motion_img_size"][0] if "motion_img_size" in loss else h
    if loss.get("vector_field_motion_weight"):
        flops += 2 * batch * losses.msoe_flops(motion)
    if loss.get("video_motion_weight"):
        flops += 2 * (n_frames - 1) * batch * losses.msoe_flops(motion)
    return float(flops)
