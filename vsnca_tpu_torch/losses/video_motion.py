"""Video-motion (motion-texture) loss on MSOE features of frame pairs — the
port's copy of ``vsnca_tpu/losses/video_motion.py`` on NCHW tensors.

For each consecutive generated-frame pair and the matching target pair, the
320-channel MSOE motion feature, matched by MotionOT, MotionSlW or
MotionGram (normalized by C*H*W, unlike the appearance Gram's H*W). Every
pair is scored, as in the JAX package (the reference scores only the
first). The OT subsample and the SlW projections come from a
``torch.Generator``: the JAX package's distribution, not its numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from vsnca_tpu_torch.losses.appearance import _flatten, _moment_loss, _project_sort, _remd
from vsnca_tpu_torch.models.msoe import motion_pair_from_rgb, motion_pairs_from_frames, msoe_forward
from vsnca_tpu_torch.ops.resize import resize_nearest_1d


def motion_feature(msoe_params, image1: torch.Tensor, image2: torch.Tensor,
                   size=(128, 128)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two RGB frames [B, 3, H, W] in [-1, 1] → (the 320-channel motion
    feature [B, 320, h, w], the flow [B, 2, h, w])."""
    flow, feats = msoe_forward(msoe_params, motion_pair_from_rgb(image1, image2, size),
                               return_features=True)
    return feats[0], flow


def _motion_gram(f: torch.Tensor) -> torch.Tensor:
    b, c, h, w = f.shape
    x = f.reshape(b, c, h * w)
    return torch.bmm(x, x.transpose(1, 2)) / (c * h * w)


def precompute_target_motion_features(msoe_params, target_video: torch.Tensor,
                                      motion_img_size=(128, 128),
                                      hbm_budget_bytes: int = 4 * 2**30):
    """The MSOE features of every consecutive pair of a target video
    [T, 3, H, W] in [-1, 1], once: [T - 1, 320, h, w], no gradient. None
    when they would take more than ``hbm_budget_bytes`` of device memory (the
    size of a pair measured from the first one); callers then pass the
    window's frames instead."""
    n_pairs = int(target_video.shape[0]) - 1
    if n_pairs < 1:
        raise ValueError("precompute_target_motion_features needs >= 2 target frames "
                         f"(got {target_video.shape[0]}); motion features are per pair")
    with torch.no_grad():
        first, _ = motion_feature(msoe_params, target_video[0:1], target_video[1:2],
                                  motion_img_size)
        if n_pairs * first[0].numel() * first.element_size() > hbm_budget_bytes:
            return None
        feats = [first[0]]
        for t in range(1, n_pairs):
            f, _ = motion_feature(msoe_params, target_video[t:t + 1],
                                  target_video[t + 1:t + 2], motion_img_size)
            feats.append(f[0])
    return torch.stack(feats)


def video_motion_loss(
    msoe_params,
    generated_frames: Sequence[torch.Tensor],
    target_frames: Optional[Sequence[torch.Tensor]],
    loss_type: str = "MotionOT",
    generator: Optional[torch.Generator] = None,
    motion_img_size=(128, 128),
    subsample: int = 1000,
    proj_n: int = 32,
    target_features=None,
    projections: Optional[Sequence[torch.Tensor]] = None,
):
    """Sum over consecutive frame pairs of the motion metric
    (video_motion.py:82). ``generated_frames`` / ``target_frames``: lists
    of RGB batches [B, 3, H, W] in [-1, 1], at least two; or
    ``target_features``, one [320, h, w] (or [B, 320, h, w]) a pair from
    ``precompute_target_motion_features``. All generated pairs go through
    one MSOE forward, stacked on the batch. ``projections`` (MotionSlW, a
    [320, proj_n] tensor a pair) replaces the draws, for tests. Returns
    (loss, (last generated flow, last target flow or None))."""
    if len(generated_frames) < 2:
        raise ValueError("the video-motion loss needs at least two generated frames")
    if target_features is None and target_frames is None:
        raise ValueError("video_motion_loss needs target_frames or target_features")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_pairs = len(generated_frames) - 1
    bsz = generated_frames[0].shape[0]
    flow_all, feats_all = msoe_forward(
        msoe_params, motion_pairs_from_frames(generated_frames, motion_img_size),
        return_features=True)
    fg_list = [feats_all[0][i * bsz:(i + 1) * bsz] for i in range(n_pairs)]
    flow_g = flow_all[(n_pairs - 1) * bsz:]

    flow_t = None
    if target_features is not None:
        ft_list = [target_features[i].reshape((-1,) + tuple(target_features[i].shape[-3:]))
                   .detach() for i in range(n_pairs)]
    else:
        tb = target_frames[0].shape[0]
        with torch.no_grad():
            tflow, tfeats = msoe_forward(
                msoe_params, motion_pairs_from_frames(target_frames, motion_img_size),
                return_features=True)
        ft_list = [tfeats[0][i * tb:(i + 1) * tb] for i in range(n_pairs)]
        flow_t = tflow[(n_pairs - 1) * tb:]

    loss = 0.0
    for i in range(n_pairs):
        fg, ft = fg_list[i], ft_list[i]
        if loss_type == "MotionGram":
            loss = loss + torch.mean((_motion_gram(ft) - _motion_gram(fg)) ** 2)
        elif loss_type == "MotionSlW":
            gf, tf_ = _flatten(fg), _flatten(ft)
            if projections is not None:
                projs = projections[i].to(gf.device, gf.dtype)
            else:
                projs = torch.randn((gf.shape[-1], proj_n), generator=generator).to(gf.device)
            projs = projs / torch.linalg.vector_norm(projs, dim=0, keepdim=True)
            sp = _project_sort(gf, projs)
            tp = resize_nearest_1d(_project_sort(tf_, projs), sp.shape[-1])
            loss = loss + torch.sum((sp - tp) ** 2)
        elif loss_type == "MotionOT":
            b, _, h, w = fg.shape
            gf, tf_ = _flatten(fg), _flatten(ft)
            if h > 32 and h * w > subsample:
                idx = torch.randperm(h * w, generator=generator)[:subsample].to(gf.device)
                gf, tf_ = gf[:, idx], tf_[:, idx]
            if tf_.shape[0] != b:  # a batch-1 precomputed target
                tf_ = tf_.expand((b,) + tuple(tf_.shape[1:]))
            loss = loss + (_remd(tf_, gf) + _moment_loss(tf_, gf)).mean()
        else:
            raise ValueError(f"unknown video motion loss type {loss_type}")
    return loss, (flow_g, flow_t)
