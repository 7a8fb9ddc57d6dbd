"""Appearance (style) loss on VGG16 features — the port's copy of the Gram
part of ``vsnca_tpu/losses/appearance.py``, on NCHW feature maps.

The sliced-Wasserstein and relaxed-OT metrics are not ported yet (ROADMAP.md
queue A5): asking for them raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vsnca_tpu_torch.models.vgg import vgg16_style_features
from vsnca_tpu_torch.ops.resize import resize_bilinear


def gram_matrix(f: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, C, C] Gram matrix / (H*W)."""
    b, c, h, w = f.shape
    x = f.reshape(b, c, h * w)
    return torch.bmm(x, x.transpose(1, 2)) / (h * w)


def gram_loss(gen_feats: Sequence[torch.Tensor],
              tgt_feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over layers of the MSE between Gram matrices; the target's carry
    no gradient."""
    loss = 0.0
    for g, t in zip(gen_feats, tgt_feats):
        loss = loss + torch.mean((gram_matrix(t).detach() - gram_matrix(g)) ** 2)
    return loss


def precompute_target_style_features(vgg_params, target: torch.Tensor,
                                     loss_type: str, size_hw=None) -> List[torch.Tensor]:
    """The target's VGG features, once, for a style image that is constant
    across iterations (``target`` NCHW in [-1, 1], resized to ``size_hw``
    when given)."""
    tgt = (target + 1.0) / 2.0
    if size_hw is not None and tuple(tgt.shape[-2:]) != tuple(size_hw):
        tgt = resize_bilinear(tgt, tuple(size_hw))
    with torch.no_grad():
        feats = vgg16_style_features(vgg_params, tgt,
                                     include_image_as_feat=(loss_type == "SlW"))
    return [t.detach() for t in feats]


def appearance_loss(
    vgg_params,
    generated: torch.Tensor,
    target: torch.Tensor,
    loss_type: str,
    target_features: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Appearance loss between NCHW RGB batches in [-1, 1]: rescale to
    [0, 1], resize the target to the generated size, VGG features, the
    metric. ``target_features`` (from ``precompute_target_style_features``)
    skips the target's forward."""
    if loss_type != "Gram":
        raise NotImplementedError(
            f"appearance loss {loss_type!r} is not ported yet (ROADMAP.md A5); "
            "the port has 'Gram'"
        )
    gen_f = vgg16_style_features(vgg_params, (generated + 1.0) / 2.0)
    if target_features is not None:
        tgt_f = [t.detach() for t in target_features]
    else:
        tgt_f = precompute_target_style_features(vgg_params, target, loss_type,
                                                 generated.shape[-2:])
    if tgt_f[0].shape[0] != gen_f[0].shape[0]:
        # a generated stack that is a multiple of the target batch: tile the
        # target features so every generated item meets the style batch
        rep, rem = divmod(gen_f[0].shape[0], tgt_f[0].shape[0])
        if rem:
            raise ValueError(f"generated batch {gen_f[0].shape[0]} is not a multiple "
                             f"of the target batch {tgt_f[0].shape[0]}")
        tgt_f = [t.repeat((rep,) + (1,) * (t.dim() - 1)) for t in tgt_f]
    return gram_loss(gen_f, tgt_f)
