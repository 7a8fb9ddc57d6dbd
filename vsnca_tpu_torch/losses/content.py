"""VGG content loss — the port's copy of ``vsnca_tpu/losses/content.py``:
MSE on the conv4_2 features (content_loss.py:11-45)."""

from __future__ import annotations

import torch

from vsnca_tpu_torch.models.vgg import vgg16_content_features


def content_loss(vgg_params, generated: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """generated/target: NCHW RGB in [0, 1] (callers rescale from [-1, 1]);
    the target's features carry no gradient."""
    gen_f = vgg16_content_features(vgg_params, generated)
    with torch.no_grad():
        tgt_f = vgg16_content_features(vgg_params, target)
    return torch.mean((gen_f - tgt_f) ** 2)
