"""Auxiliary (content-conditioning) loss — the port's copy of
``vsnca_tpu/losses/auxiliary.py``: the generated frames against the
content image with a selectable metric (auxillary_loss.py:11-95)."""

from __future__ import annotations

from typing import Optional

import torch

from vsnca_tpu_torch.losses.appearance import appearance_loss
from vsnca_tpu_torch.losses.content import content_loss
from vsnca_tpu_torch.ops.resize import resize_bilinear


def auxiliary_loss(
    vgg_params,
    generated: torch.Tensor,
    aux_target: torch.Tensor,
    loss_type: str = "VGG",
    generator: Optional[torch.Generator] = None,
    subsample: int = 1000,
    proj_n: int = 32,
) -> torch.Tensor:
    """generated/aux_target: NCHW RGB in [-1, 1].

    Metrics: 'MSE' (pixels after the [0, 1] rescale), 'VGG' (the content
    loss), 'OT' / 'SlW' / 'Gram' (the style metrics against the content
    image, their draws from ``generator``). For 'MSE' and 'VGG' the target
    is resized to the generated size.
    """
    if loss_type in ("OT", "SlW", "Gram"):
        return appearance_loss(vgg_params, generated, aux_target, loss_type,
                               generator=generator, subsample=subsample, proj_n=proj_n)
    gen = (generated + 1.0) / 2.0
    tgt = (aux_target + 1.0) / 2.0
    if gen.shape[-2:] != tgt.shape[-2:]:
        tgt = resize_bilinear(tgt, tuple(gen.shape[-2:]))
    if loss_type == "MSE":
        return torch.mean((gen - tgt.detach()) ** 2)
    if loss_type == "VGG":
        return content_loss(vgg_params, gen, tgt)
    raise ValueError(f"unknown auxiliary loss type {loss_type}")
