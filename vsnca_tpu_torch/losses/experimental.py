"""Experimental losses — the port's copy of
``vsnca_tpu/losses/experimental.py``.

``distill_style_loss`` is the reference's unreferenced ``StyleLoss``
(EncoderConditioning/utils/loss.py:17-64): the relaxed-OT objective in
log10 space. No preset uses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from vsnca_tpu_torch.losses.appearance import _flatten, _moment_loss, _remd
from vsnca_tpu_torch.models.vgg import vgg16_style_features


def distill_style_loss(
    vgg_params,
    generated: torch.Tensor,
    target: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    subsample: int = 1000,
) -> torch.Tensor:
    """log10 of (REMD + moment matching) summed over the style taps, each
    averaged over the batch. generated/target: NCHW RGB in [0, 1]. A tap
    with more than ``subsample`` pixels is cut to ``subsample`` pixels drawn
    without replacement from ``generator`` (the same for both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen_f = vgg16_style_features(vgg_params, generated)
    with torch.no_grad():
        tgt_f = vgg16_style_features(vgg_params, target)
    loss = 0.0
    for g, t in zip(gen_f, tgt_f):
        n = g.shape[-2] * g.shape[-1]
        gf, tf_ = _flatten(g), _flatten(t)
        if n > subsample:
            idx = torch.randperm(n, generator=generator)[:subsample].to(gf.device)
            gf, tf_ = gf[:, idx], tf_[:, idx]
        loss = loss + torch.mean(_remd(tf_, gf) + _moment_loss(tf_, gf))
    return torch.log10(loss + 1e-12)
