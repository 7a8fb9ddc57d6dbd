"""Style-consistency loss — the port's copy of
``vsnca_tpu/losses/style_consistency.py`` (style_consistency_loss.py:15-37).

The reference computes it under ``torch.no_grad()``: it contributes no
gradient and serves as a measure of how well a freshly seeded NCA grows the
style in ``min_steps``. The port keeps that.
"""

from __future__ import annotations

from typing import Optional

import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning


def style_consistency_loss(
    params: dict,
    nca_cfg: NCAConfig,
    style_target: torch.Tensor,
    generator: torch.Generator,
    min_steps: int = 32,
    cond_img: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grow a fresh seed ``min_steps`` steps and take the MSE of its RGB
    against the style target [B, 3, H, W] in [-1, 1]. The seed ('random'
    mode) and the rollout's masks come from ``generator``; the extra
    channels of an ExtraChannels cell are filled with the grayscale of
    ``cond_img`` [B, 1, H, W] (zeros without it). The result has no
    gradient path."""
    b, _, h, w = style_target.shape
    dev = style_target.device
    with torch.no_grad():
        seed = dynca_seed(nca_cfg, b, (h, w), generator, dev)
        extra = nca_cfg.c_in - nca_cfg.n_seed_channels
        if extra > 0:
            if cond_img is not None:
                fill = cond_img.mean(dim=1, keepdim=True).repeat(1, extra, 1, 1)
            else:
                fill = seed.new_zeros((b, extra, h, w))
            seed = torch.cat([seed, fill], dim=1)
        cond = make_conditioning(nca_cfg, (h, w), cond_img=cond_img, batch=b, device=dev)
        mask_seed = int(torch.randint(0, 1 << 30, (), generator=generator))
        _, rgb = dynca_rollout(params, seed, mask_seed, nca_cfg, min_steps, cond)
        return torch.mean((rgb - style_target) ** 2)
