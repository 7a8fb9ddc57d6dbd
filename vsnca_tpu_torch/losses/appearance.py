"""Appearance (style) losses on VGG16 features — the port's copy of
``vsnca_tpu/losses/appearance.py`` on NCHW feature maps: Gram, sliced
Wasserstein and relaxed optimal transport (REMD + moments).

Randomness (the SlW projections, the OT pixel subsample) comes from a
``torch.Generator``, drawn on the CPU, where the JAX package splits a
``jax.random`` key: the same distribution, not the same numbers. The
metrics' helpers take pixels as rows ([B, N, C], N = H*W in row-major order,
the JAX package's ``_flatten``). ``appearance_loss`` is the DyNCA
orchestrator's dispatcher ("Gram", "SlW", "OT"); the encoder trainer calls
the metrics directly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vsnca_tpu_torch.models.vgg import vgg16_style_features
from vsnca_tpu_torch.ops.resize import resize_bilinear, resize_nearest_1d


def _flatten(f: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, N, C], pixels as rows."""
    b, c, h, w = f.shape
    return f.reshape(b, c, h * w).transpose(1, 2)


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


def _project_sort(x_bnc: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """[B, N, C] x [C, P] → sorted [B, P, N]."""
    return torch.sort(torch.einsum("bnc,cp->bpn", x_bnc, projs), dim=-1).values


def sliced_wasserstein_loss(gen_feats: Sequence[torch.Tensor],
                            tgt_feats: Sequence[torch.Tensor],
                            generator: Optional[torch.Generator] = None, proj_n: int = 32,
                            projections: Optional[Sequence[torch.Tensor]] = None
                            ) -> torch.Tensor:
    """Sum over layers of the sliced-OT loss: ``proj_n`` random projections
    a layer (normal, drawn from ``generator``, or the given ``projections``
    [C, proj_n] a layer), each L2-normalized; the target's sorted
    projections, gradient-stopped, nearest-resampled to the generated
    length."""
    torch.backends.cuda.matmul.allow_tf32 = False
    loss = 0.0
    for i, (g, t) in enumerate(zip(gen_feats, tgt_feats)):
        gf, tf_ = _flatten(g), _flatten(t)
        if projections is not None:
            projs = projections[i].to(gf.device, gf.dtype)
        else:
            projs = torch.randn((gf.shape[-1], proj_n), generator=generator).to(gf.device)
        projs = projs / torch.linalg.vector_norm(projs, dim=0, keepdim=True)
        sp = _project_sort(gf, projs)
        tp = resize_nearest_1d(_project_sort(tf_, projs).detach(), sp.shape[-1])
        loss = loss + torch.sum((sp - tp) ** 2)
    return loss


def _pairwise_cos_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, C] x [..., M, C] → [..., N, M] cosine distance with the
    reference's additive epsilon."""
    xn = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y**2, dim=-1, keepdim=True))
    return 1.0 - (x @ y.transpose(-1, -2)) / (xn + 1e-10) / (yn.transpose(-1, -2) + 1e-10)


def _remd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Relaxed earth-mover distance of each batch item, [...]."""
    d = _pairwise_cos_dist(x, y)
    return torch.maximum(d.min(dim=-1).values.mean(dim=-1), d.min(dim=-2).values.mean(dim=-1))


def _moment_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean + covariance matching of each batch item, unbiased covariance."""
    mu_x, mu_y = x.mean(dim=-2, keepdim=True), y.mean(dim=-2, keepdim=True)
    xc, yc = x - mu_x, y - mu_y
    cov_x = (xc.transpose(-1, -2) @ xc) / (x.shape[-2] - 1)
    cov_y = (yc.transpose(-1, -2) @ yc) / (y.shape[-2] - 1)
    return (torch.abs(mu_x - mu_y).mean(dim=(-2, -1))
            + torch.abs(cov_x - cov_y).mean(dim=(-2, -1)))


def ot_style_loss(gen_feats: Sequence[torch.Tensor], tgt_feats: Sequence[torch.Tensor],
                  generator: Optional[torch.Generator] = None, subsample: int = 1000,
                  subsample_threshold: int = 32) -> torch.Tensor:
    """Relaxed EMD + moment loss, summed over layers, averaged over the
    batch (each item's metrics as batched products, one set of launches a
    layer). A layer taller than ``subsample_threshold`` with more than
    ``subsample`` pixels is cut to ``subsample`` pixels drawn without
    replacement from ``generator`` (the same pixels for generated and
    target). The target features are not gradient-stopped here, as in the
    reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    loss = 0.0
    for g, t in zip(gen_feats, tgt_feats):
        h, w = g.shape[-2:]
        gf, tf_ = _flatten(g), _flatten(t)
        if h > subsample_threshold and h * w > subsample:
            idx = torch.randperm(h * w, generator=generator)[:subsample].to(gf.device)
            gf, tf_ = gf[:, idx], tf_[:, idx]
        loss = loss + (_remd(tf_, gf) + _moment_loss(tf_, gf)).mean()
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
    generator: Optional[torch.Generator] = None,
    subsample: int = 1000,
    proj_n: int = 32,
) -> torch.Tensor:
    """Appearance loss between NCHW RGB batches in [-1, 1]: rescale to
    [0, 1], resize the target to the generated size, VGG features (with the
    image itself as a feature for "SlW"), the metric ("Gram", "SlW" or
    "OT", whose draws come from ``generator``). ``target_features`` (from
    ``precompute_target_style_features``) skips the target's forward."""
    if loss_type not in ("Gram", "SlW", "OT"):
        raise ValueError(f"unknown appearance loss type {loss_type!r}")
    gen_f = vgg16_style_features(vgg_params, (generated + 1.0) / 2.0,
                                 include_image_as_feat=(loss_type == "SlW"))
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
    if loss_type == "Gram":
        return gram_loss(gen_f, tgt_f)
    if loss_type == "SlW":
        return sliced_wasserstein_loss(gen_f, tgt_f, generator, proj_n)
    return ot_style_loss(gen_f, tgt_f, generator, subsample)
