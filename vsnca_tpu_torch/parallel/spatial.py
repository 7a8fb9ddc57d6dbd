"""Spatially sharded NCA rollout — the counterpart of
``vsnca_tpu/parallel/spatial.py::spatial_rollout`` (:107), with
``_perceive_h_padded`` (:74) and ``_up2x_global_clamp`` (:40).

Each rank of the ``space`` group holds an H/n-row slab of the grid. Every
step it swaps its edge rows with its two neighbours on a ring
(``batch_isend_irecv``): one row a side for the 3x3 stencil, six for
perception scales (0, 1), whose full-resolution reach that is (even, so the
slab's 2x2 downsample cells stay on the grid's even rows). 'circular'
padding is the ring itself; 'replicate' and 'zeros' overwrite the outer
halo of the first and last rank (:170-177). Multiscale needs circular
padding and an even slab (:131-149): the percept of the haloed slab is taken
as if it were a whole grid, and its slab-local wrap stays in the halo that
is cropped, except the 2x upsample's clamp at the grid's top and bottom,
which the upsampling matrix takes from the whole grid's rows.

In JAX this is plain XLA, not a Pallas kernel, so it runs plain PyTorch ops
here, on any device. Each op is the dense rollout's on fewer rows, and the
update mask is keyed by the global pixel index ``(row0 + r) * W + c``
(``ops.fused_step.mask_bits``), so the sharded rollout gives the dense
eager rollout's bits at any update rate (JAX's ``fold_in(sub, idx)`` only
decorrelates the shards). Under gloo a CUDA halo crosses through host
memory; under NCCL it is sent from the card. Inference only: the halo
exchange carries no gradient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.models.dynca import dynca_update, to_rgb
from vsnca_tpu_torch.ops.fused_step import batch_mask
from vsnca_tpu_torch.ops.padding import _PAD_MODES
from vsnca_tpu_torch.ops.perception import perceive, perceive_padded
from vsnca_tpu_torch.ops.resize import _bilinear_matrix, resize_bilinear
from vsnca_tpu_torch.parallel.mesh import Mesh, _is_gloo

def halo_rows(cfg: NCAConfig) -> int:
    """Rows a side each rank receives a step: 1, or 6 for scales (0, 1)."""
    return 6 if tuple(cfg.perception_scales) == (0, 1) else 1


def exchange_halos(x: torch.Tensor, hb: int, mesh: Mesh, axis: str = "space"):
    """(rows above, rows below) of this rank's slab ``x`` [B, C, Hl, W]: the
    previous rank's last ``hb`` rows and the next rank's first, on a ring."""
    group, n, r = mesh.group(axis), mesh.size(axis), mesh.index(axis)
    if n == 1:
        return x[:, :, -hb:], x[:, :, :hb]
    prev = dist.get_global_rank(group, (r - 1) % n)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    bot, top = x[:, :, -hb:].contiguous(), x[:, :, :hb].contiguous()
    staged = x.is_cuda and _is_gloo(group)
    if staged:
        bot, top = bot.cpu(), top.cpu()
    above, below = torch.empty_like(bot), torch.empty_like(top)
    ops = [dist.P2POp(dist.isend, bot, nxt, group, 0),
           dist.P2POp(dist.irecv, above, prev, group, 0),
           dist.P2POp(dist.isend, top, prev, group, 1),
           dist.P2POp(dist.irecv, below, nxt, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        above, below = above.to(x.device), below.to(x.device)
    return above, below


def _up_rows(h: int, row0: int, rows: int, q0: int, m: int, device) -> torch.Tensor:
    """Rows ``row0 ..`` of the whole grid's 2x upsampling matrix [H, H/2],
    on the columns of the slab's half rows ``q0 .. q0 + m`` (zero where
    those lie outside the grid): the clamp at the grid's edges included."""
    a = _bilinear_matrix(h, h // 2)[row0:row0 + rows]
    cols = np.arange(m) + q0
    inside = (cols >= 0) & (cols < h // 2)
    out = np.zeros((rows, m), np.float32)
    out[:, inside] = a[:, cols[inside]]
    return torch.from_numpy(out).to(device)


def spatial_rollout(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    mesh: Mesh,
    axis: str = "space",
    cond: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    first_step: int = 0,
):
    """Roll ``n_steps`` with the grid's rows sharded over ``axis``: ``x``
    [B, C, H/n, W] is this rank's slab (rows ``index * H/n ..``), ``cond``
    [B, c_cond, H/n, W] the same rows of the conditioning or None. Returns
    the slab's (state, rgb). The masks are the dense rollout's for ``seed``
    (step i draws absolute step ``first_step + i``)."""
    scales = tuple(cfg.perception_scales)
    if scales not in ((0,), (0, 1)):
        raise ValueError("spatial sharding supports perception_scales (0,) or (0, 1)")
    ms = scales == (0, 1)
    if ms and cfg.padding_mode != "circular":
        raise ValueError("multi-scale spatial sharding requires circular padding "
                         "(replicate/zeros would need half-res edge semantics)")
    n, r = mesh.size(axis), mesh.index(axis)
    hb = halo_rows(cfg)
    hl, w = x.shape[2], x.shape[3]
    h = hl * n
    if ms and (hl % 2 or hl < hb):
        raise ValueError(f"multi-scale sharding needs an even slab of at least {hb} rows, "
                         f"got {hl}")
    if ms and w % 2:
        raise ValueError("multi-scale perception needs an even width")
    rate = cfg.update_rate if update_rate is None else update_rate
    row0 = r * hl
    if ms:
        hs = hl + 2 * hb
        up_h = _up_rows(h, row0, hl, (row0 - hb) // 2, hs // 2, x.device).to(x.dtype)
        up_w = torch.from_numpy(_bilinear_matrix(w, w // 2)).to(x.device, x.dtype)
    with torch.no_grad():
        for step in range(first_step, first_step + n_steps):
            above, below = exchange_halos(x, hb, mesh, axis)
            if cfg.padding_mode == "replicate":
                above = x[:, :, :hb] if r == 0 else above
                below = x[:, :, -hb:] if r == n - 1 else below
            elif cfg.padding_mode == "zeros":
                above = torch.zeros_like(above) if r == 0 else above
                below = torch.zeros_like(below) if r == n - 1 else below
            xp = torch.cat([above, x, below], dim=2)
            if ms:
                y0 = perceive(xp, "circular")[:, :, hb:hb + hl]
                ps = perceive(resize_bilinear(xp, (hs // 2, w // 2)), "circular")
                y = (y0 + torch.einsum("iu,bcuv,jv->bcij", up_h, ps, up_w)) / 2.0
            else:
                y = perceive_padded(F.pad(xp, (1, 1, 0, 0), mode=_PAD_MODES[cfg.padding_mode]))
            x = dynca_update(params, x, y, batch_mask(seed, step, x.shape, rate, x.device,
                                                      row0), cond)
    return x, to_rgb(x, cfg.c_out)


def halo_bytes(x: torch.Tensor, cfg: NCAConfig) -> int:
    """Bytes a rank receives from each neighbour a step."""
    b, c, _, w = x.shape
    return b * c * halo_rows(cfg) * w * x.element_size()
