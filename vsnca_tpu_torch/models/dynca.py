"""DyNCA cell as plain functions on NCHW tensors and a params dict.

Counterpart of ``vsnca_tpu/models/dynca.py``: perception →
concat(conditioning) → relu MLP → masked residual update, and the
differentiable rollout. Parameters keep the JAX layout, input-major
``w1: [P, F]``, ``b1: [F]``, ``w2: [F, C]``, ``b2: [C]``, with the percept
rows in block order [C raw | C sobel_x | C sobel_y | C lap | cond]. Frame
taps and tap schedules (video motion) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.ops.cpe import cartesian_positional_encoding
from vsnca_tpu_torch.ops.fused_step import batch_mask, fused_rollout_chw
from vsnca_tpu_torch.ops.fused_train import (
    C_MAX,
    CC_MAX,
    F_MAX,
    fused_rollout_train,
    fused_train_supported,
)
from vsnca_tpu_torch.ops.perception import edge_extract, perceive_multiscale


def _xavier_normal(generator, shape, gain: float) -> torch.Tensor:
    std = gain * math.sqrt(2.0 / (shape[0] + shape[1]))
    return std * torch.randn(shape, generator=generator)


def dynca_init(generator: torch.Generator, cfg: NCAConfig, device=None) -> dict:
    """Initialize DyNCA parameters from a CPU ``torch.Generator`` (drawn on
    the CPU, so a seed gives the same weights on every device): w1
    Xavier-normal gain 0.2 with a uniform bias in ±1/sqrt(P), w2
    Xavier-normal gain 0.1 with a zero bias."""
    dev = resolve_device(device)
    p = cfg.perception_dim
    bound = 1.0 / math.sqrt(p)
    params = {
        "w1": _xavier_normal(generator, (p, cfg.fc_dim), 0.2),
        "b1": (torch.rand(cfg.fc_dim, generator=generator) * 2.0 - 1.0) * bound,
        "w2": _xavier_normal(generator, (cfg.fc_dim, cfg.c_in), 0.1),
        "b2": torch.zeros(cfg.c_in),
    }
    return {k: v.to(dev, torch.float32) for k, v in params.items()}


def make_conditioning(
    cfg: NCAConfig,
    shape_hw: Tuple[int, int],
    cond_img: Optional[torch.Tensor] = None,
    batch: int = 1,
    device=None,
) -> Optional[torch.Tensor]:
    """The per-rollout conditioning tensor [B, c_cond, H, W], or None.

    - 'pos_emb': the CPE grid, repeated over the batch.
    - 'edges': edge map of ``cond_img``, grayscale [B, 1, H, W]; it runs on
      ``cond_img``'s device and carries no gradient.
    """
    if cfg.conditioning == "pos_emb":
        dev = cond_img.device if cond_img is not None else resolve_device(device)
        cpe = cartesian_positional_encoding(*shape_hw, device=dev)
        return cpe[None].repeat(batch, 1, 1, 1)
    if cfg.conditioning == "edges":
        if cond_img is None:
            raise ValueError("edges conditioning requires cond_img")
        with torch.no_grad():
            return edge_extract(cond_img, cfg.edge_transform)
    return None


def dynca_step(
    params: dict,
    x: torch.Tensor,
    mask: torch.Tensor,
    cfg: NCAConfig,
    cond: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One NCA step: x [B, C, H, W] → x + dx * mask, with ``mask`` a 0/1
    tensor that broadcasts to [B, 1, H, W] (the caller draws it; see
    ``ops.fused_step.update_mask``). The MLP runs in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    y = perceive_multiscale(x, cfg.perception_scales, cfg.padding_mode)
    if cond is not None:
        y = torch.cat([y, cond], dim=1)
    h = torch.relu(
        torch.einsum("bphw,pf->bfhw", y, params["w1"]) + params["b1"][:, None, None]
    )
    dx = torch.einsum("bfhw,fc->bchw", h, params["w2"]) + params["b2"][:, None, None]
    return x + dx * mask


def to_rgb(x: torch.Tensor, c_out: int = 3) -> torch.Tensor:
    """RGB readout: the first ``c_out`` channels times 2."""
    return x[:, :c_out] * 2.0


def dynca_seed(
    cfg: NCAConfig,
    n: int,
    size,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Seed states [n, seed_channels, H, W]. 'random' draws one
    uniform(-0.5, 0.5) state from ``generator`` and repeats it over the
    batch, as the reference does."""
    dev = resolve_device(device)
    h, w = (size, size) if isinstance(size, int) else size
    c = cfg.n_seed_channels
    if cfg.seed_mode == "zeros":
        return torch.zeros((n, c, h, w), device=dev)
    if cfg.seed_mode == "center_on":
        sd = torch.zeros((n, c, h, w), device=dev)
        sd[:, :, h // 2, w // 2] = 1.0
        return sd
    if cfg.seed_mode == "random":
        if generator is None:
            raise ValueError("random seed mode requires a generator")
        one = torch.rand((1, c, h, w), generator=generator) - 0.5
        return one.to(dev).repeat(n, 1, 1, 1)
    raise ValueError(f"unknown seed_mode {cfg.seed_mode}")


ROLLOUT_PATHS = ("auto", "fused", "xla")


def rollout_route(cfg: NCAConfig, n_steps: int, device_type: str, needs_grad: bool,
                  rollout_path: str = "auto") -> str:
    """What ``dynca_rollout`` runs: 'pair' (the training kernel pair,
    ``ops.fused_train.fused_rollout_train``), 'step' (the rollout kernel,
    ``ops.fused_step.fused_rollout_chw``) or 'eager' (``dynca_step``s under
    autograd, the counterpart of the JAX package's scan).

    - 'xla': eager, on any device.
    - 'fused': the pair, on any device (its plain version for a CPU
      tensor); it raises where it does not apply, as the JAX trainer's
      assert does.
    - 'auto': eager on the CPU, as the JAX package scans off the TPU. On a
      CUDA tensor, the kernels wherever the JAX package runs Pallas
      kernels: without a gradient the rollout kernel (perception_scales
      (0,)); with one the pair where ``fused_train_supported``. A config
      that the JAX trainer trains through a Pallas pair the port lacks —
      circular multiscale (PERF.md rows 8 and 10, ROADMAP B1), or past the
      kernels' size limits — raises NotImplementedError rather than run
      plain steps on the card. The JAX CHW pair (rows 5, 6) takes nothing
      the port's pair does not: its scope is circular, scales (0,), under
      TPU layout rules. Every other config (other paddings and scales)
      runs eager, as the JAX trainer's scan does.
    """
    if rollout_path not in ROLLOUT_PATHS:
        raise ValueError(f"rollout_path must be one of {ROLLOUT_PATHS}")
    if rollout_path == "xla" or (rollout_path == "auto" and device_type != "cuda"):
        return "eager"
    if rollout_path == "fused":
        return "pair"
    scales = tuple(cfg.perception_scales)
    if not needs_grad:
        return "step" if scales == (0,) else "eager"
    if fused_train_supported(cfg, n_steps):
        return "pair"
    if n_steps >= 1 and cfg.padding_mode == "circular" and scales in ((0,), (0, 1)):
        raise NotImplementedError(
            f"the JAX trainer trains c_in {cfg.c_in}, c_cond {cfg.c_cond}, fc_dim "
            f"{cfg.fc_dim}, perception_scales {scales} through a Pallas pair that the "
            "port has not ported: multiscale is ROADMAP B1 (PERF.md rows 8 and 10); "
            f"the kernels take C <= {C_MAX}, c_cond <= {CC_MAX}, fc_dim <= {F_MAX}"
        )
    return "eager"


def dynca_rollout(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    remat: str = "none",
    rollout_path: str = "auto",
):
    """Roll the NCA ``n_steps`` and return (state, rgb), differentiable
    w.r.t. ``params``, ``x`` and ``cond``, through the route
    ``rollout_route`` picks. The eager steps map ``remat`` onto
    ``torch.utils.checkpoint`` as ``_scan_rollout`` (dynca.py:148) does:
    'none' keeps every step's activations, 'per_step' recomputes each step
    in the backward, 'segment:K' checkpoints blocks of K steps (per step
    when K does not divide ``n_steps``). The masks are the kernels' hash
    masks for ``seed``, so every route computes the same values at any
    rate.
    """
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, cond, *params.values()))
    route = rollout_route(cfg, n_steps, x.device.type, needs_grad, rollout_path)
    if route == "eager":
        return _rollout_eager(params, x, seed, cfg, n_steps, cond, update_rate, remat)
    if route == "step":
        x = fused_rollout_chw(params, x, seed, cfg, n_steps, cond, update_rate)
    else:
        x = fused_rollout_train(params, x, seed, cfg, n_steps, cond, update_rate)
    return x, to_rgb(x, cfg.c_out)


def _rollout_eager(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    remat: str = "none",
):
    """The 'eager' route of ``dynca_rollout``: ``dynca_step``s under
    autograd, on any device and config."""
    rate = cfg.update_rate if update_rate is None else update_rate

    def step_fn(x, step):
        return dynca_step(params, x, batch_mask(seed, step, x.shape, rate, x.device),
                          cfg, cond)

    block = 0
    if remat == "per_step":
        block = 1
    elif remat.startswith("segment:"):
        block = int(remat.split(":", 1)[1])
        block = block if n_steps % block == 0 else 1
    elif remat != "none":
        raise ValueError(f"unknown remat policy {remat!r}")

    def run(x, start, stop):
        for step in range(start, stop):
            x = step_fn(x, step)
        return x

    if block == 0 or not torch.is_grad_enabled():
        x = run(x, 0, n_steps)
    else:
        for start in range(0, n_steps, block):
            x = checkpoint(run, x, start, start + block, use_reentrant=False)
    return x, to_rgb(x, cfg.c_out)
