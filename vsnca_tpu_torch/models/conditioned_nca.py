"""Goal-guided ConditionedNCA (the EncoderConditioning variant) as plain
functions on NCHW tensors and a flat params dict — the port's counterpart of
``vsnca_tpu/models/conditioned_nca.py``.

State channels are [target RGB | alive | hidden ...]: 3 + 1 + 16 = 20 at
the reference's defaults, ``alive_channel`` = num_target_channels. The
parameters are the JAX package's tree, flat:

- ``perception_w`` [C, 3, 3, 3] — the learnable depthwise 3x3 perception,
  3 filters a channel, percept rows in torch grouped-conv order c*3 + s;
- ``update1.w`` [3C, D], ``update1.b`` [D], ``update2.w`` [D, D],
  ``update2.b`` [D], ``update3.w`` [D, C] — the UpdateNet's 1x1 layers,
  input-major (the JAX [1, 1, in, out] kernels without the 1x1);
- ``encoder.embed1.w`` [E, 6, 3, 3], ``encoder.embed1.b`` [E],
  ``encoder.embed2.w`` [E, E, 3, 3] — the ImageEncoder, OIHW.

``conditioned_nca_grow`` is where the route is chosen: on a card the
training kernel pair (``ops.fused_cnca.fused_cnca_train``) when gradients are
needed and the rollout kernels (``fused_cnca_rollout``) when they are not; on
the CPU eager ``conditioned_nca_step``s under autograd, the counterpart of the
JAX package's scan. Every route draws the same hash masks for a seed
(``ops.fused_step.batch_mask``), so they compute the same values at any fire
rate; ``jax.random``'s masks cannot be reproduced, so the JAX package agrees
at fire rate 1 only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.models.encoder import image_encoder_apply, image_encoder_init
from vsnca_tpu_torch.ops.conv import alive_pool, depthwise_perceive, torch_conv_init
from vsnca_tpu_torch.ops.fused_cnca import fused_cnca_rollout, fused_cnca_train
from vsnca_tpu_torch.ops.fused_step import batch_mask

ROLLOUT_PATHS = ("auto", "fused", "xla")
REMAT_POLICIES = ("per_step", "none")

# torch grouped-conv order (c*3 + s), as the JAX package's _depthwise_perceive
_depthwise_perceive = depthwise_perceive


def conditioned_nca_init(generator: torch.Generator, cfg: ConditionedNCAConfig,
                         device=None) -> dict:
    """Parameters from torch's default conv init (the reference's), drawn on
    the CPU from ``generator``: perception_w uniform in ±1/3 (fan_in 9),
    UpdateNet weights uniform in ±1/sqrt(fan_in) with zero biases and no
    bias on the last layer, and the ImageEncoder's."""
    dev = resolve_device(device)
    c, d = cfg.num_channels, cfg.update_hidden_dim
    pw = (torch.rand((c, 3, 3, 3), generator=generator) * 2.0 - 1.0) / 3.0
    u1 = torch_conv_init(generator, 1, 1, c * 3, d, zero_bias=True)
    u2 = torch_conv_init(generator, 1, 1, d, d, zero_bias=True)
    u3 = torch_conv_init(generator, 1, 1, d, c, bias=False)
    enc = image_encoder_init(generator, cfg.num_hidden_channels, cfg.num_target_channels)
    params = {
        "perception_w": pw,
        "update1.w": u1["w"][:, :, 0, 0].T, "update1.b": u1["b"],
        "update2.w": u2["w"][:, :, 0, 0].T, "update2.b": u2["b"],
        "update3.w": u3["w"][:, :, 0, 0].T,
        **{f"encoder.{k}": v for k, v in enc.items()},
    }
    return {k: v.to(dev, torch.float32).contiguous() for k, v in params.items()}


def alive_mask(x: torch.Tensor, cfg: ConditionedNCAConfig) -> torch.Tensor:
    """maxpool3x3(alpha) > threshold, bool [B, 1, H, W] (all true without the
    living channel)."""
    if not cfg.use_living_channel:
        return torch.ones_like(x[:, :1], dtype=torch.bool)
    a = cfg.alive_channel
    return alive_pool(x[:, a : a + 1], cfg.alpha_living_threshold)


def encode_goal(params: dict, cfg: ConditionedNCAConfig, goal_img: torch.Tensor) -> torch.Tensor:
    """Goal image [B, 3, H, W] → goal encoding [B, C, H, W]: the encoder's
    embedding in the LAST num_hidden_channels channels, zeros before them."""
    enc = {k[len("encoder."):]: v for k, v in params.items() if k.startswith("encoder.")}
    emb = image_encoder_apply(enc, goal_img)
    return F.pad(emb, (0, 0, 0, 0, cfg.num_channels - cfg.num_hidden_channels, 0))


def conditioned_nca_step(params: dict, x: torch.Tensor, goal_encoding: torch.Tensor,
                         mask: torch.Tensor, cfg: ConditionedNCAConfig) -> torch.Tensor:
    """One step: alive gate → perceive(x + goal·pre) → UpdateNet → residual
    under ``mask`` (0/1, broadcast to [B, 1, H, W]; the caller draws it) →
    life gate (pre ∧ post) → clamp. Float32 products (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pre = alive_mask(x, cfg)
    percept = depthwise_perceive(x + goal_encoding * pre.to(x.dtype), params["perception_w"])
    h = torch.relu(torch.einsum("bkhw,kd->bdhw", percept, params["update1.w"])
                   + params["update1.b"][:, None, None])
    h = torch.relu(torch.einsum("bdhw,de->behw", h, params["update2.w"])
                   + params["update2.b"][:, None, None])
    out = torch.einsum("behw,ec->bchw", h, params["update3.w"])
    x = x + mask * out
    life = (pre & alive_mask(x, cfg)).to(x.dtype)
    return torch.clamp(x * life, -cfg.clamp_value, cfg.clamp_value)


def conditioned_nca_seed(cfg: ConditionedNCAConfig, n: int, size: Optional[int] = None,
                         device=None) -> torch.Tensor:
    """Zero states [n, C, S, S] with channels alive_channel.. set to 1 at the
    center pixel."""
    s = size or cfg.image_size
    seed = torch.zeros((n, cfg.num_channels, s, s), device=resolve_device(device))
    seed[:, cfg.alive_channel :, s // 2, s // 2] = 1.0
    return seed


def cnca_route(device_type: str, needs_grad: bool, rollout_path: str = "auto") -> str:
    """What a grow runs: 'pair' (``fused_cnca_train``), 'rollout'
    (``fused_cnca_rollout``) or 'eager' (``conditioned_nca_step``s).

    - 'xla': eager, on any device — the JAX package's scan;
    - 'auto': eager on the CPU (the JAX package scans off the TPU); on a
      card the kernels: the pair with a gradient, the rollout without;
    - 'fused': the kernels on any device (their plain versions on the CPU).
    """
    if rollout_path not in ROLLOUT_PATHS:
        raise ValueError(f"rollout_path must be one of {ROLLOUT_PATHS}")
    if rollout_path == "xla" or (rollout_path == "auto" and device_type != "cuda"):
        return "eager"
    return "pair" if needs_grad else "rollout"


def grow_from_encoding(params: dict, x: torch.Tensor, goal_encoding: torch.Tensor,
                       seed: int, cfg: ConditionedNCAConfig, num_steps: int,
                       remat: str = "per_step", rollout_path: str = "auto") -> torch.Tensor:
    """``num_steps`` steps from state x [B, C, H, W] with a goal encoding,
    through the route ``cnca_route`` picks; differentiable w.r.t. params, x
    and the encoding. Eager steps map ``remat`` onto torch.utils.checkpoint:
    'per_step' recomputes each step in the backward, 'none' keeps every
    step's activations."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, goal_encoding, *params.values()))
    route = cnca_route(x.device.type, needs_grad, rollout_path)
    if route == "pair":
        return fused_cnca_train(params, x, goal_encoding, seed, cfg, num_steps)
    if route == "rollout":
        return fused_cnca_rollout(params, x, goal_encoding, seed, cfg, num_steps)

    def step_fn(x, step):
        mask = batch_mask(seed, step, x.shape, cfg.cell_fire_rate, x.device)
        return conditioned_nca_step(params, x, goal_encoding, mask, cfg)

    for step in range(num_steps):
        if remat == "per_step" and needs_grad:
            x = checkpoint(step_fn, x, step, use_reentrant=False)
        else:
            x = step_fn(x, step)
    return x


def conditioned_nca_grow(params: dict, x: torch.Tensor, goal_img: torch.Tensor, seed: int,
                         cfg: ConditionedNCAConfig, num_steps: int, remat: str = "per_step",
                         rollout_path: str = "auto") -> torch.Tensor:
    """Encode the goal image [B, 3, H, W] once, then grow ``num_steps``
    (``grow_from_encoding``); ``seed`` keys the fire masks."""
    return grow_from_encoding(params, x, encode_goal(params, cfg, goal_img), seed, cfg,
                              num_steps, remat, rollout_path)
