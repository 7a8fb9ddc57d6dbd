"""DyNCA cell as plain functions on NCHW tensors and a params dict.

Counterpart of ``vsnca_tpu/models/dynca.py``: perception →
concat(conditioning) → relu MLP → masked residual update, and the
differentiable rollout. Parameters keep the JAX layout, input-major
``w1: [P, F]``, ``b1: [F]``, ``w2: [F, C]``, ``b2: [C]``, with the percept
rows in block order [C raw | C sobel_x | C sobel_y | C lap | cond]. Frame
taps (video motion) come from ``dynca_rollout_with_taps``, ``tap_schedule``
and ``dynca_rollout_schedule``, on every route ``rollout_route`` picks.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.ops.cpe import cartesian_positional_encoding
from vsnca_tpu_torch.ops.fused_step import SCALES, batch_mask, fused_rollout_chw
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


def param_count(params: dict) -> int:
    """The number of parameters (dynca.py:58)."""
    return sum(int(p.numel()) for p in params.values())


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
    return dynca_update(params, x, perceive_multiscale(x, cfg.perception_scales,
                                                       cfg.padding_mode), mask, cond)


def dynca_update(params: dict, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step after perception: x + MLP([y | cond]) * mask, in full
    float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
    ``ops.fused_train.fused_rollout_train``), 'step' (the rollout kernels,
    ``ops.fused_step.fused_rollout_chw``) or 'eager' (``dynca_step``s under
    autograd, the counterpart of the JAX package's scan).

    - 'xla': eager, on any device.
    - 'fused': the pair, on any device (its plain version for a CPU
      tensor); it raises where it does not apply, as the JAX trainer's
      assert does.
    - 'auto': eager on the CPU, as the JAX package scans off the TPU. On a
      CUDA tensor, the kernels wherever the JAX package runs Pallas
      kernels: without a gradient the rollout kernels (perception_scales
      (0,) or (0, 1), any padding); with one the pair where
      ``fused_train_supported`` (circular padding, scales (0,) or (0, 1)).
      A circular config past the kernels' size limits, which the JAX
      trainer trains through a Pallas pair, raises NotImplementedError
      rather than run plain steps on the card. Every other config (other
      paddings under a gradient, other scales) runs eager, as the JAX
      trainer's scan does: the TPU's multiscale pair is circular only.

    The pair runs at segment 1 (every state kept). The JAX trainer reaches
    its segment-checkpointed CHW pair (trainer.py:292-305) only where the
    flat pair's VMEM plan fails; on the card the flat pair takes every
    config the CHW pair takes, so no route leads there. Whether the trainer
    should trade one recomputed forward for memory (``segment`` of
    ``fused_rollout_train``; PERF.md gives the trade-off) is a memory
    policy not taken here.
    """
    if rollout_path not in ROLLOUT_PATHS:
        raise ValueError(f"rollout_path must be one of {ROLLOUT_PATHS}")
    if rollout_path == "xla" or (rollout_path == "auto" and device_type != "cuda"):
        return "eager"
    if rollout_path == "fused":
        return "pair"
    scales = tuple(cfg.perception_scales)
    if not needs_grad:
        return "step" if scales in SCALES else "eager"
    if fused_train_supported(cfg, n_steps):
        return "pair"
    if n_steps >= 1 and cfg.padding_mode == "circular" and scales in SCALES:
        raise NotImplementedError(
            f"the JAX trainer trains c_in {cfg.c_in}, c_cond {cfg.c_cond}, fc_dim "
            f"{cfg.fc_dim} through a Pallas pair; the port's kernels take C <= {C_MAX}, "
            f"c_cond <= {CC_MAX}, fc_dim <= {F_MAX}"
        )
    return "eager"


def _needs_grad(params, x, cond) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, cond, *params.values()))


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
    first_step: int = 0,
):
    """Roll the NCA ``n_steps`` and return (state, rgb), differentiable
    w.r.t. ``params``, ``x`` and ``cond``, through the route
    ``rollout_route`` picks. The eager steps map ``remat`` onto
    ``torch.utils.checkpoint`` as ``_scan_rollout`` (dynca.py:148) does:
    'none' keeps every step's activations, 'per_step' recomputes each step
    in the backward, 'segment:K' checkpoints blocks of K steps (per step
    when K does not divide ``n_steps``). The masks are the kernels' hash
    masks for ``seed``, step ``i`` drawing the mask of absolute step
    ``first_step + i``, so every route computes the same values at any
    rate, and a rollout cut into chunks the same values as one call.
    """
    route = rollout_route(cfg, n_steps, x.device.type, _needs_grad(params, x, cond),
                          rollout_path)
    if route == "eager":
        x = _rollout_eager(params, x, seed, cfg, n_steps, cond, update_rate, remat,
                           first_step)
    elif route == "step":
        x = fused_rollout_chw(params, x, seed, cfg, n_steps, cond, update_rate,
                              first_step=first_step)
    else:
        x = fused_rollout_train(params, x, seed, cfg, n_steps, cond, update_rate,
                                first_step=first_step)
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
    first_step: int = 0,
) -> torch.Tensor:
    """The 'eager' route of ``dynca_rollout``: ``dynca_step``s under
    autograd, on any device and config; returns the state."""
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

    stop = first_step + n_steps
    if block == 0 or not torch.is_grad_enabled():
        return run(x, first_step, stop)
    for start in range(first_step, stop, block):
        x = checkpoint(run, x, start, start + block, use_reentrant=False)
    return x


def rollout_taps(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    chunks: Sequence[int],
    tail_steps: int = 0,
    cond: Optional[torch.Tensor] = None,
    remat: str = "none",
    rollout_path: str = "auto",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Roll ``chunks[i]`` steps and keep the state after each chunk, then
    ``tail_steps`` more: (final state, [tapped states]), sum(chunks) +
    tail_steps steps in all. Where ``rollout_route`` picks the training
    pair, ONE call with in-kernel taps (``fused_rollout_train``'s
    ``tap_steps``; a tap that is the final state is that state);
    otherwise one rollout call a chunk, each continuing the absolute step
    count, so every route draws the same masks."""
    bounds, acc = [], 0
    for c in chunks:
        acc += int(c)
        bounds.append(acc)
    total = acc + int(tail_steps)
    route = rollout_route(cfg, total, x.device.type, _needs_grad(params, x, cond),
                          rollout_path)
    interior = [t for t in bounds if t < total]
    if route == "pair" and interior:
        state, taps = fused_rollout_train(params, x, seed, cfg, total, cond,
                                          tap_steps=interior)
        return state, taps + [state] * (len(bounds) - len(interior))
    taps, start = [], 0
    for stop in bounds + [total]:
        if stop > start:
            x, _ = dynca_rollout(params, x, seed, cfg, stop - start, cond, remat=remat,
                                 rollout_path=rollout_path, first_step=start)
        start = stop
        taps.append(x)
    return x, taps[: len(bounds)]


def dynca_rollout_with_taps(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_segments: int,
    steps_per_segment: int,
    cond: Optional[torch.Tensor] = None,
    remat: str = "per_step",
    rollout_path: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rollout emitting an RGB frame every ``steps_per_segment`` steps
    (dynca.py:223): (state, frames [n_segments, B, c_out, H, W])."""
    state, taps = rollout_taps(params, x, seed, cfg, [steps_per_segment] * n_segments, 0,
                               cond, remat, rollout_path)
    return state, torch.stack([to_rgb(t, cfg.c_out) for t in taps])


def tap_schedule(step_n: int, tap_every: int = 64) -> Tuple[Tuple[int, ...], int]:
    """The reference's frame-tap schedule for a ``step_n``-step rollout
    (dynca.py:253; fit_video_motion.py:230-235): frames after steps 1,
    1 + tap_every, ... <= step_n, then a frameless tail to ``step_n``.
    Returns ``(frame_chunks, tail_steps)``."""
    if step_n < 1 or tap_every < 1:
        raise ValueError(f"tap_schedule needs step_n >= 1 and tap_every >= 1, got "
                         f"{step_n}, {tap_every}")
    frame_steps = list(range(1, step_n + 1, tap_every))
    chunks = [frame_steps[0]] + [b - a for a, b in zip(frame_steps, frame_steps[1:])]
    return tuple(chunks), step_n - frame_steps[-1]


def dynca_rollout_schedule(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    frame_chunks: Sequence[int],
    tail_steps: int = 0,
    cond: Optional[torch.Tensor] = None,
    remat: str = "per_step",
    rollout_path: str = "auto",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Rollout with an explicit tap schedule (dynca.py:276, see
    ``tap_schedule``): an RGB frame after each chunk, then ``tail_steps``
    more steps. Returns (state, [frames])."""
    state, taps = rollout_taps(params, x, seed, cfg, frame_chunks, tail_steps, cond, remat,
                               rollout_path)
    return state, [to_rgb(t, cfg.c_out) for t in taps]
