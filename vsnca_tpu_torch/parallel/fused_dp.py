"""Data-parallel training pair — the counterpart of
``vsnca_tpu/parallel/fused_dp.py::fused_rollout_train_flat_dp`` (:35).

Each rank of a ``data`` group runs the port's training pair
(``ops/fused_train.py::fused_rollout_train``: on a card the ``nca_step``
chain forward and the ``nca_bwd_mlp`` + ``nca_bwd_adjoint`` backward) on its
own batch shard, with the parameters replicated. JAX's shard_map transpose
inserts a ``psum`` of the replicated parameters' cotangents; here
``MeanGradOver`` does it, an ``autograd.Function`` that is the identity
forward and all-reduces the parameters' gradients in the backward. Each
rank's loss is a mean over its local batch, so the all-reduce takes the
MEAN of the ranks' gradients: the gradient of the global-batch mean. It runs
before the trainer's per-tensor normalization and Adam, and in one
collective over all parameters.

RNG: the masks hash ``seed + batch_index + step * _STEP_MUL``
(``ops/fused_step.py::mask_bits``), so ``rank_seed`` adds ``rank *
local_batch`` to the seed and each rank draws exactly the single-process
masks of its rows of the global batch. The sharded step therefore equals the
single-process step's masks and states at any ``update_rate``. (JAX offsets
by ``axis_index * 2^20`` and matches the single device only in
distribution.)
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.ops.fused_train import fused_rollout_train
from vsnca_tpu_torch.parallel.mesh import Mesh, all_reduce_mean

# host seconds of each gradient all-reduce, appended when not None
ALLREDUCE_SECONDS: Optional[list] = None


class MeanGradOver(torch.autograd.Function):
    """Identity on the tensors; their gradients are averaged over ``group``
    in one flat all-reduce."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        t0 = time.perf_counter()
        flat = torch.cat([
            (g if g is not None else torch.zeros(s, dtype=dt, device=dev)).reshape(-1)
            for g, (s, dt, dev) in zip(grads, ctx.shapes)])
        all_reduce_mean(flat, ctx.group)
        out, i = [], 0
        for s, _, _ in ctx.shapes:
            n = s.numel()
            out.append(flat[i:i + n].view(s))
            i += n
        if ALLREDUCE_SECONDS is not None:
            if flat.is_cuda:
                torch.cuda.synchronize(flat.device)
            ALLREDUCE_SECONDS.append(time.perf_counter() - t0)
        return (None, *out)


def replicated_params(params: dict, mesh: Mesh, axis: str = "data") -> dict:
    """``params`` (the same on every rank of ``axis``) as the rollout's
    input: the same values, whose gradient is the mean over the ranks."""
    names = list(params)
    out = MeanGradOver.apply(mesh.group(axis), *(params[k] for k in names))
    return dict(zip(names, out))


def rank_seed(seed: int, mesh: Mesh, axis: str, local_batch: int) -> int:
    """The mask seed of this rank's shard: its first row's global index
    added, so its masks are the single-process masks of those rows."""
    return int(seed) + mesh.index(axis) * int(local_batch)


def fused_rollout_train_flat_dp(
    mesh: Mesh,
    axis: str,
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor] = None,
    cond_no_grad: bool = True,
    tap_steps: Sequence[int] = (),
    update_rate: Optional[float] = None,
):
    """The training pair on this rank's batch shard ``x`` [B/n, C, H, W]
    (``cond`` and the taps sharded with it), the parameters replicated over
    ``axis`` with their gradient averaged over it. Returns what
    ``fused_rollout_train`` returns for the shard: the state, or (state,
    [tap states]) with ``tap_steps``. Unlike JAX's, which shards a global
    batch itself, it takes the shard (``parallel.mesh.shard_along``)."""
    if cond is not None and cond.shape[0] != x.shape[0]:
        raise ValueError("conditioning must be batch-aligned for data-parallel sharding")
    return fused_rollout_train(
        replicated_params(params, mesh, axis), x, rank_seed(seed, mesh, axis, x.shape[0]),
        cfg, n_steps, cond, update_rate, cond_no_grad=cond_no_grad, tap_steps=tap_steps)
