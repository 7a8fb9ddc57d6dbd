"""Data-parallel train step — the counterpart of
``vsnca_tpu/parallel/train_dp.py::make_dp_train_step`` (:20).

Every rank holds the whole batch's states and inputs (each builds them from
the same seeds) and the same parameters; ``make_dp_train_step`` hands the
train step this rank's shard as ``place`` does at :37-45 — the batch
dimension split over the ``data`` axis, ``target_motion_frames`` split on
dimension 1 (it is time-major, [T, B, ...]), ``target_motion_features``
and everything not batch-leading whole — and gathers the new states of the
global batch back in rank order. The gradient all-reduce is the train
step's (``train.trainer.make_train_step(..., mesh=...)``).
"""

from __future__ import annotations

from typing import Dict

import torch

from vsnca_tpu_torch.parallel.mesh import Mesh, all_gather_cat, shard_along


def place_input(key: str, v, batch: int, mesh: Mesh, axis: str = "data"):
    """This rank's part of one train-step input (lists element by element)."""
    if isinstance(v, (list, tuple)):
        return type(v)(place_input(key, e, batch, mesh, axis) for e in v)
    if not isinstance(v, torch.Tensor):
        return v
    if key == "target_motion_frames":
        return shard_along(v, mesh, axis, dim=1)
    if key != "target_motion_features" and v.ndim >= 1 and v.shape[0] == batch:
        return shard_along(v, mesh, axis, dim=0)
    return v


def make_dp_train_step(train_step, mesh: Mesh, axis: str = "data"):
    """Wrap a ``make_train_step(..., mesh=mesh)`` product: ``dp_step(params,
    optimizer, states, seed, inputs, **static)`` takes the global batch's
    ``states`` [B, C, H, W] and inputs (B divisible by the axis size), runs
    the step on this rank's shard and returns (params, optimizer, the global
    batch's new states, the global mean loss, logs)."""

    def dp_step(params, optimizer, states, seed: int, inputs: Dict, **static):
        b = states.shape[0]
        local = {k: place_input(k, v, b, mesh, axis) for k, v in inputs.items()}
        params, optimizer, new_local, loss, logs = train_step(
            params, optimizer, shard_along(states, mesh, axis), seed, local, **static)
        return (params, optimizer, all_gather_cat(new_local, mesh.group(axis)), loss, logs)

    return dp_step
