"""Rank bodies for ``parallel.mesh.run_ranks``: each takes the global inputs
as numpy arrays (the same on every rank), builds its mesh, runs the sharded
path on its device and returns numpy results. They live in the package so
that a spawned rank imports torch and this package only.

- ``spatial_rank``: ``spatial.spatial_rollout`` over a ``space`` axis, the
  slabs gathered back;
- ``dp_train_rank``: ``DyNCATrainer(mesh=...)`` over a ``data`` axis;
- ``fleet_rank``: ``MultiStyleTrainer`` over a ``model`` axis;
- ``fused_dp_rank``: ``fused_dp.fused_rollout_train_flat_dp`` and its
  backward over a ``data`` axis.

Each counts the kernel launches its rank made (``KERNEL_LAUNCHES`` of the
rollout and training wrappers) from zero, and on a card times its work with
the host clock after a device synchronize.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vsnca_tpu_torch.parallel.mesh import all_gather_cat, make_mesh, shard_along


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _tensors(d: Optional[Dict[str, np.ndarray]], device) -> Optional[Dict[str, torch.Tensor]]:
    if d is None:
        return None
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in d.items()}


def _counts() -> Dict[str, int]:
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft

    return {**{f"step:{k}": v for k, v in fs.KERNEL_LAUNCHES.items()},
            **{f"train:{k}": v for k, v in ft.KERNEL_LAUNCHES.items()}}


def _reset_counts() -> None:
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft

    for mod in (fs, ft):
        mod.LAUNCHES = 0
        for k in mod.KERNEL_LAUNCHES:
            mod.KERNEL_LAUNCHES[k] = 0


def spatial_rank(device: str, jobs: List[dict]) -> List[dict]:
    """For each job — ``cfg``, ``params``, ``x`` [B, C, H, W], ``cond`` or
    None, ``seed``, ``n_steps``, ``update_rate`` (None: the config's),
    ``reps`` (timed repeats after one untimed run) — the rows sharded over a
    ``space`` axis of every rank. Returns, on rank 0, the gathered final
    state, the host ms a step (median of ``reps``) and the halo bytes a
    side a step; on the other ranks their ms only."""
    from vsnca_tpu_torch.parallel.spatial import halo_bytes, spatial_rollout

    mesh = make_mesh({"space": torch.distributed.get_world_size()})
    out = []
    for job in jobs:
        params = _tensors(job["params"], device)
        x = shard_along(torch.from_numpy(job["x"]).to(device), mesh, "space", dim=2)
        cond = job.get("cond")
        cond = None if cond is None else shard_along(torch.from_numpy(cond).to(device),
                                                     mesh, "space", dim=2)

        def run():
            return spatial_rollout(params, x, job["seed"], job["cfg"], job["n_steps"], mesh,
                                   cond=cond, update_rate=job.get("update_rate"))[0]

        state = run()
        times = []
        for _ in range(job.get("reps", 0)):
            torch.distributed.barrier()
            _sync(device)
            t0 = time.perf_counter()
            run()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3 / job["n_steps"])
        full = all_gather_cat(state, mesh.group("space"), dim=2)
        rank0 = mesh.index("space") == 0
        out.append({"state": full.cpu().numpy() if rank0 else None,
                    "ms_per_step": float(np.median(times)) if times else None,
                    "halo_bytes": halo_bytes(x, job["cfg"])})
    return out


def dp_train_rank(device: str, jobs: List[dict]) -> List[dict]:
    """For each job, ``DyNCATrainer(job's configs, mesh={'data': world})``:
    ``params``, ``pool`` (NCHW) and ``seed_template``, when given, replace
    the trainer's own after its init (the tests carry JAX's over);
    ``vgg``/``msoe`` are JAX arrays, else the seeded fallbacks load (MSOE
    with ``load_msoe``); ``style_features`` precomputes the target's; then
    one ``train_iteration(inputs, **kw)`` for each entry of ``iterations``,
    ``inputs`` the global batch's. Returns the logs, batch indices, final
    params, the first iteration's gradient as the optimizer left it and its
    pool write-back (the rows of its batch), the whole pool after each
    iteration (with ``keep_pools``: small pools only), each iteration's host
    ms, the gradient all-reduces' host ms and this rank's kernel
    launches."""
    from vsnca_tpu_torch.convert import msoe_from_jax, vgg_from_jax
    from vsnca_tpu_torch.models.msoe import load_msoe
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.parallel import fused_dp
    from vsnca_tpu_torch.train.trainer import DyNCATrainer

    mesh = make_mesh({"data": torch.distributed.get_world_size()})
    out = []
    for job in jobs:
        vgg = (vgg_from_jax(job["vgg"], device) if job.get("vgg") is not None
               else load_vgg16(device=device)[0])
        msoe = None
        if job.get("msoe") is not None:
            msoe = msoe_from_jax(job["msoe"], device)
        elif job.get("load_msoe"):
            msoe = load_msoe(device=device)[0]
        trainer = DyNCATrainer(job["nca"], job["loss"], job["train"], vgg_params=vgg,
                               msoe_params=msoe, seed=job.get("seed"), device=device,
                               mesh=mesh)
        with torch.no_grad():
            for k, v in (_tensors(job.get("params"), device) or {}).items():
                trainer.params[k].copy_(v)
            for name, t in (("pool", trainer.pool.states),
                            ("seed_template", trainer._seed_template)):
                if job.get(name) is not None:
                    t.copy_(torch.from_numpy(job[name]))
        inputs = _tensors(job["inputs"], device)
        if job.get("style_features"):
            from vsnca_tpu_torch.losses.appearance import precompute_target_style_features

            inputs["target_style_features"] = precompute_target_style_features(
                vgg, inputs["target_style"], job["loss"].appearance_loss_type,
                job["train"].img_size)
        _reset_counts()
        fused_dp.ALLREDUCE_SECONDS = []
        logs, times, pools, batch_idx, grads, first_rows = [], [], [], [], None, None
        for kw in job["iterations"]:
            torch.distributed.barrier()
            _sync(device)
            t0 = time.perf_counter()
            log = trainer.train_iteration(inputs, **kw)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            logs.append(dataclasses.asdict(log))
            batch_idx.append(np.asarray(trainer.last_batch_idx))
            if grads is None:  # the first step's averaged gradient and write-back
                grads = {k: v.grad.cpu().numpy().copy() for k, v in trainer.params.items()}
                first_rows = trainer.pool.gather(trainer.last_batch_idx).cpu().numpy()
            if job.get("keep_pools"):
                pools.append(trainer.pool.states.cpu().numpy().copy())
        allreduce = [s * 1e3 for s in fused_dp.ALLREDUCE_SECONDS]
        fused_dp.ALLREDUCE_SECONDS = None
        out.append({"logs": logs, "ms": times, "allreduce_ms": allreduce,
                    "launches": _counts(), "pools": pools, "batch_idx": batch_idx,
                    "first_grads": grads, "first_rows": first_rows,
                    "params": {k: v.detach().cpu().numpy() for k, v in trainer.params.items()}})
        del trainer, inputs
    return out


def fleet_rank(device: str, job: dict) -> dict:
    """``MultiStyleTrainer(job's configs, seeds, mesh={'model': world})``:
    ``iterations`` as in ``dp_train_rank``, ``inputs`` with a leading model
    axis over every model. Returns this rank's models' params, the fleet's
    losses, each iteration's host ms and this rank's launches."""
    from vsnca_tpu_torch.convert import vgg_from_jax
    from vsnca_tpu_torch.train.multi import MultiStyleTrainer

    mesh = make_mesh({"model": torch.distributed.get_world_size()})
    if job.get("vgg") is not None:
        vgg = vgg_from_jax(job["vgg"], device)
    else:
        from vsnca_tpu_torch.models.vgg import load_vgg16

        vgg = load_vgg16(device=device)[0]
    trainer = MultiStyleTrainer(job["nca"], job["loss"], job["train"], job["seeds"],
                                vgg_params=vgg, device=device, mesh=mesh,
                                rollout_path=job.get("rollout_path"))
    inputs = _tensors(job["inputs"], device)
    _reset_counts()
    losses, times = [], []
    for kw in job["iterations"]:
        torch.distributed.barrier()
        _sync(device)
        t0 = time.perf_counter()
        log = trainer.train_iteration(inputs, **kw)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(np.asarray(log.losses))
    return {"losses": losses, "ms": times, "launches": _counts(),
            "models": list(trainer.local_models),
            "params": [{k: v.detach().cpu().numpy() for k, v in p.items()}
                       for p in trainer.params]}


def fused_dp_rank(device: str, job: dict) -> dict:
    """``fused_dp.fused_rollout_train_flat_dp`` on this rank's shard of
    ``x`` (and ``cond``), then the backward of the local mean of
    sum(state * ``gy``) a sample (``gy`` sharded too). Returns, on rank 0,
    the gathered final state and x gradient and the parameters' averaged
    gradient (the same on every rank), and this rank's launches."""
    from vsnca_tpu_torch.parallel.fused_dp import fused_rollout_train_flat_dp

    mesh = make_mesh({"data": torch.distributed.get_world_size()})
    params = {k: v.requires_grad_() for k, v in _tensors(job["params"], device).items()}
    x = shard_along(torch.from_numpy(job["x"]).to(device), mesh, "data").requires_grad_()
    gy = shard_along(torch.from_numpy(job["gy"]).to(device), mesh, "data")
    cond = job.get("cond")
    cond = None if cond is None else shard_along(torch.from_numpy(cond).to(device), mesh,
                                                 "data")
    _reset_counts()
    state = fused_rollout_train_flat_dp(mesh, "data", params, x, job["seed"], job["cfg"],
                                        job["n_steps"], cond,
                                        update_rate=job.get("update_rate"))
    ((state * gy).sum() / x.shape[0]).backward()
    group = mesh.group("data")
    full = all_gather_cat(state.detach(), group)
    gx = all_gather_cat(x.grad, group)
    rank0 = mesh.index("data") == 0
    return {"state": full.cpu().numpy() if rank0 else None,
            "grad_x": gx.cpu().numpy() if rank0 else None,
            "grads": {k: v.grad.cpu().numpy() for k, v in params.items()},
            "launches": _counts()}
