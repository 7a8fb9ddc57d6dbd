"""Fleet training: M independent DyNCA texture models — the port's copy of
``vsnca_tpu/train/multi.py`` (``make_multi_pooled_step`` :51,
``MultiTrainLog`` :113, ``MultiStyleTrainer`` :119).

Each model keeps its own parameters, Adam state, pool, host RNG for pool
indices and seed generator, and model m reproduces
``DyNCATrainer(seed=seeds[m])``: the same init, pool, index draws and
per-iteration seeds. The fleet shares one rollout length an iteration,
drawn from its own ``RandomState(train_cfg.seed)``.

- ``mesh=None`` (one device): a loop over the models, each through the
  single-model train step, which on a card is the kernel route (the
  ``nca_step`` chain forward and the ``nca_bwd_mlp`` + ``nca_bwd_adjoint``
  backward). JAX vmaps the step instead; ``torch.func.vmap`` cannot map the
  kernels' ``autograd.Function``s nor VGG16's equality-mask pool.
- ``mesh`` with a ``model`` axis: each rank trains its block of M/n models,
  with no collectives in the step; a synced iteration gathers the models'
  losses and logs so that every rank sees the fleet's and aborts together.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.losses.orchestrator import LossState
from vsnca_tpu_torch.models.dynca import dynca_init, dynca_seed
from vsnca_tpu_torch.parallel.mesh import all_gather_cat
from vsnca_tpu_torch.pool.sample_pool import DevicePool, inject_seed_into_batch
from vsnca_tpu_torch.train.optim import make_optimizer
from vsnca_tpu_torch.train.trainer import make_train_step


def _model_input(v, m: int):
    if isinstance(v, (list, tuple)):
        return type(v)(_model_input(e, m) for e in v)
    return v[m] if isinstance(v, torch.Tensor) else v


def make_multi_pooled_step(train_step):
    """The fleet's step from a single-model ``make_train_step`` product:
    ``multi_step(params, optimizers, pools, idx, seed_states, seeds, inputs,
    *, step_n, inject)``, every argument a list over the models (``inputs``
    a list of input dicts), the pools written back in place. Returns
    (losses [M], logs {name: [M]})."""

    def multi_step(params, optimizers, pools, idx, seed_states, seeds, inputs, *,
                   step_n: int, inject: bool):
        losses, logs = [], []
        for m in range(len(params)):
            states = pools[m].gather(idx[m])
            if inject:
                states = inject_seed_into_batch(states, seed_states[m])
            _, _, new_states, loss, lg = train_step(params[m], optimizers[m], states,
                                                    seeds[m], inputs[m], step_n=step_n)
            pools[m].scatter(idx[m], new_states)
            losses.append(loss)
            logs.append(lg)
        return torch.stack(losses), {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}

    return multi_step


@dataclasses.dataclass
class MultiTrainLog:
    iteration: int
    losses: np.ndarray  # [M] per-model loss (device tensor when sync=False)
    logs: Dict[str, np.ndarray]  # each [M]


class MultiStyleTrainer:
    """Concurrent trainer for M independent texture models.

    ``seeds``: one per model. ``inputs`` at ``train_iteration`` carry a
    leading model axis over all M models: ``target_style`` is
    [M, B, 3, H, W]; a precomputed ``target_style_features`` list is stacked
    per leaf. ``rollout_path=None`` keeps ``train_cfg.rollout_path`` in both
    modes ('auto': the kernels on a card): the port loops over the models
    where JAX vmaps, and JAX resolves None to 'xla' only because vmapping its
    custom-VJP pair is unsupported. ``mesh``: a ``parallel.mesh.Mesh`` whose
    first axis is the model axis; M must divide over it."""

    def __init__(self, nca_cfg: NCAConfig, loss_cfg: LossConfig, train_cfg: TrainConfig,
                 seeds: Sequence[int], vgg_params=None, msoe_params=None, mesh=None,
                 rollout_path: Optional[str] = None, device=None):
        if len(seeds) < 1:
            raise ValueError("a fleet needs at least one seed")
        self.device = resolve_device(device)
        self.nca_cfg = nca_cfg
        self.train_cfg = train_cfg
        self.n_models = len(seeds)
        self.mesh = mesh
        first = 0
        n_local = self.n_models
        if mesh is not None:
            axis = mesh.axis_names[0]
            n = mesh.size(axis)
            if self.n_models % n:
                raise ValueError(f"n_models {self.n_models} must divide evenly over the "
                                 f"{n}-rank '{axis}' mesh axis")
            n_local = self.n_models // n
            first = mesh.index(axis) * n_local
        self.local_models = range(first, first + n_local)
        self.loss_state = LossState(cfg=loss_cfg, vgg_params=vgg_params,
                                    msoe_params=msoe_params, nca_cfg=nca_cfg)
        path = train_cfg.rollout_path if rollout_path is None else rollout_path

        # per model, DyNCATrainer's order of draws: params, pool, seed template
        self.rngs: List[np.random.RandomState] = []
        self.generators: List[torch.Generator] = []
        self.params: List[dict] = []
        self.optimizers, self.pools, self._seed_templates = [], [], []
        for m in self.local_models:
            g = torch.Generator().manual_seed(seeds[m])
            self.rngs.append(np.random.RandomState(seeds[m]))
            self.generators.append(g)
            p = {k: v.requires_grad_() for k, v in dynca_init(g, nca_cfg, self.device).items()}
            self.params.append(p)
            self.optimizers.append(make_optimizer(p, train_cfg.lr, train_cfg.lr_decay_steps,
                                                  train_cfg.lr_decay_gamma))
            self.pools.append(DevicePool(dynca_seed(nca_cfg, train_cfg.pool_size,
                                                    train_cfg.img_size, g, self.device)))
            self._seed_templates.append(dynca_seed(nca_cfg, 1, train_cfg.img_size, g,
                                                   self.device))
        self._multi_step = make_multi_pooled_step(
            make_train_step(nca_cfg, self.loss_state, train_cfg.remat, path))
        self._step_rng = np.random.RandomState(train_cfg.seed)
        self.iteration = 0
        self.history: List[MultiTrainLog] = []

    def sample_step_n(self) -> int:
        """One rollout length for the whole fleet this iteration, snapped to
        the nearest bucket like ``DyNCATrainer.sample_step_n``."""
        lo, hi = self.train_cfg.step_range
        raw = self._step_rng.randint(lo, hi)
        buckets = np.asarray(self.train_cfg.step_buckets)
        return int(buckets[np.argmin(np.abs(buckets - raw))])

    def train_iteration(self, inputs: Dict[str, torch.Tensor], step_n: Optional[int] = None,
                        sync: bool = True) -> MultiTrainLog:
        tc = self.train_cfg
        i = self.iteration
        idx = [pool.sample_indices(rng, tc.batch_size)
               for pool, rng in zip(self.pools, self.rngs)]
        seeds = [int(torch.randint(0, 1 << 30, (), generator=g)) for g in self.generators]
        inject = bool(tc.inject_seed_every and i % tc.inject_seed_every == 0)
        step_n = step_n if step_n is not None else self.sample_step_n()
        local_inputs = [{k: _model_input(v, m) for k, v in inputs.items()}
                        for m in self.local_models]
        losses, logs = self._multi_step(self.params, self.optimizers, self.pools, idx,
                                        self._seed_templates, seeds, local_inputs,
                                        step_n=step_n, inject=inject)
        self.iteration += 1
        if not sync:
            return MultiTrainLog(i, losses, logs)
        names = sorted(logs)
        mat = torch.stack([losses.float()] + [logs[k].float() for k in names])
        if self.mesh is not None:  # [1 + terms, M] in model order, on every rank
            mat = all_gather_cat(mat, self.mesh.group(self.mesh.axis_names[0]), dim=1)
        mat = mat.cpu().numpy()
        if not np.all(np.isfinite(mat[0])):
            bad = np.nonzero(~np.isfinite(mat[0]))[0].tolist()
            raise FloatingPointError(f"Loss is NaN/Inf for models {bad} at iteration {i}; "
                                     "training aborted")
        log = MultiTrainLog(i, mat[0], {k: mat[1 + j] for j, k in enumerate(names)})
        self.history.append(log)
        return log

    def model_params(self, m: int) -> dict:
        """Model m's parameters as numpy arrays (for export or inference);
        m must be one of this rank's models."""
        if m not in self.local_models:
            raise ValueError(f"model {m} is trained on another rank")
        return {k: v.detach().cpu().numpy()
                for k, v in self.params[m - self.local_models.start].items()}
