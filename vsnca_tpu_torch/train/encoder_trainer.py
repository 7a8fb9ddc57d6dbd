"""EncoderConditioning training harness (BASELINE config 5) — the port's copy
of ``vsnca_tpu/train/encoder_trainer.py`` on NCHW tensors.

Protocol, as the JAX package runs it:

- a pool (a device tensor, or the host ``ListPool``) whose None and dead
  entries (no alpha above the living threshold, compared in float32) are
  reseeded; the first 2 batch slots are always fresh seeds; each sampled
  batch is trained twice;
- a train step grows 48-96 steps (bucketed), loss = overflow + appearance
  (vs the style image) + content (vs the goal image) on the raw state RGB,
  per-tensor gradient normalization with eps 1e-10, Adam at 2e-3 with
  MultiStepLR([5000], 0.3);
- optional circular damage in the last ``num_damaged`` batch entries, and
  collapse recovery (best params back, the pool reseeded, the optimizer
  reset).

Host randomness keeps the JAX trainer's streams and draw order:
``random.Random(seed)`` for pool indices and step counts,
``np.random.RandomState(seed)`` for goal images and damage. The rest — the
initial parameters, the fire-mask seed of each grow, the OT subsample and
the SlW projections — comes from ``torch.Generator().manual_seed(seed)``
where the JAX package splits a ``jax.random`` key.

``rollout_path`` is ``models.conditioned_nca.cnca_route``'s: 'auto' grows
through the CUDA training pair on a card and through eager steps on the
CPU, 'fused' through the pair everywhere (its plain version on the CPU),
'xla' through eager steps everywhere.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.losses.appearance import gram_loss, ot_style_loss, sliced_wasserstein_loss
from vsnca_tpu_torch.losses.overflow import overflow_loss
from vsnca_tpu_torch.models.conditioned_nca import (
    cnca_route,
    conditioned_nca_grow,
    conditioned_nca_init,
    conditioned_nca_seed,
    encode_goal,
    grow_from_encoding,
)
from vsnca_tpu_torch.models.vgg import vgg16_content_features, vgg16_style_features
from vsnca_tpu_torch.ops.fused_cnca import check_supported
from vsnca_tpu_torch.pool.sample_pool import ListPool
from vsnca_tpu_torch.train.optim import make_optimizer
from vsnca_tpu_torch.utils import spans


def create_2d_circular_mask(h, w, rng: np.random.RandomState, radius: int = 3) -> np.ndarray:
    """Random-centered circular damage mask, bool [h, w]."""
    center = (rng.randint(radius + 2, w - (radius + 2)),
              rng.randint(radius + 2, h - (radius + 2)))
    yy, xx = np.ogrid[:h, :w]
    return np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2) <= radius


def make_encoder_loss_fn(vgg_params, style_image: torch.Tensor,
                         appearance_loss_type: str = "OT", appearance_weight: float = 1.0,
                         content_weight: float = 1.0, overflow_weight: float = 1.0,
                         ot_subsample: int = 1000) -> Callable:
    """``loss_fn(nca_state, generated, targets, generator) -> (total, logs)``:
    overflow + appearance against the style image [1, 3, H, W] in [0, 1]
    (its VGG16 features computed once) + content against the goal images, on
    the raw generated RGB (the EncoderConditioning stack does not rescale).
    ``generator`` draws the OT subsample or the SlW projections. Each term
    is a span (``utils.spans``): ``loss.overflow``, ``loss.appearance``,
    ``loss.content``."""
    if appearance_loss_type not in ("OT", "SlW", "Gram"):
        raise ValueError(f"unknown appearance loss type {appearance_loss_type}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slw = appearance_loss_type == "SlW"
    style_feats = None
    if appearance_weight:
        with torch.no_grad():
            style_feats = vgg16_style_features(vgg_params, style_image, include_image_as_feat=slw)

    def loss_fn(nca_state, generated, targets, generator):
        logs: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=nca_state.device)
        if overflow_weight:
            with spans.span("loss.overflow"):
                logs["overflow"] = overflow_loss(nca_state) * overflow_weight
                total = total + logs["overflow"]
        if appearance_weight:
            with spans.span("loss.appearance"):
                gen_feats = vgg16_style_features(vgg_params, generated,
                                                 include_image_as_feat=slw)
                b = generated.shape[0]
                tiled = [f.repeat((b,) + (1,) * (f.dim() - 1)) for f in style_feats]
                if appearance_loss_type == "Gram":
                    l = gram_loss(gen_feats, tiled)
                elif slw:
                    l = sliced_wasserstein_loss(gen_feats, tiled, generator)
                else:
                    l = ot_style_loss(gen_feats, tiled, generator, ot_subsample)
                logs["appearance"] = l * appearance_weight
                total = total + logs["appearance"]
        if content_weight:
            with spans.span("loss.content"):
                gf = vgg16_content_features(vgg_params, generated)
                with torch.no_grad():
                    tf_ = vgg16_content_features(vgg_params, targets)
                logs["content"] = torch.mean((gf - tf_) ** 2) * content_weight
                total = total + logs["content"]
        return total, logs

    return loss_fn


class ConditionedNCATrainer:
    def __init__(
        self,
        cfg: ConditionedNCAConfig,
        dataset,
        style_image: torch.Tensor,
        vgg_params,
        nca_steps=(48, 96),
        step_buckets=(48, 64, 80, 96),
        lr: float = 2e-3,
        pool_size: int = 512,
        num_damaged: int = 0,
        damage_radius: int = 3,
        appearance_loss_type: str = "OT",
        appearance_weight: float = 1.0,
        content_weight: float = 1.0,
        overflow_weight: float = 1.0,
        seed: int = 0,
        recovery_patience: int = 0,
        recovery_factor: float = 3.0,
        device_pool: bool = True,
        grow_remat: str = "per_step",
        rollout_path: str = "auto",
        device=None,
    ):
        """``dataset`` a ``data.dataset.ConditioningDataset`` on ``device``;
        ``style_image`` [1, 3, H, W] in [0, 1]; ``vgg_params`` the port's
        VGG16 on ``device``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dataset = dataset
        cnca_route(self.device.type, True, rollout_path)  # validates the name
        if rollout_path == "fused":
            check_supported(cfg)
        self.rollout_path = rollout_path
        self.grow_remat = grow_remat
        self.min_steps, self.max_steps = nca_steps
        self.step_buckets = step_buckets
        self.num_damaged = num_damaged
        self.damage_radius = damage_radius

        self.rng = np.random.RandomState(seed)
        self.py_rng = random.Random(seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.params = {k: v.requires_grad_() for k, v in
                       conditioned_nca_init(self.generator, cfg, self.device).items()}
        self.lr = lr
        self.optimizer = self._make_optimizer()

        self.device_pool = device_pool
        self.pool = ListPool(pool_size)
        if device_pool:
            self.pool_states = conditioned_nca_seed(cfg, pool_size, device=self.device)
            self._seed2 = conditioned_nca_seed(cfg, 2, device=self.device)
        self.loss_fn = make_encoder_loss_fn(vgg_params, style_image, appearance_loss_type,
                                            appearance_weight, content_weight, overflow_weight)
        self.iteration = 0
        self.history = []
        # collapse recovery (vsnca_tpu/train/encoder_trainer.py:242-257)
        self.recovery_patience = recovery_patience
        self.recovery_factor = recovery_factor
        self.best_loss = float("inf")
        self.best_iteration = -1
        self._best_params = None
        self._plateau = 0
        self.recoveries = []

    def _make_optimizer(self):
        return make_optimizer(self.params, self.lr, (5000,), 0.3, eps=1e-10)

    def _pool_size(self) -> int:
        return self.pool_states.shape[0] if self.device_pool else len(self.pool)

    def sample_num_steps(self) -> int:
        raw = self.py_rng.randint(self.min_steps, self.max_steps)
        buckets = np.asarray(self.step_buckets)
        return int(buckets[np.argmin(np.abs(buckets - raw))])

    def _is_dead(self, entry: np.ndarray) -> bool:
        """Host check of ``sum(alive_mask) == 0`` on a pool entry [C, H, W]:
        the 3x3 pool has a cell above the threshold iff the raw alpha does,
        compared in float32 as the device does."""
        if not self.cfg.use_living_channel:
            return False
        a = np.asarray(entry)[self.cfg.alive_channel]
        return not bool(a.max() > np.float32(self.cfg.alpha_living_threshold))

    def _gather(self, idxs) -> torch.Tensor:
        """The device pool's batch: dead entries reseeded, the first two
        slots fresh seeds."""
        batch = self.pool_states[torch.as_tensor(idxs, device=self.device)]
        if self.cfg.use_living_channel:
            amax = batch[:, self.cfg.alive_channel].amax(dim=(1, 2))
            thr = torch.tensor(self.cfg.alpha_living_threshold, dtype=torch.float32)
            dead = ~(amax > thr.to(self.device))
            batch = torch.where(dead[:, None, None, None], self._seed2[:1], batch)
        batch[:2] = self._seed2
        return batch

    def damage(self, batch: torch.Tensor) -> torch.Tensor:
        """Zero circular patches in the LAST num_damaged entries."""
        batch = batch.clone()
        size, s = batch.shape[0], batch.shape[-1]
        for i in range(self.num_damaged):
            mask = create_2d_circular_mask(s, s, self.rng, self.damage_radius)
            keep = torch.from_numpy((~mask).astype(np.float32)).to(self.device)
            batch[max(size - i - 1, 0)] *= keep
        return batch

    def _train_step(self, batch, targets, num_steps: int, mark):
        cfg = self.cfg
        self.optimizer.zero_grad()
        seed = int(torch.randint(0, 2**30 - 1, (), generator=self.generator))
        mark("encode")
        with spans.span("train.encode"):
            goal = encode_goal(self.params, cfg, targets)
        mark("rollout forward")
        with spans.span("train.rollout"):
            grown = grow_from_encoding(self.params, batch, goal, seed, cfg, num_steps,
                                       self.grow_remat, self.rollout_path)
        mark("loss forward")
        with spans.span("train.loss"):
            loss, logs = self.loss_fn(grown, grown[:, : cfg.num_target_channels], targets,
                                      self.generator)
        mark("loss backward")
        grown.register_hook(lambda g: mark("rollout backward"))
        with spans.span("train.backward"):
            loss.backward()
        mark("optimizer")
        if cfg.use_living_channel:
            logs["alive_frac"] = (grown[:, cfg.alive_channel] > cfg.alpha_living_threshold
                                  ).float().mean()
        with spans.span("train.optimizer"):
            self.optimizer.step()
        mark("end")
        return grown.detach(), loss.detach(), {k: v.detach() for k, v in logs.items()}

    @spans.span("train.iteration")
    def train_iteration(self, batch_size: int = 8, num_steps: Optional[int] = None,
                        mark: Optional[Callable[[str], None]] = None):
        """One epoch: sample a pool batch (2 forced fresh seeds), train it
        twice, write it back. ``num_steps``, when given, is the step count
        of both train steps (else each draws its own). ``mark``, when given,
        is called with the name of each part of each of the two train steps
        as it begins, and with "end" after the step's update; a caller can
        record a CUDA event in it to time the parts:

        - "encode": the ImageEncoder's forward on the goal images;
        - "rollout forward": the grow from the batch and the encoding;
        - "loss forward": overflow, appearance and content;
        - "loss backward": the backward through the losses;
        - "rollout backward" (from a hook in the backward): the grow's
          backward, then the encoder's;
        - "optimizer": the gradient normalization and Adam.

        The host's parts are spans (``utils.spans``): ``train.iteration``
        the whole call; inside it ``train.pool_gather`` (the batch with its
        reseeding), each train step's ``train.encode``, ``train.rollout``,
        ``train.loss``, ``train.backward`` and ``train.optimizer``,
        ``train.pool_scatter`` and ``train.loss_read``."""
        mark = mark or (lambda name: None)
        idxs = self.py_rng.sample(range(self._pool_size()), batch_size)
        targets = self.dataset.sample(self.rng, batch_size)
        n1 = num_steps if num_steps is not None else self.sample_num_steps()
        with spans.span("train.pool_gather"):
            if self.device_pool:
                batch = self._gather(idxs)
            else:
                def reseed(n):
                    return conditioned_nca_seed(self.cfg, n, device="cpu").numpy()

                batch = torch.from_numpy(self.pool.get(idxs, reseed, is_dead_fn=self._is_dead))
                batch = batch.to(self.device)
                batch[:2] = conditioned_nca_seed(self.cfg, 2, device=self.device)
        if self.num_damaged:
            batch = self.damage(batch)
        outputs, loss, logs = self._train_step(batch, targets, n1, mark)
        n2 = num_steps if num_steps is not None else self.sample_num_steps()
        outputs, loss, logs = self._train_step(outputs, targets, n2, mark)
        if self.device_pool:
            with spans.span("train.pool_scatter"):
                self.pool_states[torch.as_tensor(idxs, device=self.device)] = outputs

        names = sorted(logs)
        with spans.span("train.loss_read"):
            vec = torch.stack([loss] + [logs[k] for k in names]).float().cpu().numpy()
        loss_f = float(vec[0])
        if not np.isfinite(loss_f):
            raise FloatingPointError(f"loss NaN/Inf at epoch {self.iteration}")
        if not self.device_pool:
            with spans.span("train.pool_scatter"):
                self.pool.set(idxs, outputs.cpu().numpy())
        metrics = dict(zip(names, map(float, vec[1:])))
        metrics["log10loss"] = math.log10(loss_f + 1e-5)
        self.iteration += 1

        if loss_f < self.best_loss:
            self.best_loss = loss_f
            self.best_iteration = self.iteration
            self._plateau = 0
            self._best_params = {k: v.detach().clone() for k, v in self.params.items()}
        elif self.recovery_patience and loss_f > self.recovery_factor * self.best_loss:
            self._plateau += 1
            if self._plateau >= self.recovery_patience:
                self.recover()
                metrics["recovered"] = 1.0
        else:
            self._plateau = 0
        self.history.append((self.iteration, loss_f, metrics))
        return loss_f, metrics

    def recover(self) -> None:
        """Restore the best-loss params, reseed the whole pool, reset the
        optimizer state (no-op before the first snapshot)."""
        if self._best_params is None:
            return
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(self._best_params[k])
        self.optimizer = self._make_optimizer()
        if self.device_pool:
            self.pool_states = conditioned_nca_seed(self.cfg, self.pool_states.shape[0],
                                                    device=self.device)
        else:
            self.pool = ListPool(len(self.pool))
        self._plateau = 0
        self.recoveries.append((self.iteration, self.best_iteration, self.best_loss))

    @torch.no_grad()
    def grow_preview(self, goal_images: torch.Tensor, num_steps: int = 96) -> torch.Tensor:
        """Grow fresh seeds toward goal images [B, 3, H, W]; RGB in [0, 1]."""
        seeds = conditioned_nca_seed(self.cfg, goal_images.shape[0], device=self.device)
        seed = int(torch.randint(0, 2**30 - 1, (), generator=self.generator))
        grown = conditioned_nca_grow(self.params, seeds, goal_images, seed, self.cfg,
                                     num_steps, rollout_path=self.rollout_path)
        return grown[:, : self.cfg.num_target_channels].clamp(0.0, 1.0)
