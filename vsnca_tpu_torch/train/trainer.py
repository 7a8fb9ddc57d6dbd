"""DyNCA training harness — the port's copy of ``vsnca_tpu/train/trainer.py``.

``make_train_step`` builds the step: the content-channel append of an
ExtraChannels cell, conditioning, the one-step pre-roll without a gradient
that gives the vector-field loss its flow baseline, the BPTT rollout (the
fused kernel pair of ``ops/fused_train.py`` on a card where it applies, see
``TrainConfig.rollout_path``), the loss, per-tensor gradient normalization,
the Adam update and the strip of appended channels before the pool
write-back. ``DyNCATrainer`` owns what the reference loop owns:
pool sampling and the rollout length from one ``np.random.RandomState(seed)``
in the JAX trainer's order (so both packages draw the same batch indices and
step counts from the same seed), seed injection every K iterations, the NaN
abort, the pool write-back and the history. The tapped (video-motion)
schedule runs as the JAX trainer's does (trainer.py:161-288): one call of
the training pair with in-kernel taps where the pair applies, else one
rollout a chunk; appearance scores every tapped frame.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh`` with a ``data`` axis;
trainer.py:48-58, 444-530): every rank keeps the parameters, Adam's state
and the whole pool, draws the same pool indices, step counts and seeds,
and trains on its shard of the batch (``parallel/train_dp.py``); the
parameters' gradient is averaged over the ranks inside the backward
(``parallel/fused_dp.py::MeanGradOver``), before the normalization and Adam,
so every rank takes the same update; the loss and logs are averaged before
the NaN abort, so every rank aborts together; the new states of the global
batch are gathered into every rank's pool. The port's trainer never runs the
segment-checkpointed CHW pair, which JAX skips under a mesh (:232).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.losses.orchestrator import LossState, make_loss_fn
from vsnca_tpu_torch.models.dynca import (
    ROLLOUT_PATHS,
    dynca_init,
    dynca_rollout,
    dynca_seed,
    make_conditioning,
    rollout_taps,
    to_rgb,
)
from vsnca_tpu_torch.parallel.fused_dp import rank_seed, replicated_params
from vsnca_tpu_torch.parallel.mesh import all_reduce_mean, replicate
from vsnca_tpu_torch.parallel.train_dp import make_dp_train_step
from vsnca_tpu_torch.pool.sample_pool import DevicePool, inject_seed_into_batch
from vsnca_tpu_torch.train.optim import NormalizedAdam, make_optimizer
from vsnca_tpu_torch.utils import spans

# the pre-roll's masks come from the step's seed with these bits flipped, so
# that they are not the rollout's first mask (the JAX step splits a key)
PREROLL_SEED_XOR = 0x5BD1E995


def _tap_plan(n_motion_frames: int, tap_every: int, tap_chunks, tail_steps):
    """(frame chunks, tail) of a tapped iteration, or None: ``tap_chunks``
    and ``tail_steps`` (``models.dynca.tap_schedule``), else the legacy
    ``n_motion_frames`` equal chunks of ``tap_every`` steps."""
    if tap_chunks:
        return tuple(int(c) for c in tap_chunks), int(tail_steps)
    if n_motion_frames > 0:
        return (int(tap_every),) * n_motion_frames, 0
    return None


def make_train_step(nca_cfg: NCAConfig, loss_state: LossState,
                    remat: str = "per_step", rollout_path: str = "auto", mesh=None,
                    data_axis: str = "data"):
    """The train step ``step(params, optimizer, states, seed, inputs, *,
    step_n, n_motion_frames=0, tap_every=0, tap_chunks=(), tail_steps=0,
    mark=None) -> (params, optimizer, new_states, loss, logs)``. ``params``
    are leaf tensors that require grad and ``optimizer`` a
    ``NormalizedAdam`` over them; both are updated in place. ``seed`` keys
    the rollout's masks and the loss's draws. ``inputs`` (NCHW tensors):
    ``target_style`` [B, 3, H, W] in [-1, 1]; ``target_style_features``
    (optional, from ``losses.appearance.precompute_target_style_features``);
    ``aux_imgs`` [B, 3, H, W] content frames in [-1, 1] (the auxiliary and
    content terms); ``aux_gs`` [B, 1, H, W] their grayscale, for edge
    conditioning and the ExtraChannels content channel;
    ``target_motion_frames`` [T, B, 3, H, W], the target video's window,
    or ``target_motion_features`` [T - 1, 320, h, w], its pairs' MSOE
    features (``losses.video_motion.precompute_target_motion_features``).

    Tapped iterations (video motion): ``tap_chunks``/``tail_steps`` roll
    one frame a chunk and then a frameless tail (``step_n`` is then their
    sum); the legacy ``(n_motion_frames, tap_every)`` form rolls equal
    chunks. ``models.dynca.rollout_taps`` runs either: where
    ``rollout_route`` picks the training pair, the whole schedule is ONE
    call with in-kernel taps; otherwise one rollout a chunk (the JAX
    trainer's chunked fallback and its two-level tap scan, which compute
    the same values).

    With a vector-field term, one step from the same states without a
    gradient gives the flow's "before" frame (trainer.py:118-126), with masks
    of its own seed (``seed ^ PREROLL_SEED_XOR``): on a card the rollout
    kernel, one launch. The new states returned are the first
    ``n_seed_channels`` of the final state (trainer.py:362).

    ``rollout_path`` is ``rollout_route``'s: "auto" runs the fused kernel
    pair for a CUDA state where it applies and the eager steps on the CPU,
    "fused" always the pair (its plain version for a CPU state), "xla" the
    eager steps. The conditioning (a positional constant or an edge map of
    the content) takes no gradient. The whole step runs in full float32
    (TF32 off for products and convolutions).

    ``mark``, when given, is called with the name of each part of the step
    as it begins — "rollout forward", "loss forward", "loss backward",
    "rollout backward" (from a hook on the final state's gradient, in the
    backward's thread), "optimizer" — and with "end"; a caller can record
    a CUDA event in it to time the parts. The host's parts are spans
    (``utils.spans``): ``train.pre_roll``, ``train.rollout``, ``train.loss``
    (the loss's inputs and ``loss_fn``), ``train.backward`` and
    ``train.optimizer``.

    ``mesh``/``data_axis``: data-parallel mode. ``states`` and the
    batch-leading inputs are then this rank's shard
    (``parallel.train_dp.make_dp_train_step`` places them); the masks are
    those of the shard's rows of the global batch (``rank_seed``); the
    parameters' gradient is averaged over the axis in the backward; the
    returned loss and logs are the ranks' mean, the new states the shard's."""
    if rollout_path not in ROLLOUT_PATHS:
        raise ValueError(f"rollout_path must be one of {ROLLOUT_PATHS}")
    loss_fn = make_loss_fn(loss_state)
    cfg = loss_state.cfg
    # the pre-roll runs without a gradient: 'auto' takes the rollout kernel on
    # a card ('fused' would take the training pair)
    pre_path = "xla" if rollout_path == "xla" else "auto"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def train_step(params, optimizer: NormalizedAdam, states, seed: int,
                   inputs: Dict[str, torch.Tensor], *, step_n: int,
                   n_motion_frames: int = 0, tap_every: int = 0, tap_chunks=(),
                   tail_steps: int = 0, mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        p, roll_seed, pre_seed = params, seed, seed ^ PREROLL_SEED_XOR
        if mesh is not None:
            p = replicated_params(params, mesh, data_axis)
            roll_seed = rank_seed(seed, mesh, data_axis, states.shape[0])
            pre_seed = rank_seed(pre_seed, mesh, data_axis, states.shape[0])
        if nca_cfg.n_seed_channels < nca_cfg.c_in:
            # the ExtraChannels content channel (experiments.py:211)
            states = torch.cat([states, inputs["aux_gs"]], dim=1)
        cond = make_conditioning(nca_cfg, tuple(states.shape[-2:]),
                                 cond_img=inputs.get("aux_gs"), batch=states.shape[0],
                                 device=states.device)
        optimizer.zero_grad()
        mark("rollout forward")
        rgb_before = None
        if cfg.vector_field_motion_weight != 0:
            with spans.span("train.pre_roll"), torch.no_grad():
                pre, _ = dynca_rollout(params, states, pre_seed, nca_cfg, 1, cond,
                                       rollout_path=pre_path)
                rgb_before = to_rgb(pre, nca_cfg.c_out)
        plan = _tap_plan(n_motion_frames, tap_every, tap_chunks, tail_steps)
        input_dict = {"step_n": step_n}
        with spans.span("train.rollout"):
            if plan is None:
                state_after, rgb_after = dynca_rollout(p, states, roll_seed, nca_cfg, step_n,
                                                       cond, remat=remat,
                                                       rollout_path=rollout_path)
                input_dict["generated_image_list"] = [rgb_after]
            else:
                chunks, tail = plan
                state_after, taps = rollout_taps(p, states, roll_seed, nca_cfg, chunks, tail,
                                                 cond, remat, rollout_path)
                frames = [to_rgb(t, nca_cfg.c_out) for t in taps]
                rgb_after = frames[-1]
                n_frames = len(frames)
                # appearance scores every tapped frame (fit_video_motion.py:243-256)
                input_dict["generated_image_list"] = frames
                input_dict["generated_image_list_motion"] = frames
                if "target_motion_frames" in inputs:
                    input_dict["target_motion_image_list"] = [
                        inputs["target_motion_frames"][i] for i in range(n_frames)]
                if "target_motion_features" in inputs:
                    input_dict["target_motion_feature_list"] = [
                        inputs["target_motion_features"][i] for i in range(n_frames - 1)]
        mark("loss forward")
        with spans.span("train.loss"):
            input_dict["nca_state"] = state_after
            if "target_style" in inputs:
                input_dict["target_image_list"] = (
                    [inputs["target_style"]] * len(input_dict["generated_image_list"]))
            if "target_style_features" in inputs:
                input_dict["target_style_features"] = inputs["target_style_features"]
            if rgb_before is not None:
                input_dict["generated_image_before_nca"] = rgb_before
                input_dict["generated_image_after_nca"] = rgb_after
            if "aux_imgs" in inputs:
                input_dict["auxillary_image_list"] = [inputs["aux_imgs"]]
                input_dict["content_image"] = inputs["aux_imgs"]
            if cfg.style_consistency_weight != 0:
                # the live params for the fresh-seed grow, which runs without a
                # gradient (the reference's no_grad)
                input_dict["nca_params"] = params
                if "aux_gs" in inputs:
                    input_dict["style_consistency_cond_img"] = inputs["aux_gs"]
            loss, logs = loss_fn(input_dict, torch.Generator().manual_seed(seed + 1))
        mark("loss backward")
        state_after.register_hook(lambda g: mark("rollout backward"))
        with spans.span("train.backward"):
            loss.backward()
        mark("optimizer")
        with spans.span("train.optimizer"):
            optimizer.step()
        mark("end")
        # the pool write-back strips appended channels (experiments.py:269)
        new_states = state_after.detach()[:, :nca_cfg.n_seed_channels]
        loss, logs = loss.detach(), {k: v.detach() for k, v in logs.items()}
        if mesh is not None:  # the global batch's mean, on every rank
            names = sorted(logs)
            vec = all_reduce_mean(torch.stack([loss] + [logs[k] for k in names]).float(),
                                  mesh.group(data_axis))
            loss, logs = vec[0], dict(zip(names, vec[1:]))
        return params, optimizer, new_states, loss, logs

    return train_step


@dataclasses.dataclass
class TrainLog:
    iteration: int
    loss: float  # a device scalar when sync=False
    logs: Dict[str, float]


class DyNCATrainer:
    """Host-side training loop mirroring the reference harness."""

    def __init__(self, nca_cfg: NCAConfig, loss_cfg: LossConfig,
                 train_cfg: TrainConfig, vgg_params=None, msoe_params=None,
                 seed: Optional[int] = None, device=None, mesh=None):
        """Parameters and pool seeds come from ``torch.Generator(seed)``
        (drawn on the CPU); batch indices and rollout lengths from
        ``np.random.RandomState(seed)``, as in the JAX trainer. ``mesh``: a
        ``parallel.mesh.Mesh`` whose first axis is the data axis — the
        trainer then runs data-parallel (see the module docstring); the
        batch and the pool must divide the axis size."""
        self.device = resolve_device(device)
        self.nca_cfg = nca_cfg
        self.train_cfg = train_cfg
        self.loss_state = LossState(cfg=loss_cfg, vgg_params=vgg_params,
                                    msoe_params=msoe_params, nca_cfg=nca_cfg)
        s = train_cfg.seed if seed is None else seed
        self.rng = np.random.RandomState(s)
        self.generator = torch.Generator().manual_seed(s)
        self.params = {k: v.requires_grad_()
                       for k, v in dynca_init(self.generator, nca_cfg, self.device).items()}
        self.optimizer = make_optimizer(self.params, train_cfg.lr,
                                        train_cfg.lr_decay_steps,
                                        train_cfg.lr_decay_gamma)
        self.pool = DevicePool(dynca_seed(nca_cfg, train_cfg.pool_size,
                                          train_cfg.img_size, self.generator,
                                          self.device))
        self.mesh = mesh
        if mesh is not None:
            axis = mesh.axis_names[0]
            n = mesh.size(axis)
            for name in ("batch_size", "pool_size"):
                if getattr(train_cfg, name) % n:
                    raise ValueError(f"{name} {getattr(train_cfg, name)} must divide evenly "
                                     f"over the {n}-rank '{axis}' mesh axis")
            replicate(self.params, mesh)
        self._train_step = self._make_step()
        self._seed_template = dynca_seed(nca_cfg, 1, train_cfg.img_size,
                                         self.generator, self.device)
        self.iteration = 0
        self.history: list = []

    def rebuild_loss(self, new_cfg: LossConfig) -> None:
        """Swap the loss weights (the video-motion calibration)."""
        self.loss_state = dataclasses.replace(self.loss_state, cfg=new_cfg)
        self._train_step = self._make_step()

    def _make_step(self):
        if self.mesh is None:
            return make_train_step(self.nca_cfg, self.loss_state, self.train_cfg.remat,
                                   self.train_cfg.rollout_path)
        axis = self.mesh.axis_names[0]
        return make_dp_train_step(
            make_train_step(self.nca_cfg, self.loss_state, self.train_cfg.remat,
                            self.train_cfg.rollout_path, mesh=self.mesh, data_axis=axis),
            self.mesh, axis)

    def sample_step_n(self) -> int:
        """Random rollout length snapped to the nearest bucket."""
        lo, hi = self.train_cfg.step_range
        raw = self.rng.randint(lo, hi)
        buckets = np.asarray(self.train_cfg.step_buckets)
        return int(buckets[np.argmin(np.abs(buckets - raw))])

    @spans.span("train.iteration")
    def train_iteration(self, inputs: Dict[str, torch.Tensor],
                        step_n: Optional[int] = None, n_motion_frames: int = 0,
                        tap_every: int = 0, tap_chunks=(), tail_steps: int = 0,
                        sync: bool = True,
                        mark: Optional[Callable[[str], None]] = None) -> TrainLog:
        """One training iteration. ``tap_chunks``/``tail_steps`` (see
        ``models.dynca.tap_schedule``) run the reference's tapped rollout,
        one frame a chunk plus a frameless tail; the legacy
        ``(n_motion_frames, tap_every)`` form rolls equal chunks.
        ``sync=False`` skips the host read of the loss (the NaN guard then
        fires on the next synced iteration); ``mark`` goes to the train step
        (see ``make_train_step``). The host's parts are spans
        (``utils.spans``): ``train.iteration`` the whole call, inside it
        ``train.pool_gather`` (the draw, the gather and the seed injection),
        the step's spans, ``train.pool_scatter`` and ``train.loss_read``."""
        tc = self.train_cfg
        i = self.iteration
        with spans.span("train.pool_gather"):
            idx = self.pool.sample_indices(self.rng, tc.batch_size)
            self.last_batch_idx = idx  # for anomaly recovery
            inject = bool(tc.inject_seed_every and i % tc.inject_seed_every == 0)
            step_n = step_n if step_n is not None else self.sample_step_n()

            states = self.pool.gather(idx)
            if inject:
                states = inject_seed_into_batch(states, self._seed_template)
        seed = int(torch.randint(0, 1 << 30, (), generator=self.generator))
        self.params, self.optimizer, new_states, loss, logs = self._train_step(
            self.params, self.optimizer, states, seed, inputs, step_n=step_n,
            n_motion_frames=n_motion_frames, tap_every=tap_every,
            tap_chunks=tuple(tap_chunks), tail_steps=tail_steps, mark=mark,
        )
        with spans.span("train.pool_scatter"):
            self.pool.scatter(idx, new_states)

        self.iteration += 1
        if not sync:
            return TrainLog(i, loss, logs)
        names = sorted(logs)
        with spans.span("train.loss_read"):
            vec = torch.stack([loss] + [logs[k] for k in names]).float().cpu().numpy()
        loss_f = float(vec[0])
        if not np.isfinite(loss_f):
            raise FloatingPointError(
                f"Loss is NaN/Inf at iteration {i}; training aborted"
            )
        log = TrainLog(i, loss_f, dict(zip(names, map(float, vec[1:]))))
        self.history.append(log)
        return log

    def reseed_pool_slots(self, idx: np.ndarray) -> None:
        """Anomaly recovery: replace diverged slots with fresh seeds."""
        self.pool.scatter(idx, dynca_seed(self.nca_cfg, len(idx), self.train_cfg.img_size,
                                          self.generator, self.device))
