"""Benchmark harness: steps/sec, cell-updates/sec, stylized frames/sec,
train iterations/sec.

Counterpart of ``vsnca_tpu/infer/benchmark.py``, with the same functions and
the same keys in what they return. On a card the times come from CUDA events
around the timed calls (the JAX package fetched one element to the host as
its fence, a workaround for its TPU backend); on the CPU from the host clock,
since CPU work is done when a call returns. Every function runs on ``cuda``
unless ``device`` names another, and says nothing of a device it did not run
on: a CPU time is a time of PyTorch's CPU kernels.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.models.dynca import (
    dynca_init,
    dynca_rollout,
    dynca_seed,
    make_conditioning,
)


def _seconds(dev: torch.device, fn: Callable[[], object]) -> float:
    """Seconds ``fn()`` takes: CUDA events around it on a card (then a
    synchronize), the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / 1e3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit_chained(dev, step, x0, warmup: int = 2, iters: int = 10) -> float:
    """Average seconds per call of ``x = step(x)``, the calls chained through
    their data dependency."""
    x = x0
    for _ in range(warmup):
        x = step(x)
    _sync(dev)
    box = [x]

    def run():
        for _ in range(iters):
            box[0] = step(box[0])

    return _seconds(dev, run) / iters


def _setup(cfg: NCAConfig, size: int, batch: int, dev: torch.device):
    """Params (seed 0), seed states with any extra channel zeroed, and the
    conditioning (edges of a zero image), as the JAX harness sets them up."""
    params = dynca_init(torch.Generator().manual_seed(0), cfg, dev)
    x = dynca_seed(cfg, batch, size, generator=torch.Generator().manual_seed(0), device=dev)
    if cfg.n_seed_channels < cfg.c_in:
        x = torch.cat([x, x.new_zeros((batch, cfg.c_in - cfg.n_seed_channels, size, size))],
                      dim=1)
    gray = torch.zeros((batch, 1, size, size), device=dev)
    cond = make_conditioning(cfg, (size, size),
                             cond_img=gray if cfg.conditioning == "edges" else None,
                             batch=batch, device=dev)
    return params, x, cond


def benchmark_rollout(
    nca_cfg: Optional[NCAConfig] = None,
    size: int = 256,
    batch: int = 1,
    n_steps: int = 96,
    step_n_per_frame: int = 24,
    iters: int = 10,
    device=None,
) -> Dict[str, float]:
    """Benchmark the inference rollout (``dynca_rollout`` without a
    gradient: the rollout kernels on a card); returns a metrics dict.

    cell_updates_per_sec counts B*H*W*steps; frames_per_sec assumes
    ``step_n_per_frame`` NCA steps per stylized output frame (the
    reference's nca_base_num_steps=24)."""
    dev = resolve_device(device)
    cfg = nca_cfg or NCAConfig(c_in=12, fc_dim=96, conditioning="pos_emb")
    params, x, cond = _setup(cfg, size, batch, dev)

    @torch.no_grad()
    def step(x):
        return dynca_rollout(params, x, 0, cfg, n_steps, cond)[0]

    t = _timeit_chained(dev, step, x, iters=iters)
    steps_per_sec = n_steps / t
    return {
        "size": size,
        "batch": batch,
        "n_steps": n_steps,
        "sec_per_rollout": t,
        "ms_per_step": 1000.0 * t / n_steps,
        "steps_per_sec": steps_per_sec,
        "cell_updates_per_sec": steps_per_sec * batch * size * size,
        "frames_per_sec": steps_per_sec / step_n_per_frame,
    }


def benchmark_stages(
    nca_cfg: Optional[NCAConfig] = None,
    size: int = 256,
    batch: int = 1,
    iters: int = 20,
    device=None,
) -> Dict[str, float]:
    """Per-stage breakdown (the browser's ca.benchmark() Perception / FC /
    Stochastic-Update timings, docs/dynca.js:1134-1190): each stage alone in
    eager PyTorch, ``iters`` calls, ms per call."""
    from vsnca_tpu_torch.ops.perception import perceive_multiscale

    dev = resolve_device(device)
    cfg = nca_cfg or NCAConfig(c_in=12, fc_dim=96)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, dev)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((batch, cfg.c_in, size, size), generator=g) - 0.5).to(dev)
    mask_noise = torch.rand((batch, 1, size, size), generator=g).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False

    def percept(x):
        return perceive_multiscale(x, cfg.perception_scales, cfg.padding_mode)

    def fc(y):
        h = torch.relu(torch.einsum("bfhw,fd->bdhw", y, params["w1"][: y.shape[1]])
                       + params["b1"][:, None, None])
        return torch.einsum("bdhw,dc->bchw", h, params["w2"]) + params["b2"][:, None, None]

    def update(x):
        return x + x * torch.floor(mask_noise + 0.5)

    def timed_fixed(fn, arg):
        fn(arg)
        _sync(dev)

        def run():
            for _ in range(iters):
                fn(arg)

        return _seconds(dev, run) / iters

    with torch.no_grad():
        y0 = percept(x)
        return {
            "size": size,
            "perception_ms": 1000 * timed_fixed(percept, x),
            "fc_ms": 1000 * timed_fixed(fc, y0),
            "stochastic_update_ms": 1000 * timed_fixed(update, x),
        }


def profile_rollout(
    log_dir: str,
    nca_cfg: Optional[NCAConfig] = None,
    size: int = 256,
    n_steps: int = 96,
    device=None,
) -> str:
    """A ``torch.profiler`` trace of one rollout (after a warm-up one),
    written as a Chrome trace to ``log_dir/rollout_trace.json``; returns
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    cfg = nca_cfg or NCAConfig(c_in=12, fc_dim=96)
    params, x, cond = _setup(cfg, size, 1, dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                           else [])
    with torch.no_grad():
        dynca_rollout(params, x, 1, cfg, n_steps, cond)
        _sync(dev)
        with profile(activities=activities) as prof:
            dynca_rollout(params, x, 1, cfg, n_steps, cond)
            _sync(dev)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "rollout_trace.json"))
    return log_dir


def benchmark_serving(
    nca_cfg: Optional[NCAConfig] = None,
    size: int = 256,
    n_streams: int = 8,
    step_n: int = 24,
    n_frames: int = 12,
    device=None,
) -> Dict[str, float]:
    """Multi-stream serving throughput: one ``VideoStylizer`` whose
    persistent state is batched over ``n_streams`` independent streams (e.g.
    concurrent webcam sessions), one frame of each stream a call. Reports
    aggregate and per-stream frames/s."""
    from vsnca_tpu_torch.infer.stylize import VideoStylizer

    dev = resolve_device(device)
    cfg = nca_cfg or NCAConfig(c_in=12, fc_dim=96, padding_mode="circular",
                               conditioning="edges")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, dev)
    styl = VideoStylizer(params, cfg, size, step_n=step_n, device=dev)
    styl.state = styl.state.repeat(n_streams, 1, 1, 1)
    frame = torch.zeros((n_streams, size, size, 3), device=dev)
    styl.step_frame(frame)
    _sync(dev)

    def run():
        for _ in range(n_frames):
            styl.step_frame(frame)

    dt = _seconds(dev, run) / n_frames
    return {
        "size": size,
        "n_streams": n_streams,
        "aggregate_fps": n_streams / dt,
        "per_stream_fps": 1.0 / dt,
        "ms_per_batched_frame": 1000 * dt,
    }


def benchmark_train_step(
    preset: str = "static_texture",
    iters: int = 5,
    step_n: Optional[int] = None,
    img_size: Optional[int] = None,
    rollout_path: Optional[str] = None,
    precompute_targets: bool = False,
    reference_shape: bool = True,
    loss_overrides: Optional[dict] = None,
    device=None,
) -> Dict[str, float]:
    """One full training iteration (rollout + loss + backward + update) of a
    preset, as ``DyNCATrainer.train_iteration`` runs it; the minimum over 2
    rounds of ``iters`` iterations, after 2 warm-up ones. Presets with a
    video-motion term get a synthetic target window and tapped frames: with
    ``reference_shape`` the reference's schedule (step_n steps, frames after
    steps 1, 65, ...; fit_video_motion.py:229-235), else 3 equal chunks of
    step_n // 2. ``rollout_path`` overrides TrainConfig.rollout_path,
    ``precompute_targets`` computes the target's VGG16 / MSOE features once,
    ``loss_overrides`` replaces fields of the preset's LossConfig. The
    conditioned presets (edges, an extra content channel or an auxiliary
    term) get a fixed batch of content frames, the synthetic style image
    of seed 7, and its channel-mean grayscale."""
    from vsnca_tpu_torch.data.preprocess import synthetic_style_image
    from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
    from vsnca_tpu_torch.losses.video_motion import precompute_target_motion_features
    from vsnca_tpu_torch.models.dynca import tap_schedule
    from vsnca_tpu_torch.models.msoe import load_msoe
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.presets import PRESETS
    from vsnca_tpu_torch.train.trainer import DyNCATrainer

    dev = resolve_device(device)
    nca_cfg, loss_cfg, train_cfg = PRESETS[preset](
        **({} if img_size is None else {"img_size": img_size}))
    if rollout_path is not None:
        train_cfg = dataclasses.replace(train_cfg, rollout_path=rollout_path)
    if loss_overrides:
        loss_cfg = dataclasses.replace(loss_cfg, **loss_overrides)
    vgg, _ = load_vgg16(device=dev)
    msoe = None
    if loss_cfg.vector_field_motion_weight or loss_cfg.video_motion_weight:
        msoe, _ = load_msoe(device=dev)
    trainer = DyNCATrainer(nca_cfg, loss_cfg, train_cfg, vgg_params=vgg,
                           msoe_params=msoe, device=dev)
    style = torch.from_numpy(
        synthetic_style_image(train_cfg.img_size, train_cfg.batch_size) * 2 - 1
    ).permute(0, 3, 1, 2).contiguous().to(dev)
    inputs = {"target_style": style}
    if (nca_cfg.conditioning == "edges" or nca_cfg.n_seed_channels < nca_cfg.c_in
            or loss_cfg.auxiliary_weight):
        aux = torch.from_numpy(
            synthetic_style_image(train_cfg.img_size, train_cfg.batch_size, seed=7) * 2 - 1
        ).permute(0, 3, 1, 2).contiguous().to(dev)
        inputs["aux_imgs"] = aux
        inputs["aux_gs"] = aux.mean(dim=1, keepdim=True)
    if step_n is None:
        step_n = train_cfg.step_buckets[len(train_cfg.step_buckets) // 2]

    kwargs = {"step_n": step_n}
    n_motion_frames = 0
    if loss_cfg.video_motion_weight:
        if reference_shape:
            chunks, tail = tap_schedule(step_n, 64)
            n_motion_frames = len(chunks)
            kwargs.update(tap_chunks=chunks, tail_steps=tail)
        else:
            n_motion_frames = 3
            kwargs.update(n_motion_frames=3, tap_every=max(step_n // 2, 1))
        inputs["target_motion_frames"] = torch.stack(
            [style + 0.01 * k for k in range(n_motion_frames)])

    if precompute_targets:
        if loss_cfg.appearance_weight:
            inputs["target_style_features"] = precompute_target_style_features(
                vgg, style, loss_cfg.appearance_loss_type, train_cfg.img_size)
        if loss_cfg.video_motion_weight:
            window = torch.stack([style[0] + 0.01 * k for k in range(n_motion_frames)])
            feats = precompute_target_motion_features(msoe, window,
                                                      loss_cfg.motion_img_size)
            if feats is not None:
                inputs["target_motion_features"] = feats
                del inputs["target_motion_frames"]

    # warm-up: the seed-injecting iteration 0 and a plain one
    trainer.train_iteration(inputs, **kwargs)
    trainer.train_iteration(inputs, **kwargs)
    _sync(dev)

    def run():
        for k in range(iters):
            trainer.train_iteration(inputs, sync=(k == iters - 1), **kwargs)

    dt = min(_seconds(dev, run) / iters for _ in range(2))
    return {
        "preset": preset,
        "sec_per_train_iter": dt,
        "train_iters_per_sec": 1.0 / dt,
        "step_n": step_n,
    }
