"""Training cells: ``DyNCATrainer.train_iteration`` in the training CLI's
loop, the loss read to the host every iteration.

The feed is the CLI's, but for the step counts: each iteration takes its
step count from the mix's ``step_cycle`` (the buckets in the proportions the
trainer's own draw gives them), every cycle in an order shuffled by the
feed's ``RandomState``, so that every seed asks the same work of a window;
the trainer's draw would give each seed a different mean step count. Where
the configuration taps frames, they come after steps 1, 1 + tap_every, ...
Then, from the same ``RandomState``, a batch of content frames with
replacement (the auxiliary and edge-conditioned presets) or the start of the
target video's window (video motion). The style image's VGG16 features and
the target video's MSOE features are computed once, as the CLI does.

Correctness (``reference/train_check.py``): set-up builds the trainer and
drives it through its first ``checked_steps`` iterations with the window's
own call and feed, keeping each iteration's loss, the rows it wrote back to
the pool, the first iteration's gradients as the optimizer receives them
and the parameters after the last; then one iteration at the largest step
count warms up the window's shapes, and the same trainer runs the window.
After the window the reference follows the checked iterations from the same
seed and inputs.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts.training import iteration_flops
from portbench.harness import inputs
from portbench.harness.run_context import Phases, RunRecord
from portbench.harness.serve import device_info
from portbench.harness.trace import Stretch

PARTS = ("rollout forward", "loss forward", "loss backward", "rollout backward",
         "optimizer", "end")
TRAIN_FIELDS = ("img_size", "batch_size", "pool_size", "step_range", "step_buckets",
                "inject_seed_every", "lr", "lr_decay_steps", "lr_decay_gamma")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class ProgramTrainer:
    """The system under test: the port's ``DyNCATrainer`` fed as the
    training CLI feeds it."""

    def __init__(self, model, loss, train, params, vgg, msoe, seed, style, target_video,
                 device):
        from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
        from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
        from vsnca_tpu_torch.losses.video_motion import precompute_target_motion_features
        from vsnca_tpu_torch.train.trainer import DyNCATrainer

        loss_cfg = LossConfig(**_tuples(loss))
        train_cfg = TrainConfig(**_tuples({k: train[k] for k in TRAIN_FIELDS}))
        self.trainer = DyNCATrainer(NCAConfig(**_tuples(model)), loss_cfg, train_cfg,
                                    vgg_params=vgg, msoe_params=msoe, seed=seed,
                                    device=device)
        with torch.no_grad():
            for k, v in params.items():
                self.trainer.params[k].copy_(v)
        self.style = style
        self.style_feats = (precompute_target_style_features(vgg, style, loss_cfg.appearance_loss_type,
                                                             train_cfg.img_size)
                            if loss_cfg.appearance_weight else None)
        self.motion_feats = (precompute_target_motion_features(msoe, target_video,
                                                               loss_cfg.motion_img_size)
                             if loss_cfg.video_motion_weight else None)

    @property
    def params(self):
        return self.trainer.params

    def iteration(self, feed, step_n, chunks=(), tail=0, mark=None) -> float:
        inputs_ = {"target_style": self.style}
        if self.style_feats is not None:
            inputs_["target_style_features"] = self.style_feats
        if "aux" in feed:
            inputs_["aux_imgs"] = feed["aux"]
            inputs_["aux_gs"] = feed["aux"].mean(dim=1, keepdim=True)
        kw = {"step_n": step_n}
        if "window" in feed:
            start, nf = feed["window"]
            inputs_["target_motion_features"] = self.motion_feats[start:start + nf - 1]
            kw.update(tap_chunks=tuple(chunks), tail_steps=tail)
        return self.trainer.train_iteration(inputs_, sync=True, mark=mark, **kw).loss

    def written_rows(self) -> torch.Tensor:
        pool = self.trainer.pool.states
        return pool[torch.as_tensor(self.trainer.last_batch_idx, device=pool.device)].clone()


def tap_plan(step_n: int, every: int):
    """Frames after steps 1, 1 + every, ... <= step_n, then a frameless
    tail: (chunks, tail)."""
    steps = list(range(1, step_n + 1, every))
    return tuple([steps[0]] + [b - a for a, b in zip(steps, steps[1:])]), step_n - steps[-1]


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device,
        make_system: Optional[Callable] = None):
    """One run of a training cell; returns (record, e2e, checks, attempted,
    failed). ``make_system`` replaces the program (the control, the fault
    tests)."""
    from portbench.reference import train_check

    tr, cfg = cell.traffic, cell.config
    model, loss, train = cfg["nca"], cfg["loss"], cfg["train"]
    b, (h, w) = train["batch_size"], train["img_size"]
    rec = RunRecord(kind="train", model=model, config=cfg, traffic=tr, device={})
    phase = Phases(rec, t_start)
    s_inputs, s_weights, s_nets, s_trainer, s_feed = inputs.sub_seeds(seed, 5)
    g_in = inputs.generator(s_inputs, device)
    style = inputs.videos(g_in, 1, 1, h, tr["style"], device)[0]
    style = style.permute(0, 3, 1, 2).repeat(b, 1, 1, 1).contiguous()
    tapped = "tap_every" in train
    content = target_video = None
    if "content_frames" in tr:
        content = inputs.videos(g_in, 1, tr["content_frames"], h, tr["style"], device)[:, 0]
        content = content.permute(0, 3, 1, 2).contiguous()
    if tapped:
        target_video = inputs.videos(g_in, 1, tr["target_video_frames"], h, tr["style"],
                                     device)[:, 0].permute(0, 3, 1, 2).contiguous()
    params = inputs.dynca_weights(inputs.generator(s_weights, device), model, device)
    g_nets = inputs.generator(s_nets, device)
    vgg = inputs.vgg16_weights(g_nets, device)
    msoe = inputs.msoe_weights(g_nets, device) \
        if loss.get("vector_field_motion_weight") or loss.get("video_motion_weight") else None
    kw = dict(model=model, loss=loss, train=train, params=params, vgg=vgg, msoe=msoe,
              seed=s_trainer, style=style, target_video=target_video, device=device)
    phase("inputs and weights")
    system = (make_system or ProgramTrainer)(**kw)
    phase("trainer and target features")
    feed_rng = np.random.RandomState(s_feed)
    cuda = torch.device(device).type == "cuda"

    cycle = []

    def next_feed(step_n=None):
        if step_n is None:
            if not cycle:
                cycle.extend(feed_rng.permutation(tr["step_cycle"]).tolist())
            step_n = int(cycle.pop())
        if tapped:
            step_n = max(step_n, train["min_step_n"])
            chunks, tail = tap_plan(step_n, train["tap_every"])
            start = int(feed_rng.randint(0, max(target_video.shape[0] - len(chunks), 1)))
            return {"window": (start, len(chunks))}, step_n, chunks, tail
        idx = feed_rng.choice(content.shape[0], b, replace=True)
        return {"aux": content[torch.as_tensor(idx, device=content.device)]}, step_n, (), 0

    # the checked iterations: the window's own call and feed
    checked = []
    grads = {}

    def grab(name):
        if name == "optimizer" and not grads:
            grads.update({k: float(torch.linalg.vector_norm(p.grad))
                          for k, p in system.params.items()})

    for j in range(tr["checked_steps"]):
        feed, step_n, chunks, tail = next_feed()
        value = system.iteration(feed, step_n, chunks, tail, mark=grab if j == 0 else None)
        checked.append({"feed": feed, "step_n": step_n, "chunks": chunks, "tail": tail,
                        "loss": value, "rows": system.written_rows(),
                        "params": {k: v.detach().clone() for k, v in system.params.items()}})
    phase("checked iterations")
    # warm-up at the largest step count: the window's largest shapes
    biggest = max(train["step_buckets"])
    system.iteration(*next_feed(biggest))
    if cuda:
        torch.cuda.synchronize()
    phase("warm-up iteration")
    marks = []
    parts = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        parts[name] = ev
        if name == "end":
            marks.append(dict(parts))

    failed = 0

    def one(traced=None):
        nonlocal failed
        feed, step_n, chunks, tail = next_feed()
        try:
            if traced is None:
                system.iteration(feed, step_n, chunks, tail, mark=mark if trace and cuda else None)
            else:  # name the host's part for the trace's idle gaps
                with record_function("portbench.iteration"):
                    system.iteration(feed, step_n, chunks, tail)
        except Exception:  # a failed iteration counts; the run goes on
            if not failed:
                traceback.print_exc()
            failed += 1
            return
        if traced is not None:
            traced.append(step_n)
            return
        rec.iteration_flops.append(iteration_flops(model, loss, b, h, w, step_n,
                                                   max(len(chunks), 1)))

    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_at = t0 + min(tr["trace_after_s"], 0.25 * seconds)
    stretch, stretch_s = None, 0.0
    attempted = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if trace and stretch is None and now >= trace_at:
            # the profiled stretch: its iterations and seconds are left out of
            # the window's per-layer metrics
            stretch = Stretch()
            stretch.start()
            with stretch.span():
                for _ in range(tr["trace_iterations"]):
                    attempted += 1
                    one(rec.trace_step_counts)
            if cuda:
                torch.cuda.synchronize()
            stretch.stop()
            stretch_s = time.perf_counter() - now
            continue
        attempted += 1
        one()
    window_s = time.perf_counter() - t0
    rec.window_s = window_s - stretch_s
    if cuda:
        torch.cuda.synchronize()
    for m in marks:
        for a, z in zip(PARTS, PARTS[1:]):
            rec.part_ms.setdefault(a, []).append(m[a].elapsed_time(m[z]))
    if stretch is not None:
        rec.trace = stretch.summarize()
    rec.device = device_info(device)
    del system
    if cuda:
        torch.cuda.empty_cache()
    checks = train_check.check(cell, kw, checked, grads, rec.notes)
    e2e = {"iters_per_s": (attempted - failed) / window_s, "setup_s": setup_s}
    return rec, e2e, checks, attempted, failed
