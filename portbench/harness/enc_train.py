"""Encoder-conditioned training cells: ``ConditionedNCATrainer.train_iteration``
in the EncoderConditioning CLI's loop, fed as the CLI feeds it (a
``ConditioningDataset`` of goal images on the device, the style image, the
seeded VGG16, the device pool, the 'auto' route: the CUDA training pair on
a card), the loss read to the host every iteration.

Each iteration's step count, for both of its train steps, comes from the
mix's ``step_cycle`` (the buckets in the proportions the trainer's own draw
gives them), every cycle shuffled by the feed's ``RandomState``; the trainer
draws its pool rows and goal images itself.

Correctness (``reference/cnca_train_check.py``): set-up drives the trainer
through its first ``checked_steps`` iterations with the window's own call,
keeping each iteration's loss, the rows it wrote back to the pool, the
first train step's gradients as the optimizer receives them and the
parameters after each train step; one iteration at the largest step count warms up
the window's shapes, and the same trainer runs the window. After the window
the reference follows the checked iterations from the same seed and inputs.
"""

from __future__ import annotations

import math
import random
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts.cnca import iteration_flops
from portbench.harness import inputs
from portbench.harness.run_context import Phases, RunRecord
from portbench.harness.serve import device_info
from portbench.harness.trace import Stretch

PARTS = ("encode", "rollout forward", "loss forward", "loss backward", "rollout backward",
         "optimizer", "end")


def cnca_config(model: dict, train: dict):
    from vsnca_tpu_torch.config import ConditionedNCAConfig

    return ConditionedNCAConfig(image_size=train["img_size"][0], **model)


class ProgramEncTrainer:
    """The system under test: the port's ``ConditionedNCATrainer``, built as
    the encoder CLI builds it, with the run's weights."""

    def __init__(self, model, loss, train, params, vgg, seed, style, goals, device):
        from vsnca_tpu_torch.data.dataset import ConditioningDataset
        from vsnca_tpu_torch.train.encoder_trainer import ConditionedNCATrainer

        dataset = ConditioningDataset(goals.permute(0, 2, 3, 1).cpu().numpy(), device)
        self.trainer = ConditionedNCATrainer(
            cnca_config(model, train), dataset, style, vgg,
            nca_steps=tuple(train["step_range"]), step_buckets=tuple(train["step_buckets"]),
            lr=train["lr"], pool_size=train["pool_size"], num_damaged=train["num_damaged"],
            appearance_loss_type=loss["appearance_loss_type"],
            appearance_weight=loss["appearance_weight"], content_weight=loss["content_weight"],
            overflow_weight=loss["overflow_weight"], seed=seed, device_pool=True,
            rollout_path="auto", device=device)
        with torch.no_grad():
            for k, v in params.items():
                self.trainer.params[k].copy_(v)
        self.batch_size, self.pool_size = train["batch_size"], train["pool_size"]

    @property
    def params(self):
        return self.trainer.params

    def iteration(self, step_n: int, mark=None) -> float:
        # the rows the iteration writes back: the trainer draws them first
        # from its py_rng, so draw them from a copy of its state
        probe = random.Random()
        probe.setstate(self.trainer.py_rng.getstate())
        self.rows = probe.sample(range(self.pool_size), self.batch_size)
        return self.trainer.train_iteration(self.batch_size, num_steps=step_n, mark=mark)[0]

    def written_rows(self) -> torch.Tensor:
        t = self.trainer
        return t.pool_states[torch.as_tensor(self.rows, device=t.device)].clone()


def cnca_weights(g: torch.Generator, model: dict, device) -> dict:
    """torch's default convolution initialisation (the reference's
    ``nn.Conv2d``s): weights uniform in +-1/sqrt(fan_in), the update layers'
    biases zero, the encoder's first bias uniform in +-1/sqrt(fan_in)."""
    from portbench.reference.cnca_trainer import init_draw_shapes

    keys = ("perception_w", "update1.w", "update2.w", "update3.w", "encoder.embed1.w",
            "encoder.embed1.b", "encoder.embed2.w")
    shapes = dict(zip(keys, init_draw_shapes(model)))
    out = {}
    for key, shape in shapes.items():
        fan = math.prod(shapes[key.replace(".b", ".w")][1:])
        out[key] = (torch.rand(shape, generator=g, device=device) * 2 - 1) / math.sqrt(fan)
    for k in ("update1.w", "update2.w", "update3.w"):  # [out, in, 1, 1] -> [in, out]
        out[k] = out[k][:, :, 0, 0].T.contiguous()
    d = model["update_hidden_dim"]
    out["update1.b"] = torch.zeros(d, device=device)
    out["update2.b"] = torch.zeros(d, device=device)
    return out


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device,
        make_system: Optional[Callable] = None):
    """One run of an ``enc_train`` cell; returns (record, e2e, checks,
    attempted, failed). ``make_system`` replaces the program (the control,
    the fault tests)."""
    from portbench.reference import cnca_train_check
    from vsnca_tpu_torch.ops import fused_cnca

    tr, cfg = cell.traffic, cell.config
    model, loss, train = cfg["nca"], cfg["loss"], cfg["train"]
    h = train["img_size"][0]
    rec = RunRecord(kind="train", model=model, config=cfg, traffic=tr, device={})
    phase = Phases(rec, t_start)
    s_inputs, s_weights, s_nets, s_trainer, s_feed = inputs.sub_seeds(seed, 5)
    g_in = inputs.generator(s_inputs, device)
    style = (inputs.videos(g_in, 1, 1, h, tr["style"], device)[0] + 1.0) / 2.0
    style = style.permute(0, 3, 1, 2).contiguous()
    goals = (inputs.videos(g_in, 1, tr["goal_frames"], h, tr["style"], device)[:, 0] + 1.0) / 2.0
    goals = goals.permute(0, 3, 1, 2).contiguous()
    params = cnca_weights(inputs.generator(s_weights, device), model, device)
    vgg = inputs.vgg16_weights(inputs.generator(s_nets, device), device)
    kw = dict(model=model, loss=loss, train=train, params=params, vgg=vgg, seed=s_trainer,
              style=style, goals=goals, device=device)
    phase("inputs and weights")
    system = (make_system or ProgramEncTrainer)(**kw)
    phase("trainer and target features")
    feed_rng = np.random.RandomState(s_feed)
    cuda = torch.device(device).type == "cuda"
    cycle = []

    def next_steps() -> int:
        if not cycle:
            cycle.extend(feed_rng.permutation(tr["step_cycle"]).tolist())
        return int(cycle.pop())

    # the checked iterations: the window's own call, observed through its
    # mark hook: the first train step's gradients as the optimizer receives
    # them, and the parameters after each train step's update
    checked = []
    grads = {}

    def observe(name):
        if name == "optimizer" and not grads:
            grads.update({k: float(torch.linalg.vector_norm(p.grad))
                          for k, p in system.params.items()})
        if name == "end":
            checked[-1]["step_params"].append(
                {k: v.detach().clone() for k, v in system.params.items()})

    for _ in range(tr["checked_steps"]):
        checked.append({"step_n": next_steps(), "step_params": []})
        checked[-1]["loss"] = system.iteration(checked[-1]["step_n"], mark=observe)
        checked[-1]["rows"] = system.written_rows()
    phase("checked iterations")
    system.iteration(max(train["step_buckets"]))  # the window's largest shapes
    if cuda:
        torch.cuda.synchronize()
    phase("warm-up iteration")

    iteration_marks = []  # per iteration: each train step's events by part

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps = iteration_marks[-1]
        if not steps or "end" in steps[-1]:
            steps.append({})
        steps[-1][name] = ev

    failed = 0

    def one(traced=None):
        nonlocal failed
        step_n = next_steps()
        timed = trace and cuda and traced is None
        if timed:
            iteration_marks.append([])
        try:
            if traced is None:
                system.iteration(step_n, mark=mark if timed else None)
            else:  # name the host's part for the trace's idle gaps
                with record_function("portbench.iteration"):
                    system.iteration(step_n)
        except Exception:  # a failed iteration counts; the run goes on
            if not failed:
                traceback.print_exc()
            failed += 1
            if timed:
                iteration_marks.pop()
            return
        if traced is not None:
            traced.append(step_n)
            return
        rec.iteration_flops.append(iteration_flops(model, loss, train, step_n))

    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_at = t0 + min(tr["trace_after_s"], 0.25 * seconds)
    stretch, stretch_s, stretch_launches = None, 0.0, 0
    l0 = fused_cnca.LAUNCHES
    attempted = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if trace and stretch is None and now >= trace_at:
            # the profiled stretch: its iterations, launches and seconds are
            # left out of the window's per-layer metrics
            l1 = fused_cnca.LAUNCHES
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
            stretch_launches = fused_cnca.LAUNCHES - l1
            continue
        attempted += 1
        one()
    window_s = time.perf_counter() - t0
    rec.window_s = window_s - stretch_s
    rec.launches = fused_cnca.LAUNCHES - l0 - stretch_launches
    if cuda:
        torch.cuda.synchronize()
    for steps in iteration_marks:
        sums = {}
        for m in steps:
            names = [p for p in PARTS if p in m]
            for x, z in zip(names, names[1:]):
                sums[x] = sums.get(x, 0.0) + m[x].elapsed_time(m[z])
        for name, ms in sums.items():
            rec.part_ms.setdefault(name, []).append(ms)
    if stretch is not None:
        rec.trace = stretch.summarize()
    rec.device = device_info(device)
    del system
    if cuda:
        torch.cuda.empty_cache()
    checks = cnca_train_check.check(cell, kw, checked, grads, rec.notes)
    e2e = {"iters_per_s": (attempted - failed) / window_s, "setup_s": setup_s}
    return rec, e2e, checks, attempted, failed
