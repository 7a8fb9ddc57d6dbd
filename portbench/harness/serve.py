"""Serving cells: closed-loop live stylization through ``VideoStylizer``.

Each tick hands the stylizer one host float32 content frame of every stream
([S, H, W, 3] in [-1, 1], as a decoder would give it), and copies the RGB
it returns to host memory, as ``stylize_frames`` does. The next tick starts
when that copy is done. The latency of a tick is taken by CUDA events on the
stream, recorded before the frame is handed over and after its RGB reached
the host: the device's clock, which the host paces in a closed loop.

Correctness (``reference/serve_check.py``): a sample of the window's ticks,
drawn from the seed by a stride and an offset, keeps the state the tick
started from, the state it left and the RGB it delivered; after the window
the reference steps each from the program's own starting state, and the
first ``start_frames`` ticks are followed from the seed state by the
reference alone.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import inputs
from portbench.harness.result import p95
from portbench.harness.run_context import Phases, RunRecord
from portbench.harness.trace import Stretch

EVENT_RING = 64


def program_stylizer(params, model: dict, serve: dict, size: int, streams: int, device):
    """The system under test: the port's stylizer, its state batched over
    the streams as ``infer.benchmark.benchmark_serving`` batches it."""
    from vsnca_tpu_torch.config import NCAConfig
    from vsnca_tpu_torch.infer.stylize import VideoStylizer

    cfg = NCAConfig(**{**model, "perception_scales": tuple(model["perception_scales"])})
    styl = VideoStylizer(params, cfg, size, step_n=serve["step_n"], device=device,
                         compute_dtype=serve["compute_dtype"])
    if streams > 1:
        styl.state = styl.state.repeat(streams, 1, 1, 1)
    return styl


def launches() -> int:
    from vsnca_tpu_torch.ops import fused_step

    return fused_step.LAUNCHES


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device,
        make_system: Optional[Callable] = None):
    """One run of a serving cell; returns (record, e2e, checks, attempted,
    failed). ``make_system`` replaces the program (the control, the fault
    tests)."""
    from portbench.reference import serve_check

    tr, model, cfg = cell.traffic, cell.config["nca"], cell.config
    serve = cfg["serve"]
    size, streams, n_distinct = tr["size"], tr["streams"], tr["distinct_frames"]
    rec = RunRecord(kind="serve", model=model, config=cfg, traffic=tr, device={},
                    pixels_per_tick=streams * size * size)
    phase = Phases(rec, t_start)
    s_content, s_weights, s_sample = inputs.sub_seeds(seed, 3)
    params = inputs.served_weights(inputs.generator(s_weights, device), model,
                                   cfg["serve_weights"], device)
    host_frames = inputs.videos(inputs.generator(s_content, device), streams, n_distinct,
                                size, tr["content"], device).cpu().numpy()
    phase("inputs and weights")
    make = make_system or program_stylizer
    styl = make(params, model, serve, size, streams, device)
    phase("stylizer")
    cuda = torch.device(device).type == "cuda"

    def frame_of(k: int) -> np.ndarray:  # tick k (1-based) shows frame k - 1 of the cycle
        return host_frames[(k - 1) % n_distinct]

    # warm-up: every shape of the window, the first ticks kept for the start check
    k = 0
    start = None
    for _ in range(tr["warmup_frames"]):
        k += 1
        rgb = styl.step_frame(frame_of(k)).cpu().numpy()
        if k == tr["start_frames"]:
            start = (k, styl.state, rgb)
    stride, cap = tr["sample_stride"], tr["max_samples"]
    offset = int(np.random.RandomState(s_sample).randint(stride))
    # cache blocks for the states the samples will hold, so the window
    # allocates from the cache
    spare = [torch.empty_like(styl.state) for _ in range(2 * cap + 4)]
    del spare
    ring = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(EVENT_RING)] if cuda else None
    if cuda:
        torch.cuda.synchronize()
    phase("warm-up ticks")
    latencies, samples, spans = [], [], []
    host_t = []
    raised = [0]

    def tick(k: int, profiled: bool = False):
        frame = frame_of(k)
        keep = (k - offset) % stride == 0 and len(samples) < cap
        prev = styl.state if keep else None
        if cuda:
            e0, e1 = ring[k % EVENT_RING]
            if k >= EVENT_RING + first:
                latencies.append(e0.elapsed_time(e1))
            e0.record()
        else:
            t0 = time.perf_counter()
        if profiled:  # name the host's parts for the trace's idle gaps
            with record_function("portbench.step_frame"):
                out = styl.step_frame(frame)
            with record_function("portbench.readout"):
                rgb = out.cpu().numpy()
        elif trace:
            h0 = time.perf_counter()
            out = styl.step_frame(frame)
            spans.append(time.perf_counter() - h0)
            rgb = out.cpu().numpy()
        else:
            out = styl.step_frame(frame)
            rgb = out.cpu().numpy()
        if cuda:
            e1.record()
        else:
            host_t.append(time.perf_counter() - t0)
        if keep:
            samples.append((k, prev, styl.state, rgb))

    first = k + 1
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_at = t0 + min(tr["trace_after_s"], 0.25 * seconds)
    stretch, stretch_s, stretch_launches, stretch_ticks = None, 0.0, 0, 0
    l0 = launches()
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if trace and stretch is None and now >= trace_at:
            # the profiled stretch: its ticks, launches and seconds are left
            # out of the window's per-layer metrics
            l1 = launches()
            stretch = Stretch()
            stretch.start()
            with stretch.span():
                for _ in range(tr["trace_frames"]):
                    k += 1
                    tick(k, profiled=True)
            if cuda:
                torch.cuda.synchronize()
            stretch.stop()
            stretch_s = time.perf_counter() - now
            stretch_launches = launches() - l1
            stretch_ticks = tr["trace_frames"]
            continue
        k += 1
        try:
            tick(k)
        except Exception:  # a tick that raises is a failed tick; the run goes on
            if not raised[0]:
                traceback.print_exc()
            raised[0] += 1
    window_s = time.perf_counter() - t0
    ticks = k - first + 1
    if cuda:
        torch.cuda.synchronize()
        for j in range(max(first, k - EVENT_RING + 1), k + 1):
            e0, e1 = ring[j % EVENT_RING]
            latencies.append(e0.elapsed_time(e1))
    else:
        latencies = [t * 1e3 for t in host_t]
    rec.launches = launches() - l0 - stretch_launches
    rec.window_s = window_s - stretch_s
    rec.ticks = ticks - stretch_ticks
    rec.frames = rec.ticks * streams
    rec.host_spans = spans
    if stretch is not None:
        rec.trace = stretch.summarize()
        rec.trace_units = stretch_ticks
    rec.device = device_info(device)
    final_state = styl.state
    del styl

    failed = raised[0] * streams
    finite = torch.isfinite(final_state).flatten(1).all(dim=1)
    if not bool(finite.all()):
        # a non-finite state never heals (x + dx * mask keeps a NaN), so
        # every tick after the last finite sampled state may have failed
        last_ok = max([s[0] for s in samples if bool(torch.isfinite(s[2]).all())],
                      default=first - 1)
        failed = (k - last_ok) * int((~finite).sum())
    del final_state
    checks = serve_check.check(cell, params, start, samples, frame_of, device,
                               serve_check.operand_of(serve["compute_dtype"]))
    e2e = {"frames_per_s": ticks * streams / window_s,
           "frame_p95_ms": p95(latencies) if len(latencies) > 1 else float("nan"),
           "setup_s": setup_s}
    return rec, e2e, checks, ticks * streams, failed


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
