"""What a per-layer metric's reader sees of a run."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class RunRecord:
    kind: str  # "serve" or "train"
    model: dict  # the configuration's "nca" group
    config: dict  # the whole configuration file
    traffic: dict
    device: dict
    window_s: float = 0.0
    frames: int = 0  # served frames delivered (summed over streams)
    ticks: int = 0  # stylizer calls (one frame of every stream)
    pixels_per_tick: int = 0  # streams x H x W
    launches: Optional[int] = None  # rollout launches over the window
    host_spans: List[float] = dataclasses.field(default_factory=list)
    iteration_flops: List[float] = dataclasses.field(default_factory=list)
    part_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None  # trace.summarize of the traced stretch
    trace_units: int = 0  # ticks inside the traced stretch
    trace_step_counts: List[int] = dataclasses.field(default_factory=list)
    notes: dict = dataclasses.field(default_factory=dict)  # the checks' details
    setup_phases: Dict[str, float] = dataclasses.field(default_factory=dict)


class Phases:
    """Seconds of each part of set-up, into ``RunRecord.setup_phases``: each
    call closes the part that began at the previous call (the first at
    ``t_start``, the process's start)."""

    def __init__(self, rec: RunRecord, t_start: float):
        self.rec, self.t = rec, t_start
        self("process start to harness")

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.rec.setup_phases[name] = now - self.t
        self.t = now
