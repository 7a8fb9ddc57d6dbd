"""The traced stretch: ``torch.profiler`` over a bounded part of the window,
reduced to device busy time, device time by kernel name and the host's work
during the device's idle gaps. The trace of the stretch goes to a temporary
file under ``TMPDIR`` and is deleted once read; no trace of a whole window
is ever written."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "portbench.stretch"


class Stretch:
    """Profiles what runs between ``start()`` and ``stop()``; the caller
    wraps the stretch's own work in ``torch.profiler.record_function(STRETCH)``
    via ``span()``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.summary = None

    def start(self):
        self._prof.__enter__()

    def span(self):
        from torch.profiler import record_function

        return record_function(STRETCH)

    def stop(self):
        self._prof.__exit__(None, None, None)

    def summarize(self):
        """Read the stretch's trace (after the window: exporting it takes
        seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = summarize(events)
        return self.summary


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: list) -> Dict:
    """busy_s, window_s, device seconds by name and the idle time by the
    host's innermost span at each gap (all within the stretch's span)."""
    stretch = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch span")
    lo = min(e["ts"] for e in stretch)
    hi = max(e["ts"] + e["dur"] for e in stretch)
    dev, host = [], []
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b))
            by_name[e["name"]] += (b - a) * 1e-6
        elif e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver") \
                and e.get("name") != STRETCH:
            host.append((a, b, e["name"]))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    t = lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    idle_by: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "(no host op)"
        idle_by[label] += (b - a) * 1e-6
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_s, "device_by_name": dict(by_name),
            "idle_by_host": dict(idle_by)}


def breakdown(summary: Dict) -> Dict:
    top = sorted(summary["device_by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}


def device_seconds(summary: Dict, parts) -> float:
    """Device seconds of the operations whose names hold any of ``parts``
    (a kernel's trace name is its demangled C++ signature)."""
    return sum(v for k, v in summary["device_by_name"].items()
               if any(p in k for p in parts))
