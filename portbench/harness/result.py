"""The end of a run: the check that no JAX module was loaded, the metrics the
cell reports, and the result line."""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from typing import Dict, Optional

from portbench.harness.spec import metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "vsnca_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that no run may load, compared whole
    (``vsnca_tpu_torch`` is the port, ``vsnca_tpu`` the JAX package)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def p95(values) -> float:
    return statistics.quantiles(values, n=20)[18]


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def finish(cell, run, e2e: Dict[str, float], checks: Dict[str, Dict], attempted: int,
           failed: int, trace: bool) -> int:
    """Print the stderr lines and the result line; returns the exit code."""
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    correct = failed == 0 and bool(checks) and all(
        not math.isnan(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    device = dict(run.device)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        from portbench.harness.trace import breakdown

        device["power_limit"] = power_limit()
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in run.setup_phases.items()),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
