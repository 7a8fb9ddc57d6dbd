"""The cells of ``BENCHMARK.json`` cut to sizes the CPU runs in seconds (the
program then runs its plain PyTorch path), for the benchmark's tests."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, size: int = 32):
    """The cell ``name`` at ``size``^2 and a few frames or steps."""
    from portbench.harness.spec import Cell, load_benchmark

    cell = Cell(load_benchmark(), name)
    if cell.traffic["kind"] == "serve":
        cell.traffic.update(size=size, distinct_frames=5, warmup_frames=3, start_frames=2,
                            sample_stride=3, max_samples=4, trace_frames=4,
                            trace_after_s=0.1)
        return cell
    train = cell.config["train"]
    train.update(img_size=[size, size], pool_size=8)
    if "tap_every" in train:
        train.update(step_range=[10, 14], step_buckets=[10, 14], tap_every=4, min_step_n=5)
        cell.traffic.update(target_video_frames=6, step_cycle=[10, 14, 14])
    else:
        train.update(step_range=[6, 10], step_buckets=[6, 10])
        cell.traffic.update(step_cycle=[6, 10, 10])
    cell.config["loss"]["motion_img_size"] = [size, size]
    cell.traffic.update(trace_after_s=0.1, trace_iterations=2)
    return cell


def run_tiny(cell, seed: int = 2 ** 31 + 5, seconds: float = 1.0, trace: bool = False,
             device: str = "cpu", make_system=None):
    """One run of a tiny cell: (record, e2e, checks, attempted, failed)."""
    import importlib
    import time

    harness = importlib.import_module(f"portbench.harness.{cell.traffic['kind']}")
    return harness.run(cell, seed, seconds, trace, time.perf_counter(), device,
                       make_system=make_system)


def correct(checks: dict, failed: int = 0) -> bool:
    return failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())


SERVE_CELLS = ("edge_stream_256", "edge_streams8_512")
TRAIN_CELLS = ("vm_train_256", "edge_train_256")
