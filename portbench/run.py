"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and per-layer metrics are
found by the names in ``BENCHMARK.json`` (``harness/spec.py``). With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read over a profiled stretch of the
window. The last line of standard output is the result; the numbers that
decided ``correct`` are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench.harness.result import finish
    from portbench.harness.spec import Cell, load_benchmark

    cell = Cell(load_benchmark(), args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    harness = importlib.import_module(f"portbench.harness.{cell.traffic['kind']}")
    rec, e2e, checks, attempted, failed = harness.run(
        cell, args.seed, args.seconds, bool(args.trace), T_START, "cuda")
    return finish(cell, rec, e2e, checks, attempted, failed, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
