"""Readings for the limits of ``correct``: run a cell on many seeds in one
process and print, a line each, the numbers its comparison gives, for the
program, for the control (the reference put in the program's place one
precision step lower) or for the program with a planted fault
(``tools/faults.py``). On the card, from the root of a checkout:

    python3 portbench/tools/readings.py --workload edge_stream_256 \
        --seeds 11,12,13 --seconds 2 --system control

The lower reading of each limit is the largest the program gives over a
dozen seeds or more; the upper is the smallest the control gives.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--system", default="program",
                   choices=("program", "control", "fault-unchanged", "fault-half",
                            "fault-altered"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--stride", type=int, default=0,
                   help="a serving cell's sample stride, for a control too slow to reach "
                        "the cell's own in a short window")
    args = p.parse_args(argv)

    from portbench.harness.spec import Cell, load_benchmark
    from portbench.reference import control

    cell = Cell(load_benchmark(), args.workload)
    if args.stride:
        cell.traffic["sample_stride"] = args.stride
    kind = cell.traffic["kind"]
    harness = importlib.import_module(f"portbench.harness.{kind}")
    make = None
    if args.system == "control":
        make = control.serve_control() if kind == "serve" else control.train_control()
    elif args.system.startswith("fault-"):
        from portbench.tools import faults

        fault = args.system[len("fault-"):]
        if kind == "serve":
            make = faults.make_serving_fault(fault)
        else:
            make = faults.make_training_fault(fault)
            if fault == "half":
                from vsnca_tpu_torch.train import trainer

                trainer.make_loss_fn = faults.half_batch_loss(trainer.make_loss_fn)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rec, e2e, checks, attempted, failed = harness.run(
            cell, seed, args.seconds, False, t, args.device, make_system=make)
        print(json.dumps({"workload": args.workload, "system": args.system, "seed": seed,
                          "attempted": attempted, "failed": failed,
                          "checks": {k: v["value"] for k, v in checks.items()},
                          "e2e": e2e, "notes": rec.notes,
                          "setup_phases": rec.setup_phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
