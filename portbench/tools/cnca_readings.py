"""Readings for the limits of ``correct`` in an ``enc_train`` cell: run the
cell on many seeds in one process and print, a line each, the numbers its
comparison gives, for the program, for the control (the reference with TF32
on in the program's place) or for the program with a planted fault
(``tools/cnca_faults.py``). On the card, from the root of a checkout:

    python3 portbench/tools/cnca_readings.py --workload enc_train_64_b8 \
        --seeds 11,12,13 --seconds 2 --system control

The lower reading of each limit is the largest the program gives over a
dozen seeds or more; the upper is the smallest the control gives.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    from portbench.tools.cnca_faults import FAULTS

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--system", default="program",
                   choices=("program", "control") + tuple(f"fault-{f}" for f in FAULTS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench.harness import enc_train
    from portbench.harness.spec import Cell, load_benchmark

    cell = Cell(load_benchmark(), args.workload)
    make = None
    if args.system == "control":
        from portbench.reference.cnca_control import enc_train_control

        make = enc_train_control()
    elif args.system.startswith("fault-"):
        from portbench.tools.cnca_faults import make_enc_training_fault

        make = make_enc_training_fault(args.system[len("fault-"):])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rec, e2e, checks, attempted, failed = enc_train.run(
            cell, seed, args.seconds, False, t, args.device, make_system=make)
        print(json.dumps({"workload": args.workload, "system": args.system, "seed": seed,
                          "attempted": attempted, "failed": failed,
                          "checks": {k: v["value"] for k, v in checks.items()},
                          "e2e": e2e, "notes": rec.notes,
                          "memory_peak_bytes": rec.device.get("memory_peak_bytes"),
                          "setup_phases": rec.setup_phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
