"""The comparison that decides ``correct`` in a training cell.

The reference (``reference.trainer.ReferenceTrainer``) is built from the same
seed, weights and inputs as the program's trainer and follows its checked
iterations: it draws its own batch rows and iteration seeds by the
trainer's protocol and is handed the same feed and step counts. Four
numbers, each against its limit in ``limits/<cell>.json``:

- ``loss_gap``: the first checked iteration's |loss - reference loss| /
  |reference loss|.
- ``grad_gap``: the first iteration's gradient as the optimizer receives it,
  by the worst parameter tensor: |norm - reference norm| over the larger of
  the reference's norm of that tensor and of the median tensor.
- ``change_gap``: the parameters' change over the checked iterations, by
  the worst tensor in the same way. Tensors whose reference gradient is
  under a thousandth of the median tensor's are left out of both.
- ``pool_gap``: the states the first iteration wrote back to the pool,
  max |difference| over max |reference|.

The later iterations' loss and pool gaps are kept in ``notes``, not
compared: Adam's first update moves every element by about the learning
rate whatever its gradient's size, so an element whose gradient is zero to
rounding can move either way in the program and the reference, and the
iterations after it then differ by far more than rounding (PERF.md gives
the readings).
"""

from __future__ import annotations

import statistics

import torch

from portbench.reference.trainer import ReferenceTrainer


def _leaf_gaps(prog: dict, ref: dict, keep) -> float:
    floor = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keep)


def check(cell, kw: dict, checked: list, grads: dict, notes=None) -> dict:
    """The four numbers with their limits; ``notes``, a dict, receives each
    iteration's own gaps, which ``tools/readings.py`` prints."""
    notes = {} if notes is None else notes
    limits = cell.limits
    ref = ReferenceTrainer(**kw)
    ref_grads = {}

    def grab(name):
        if name == "optimizer" and not ref_grads:
            ref_grads.update({k: float(torch.linalg.vector_norm(p.grad))
                              for k, p in ref.params.items()})

    loss_gap, pool_gap = 0.0, 0.0
    for j, c in enumerate(checked):
        value = ref.iteration(c["feed"], c["step_n"], c["chunks"], c["tail"],
                              mark=grab if j == 0 else None)
        gap = abs(c["loss"] - value) / max(abs(value), 1e-30)
        rows = ref.written_rows()
        pgap = float((c["rows"] - rows).abs().max()) / max(float(rows.abs().max()), 1e-30)
        if j == 0:
            loss_gap, pool_gap = gap, pgap
        apart = 0.5 * kw["train"]["lr"]
        moved = {k: int(((c["params"][k] - p.detach()).abs() > apart).sum())
                 for k, p in ref.params.items()}
        notes.setdefault("steps", []).append({"step_n": c["step_n"], "loss": value,
                                              "loss_gap": gap, "pool_gap": pgap,
                                              "params_apart": moved})
    floor = statistics.median(ref_grads.values())
    keep = [k for k, v in ref_grads.items() if v >= 1e-3 * floor]
    notes["left_out"] = sorted(set(ref_grads) - set(keep))
    grad_gap = _leaf_gaps(grads, ref_grads, keep)
    start = kw["params"]
    after = checked[-1]["params"]
    prog_change = {k: float(torch.linalg.vector_norm(after[k] - start[k])) for k in keep}
    ref_change = {k: float(torch.linalg.vector_norm(ref.params[k].detach() - start[k]))
                  for k in keep}
    change_gap = _leaf_gaps(prog_change, ref_change, keep)
    return {
        "loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
        "grad_gap": {"value": grad_gap, "limit": limits["grad_gap"]},
        "change_gap": {"value": change_gap, "limit": limits["change_gap"]},
        "pool_gap": {"value": pool_gap, "limit": limits["pool_gap"]},
    }
