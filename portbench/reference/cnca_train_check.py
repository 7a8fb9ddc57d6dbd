"""The comparison that decides ``correct`` in an ``enc_train`` cell: the four
numbers of ``reference.train_check`` (``loss_gap``, ``grad_gap``,
``change_gap``, ``pool_gap``, each against its limit in
``limits/<cell>.json``), with the encoder-conditioned reference
(``reference.cnca_trainer.ReferenceEncTrainer``) built from the same seed,
weights and inputs as the program's trainer and following its checked
iterations at their step counts.

The reference steps from the program's parameters: after its own update in
each train step it takes the parameters the program held after that step.
An iteration trains twice, and Adam's first update moves every element by
about the learning rate whatever its gradient's size, so an element whose
gradient is zero to rounding moves either way in the program and the
reference; without this the second train step, whose loss the iteration
returns and whose state it writes back, would start from parameters 2 lr
apart in such elements.

- ``loss_gap``: the first checked iteration's loss (its second train
  step's), relative to the reference's.
- ``grad_gap``: the first train step's gradient as the optimizer receives
  it, by the worst parameter tensor (the encoder's three included).
- ``change_gap``: the parameters' change over the checked iterations
  against the sum of the reference's own updates, by the worst tensor.
- ``pool_gap``: the states the first iteration wrote back to the pool,
  max |difference| over max |reference|.
"""

from __future__ import annotations

import statistics

import torch

from portbench.reference.cnca_trainer import ReferenceEncTrainer
from portbench.reference.train_check import _leaf_gaps


def check(cell, kw: dict, checked: list, grads: dict, notes=None) -> dict:
    """The four numbers with their limits; ``notes``, a dict, receives each
    iteration's own gaps, which ``tools/cnca_readings.py`` prints."""
    notes = {} if notes is None else notes
    limits = cell.limits
    ref = ReferenceEncTrainer(**kw)
    ref_grads = {}

    def grab(name):
        if name == "optimizer" and not ref_grads:
            ref_grads.update({k: float(torch.linalg.vector_norm(p.grad))
                              for k, p in ref.params.items()})

    loss_gap, pool_gap = 0.0, 0.0
    for j, c in enumerate(checked):
        value = ref.iteration(c["step_n"], mark=grab if j == 0 else None,
                              follow=c["step_params"])
        gap = abs(c["loss"] - value) / max(abs(value), 1e-30)
        rows = ref.written_rows()
        pgap = float((c["rows"] - rows).abs().max()) / max(float(rows.abs().max()), 1e-30)
        if j == 0:
            loss_gap, pool_gap = gap, pgap
        notes.setdefault("steps", []).append({
            "step_n": c["step_n"], "loss": value, "loss_gap": gap, "pool_gap": pgap,
            "alive_px": int((rows[:, 3] != 0).sum())})
    floor = statistics.median(ref_grads.values())
    keep = [k for k, v in ref_grads.items() if v >= 1e-3 * floor]
    notes["left_out"] = sorted(set(ref_grads) - set(keep))
    notes["grad_gaps"] = {k: abs(grads[k] - ref_grads[k]) / max(ref_grads[k], floor)
                          for k in keep}
    grad_gap = _leaf_gaps(grads, ref_grads, keep)
    start = kw["params"]
    after = checked[-1]["step_params"][-1]
    prog_change = {k: float(torch.linalg.vector_norm(after[k] - start[k])) for k in keep}
    ref_change = {k: float(torch.linalg.vector_norm(ref.moved[k])) for k in keep}
    change_gap = _leaf_gaps(prog_change, ref_change, keep)
    return {
        "loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
        "grad_gap": {"value": grad_gap, "limit": limits["grad_gap"]},
        "change_gap": {"value": change_gap, "limit": limits["change_gap"]},
        "pool_gap": {"value": pool_gap, "limit": limits["pool_gap"]},
    }
