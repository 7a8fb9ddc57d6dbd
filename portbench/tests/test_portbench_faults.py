"""A run whose timed path is broken underneath comes out not correct: the
harness runs as on the card but at a tiny size on the CPU (the program's
plain path), with one fault planted in the program each time. The cells
have no exchange between chips, so that fault does not apply."""

import pytest

from portbench.tools.faults import half_batch_loss, make_serving_fault, make_training_fault
from portbench_tiny import SERVE_CELLS, TRAIN_CELLS, correct, run_tiny, tiny_cell


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serving_fault_is_not_correct(name, kind):
    cell = tiny_cell(name)
    if kind == "half" and cell.traffic["streams"] < 2:
        pytest.skip("one stream: no half of a batch to leave out")
    _, _, checks, _, failed = run_tiny(cell, make_system=make_serving_fault(kind))
    assert not correct(checks, failed), checks


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_fault_is_not_correct(name, kind, monkeypatch):
    from vsnca_tpu_torch.train import trainer

    if kind == "half":
        monkeypatch.setattr(trainer, "make_loss_fn", half_batch_loss(trainer.make_loss_fn))
    _, _, checks, _, failed = run_tiny(tiny_cell(name), make_system=make_training_fault(kind))
    assert not correct(checks, failed), checks
