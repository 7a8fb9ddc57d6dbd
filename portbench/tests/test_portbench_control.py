"""The controls come out not correct: the reference in the program's place,
one precision step below the cell's (float8 operands for the bf16 serving
cells; TF32 for the float32 training cells, which only the card has)."""

import pytest

from portbench_tiny import SERVE_CELLS, TRAIN_CELLS, correct, run_tiny, tiny_cell


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serving_control_is_not_correct(name):
    from portbench.reference.control import serve_control

    _, _, checks, _, failed = run_tiny(tiny_cell(name), make_system=serve_control())
    assert not correct(checks, failed), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_control_is_not_correct(name, cuda):
    from portbench.reference.control import train_control

    _, _, checks, _, failed = run_tiny(tiny_cell(name, size=64), device=cuda,
                                       make_system=train_control())
    assert not correct(checks, failed), checks
