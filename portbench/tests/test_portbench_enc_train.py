"""The encoder-conditioned training cell (kind ``enc_train``) at a tiny size
on the CPU, the program on its plain path: a sound run comes out correct
and prints the contract's line, each planted fault comes out not correct,
the control does on the card, a run loads no JAX, and the configuration
and mix hold the encoder CLI's defaults and the trainer's step draw."""

import collections
import json
import subprocess
import sys

import pytest

from portbench_tiny import ROOT, correct, run_tiny, tiny_cell

CELL = "enc_train_64_b8"


def test_sound_run_is_correct_and_prints_the_contracts_line(capsys):
    from portbench.harness.result import finish

    cell = tiny_cell(CELL)
    cell.traffic["trace_after_s"] = 0.0  # the stretch first, then the window's iterations
    out = run_tiny(cell, seconds=3.0, trace=True)
    rec, e2e, checks, attempted, failed = out
    assert attempted > 2 and failed == 0
    assert correct(checks), checks
    assert rec.kind == "train" and len(rec.trace_step_counts) == 2
    assert rec.iteration_flops and rec.launches == 0  # the CPU runs no kernel
    assert finish(cell, *out, True) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"mfu.train", "device_idle_pct.train"} <= set(line["metrics"])


@pytest.mark.parametrize("kind", ["no_goal", "one_step", "no_content"])
def test_training_fault_is_not_correct(kind):
    from portbench.tools.cnca_faults import make_enc_training_fault

    _, _, checks, _, failed = run_tiny(tiny_cell(CELL), make_system=make_enc_training_fault(kind))
    assert not correct(checks, failed), checks


@pytest.mark.cuda
def test_training_control_is_not_correct(cuda):
    from portbench.reference.cnca_control import enc_train_control

    _, _, checks, _, failed = run_tiny(tiny_cell(CELL, size=64), device=cuda,
                                       make_system=enc_train_control())
    assert not correct(checks, failed), checks


def test_a_run_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
            f"from portbench_tiny import run_tiny, tiny_cell\n"
            f"run_tiny(tiny_cell({CELL!r}))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "vsnca_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "vsnca_tpu"}


def test_configuration_is_the_encoder_clis_job():
    import numpy as np

    from portbench.harness.enc_train import cnca_config
    from portbench.harness.spec import Cell, load_benchmark
    from vsnca_tpu_torch.config import ConditionedNCAConfig
    from vsnca_tpu_torch.train.encoder_cli import setup_args

    cell = Cell(load_benchmark(), CELL)
    model, loss, train = (cell.config[k] for k in ("nca", "loss", "train"))
    args = setup_args([])
    assert cnca_config(model, train) == ConditionedNCAConfig(
        image_size=args.image_size, num_hidden_channels=args.num_hidden_channels)
    assert train["img_size"] == [args.image_size] * 2
    assert (train["batch_size"], train["pool_size"], train["lr"], train["num_damaged"]) == (
        args.batch_size, args.pool_size, args.lr, args.num_damaged)
    assert train["step_range"] == [args.min_steps, args.max_steps]
    assert (loss["appearance_loss_type"], loss["appearance_weight"], loss["content_weight"],
            loss["overflow_weight"]) == (args.appearance_loss_type, args.appearance_loss_weight,
                                         args.content_loss_weight, args.overflow_loss_weight)
    # the step cycle holds the buckets in the proportions of the trainer's draw
    lo, hi = train["step_range"]
    buckets = np.asarray(train["step_buckets"])
    draws = collections.Counter(int(buckets[np.argmin(np.abs(buckets - raw))])
                                for raw in range(lo, hi + 1))
    assert collections.Counter(cell.traffic["step_cycle"]) == draws


def test_cell_is_found_by_name():
    from portbench.harness.spec import Cell, load_benchmark, metric_reader

    cell = Cell(load_benchmark(), CELL)
    assert (ROOT / "portbench" / "harness" / f"{cell.traffic['kind']}.py").exists()
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap", "pool_gap"}
    names = {m["name"] for m in cell.end_to_end}
    assert names == {"iters_per_s", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert {"encoder_ms.train", "cnca_launches_per_iter.train", "cnca_fwd_roofline.train",
            "cnca_bwd_roofline.train", "rollout_ms.train", "loss_ms.train", "mfu.train",
            "device_idle_pct.train"} == layer  # not bwd_roofline.train: DyNCA's count
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"])) and m["moves"] in names
