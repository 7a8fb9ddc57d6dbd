"""The training CLI's ``--dp 2 --device cpu`` (two gloo ranks, spawned by
the CLI) against the one-process CLI on the same arguments: rank 0 alone
prints and writes, and its checkpoint holds the one-process parameters
within rtol 1e-4, atol 1e-6 (a mean of two half-batch gradients sums in
another order; as ``tests/test_torch_dp_trainer.py``)."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args):
    r = subprocess.run([sys.executable, "-m", "vsnca_tpu_torch.train.cli"] + args, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def test_cli_dp_on_cpu_trains_like_one_process(tmp_path):
    """``--dp 2 --device cpu`` runs two gloo ranks; rank 0 alone writes
    (one line of output a log, one checkpoint), and the checkpoint is
    the one-process run's within the DP/single-process rounding."""
    from vsnca_tpu_torch.convert import load_params_pickle

    common = ["--preset", "static_texture", "--img-size", "16", "--batch-size", "2",
              "--max-iterations", "2", "--log-every", "1", "--device", "cpu"]
    out_dp = _cli(common + ["--dp", "2", "--out", str(tmp_path / "dp")])
    _cli(common + ["--out", str(tmp_path / "one")])
    assert out_dp.count("iter     0") == 1 and "data-parallel over 2 ranks" in out_dp
    got = load_params_pickle(str(tmp_path / "dp" / "checkpoint"), "cpu")
    want = load_params_pickle(str(tmp_path / "one" / "checkpoint"), "cpu")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6)
