"""The port's ``examples/train_video_motion`` on the CPU: the whole
protocol (warmup 1, calibration, re-init, main 1) at 32^2 on a synthetic
video, its checkpoint and the final evaluation's scores file, as the JAX
example writes them."""

import os

import numpy as np

import torch

from vsnca_tpu_torch.convert import load_params_pickle

torch.set_num_threads(2)


def test_train_video_motion_runs_the_protocol(tmp_path):
    from vsnca_tpu_torch.examples import train_video_motion

    trainer, scores = train_video_motion.main(["--img-size", "32", "--iterations", "1",
                                               "--warmup", "1", "--out", str(tmp_path),
                                               "--device", "cpu"])
    assert set(scores) == {"appearance_loss_mean", "video_motion_loss_mean"}
    assert np.isfinite(scores["video_motion_loss_mean"])
    assert os.path.getsize(tmp_path / "final_loss_test.txt") > 0
    assert tuple(load_params_pickle(str(tmp_path / "checkpoint"), "cpu")["w1"].shape) \
        == (66, 128)
