"""The port's examples (``vsnca_tpu_torch/examples``) on the CPU, each
``main(argv)`` at 16-32^2 for 1-2 iterations, with synthetic data:
``export_webgl`` writes the same JSON bytes as the JAX package's
``examples/export_webgl.py`` on the same checkpoint, and the others write
what their JAX counterparts write. ``train_video_motion`` is in
``tests/test_torch_examples_video.py``, so that each file stays small.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest

import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import load_params_pickle
from vsnca_tpu_torch.export.checkpoint import save_checkpoint
from vsnca_tpu_torch.models.dynca import dynca_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_tensorflow(monkeypatch):
    """The examples' ``MetricsLogger`` runs in this process: TensorBoard takes
    its own stub in place of TensorFlow, which can crash a process beside
    jaxlib."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def test_export_webgl_writes_the_jax_examples_json(tmp_path, monkeypatch):
    from vsnca_tpu_torch.examples import export_webgl

    cfg = NCAConfig(c_in=12, fc_dim=96, conditioning="pos_emb")
    params = dynca_init(torch.Generator().manual_seed(4), cfg, "cpu")
    save_checkpoint(str(tmp_path / "ck"), {"params": params, "iteration": 3})
    drift = export_webgl.main([str(tmp_path / "ck"), str(tmp_path / "port.json"),
                               "--conditioning", "pos_emb", "--name", "tex", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["export_webgl.py", str(tmp_path / "ck"),
                                      str(tmp_path / "jax.json"), "--conditioning", "pos_emb",
                                      "--name", "tex"])
    runpy.run_path(os.path.join(ROOT, "examples", "export_webgl.py"), run_name="__main__")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text())["layers"][0]["shape"] == [51, 96]
    assert drift["weight_max_abs_diff"] < 1e-3 and np.isfinite(drift["state_max_abs_diff"])


def test_interactive_growth_writes_its_strip(tmp_path):
    from PIL import Image

    from vsnca_tpu_torch.examples import interactive_growth

    path = interactive_growth.main(["--image-size", "16", "--out", str(tmp_path),
                                    "--device", "cpu"])
    strip = np.asarray(Image.open(path))
    assert strip.ndim == 3 and strip.shape[2] == 3 and strip.size >= 9 * 16 * 16 * 3


def test_learning_proof_writes_its_artifacts(tmp_path):
    from vsnca_tpu_torch.examples import learning_proof
    from vsnca_tpu_torch.utils.display import plotting_available

    out = learning_proof.main(["--size", "16", "--iters", "2", "--test-frames", "2",
                               "--out", str(tmp_path), "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert len(out["errors"]) == 2 and np.all(np.isfinite(out["errors"]))
    files = {"content_output_error.png", "content_vs_output.gif"}
    if plotting_available():
        files.add("training_loss.png")
    assert files <= set(os.listdir(tmp_path))


def test_train_encoder_writes_previews_and_a_jax_readable_checkpoint(tmp_path):
    from vsnca_tpu.export.checkpoint import load_checkpoint as jload_checkpoint
    from vsnca_tpu_torch.examples import train_encoder

    trainer, losses = train_encoder.main(["--image-size", "32", "--epochs", "1",
                                          "--out", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(losses).all() and trainer.iteration == 1
    assert (tmp_path / "preview_0.png").exists()
    state = jload_checkpoint(str(tmp_path / "checkpoint"))
    assert "encoder" in state["params"] and int(state["iteration"]) == 1
    port = load_params_pickle(str(tmp_path / "checkpoint"), "cpu")
    for k, v in trainer.params.items():
        np.testing.assert_array_equal(port[k].numpy(), v.detach().numpy())


def test_train_vector_field_writes_its_dumps_and_videos(tmp_path, no_tensorflow):
    from vsnca_tpu_torch.examples import train_vector_field

    trainer = train_vector_field.main(["--img-size", "32", "--iterations", "1",
                                       "--save-every", "1", "--out", str(tmp_path),
                                       "--device", "cpu"])
    assert trainer.iteration == 1 and np.isfinite(trainer.history[-1].loss)
    for f in ("checkpoint/state.pkl", "videos/style_img.mp4", "videos/black_img.mp4",
              "video_last.mp4", "video_large_last.mp4", "flow_gen0.jpg", "metrics.jsonl"):
        assert os.path.getsize(tmp_path / f) > 0, f
    assert tuple(load_params_pickle(str(tmp_path / "checkpoint"), "cpu")["w1"].shape) == (50, 96)
