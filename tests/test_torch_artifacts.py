"""The utilities, the video path and the training CLI's artifacts of the port
(``vsnca_tpu_torch/utils``, ``apps``, ``data/preprocess.py``,
``train/cli.py``, ``train/vector_field_protocol.py``) on the CPU, against
the JAX package's copies where both write the same thing:

- ``flow_to_image``, ``to_uint8``, ``save_image_grid``, the plots: equal
  arrays and files;
- mp4 decoding equals JAX's ``preprocess_video`` on an OpenCV-written clip;
  ``VideoWriter`` writes mp4 and gif;
- ``MetricsLogger``'s records, the experiment helpers and the results
  browser's index: the same files as JAX's on the same folder;
- the CLI's lifecycle (train with ``--save-every 1 --make-videos
  --eval-videos``, then ``--video-only`` on its checkpoint) at
  edge_conditioned's widths, 32^2, batch 1 (at 16^2 both packages' losses
  are NaN at the first iteration): every file, the same control videos
  twice, a checkpoint that JAX reads and exports to the same WebGL JSON;
- ``VectorFieldProtocol``'s dumps.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from vsnca_tpu.apps import results_browser as jbrowser
from vsnca_tpu.data.preprocess import preprocess_video as jpreprocess_video
from vsnca_tpu.export.checkpoint import load_checkpoint as jload_checkpoint
from vsnca_tpu.export.webgl import export_models_to_webgl_json as jexport
from vsnca_tpu.utils import display as jdisplay
from vsnca_tpu.utils import experiment as jexperiment
from vsnca_tpu.utils import flow_viz as jflow_viz
from vsnca_tpu.utils import video_writer as jvideo_writer
from vsnca_tpu.utils.logging import MetricsLogger as JMetricsLogger
from vsnca_tpu_torch.apps import results_browser
from vsnca_tpu_torch.convert import load_params_pickle
from vsnca_tpu_torch.data.preprocess import preprocess_video, synthetic_video
from vsnca_tpu_torch.export.webgl import export_models_to_webgl_json
from vsnca_tpu_torch.utils import display, experiment, flow_viz
from vsnca_tpu_torch.utils.logging import MetricsLogger
from vsnca_tpu_torch.utils.video_writer import VideoWriter

torch.set_num_threads(1)


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("clip_flow", [None, 0.5])
def test_flow_to_image_equals_jax(clip_flow):
    rng = np.random.RandomState(0)
    flow = rng.randn(17, 23, 2).astype(np.float32)
    flow[3, 4] = 0.0
    np.testing.assert_array_equal(flow_viz.flow_to_image(flow, clip_flow),
                                  jflow_viz.flow_to_image(flow, clip_flow))
    np.testing.assert_array_equal(flow_viz._COLORWHEEL, jflow_viz._COLORWHEEL)


def test_to_uint8_and_image_grid_equal_jax(tmp_path):
    imgs = np.random.RandomState(1).uniform(-0.2, 1.2, (3, 8, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(display.to_uint8(imgs), jdisplay.to_uint8(imgs))
    got = display.save_image_grid(imgs, str(tmp_path / "a" / "grid.png"))
    want = jdisplay.save_image_grid(imgs, str(tmp_path / "b" / "grid.png"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 27, 3)
    assert (tmp_path / "a" / "grid.png").read_bytes() == (tmp_path / "b" / "grid.png").read_bytes()


def test_plots_equal_jax(tmp_path):
    assert display.plotting_available()
    vec = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    np.testing.assert_array_equal(flow_viz.plot_vec_field(vec, "v"),
                                  jflow_viz.plot_vec_field(vec, "v"))
    np.testing.assert_array_equal(display.plot_losses([10.0, 5.0, 1.0]),
                                  jdisplay.plot_losses([10.0, 5.0, 1.0]))
    gen = np.random.RandomState(3).rand(2, 8, 8, 3).astype(np.float32)
    flows = {"flow": np.zeros((8, 8, 3), np.uint8)}
    for pkg, d in ((display, "a"), (jdisplay, "b")):
        pkg.save_train_artifacts(str(tmp_path / d), 3, generated=gen, reference=gen,
                                 loss_log=[2.0, 1.0], flow_images=flows)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b")) == [
        "flow_3.png", "loss_plot.png", "ref_3.png", "step_3.png"]
    for n in ("flow_3.png", "ref_3.png", "step_3.png"):
        assert (tmp_path / "a" / n).read_bytes() == (tmp_path / "b" / n).read_bytes()


def test_video_writer_and_mp4_decode_equal_jax(tmp_path):
    frames = (synthetic_video((24, 30), 5) + 1.0) / 2.0
    for pkg, d in ((VideoWriter, "a"), (jvideo_writer.VideoWriter, "b")):
        for ext in ("mp4", "gif"):
            with pkg(str(tmp_path / d / f"clip.{ext}"), fps=10) as w:
                for f in frames:
                    w.add(f)
    np.testing.assert_array_equal(_decode(str(tmp_path / "a" / "clip.mp4")),
                                  _decode(str(tmp_path / "b" / "clip.mp4")))
    assert _decode(str(tmp_path / "a" / "clip.mp4")).shape == (5, 24, 30, 3)
    assert (tmp_path / "a" / "clip.gif").read_bytes() == (tmp_path / "b" / "clip.gif").read_bytes()
    for ext in ("mp4", "gif"):
        path = str(tmp_path / "a" / f"clip.{ext}")
        got = preprocess_video(path, (16, 16))
        want = jpreprocess_video(path, (16, 16))
        assert got.shape == (5, 16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(preprocess_video(path, (16, 16), True, max_frames=2),
                                      jpreprocess_video(path, (16, 16), True, max_frames=2))
    with pytest.raises(ValueError, match="unsupported video format"):
        preprocess_video(str(tmp_path / "clip.webm"))


def test_metrics_logger_and_experiment_helpers_equal_jax(tmp_path):
    for cls, d in ((MetricsLogger, "a"), (JMetricsLogger, "b")):
        log = cls(str(tmp_path / d), use_tensorboard=False, config={"preset": "x", "n": 2})
        log.log_scalars(0, {"loss": 1.5, "it_per_sec": 2.0})
        log.log_scalars(5, {"loss": 0.25})
        log.close()

    def records(d):
        lines = (tmp_path / d / "metrics.jsonl").read_text().splitlines()
        return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in lines]

    assert records("a") == records("b") == [{"step": 0, "loss": 1.5, "it_per_sec": 2.0},
                                            {"step": 5, "loss": 0.25}]
    assert (tmp_path / "a" / "config.json").read_bytes() == (
        tmp_path / "b" / "config.json").read_bytes()

    base = tmp_path / "exps"
    for n in ("experiment_0", "experiment_3", "experiment_x", "other"):
        (base / n).mkdir(parents=True)
    assert experiment.get_next_experiment_index(str(base)) == \
        jexperiment.get_next_experiment_index(str(base)) == 4
    assert experiment.get_next_experiment_index(str(tmp_path / "new")) == 0
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for n in ("b.png", "a.JPG", "a.txt", "c.bmp"):
        (imgs / n).write_bytes(b"")
    assert experiment.scan_folder_for_images(str(imgs)) == \
        jexperiment.scan_folder_for_images(str(imgs))
    for name in ("a", "c", "z"):
        assert experiment.find_image_by_name(str(imgs), name) == \
            jexperiment.find_image_by_name(str(imgs), name)
    named = dict(style=np.random.RandomState(5).uniform(-1, 1, (1, 5, 5, 3)),
                 gray=np.random.RandomState(6).rand(5, 5, 1))
    experiment.save_setup_images(str(tmp_path / "sa"), **named)
    jexperiment.save_setup_images(str(tmp_path / "sb"), **named)
    for n in ("style.png", "gray.png"):
        assert (tmp_path / "sa" / n).read_bytes() == (tmp_path / "sb" / n).read_bytes()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args):
    """``python -m vsnca_tpu_torch.train.cli ARGS`` in a subprocess, as a
    user runs it: that process imports no JAX, so TensorBoard's TensorFlow
    never loads beside jaxlib (the pair can crash one process)."""
    r = subprocess.run([sys.executable, "-m", "vsnca_tpu_torch.train.cli"] + args, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The CLI's lifecycle at edge_conditioned's widths, 32^2, batch 1, on the
    CPU: 2 iterations with a preview and checkpoint each, the control videos
    and one evaluation clip; then --video-only on that checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    evals = root / "evals"
    with VideoWriter(str(evals / "clip.mp4"), fps=10) as w:
        for f in synthetic_video((40, 40), 3):
            w.add((f + 1.0) / 2.0)
    out, again = str(root / "runs" / "edges"), str(root / "runs" / "again")
    common = ["--preset", "edge_conditioned", "--img-size", "32", "--device", "cpu"]
    _run_cli(common + ["--batch-size", "1", "--max-iterations", "2", "--save-every", "1",
                       "--log-every", "1", "--make-videos", "--eval-videos", str(evals),
                       "--out", out])
    _run_cli(common + ["--video-only", "--checkpoint", f"{out}/checkpoint", "--out", again])
    return root, out, again


def test_cli_writes_every_artifact(cli_run):
    root, out, again = cli_run
    for f in ("args.json", "config.json", "metrics.jsonl", "artifacts/step_0.png",
              "artifacts/step_1.png", "artifacts/loss_plot.png", "checkpoint/state.pkl",
              "checkpoint/metadata.json", "videos/style_img.mp4", "videos/black_img.mp4",
              "videos/clip.mp4"):
        assert os.path.getsize(os.path.join(out, f)) > 0, f
    steps = [json.loads(line)["step"] for line in open(os.path.join(out, "metrics.jsonl"))]
    assert steps == [0, 1]
    from PIL import Image

    assert np.asarray(Image.open(os.path.join(out, "artifacts/step_0.png"))).shape == (32, 32, 3)
    assert _decode(os.path.join(out, "videos/style_img.mp4")).shape == (64, 32, 32, 3)
    assert _decode(os.path.join(out, "videos/clip.mp4")).shape == (3, 32, 32, 3)
    assert sorted(os.listdir(os.path.join(again, "videos"))) == ["black_img.mp4",
                                                                 "style_img.mp4"]
    for name in ("style_img.mp4", "black_img.mp4"):
        np.testing.assert_array_equal(_decode(os.path.join(again, "videos", name)),
                                      _decode(os.path.join(out, "videos", name)))
    with open(os.path.join(out, "checkpoint", "metadata.json")) as f:
        assert json.load(f)["nca"]["conditioning"] == "edges"
    events = os.listdir(os.path.join(out, "tensorboard"))
    assert any(n.startswith("events.out.tfevents.") for n in events), events


def test_cli_checkpoint_reads_in_jax_and_exports_alike(cli_run):
    _, out, _ = cli_run
    state = jload_checkpoint(os.path.join(out, "checkpoint"))
    assert int(state["iteration"]) == 2 and state["pool"].shape == (256, 32, 32, 12)
    assert int(state["opt_state"]["count"]) == 2
    port = load_params_pickle(os.path.join(out, "checkpoint"), "cpu")
    want = jexport([state["params"]], ["edges"], edge_conditioning=True)
    got = export_models_to_webgl_json([port], ["edges"], edge_conditioning=True)
    assert json.dumps(got) == json.dumps(want)
    assert got["layers"][0]["shape"] == [52, 96]


def test_results_browser_index_equals_jax(cli_run, tmp_path):
    root, _, _ = cli_run
    runs = str(root / "runs")
    got = results_browser.build_index(runs, str(tmp_path / "a.html"))
    want = jbrowser.build_index(runs, str(tmp_path / "b.html"))
    assert open(got, "rb").read() == open(want, "rb").read()
    text = open(got).read()
    assert "edges/videos/style_img.mp4" in text and "edges/artifacts/step_0.png" in text


def test_cli_refuses_a_checkpoint_without_video_only(tmp_path):
    from vsnca_tpu_torch.train import cli

    with pytest.raises(SystemExit, match="--video-only requires --checkpoint"):
        cli.main(["--video-only", "--device", "cpu", "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="--checkpoint is read by --video-only only"):
        cli.main(["--checkpoint", str(tmp_path), "--device", "cpu", "--out", str(tmp_path)])


def test_vector_field_protocol_dumps(tmp_path):
    import dataclasses

    from vsnca_tpu_torch.data.preprocess import synthetic_style_image
    from vsnca_tpu_torch.models.msoe import msoe_random_init
    from vsnca_tpu_torch.models.vgg import vgg16_random_init
    from vsnca_tpu_torch.train import presets
    from vsnca_tpu_torch.train.vector_field_protocol import VectorFieldProtocol

    nca, loss, train = presets.vector_field_motion(img_size=32)
    train = dataclasses.replace(train, batch_size=1, max_iterations=2, step_range=(8, 9),
                                step_buckets=(8,))
    style = torch.from_numpy(synthetic_style_image((32, 32), 1) * 2.0 - 1.0).permute(0, 3, 1, 2)
    out = tmp_path / "vf"
    proto = VectorFieldProtocol(nca, loss, train, style, recalibrate_every=0, save_every=2,
                                out_dir=str(out), video_frames=3, device="cpu")
    proto.run(vgg16_random_init(torch.Generator().manual_seed(16), "cpu"),
              msoe_random_init(torch.Generator().manual_seed(175), "cpu"))
    assert sorted(os.listdir(out)) == ["flow_gen1.jpg", "vec_field_gen1.png",
                                       "vec_field_target.png", "video_large_last.mp4",
                                       "video_last.mp4"]
    assert _decode(str(out / "video_last.mp4")).shape == (3, 32, 32, 3)
    assert _decode(str(out / "video_large_last.mp4")).shape == (3, 64, 64, 3)


def test_cli_and_protocol_skip_only_the_plots_without_matplotlib(tmp_path, monkeypatch,
                                                                 capsys):
    """Where matplotlib is not installed (``plotting_available`` False) the
    CLI says so and writes every artifact but the loss plot; the protocol
    writes its videos and flow images but no field plot."""
    import dataclasses

    from vsnca_tpu_torch.data.preprocess import synthetic_style_image
    from vsnca_tpu_torch.models.msoe import msoe_random_init
    from vsnca_tpu_torch.models.vgg import vgg16_random_init
    from vsnca_tpu_torch.train import cli, presets
    from vsnca_tpu_torch.train.vector_field_protocol import VectorFieldProtocol

    monkeypatch.setattr(display, "plotting_available", lambda: False)
    # the CLI runs in this process (for the patch above): TensorBoard takes its
    # own stub in place of TensorFlow, which can crash a process beside jaxlib
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    out = tmp_path / "run"
    cli.main(["--preset", "static_texture", "--img-size", "16", "--batch-size", "1",
              "--max-iterations", "1", "--save-every", "1", "--device", "cpu",
              "--out", str(out)])
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert sorted(os.listdir(out / "artifacts")) == ["step_0.png"]
    assert (out / "checkpoint" / "state.pkl").exists()

    nca, loss, train = presets.vector_field_motion(img_size=32)
    train = dataclasses.replace(train, batch_size=1, max_iterations=1, step_range=(4, 5),
                                step_buckets=(4,))
    style = torch.from_numpy(synthetic_style_image((32, 32), 1) * 2.0 - 1.0).permute(0, 3, 1, 2)
    proto = VectorFieldProtocol(nca, loss, train, style, recalibrate_every=0, save_every=1,
                                out_dir=str(tmp_path / "vf"), video_frames=2, device="cpu")
    proto.run(vgg16_random_init(torch.Generator().manual_seed(16), "cpu"),
              msoe_random_init(torch.Generator().manual_seed(175), "cpu"))
    assert sorted(os.listdir(tmp_path / "vf")) == ["flow_gen0.jpg", "video_large_last.mp4",
                                                   "video_last.mp4"]
