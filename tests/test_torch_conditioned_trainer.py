"""The port's training path for the three conditioned and vector-field
presets against the JAX package on the CPU: one ``make_train_step`` each for
``edge_conditioned`` (edge map of the content's grayscale; OT appearance,
auxiliary VGG, vector-field motion, overflow), ``extra_channels`` (the
grayscale content appended as a 13th channel, stripped before the pool
write-back) and ``vector_field_motion`` (pos_emb; OT appearance and the
vector-field term against the circular field), each cell narrowed to fc 16,
from identical parameters, pool, inputs, VGG16 and MSOE arrays, at
update_rate 1 (so the masks, and the pre-roll's own mask, do not matter)
and 32^2, where no OT term subsamples. The JAX step runs
``rollout_path="xla"``; the port's both its 'fused' route (the training
pair's plain version) and its 'xla' route (eager steps). Then three
``DyNCATrainer`` iterations of the edge_conditioned cell draw for draw with
JAX's, on content frames drawn as the CLI draws them; the
``VectorFieldProtocol`` recalibration against JAX's rule; and the CLI's
content draw and ``--motion-field``, in process on the CPU.

Tolerances: loss and logs rtol 1e-5; updated parameters atol 1e-6, 0.1 % of
one Adam update (as tests/test_torch_trainer.py), except where the update
is not Adam's full step: the first update is lr * g / (|g| + 1e-8) per
element of the normalized gradient g, so an element with |g| near 1e-6
turns float32 rounding into a visible share of lr. Those elements (the JAX
update below 0.999 lr) are held at atol 1e-5, 1 % of an update: at the
vector_field_motion cell one element of w1 has |g| 1.5e-6 in JAX and
1.9e-6 in the port (the OT term's nearest-neighbour minima, whose
gradients agree to 6e-6 of the largest element; the vector-field term's
alone to 7e-7), an update difference of 1.44e-6. The new pool states
rtol 1e-4 / atol 1e-5; the trainer iterations' losses and logs rtol 1e-4,
as tests/test_torch_trainer.py's (the parameters and the pool carry the
previous iterations' rounding); the recalibrated weights rtol 1e-6.
``-s`` prints the measured differences.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.config import TrainConfig as JTrainConfig
from vsnca_tpu.data.preprocess import synthetic_video as j_synthetic_video
from vsnca_tpu.losses.appearance import precompute_target_style_features as j_style_feats
from vsnca_tpu.losses.orchestrator import LossState as JLossState
from vsnca_tpu.losses.orchestrator import set_loss_weight as j_set_loss_weight
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu.train import presets as jpresets
from vsnca_tpu.train.optim import make_optimizer as jmake_optimizer
from vsnca_tpu.train.trainer import DyNCATrainer as JTrainer
from vsnca_tpu.train.trainer import make_train_step as jmake_train_step
from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.convert import load_params_pickle, msoe_from_jax, params_from_jax, \
    vgg_from_jax
from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
from vsnca_tpu_torch.losses.orchestrator import LossState
from vsnca_tpu_torch.losses.vector_field import get_motion_vector_field_by_name
from vsnca_tpu_torch.train import cli
from vsnca_tpu_torch.train import presets
from vsnca_tpu_torch.train.optim import make_optimizer
from vsnca_tpu_torch.train.trainer import DyNCATrainer, make_train_step
from vsnca_tpu_torch.train.vector_field_protocol import VectorFieldProtocol

from test_torch_losses import np_vgg16

torch.set_num_threads(1)

PRESETS = ["edge_conditioned", "extra_channels", "vector_field_motion"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _cells(preset):
    """(JAX, port) configs of a preset at 32^2 with its cell narrowed to
    fc 16 and update rate 1."""
    j = getattr(jpresets, preset)(32)
    p = presets.PRESETS[preset](32)
    narrow = dict(fc_dim=16, update_rate=1.0)
    return (dataclasses.replace(j[0], **narrow), j[1]), (dataclasses.replace(p[0], **narrow),
                                                         p[1])


@pytest.fixture(scope="module")
def arrays():
    jm = jmsoe.msoe_random_init(jax.random.PRNGKey(175))
    return np_vgg16(0), {k: np.asarray(v) for k, v in jm.items()}


@pytest.fixture(scope="module", params=PRESETS)
def jax_step_result(arrays, request):
    """One JAX train step of a preset (rollout_path "xla", remat "none")."""
    preset = request.param
    (jcfg, jloss), _ = _cells(preset)
    vgg_np, msoe_np = arrays
    jvgg = [{k: jnp.asarray(v) for k, v in d.items()} for d in vgg_np]
    jm = {k: jnp.asarray(v) for k, v in msoe_np.items()}
    params = jdynca.dynca_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    states = rng.uniform(-0.5, 0.5, (2, 32, 32, 12)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    aux = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    opt = jmake_optimizer(1e-3, (500, 1000), 0.5)
    step = jmake_train_step(jcfg, JLossState(cfg=jloss, vgg_params=jvgg, msoe_params=jm), opt,
                            remat="none", rollout_path="xla")
    inputs = {"target_style": jnp.asarray(style),
              "target_style_features": j_style_feats(jvgg, jnp.asarray(style), "OT", (32, 32))}
    if preset != "vector_field_motion":
        inputs["aux_imgs"] = jnp.asarray(aux)
        inputs["aux_gs"] = jnp.asarray(aux.mean(-1, keepdims=True))
    p2, _, new_states, loss, logs = step(params, opt.init(params), jnp.asarray(states),
                                         jax.random.PRNGKey(3), inputs, step_n=4)
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return dict(preset=preset, params=np_(params), states=states, style=style, aux=aux,
                new_params=np_(p2), new_states=np.asarray(new_states), loss=float(loss),
                logs={k: float(v) for k, v in logs.items()})


@pytest.mark.parametrize("rollout_path", ["fused", "xla"])
def test_conditioned_train_step_matches_jax(arrays, jax_step_result, rollout_path):
    r = jax_step_result
    _, (cfg, loss_cfg) = _cells(r["preset"])
    vgg = vgg_from_jax(arrays[0], "cpu")
    msoe = msoe_from_jax(arrays[1], "cpu")
    params = {k: v.requires_grad_() for k, v in params_from_jax(r["params"], "cpu").items()}
    opt = make_optimizer(params, 1e-3, (500, 1000), 0.5)
    step = make_train_step(cfg, LossState(cfg=loss_cfg, vgg_params=vgg, msoe_params=msoe),
                           "none", rollout_path)
    style = _nchw(r["style"])
    inputs = {"target_style": style,
              "target_style_features": precompute_target_style_features(vgg, style, "OT",
                                                                        (32, 32))}
    if r["preset"] != "vector_field_motion":
        inputs["aux_imgs"] = _nchw(r["aux"])
        inputs["aux_gs"] = inputs["aux_imgs"].mean(dim=1, keepdim=True)
    _, _, new_states, loss, logs = step(params, opt, _nchw(r["states"]), 0, inputs, step_n=4)
    dp = max(np.abs(v.detach().numpy() - r["new_params"][k]).max() for k, v in params.items())
    print(f"\n{r['preset']} step, rollout_path={rollout_path}: loss rel diff "
          f"{abs(float(loss) - r['loss']) / r['loss']:.1e}; logs " + ", ".join(
              f"{k} {float(v):.4g}" for k, v in logs.items())
          + f"; updated params max abs diff {dp:.2e}")
    assert set(logs) == set(r["logs"])
    assert {"vector_field_motion", "appearance", "overflow"} <= set(logs)
    assert float(loss) == pytest.approx(r["loss"], rel=1e-5)
    assert {k: float(v) for k, v in logs.items()} == pytest.approx(r["logs"], rel=1e-5)
    for k, v in params.items():
        step = np.abs(r["new_params"][k] - r["params"][k])
        full = step >= 0.999e-3  # Adam's full step, lr * sign(g)
        got = v.detach().numpy()
        np.testing.assert_allclose(got[full], r["new_params"][k][full], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(got[~full], r["new_params"][k][~full], rtol=0, atol=1e-5,
                                   err_msg=k)
        assert step.max() > 5e-4 and full.mean() > 0.9  # it moved
    assert tuple(new_states.shape) == (2, 12, 32, 32)  # extra_channels: the content stripped
    np.testing.assert_allclose(new_states.numpy(), r["new_states"].transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


def _content_draw(rng, frames, batch):
    """The CLI's content draw (cli.py:243-248): indices with replacement,
    the frames and their channel-mean grayscale, NHWC."""
    idx = rng.choice(frames.shape[0], batch, replace=True)
    aux = frames[idx]
    return aux, aux.mean(-1, keepdims=True)


def test_edge_trainer_iterations_match_jax_draw_for_draw():
    """Three iterations of the edge_conditioned cell (narrowed) from one
    seed: the same batch indices and rollout lengths as the JAX trainer,
    seed injection at iterations 0 and 2, the same content frames drawn as
    the CLI draws them, and — from the JAX trainer's parameters and pool —
    the same losses (overflow and auxiliary MSE, so that JAX compiles no
    VGG16) and pool."""
    train = dict(img_size=(16, 16), batch_size=2, pool_size=6, step_range=(2, 6),
                 step_buckets=(2, 4), inject_seed_every=2, remat="none",
                 rollout_path="xla", seed=7)
    (jcfg, _), (cfg, _) = _cells("edge_conditioned")
    loss = dict(overflow_weight=1000.0, auxiliary_weight=10.0, auxiliary_loss_type="MSE")
    jcfg = dataclasses.replace(jcfg, seed_mode="random")
    cfg = dataclasses.replace(cfg, seed_mode="random")
    jt = JTrainer(jcfg, JLossConfig(**loss), JTrainConfig(**train))
    pt = DyNCATrainer(cfg, LossConfig(**loss), TrainConfig(**train), device="cpu")
    with torch.no_grad():
        for k, v in pt.params.items():
            v.copy_(torch.from_numpy(np.array(jt.params[k])))
        pt.pool.states.copy_(_nchw(jt.pool.states))
        pt._seed_template.copy_(_nchw(jt._seed_template))
    frames = np.asarray(j_synthetic_video((16, 16), 8))
    jrng, prng = np.random.RandomState(7), np.random.RandomState(7)
    for i in range(3):
        jaux, jgs = _content_draw(jrng, frames, 2)
        paux, pgs = _content_draw(prng, frames, 2)
        jlog = jt.train_iteration({"aux_imgs": jnp.asarray(jaux), "aux_gs": jnp.asarray(jgs)})
        plog = pt.train_iteration({"aux_imgs": _nchw(paux), "aux_gs": _nchw(pgs)})
        np.testing.assert_array_equal(pt.last_batch_idx, jt.last_batch_idx)
        assert plog.iteration == i and np.isfinite(plog.loss)
        print(f"\niteration {i}: loss rel diff {abs(plog.loss - jlog.loss) / jlog.loss:.1e}")
        assert plog.loss == pytest.approx(jlog.loss, rel=1e-4)
        assert plog.logs == pytest.approx(jlog.logs, rel=1e-4)
    for a, b in zip(pt.rng.get_state()[1:], jt.rng.get_state()[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pt.pool.states.numpy(),
                               np.asarray(jt.pool.states).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


def test_vector_field_protocol_recalibrates_as_jax():
    """Recalibrations at i = 2 and 4 (i % 2 == 0 and i > 0), each weight
    JAX's rule on the same appearance log so far, applied to the live loss;
    the artifact dumps (held in test_torch_artifacts.py) are off without
    ``save_every``."""
    nca = NCAConfig(c_in=6, fc_dim=16, conditioning="pos_emb", padding_mode="circular")
    loss = dict(overflow_weight=1.0, appearance_weight=2.0, appearance_loss_type="Gram",
                vector_field_motion_weight=4.0, motion_img_size=(32, 32), nca_base_num_steps=4)
    train = TrainConfig(img_size=(32, 32), batch_size=2, pool_size=8, step_range=(4, 9),
                        step_buckets=(4, 8), inject_seed_every=2, max_iterations=5)
    style = _nchw(np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3)))
    vgg = vgg_from_jax(np_vgg16(0), "cpu")
    msoe = msoe_from_jax({k: np.asarray(v) for k, v in
                          jmsoe.msoe_random_init(jax.random.PRNGKey(1)).items()}, "cpu")
    proto = VectorFieldProtocol(nca, LossConfig(**loss), train, style, recalibrate_every=2,
                                device="cpu")
    trainer = proto.run(vgg, msoe)
    assert trainer.iteration == 5 and len(proto._appearance_log) == 5
    assert [it for it, _ in proto.recalibrations] == [2, 4]
    for it, w in proto.recalibrations:
        want = j_set_loss_weight(JLossConfig(**loss), "vector_field_motion",
                                 appearance_loss_log=proto._appearance_log[:it + 1])
        assert w == pytest.approx(want.vector_field_motion_weight, rel=1e-6)
    assert trainer.loss_state.cfg.vector_field_motion_weight == proto.recalibrations[-1][1]
    # the raw appearance values: the weighted logs over the weight
    assert trainer.history[0].logs["appearance"] / 2.0 == pytest.approx(proto._appearance_log[0])
    assert proto.save_every == 0 and proto.out_dir is None


def test_cli_content_draw_and_motion_field(tmp_path, monkeypatch):
    """``--preset edge_conditioned`` draws content frames as the JAX CLI
    does (8 synthetic frames, RandomState(seed).choice with replacement, in
    the loop's order), prints the parameter count and writes a checkpoint
    whose pool keeps 12 channels; ``--motion-field`` reaches the
    vector_field_motion preset's loss."""
    seen = []
    run = DyNCATrainer.train_iteration

    def recording(self, inputs, **kw):
        seen.append((self, dict(inputs)))
        return run(self, inputs, **kw)

    monkeypatch.setattr(DyNCATrainer, "train_iteration", recording)
    # the CLI runs in this process (for the patch above): TensorBoard takes its
    # own stub in place of TensorFlow, which can crash a process beside jaxlib
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    out = str(tmp_path / "edges")
    cli.main(["--preset", "edge_conditioned", "--img-size", "32", "--max-iterations", "2",
              "--device", "cpu", "--seed", "3", "--out", out])
    frames = np.asarray(j_synthetic_video((32, 32), 8))
    rng = np.random.RandomState(3)
    for _, inputs in seen:
        aux, gs = _content_draw(rng, frames, 2)
        np.testing.assert_array_equal(inputs["aux_imgs"].numpy(), aux.transpose(0, 3, 1, 2))
        np.testing.assert_allclose(inputs["aux_gs"].numpy(), gs.transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-7)
    trainer = seen[0][0]
    assert trainer.pool.states.shape[1] == 12 and trainer.iteration == 2
    assert tuple(load_params_pickle(f"{out}/checkpoint", "cpu")["w1"].shape) == (51, 96)

    seen.clear()
    out = str(tmp_path / "vf")
    cli.main(["--preset", "vector_field_motion", "--img-size", "32", "--max-iterations", "1",
              "--batch-size", "2", "--motion-field", "diverge", "--device", "cpu",
              "--out", out])
    trainer, inputs = seen[0]
    assert "aux_imgs" not in inputs
    assert trainer.loss_state.cfg.motion_vector_field_name == "diverge"
    torch.testing.assert_close(trainer.loss_state.target_field,
                               get_motion_vector_field_by_name("diverge", (32, 32)))
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["loss"]["motion_vector_field_name"] == "diverge"
