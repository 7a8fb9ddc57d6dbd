"""The port's trainer (vsnca_tpu_torch.train) against the JAX trainer on the
CPU, from identical parameters, pool, inputs and VGG16 arrays, at
update_rate=1 (so the masks do not matter): one static_texture-shaped train
step (overflow x100 + Gram appearance on the five VGG16 taps, grad-normalized
Adam), and three DyNCATrainer iterations.

Tolerances: loss and logs rtol 1e-5; updated parameters atol 1e-6, 0.1 %
of one Adam update (±1e-3 each; measured 1.5e-8 with either rollout path,
printed with ``-s``). The margin is wide because the first update
is lr * g / (|g| + 1e-8) per element: an element whose normalized gradient
is near 1e-8 turns float32 rounding of the VGG and loss sums into a visible
share of lr. New pool states rtol 1e-4 / atol 1e-5 (as the rollout tests).
The trainer iterations' overflow-only losses are means of tiny excesses
over ±1 (~1e-5), differences of nearly equal numbers: rtol 1e-4 there.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.config import TrainConfig as JTrainConfig
from vsnca_tpu.losses.appearance import precompute_target_style_features as jprecompute
from vsnca_tpu.losses.orchestrator import LossState as JLossState
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.train.optim import make_optimizer as jmake_optimizer
from vsnca_tpu.train.trainer import DyNCATrainer as JTrainer
from vsnca_tpu.train.trainer import make_train_step as jmake_train_step
from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.convert import params_from_jax, vgg_from_jax
from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
from vsnca_tpu_torch.losses.orchestrator import LossState
from vsnca_tpu_torch.train.optim import make_optimizer
from vsnca_tpu_torch.train.presets import PRESETS
from vsnca_tpu_torch.train.trainer import DyNCATrainer, make_train_step

from test_torch_losses import np_vgg16

torch.set_num_threads(1)

CELL = dict(c_in=12, fc_dim=16, conditioning="pos_emb", padding_mode="circular",
            update_rate=1.0)
LOSS = dict(overflow_weight=100.0, appearance_weight=1.0, appearance_loss_type="Gram")


def _nchw(a):
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def jax_step_result():
    """One JAX train step (rollout_path="xla", remat "none") and its inputs."""
    jcfg = JNCAConfig(**CELL)
    jvgg = [{k: jnp.asarray(v) for k, v in d.items()} for d in np_vgg16(0)]
    params = jdynca.dynca_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    states = rng.uniform(-0.5, 0.5, (2, 32, 32, 12)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    opt = jmake_optimizer(1e-3, (1000, 2000), 0.5)
    step = jmake_train_step(jcfg, JLossState(cfg=JLossConfig(**LOSS), vgg_params=jvgg),
                            opt, remat="none", rollout_path="xla")
    feats = jprecompute(jvgg, jnp.asarray(style), "Gram", (32, 32))
    p2, _, new_states, loss, logs = step(
        params, opt.init(params), jnp.asarray(states), jax.random.PRNGKey(3),
        {"target_style": jnp.asarray(style), "target_style_features": feats}, step_n=4,
    )
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return dict(vgg=[np_(d) for d in jvgg], params=np_(params), states=states,
                style=style, new_params=np_(p2), new_states=np.asarray(new_states),
                loss=float(loss), logs={k: float(v) for k, v in logs.items()})


@pytest.mark.parametrize("rollout_path", ["fused", "xla"])
def test_train_step_matches_jax(jax_step_result, rollout_path):
    """'fused' runs the training pair's plain version, 'xla' the eager
    autograd steps; both must give the JAX step's loss and update."""
    r = jax_step_result
    vgg = vgg_from_jax(r["vgg"], "cpu")
    params = {k: v.requires_grad_() for k, v in params_from_jax(r["params"], "cpu").items()}
    opt = make_optimizer(params, 1e-3, (1000, 2000), 0.5)
    step = make_train_step(NCAConfig(**CELL), LossState(cfg=LossConfig(**LOSS), vgg_params=vgg),
                           "none", rollout_path)
    style = _nchw(r["style"])
    inputs = {"target_style": style,
              "target_style_features": precompute_target_style_features(vgg, style, "Gram",
                                                                        (32, 32))}
    _, _, new_states, loss, logs = step(params, opt, _nchw(r["states"]), 0, inputs, step_n=4)
    print(f"\ntrain step, rollout_path={rollout_path}: loss rel diff "
          f"{abs(float(loss) - r['loss']) / r['loss']:.1e}, updated params max abs diff "
          + f"{max(np.abs(v.detach().numpy() - r['new_params'][k]).max() for k, v in params.items()):.2e}")
    assert float(loss) == pytest.approx(r["loss"], rel=1e-5)
    assert {k: float(v) for k, v in logs.items()} == pytest.approx(r["logs"], rel=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), r["new_params"][k], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.abs(r["new_params"][k] - r["params"][k]).max() > 5e-4  # it moved
    np.testing.assert_allclose(new_states.numpy(), r["new_states"].transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


def test_trainer_iterations_match_jax_draw_for_draw():
    """Three iterations from the same seed: the same batch indices and
    rollout lengths as the JAX trainer (one np.random.RandomState, the same
    order of draws), seed injection at iteration 0 and 2, the pool written
    back, and — from the JAX trainer's parameters and pool — the same
    losses (overflow only, so that JAX compiles no VGG)."""
    train = dict(img_size=(16, 16), batch_size=2, pool_size=6, step_range=(2, 6),
                 step_buckets=(2, 4), inject_seed_every=2, remat="none",
                 rollout_path="xla", seed=7)
    jcfg = JNCAConfig(**dict(CELL, seed_mode="random"))
    jt = JTrainer(jcfg, JLossConfig(overflow_weight=1.0), JTrainConfig(**train))
    pt = DyNCATrainer(NCAConfig(**dict(CELL, seed_mode="random")),
                      LossConfig(overflow_weight=1.0), TrainConfig(**train), device="cpu")
    with torch.no_grad():
        for k, v in pt.params.items():
            v.copy_(torch.from_numpy(np.array(jt.params[k])))
        pt.pool.states.copy_(_nchw(jt.pool.states))
        pt._seed_template.copy_(_nchw(jt._seed_template))

    def next_draws(trainer):
        """(batch indices, step_n) the trainer's next iteration will draw."""
        saved = trainer.rng.get_state()
        idx = trainer.pool.sample_indices(trainer.rng, 2)
        step_n = trainer.sample_step_n()
        trainer.rng.set_state(saved)
        return idx, step_n

    for i in range(3):
        want_idx, step_n = next_draws(jt)
        p_idx, p_step_n = next_draws(pt)
        np.testing.assert_array_equal(p_idx, want_idx)
        assert p_step_n == step_n
        probe = np.random.RandomState()
        probe.set_state(jt.rng.get_state())
        probe.choice(6, 2, replace=False)
        probe.randint(2, 6)
        jlog = jt.train_iteration({})
        plog = pt.train_iteration({})
        np.testing.assert_array_equal(pt.last_batch_idx, jt.last_batch_idx)
        np.testing.assert_array_equal(pt.last_batch_idx, want_idx)
        # both consumed exactly the draws (indices, then rollout length)
        for a, b in zip(pt.rng.get_state()[1:], probe.get_state()[1:]):
            np.testing.assert_array_equal(a, b)
        assert np.isfinite(plog.loss) and plog.iteration == i
        assert plog.loss == pytest.approx(jlog.loss, rel=1e-4)
    np.testing.assert_allclose(pt.pool.states.numpy(),
                               np.asarray(jt.pool.states).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)
    assert len(pt.history) == 3


def test_presets_match_jax():
    from vsnca_tpu.train.presets import PRESETS as JPRESETS

    assert set(PRESETS) == set(JPRESETS) == {"static_texture", "vector_field_motion",
                                             "video_motion", "extra_channels",
                                             "edge_conditioned"}
    for name, theirs_fn in JPRESETS.items():
        mine_fn = PRESETS[name]
        for size in ((), (64,), (256,)):
            for mine, theirs in zip(mine_fn(*size), theirs_fn(*size)):
                assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
    for field in ("diverge", "grad_45_30"):
        for mine, theirs in zip(PRESETS["vector_field_motion"](128, field),
                                JPRESETS["vector_field_motion"](128, field)):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    assert dataclasses.asdict(LossConfig()) == dataclasses.asdict(JLossConfig())


def test_unported_loss_terms_raise():
    """Every term of LossConfig builds; each still raises ValueError without
    what it needs: VGG16 params (auxiliary with a VGG metric, content),
    MSOE params (vector-field and video motion), the model config (style
    consistency). The vector-field term builds its target field once, on
    the MSOE params' device."""
    from vsnca_tpu_torch.losses.appearance import appearance_loss
    from vsnca_tpu_torch.losses.orchestrator import make_loss_fn
    from vsnca_tpu_torch.losses.vector_field import get_motion_vector_field_by_name

    vgg, msoe = [{"w": torch.zeros(1)}], {"w": torch.zeros(1)}
    for term, missing, needs in (("auxiliary_weight", "VGG", dict(vgg_params=vgg)),
                                 ("content_weight", "VGG", dict(vgg_params=vgg)),
                                 ("vector_field_motion_weight", "MSOE",
                                  dict(msoe_params=msoe)),
                                 ("style_consistency_weight", "model config",
                                  dict(nca_cfg=NCAConfig(**CELL)))):
        with pytest.raises(ValueError, match=missing):
            make_loss_fn(LossState(cfg=LossConfig(**{term: 1.0})))
        assert callable(make_loss_fn(LossState(cfg=LossConfig(**{term: 1.0}), **needs)))
    assert callable(make_loss_fn(LossState(cfg=LossConfig(auxiliary_weight=1.0,
                                                          auxiliary_loss_type="MSE"))))
    state = LossState(cfg=LossConfig(vector_field_motion_weight=1.0, motion_img_size=(16, 24),
                                     motion_vector_field_name="3block"), msoe_params=msoe)
    make_loss_fn(state)
    torch.testing.assert_close(state.target_field,
                               get_motion_vector_field_by_name("3block", (16, 24)))
    with pytest.raises(ValueError, match="MSOE"):
        make_loss_fn(LossState(cfg=LossConfig(video_motion_weight=1.0)))
    img = torch.zeros((1, 3, 32, 32))
    with pytest.raises(ValueError, match="appearance loss type"):
        appearance_loss([], img, img, "MotionOT")
