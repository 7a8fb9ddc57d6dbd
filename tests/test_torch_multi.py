"""The port's fleet trainer (``vsnca_tpu_torch/train/multi.py``) on the CPU:

- against JAX's ``MultiStyleTrainer`` in vmap mode (``rollout_path`` None →
  'xla' there), M = 2 models (seeds 3 and 5) at c6/fc16, pos_emb, 16^2,
  batch 2, pool 4, Gram + overflow, 2 iterations at update_rate 1, each
  model's parameters, pool and seed template carried over from JAX's:
  losses and logs rtol 1e-5 (measured 6e-7); pools rtol 1e-4, atol 1e-6;
  parameters rtol 1e-4, atol 1e-5, 1 % of one Adam step (lr 1e-3): the
  losses' rounding (another VGG16 order) reaches the second normalized
  Adam update, which amplifies it where an element's two gradients nearly
  cancel (measured 6.6e-6 at one element of w1, 1e-7 elsewhere; ROADMAP.md
  C records the class);
- model m against the port's ``DyNCATrainer(seed=seeds[m])`` at update_rate
  0.5: the same init, pool, draws and seeds, so the same bits;
- over a ``model`` axis of 2 gloo ranks, one model each, against the
  one-process fleet: the same bits, and every rank sees the fleet's losses.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.config import TrainConfig as JTrainConfig
from vsnca_tpu.train.multi import MultiStyleTrainer as JMulti
from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.convert import vgg_from_jax
from vsnca_tpu_torch.parallel.mesh import run_ranks
from vsnca_tpu_torch.parallel.ranks import fleet_rank
from vsnca_tpu_torch.train.multi import MultiStyleTrainer
from vsnca_tpu_torch.train.trainer import DyNCATrainer

from test_torch_losses import np_vgg16

torch.set_num_threads(1)
SEEDS = (3, 5)
M, B = len(SEEDS), 2
CELL = dict(c_in=6, fc_dim=16, conditioning="pos_emb", update_rate=1.0)
LOSS = dict(overflow_weight=100.0, appearance_weight=1.0, appearance_loss_type="Gram")
TRAIN = dict(img_size=(16, 16), batch_size=B, pool_size=4, step_range=(3, 6),
             step_buckets=(3, 5), inject_seed_every=2, remat="none", rollout_path="xla",
             seed=1)
STEP_NS = (3, 5)


def _styles():
    return np.random.RandomState(2).rand(M, B, 16, 16, 3).astype(np.float32) * 2 - 1


def _nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


@pytest.fixture(scope="module")
def vgg():
    arrays = np_vgg16(0)
    return arrays, vgg_from_jax(arrays, "cpu")


def test_fleet_matches_jax(vgg):
    arrays, tvgg = vgg
    jt = JMulti(JNCAConfig(**CELL), JLossConfig(**LOSS), JTrainConfig(**TRAIN), SEEDS,
                vgg_params=[{k: jnp.asarray(v) for k, v in d.items()} for d in arrays])
    pt = MultiStyleTrainer(NCAConfig(**CELL), LossConfig(**LOSS), TrainConfig(**TRAIN), SEEDS,
                           vgg_params=tvgg, device="cpu")
    with torch.no_grad():
        for m in range(M):
            for k, v in pt.params[m].items():
                v.copy_(torch.from_numpy(np.array(jt.params[k][m])))
            pt.pools[m].states.copy_(_nchw(jt.pools[m]))
            pt._seed_templates[m].copy_(_nchw(jt._seed_templates[m]))
    styles = _styles()
    for n in STEP_NS:
        jlog = jt.train_iteration({"target_style": jnp.asarray(styles)}, step_n=n)
        plog = pt.train_iteration({"target_style": _nchw(styles)}, step_n=n)
        print(f"step_n {n}: losses {plog.losses} vs JAX {jlog.losses}")
        np.testing.assert_allclose(plog.losses, jlog.losses, rtol=1e-5)
        for k in plog.logs:
            np.testing.assert_allclose(plog.logs[k], jlog.logs[k], rtol=1e-5, err_msg=k)
    for m in range(M):
        want = {k: np.asarray(v[m]) for k, v in jt.params.items()}
        got = pt.model_params(m)
        for k in want:
            print(f"model {m} {k}: max |diff| {np.abs(got[k] - want[k]).max():.3g}")
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(pt.pools[m].states.numpy(), _nchw(jt.pools[m]).numpy(),
                                   rtol=1e-4, atol=1e-6)


def _half_rate():
    return NCAConfig(**dict(CELL, padding_mode="circular", update_rate=0.5))


@pytest.mark.parametrize("rollout_path", ["xla", "fused"])
def test_each_model_is_its_own_trainer(vgg, rollout_path):
    _, tvgg = vgg
    train = TrainConfig(**dict(TRAIN, rollout_path=rollout_path))
    fleet = MultiStyleTrainer(_half_rate(), LossConfig(**LOSS), train, SEEDS, vgg_params=tvgg,
                              device="cpu")
    alone = [DyNCATrainer(_half_rate(), LossConfig(**LOSS), train, vgg_params=tvgg, seed=s,
                          device="cpu") for s in SEEDS]
    styles = _nchw(_styles())
    for n in STEP_NS:
        log = fleet.train_iteration({"target_style": styles}, step_n=n)
        for m, t in enumerate(alone):
            assert t.train_iteration({"target_style": styles[m]}, step_n=n).loss \
                == log.losses[m]
    for m, t in enumerate(alone):
        np.testing.assert_array_equal(fleet.pools[m].states.numpy(), t.pool.states.numpy())
        for k, v in fleet.model_params(m).items():
            np.testing.assert_array_equal(v, t.params[k].detach().numpy())


def test_fleet_over_a_model_axis_equals_one_process(vgg):
    arrays, tvgg = vgg
    styles = _nchw(_styles())
    job = dict(nca=_half_rate(), loss=LossConfig(**LOSS), train=TrainConfig(**TRAIN),
               seeds=SEEDS, vgg=arrays, inputs={"target_style": styles.numpy()},
               iterations=[{"step_n": n} for n in STEP_NS])
    ranks = run_ranks(fleet_rank, 2, "gloo", ["cpu"] * 2, args=(job,), threads=1,
                      timeout=300)
    one = MultiStyleTrainer(_half_rate(), LossConfig(**LOSS), TrainConfig(**TRAIN), SEEDS,
                            vgg_params=tvgg, device="cpu")
    losses = [one.train_iteration({"target_style": styles}, step_n=n).losses for n in STEP_NS]
    for r, rank in enumerate(ranks):
        assert list(rank["models"]) == [r]
        for got, want in zip(rank["losses"], losses):
            np.testing.assert_array_equal(got, want)
        for k, v in rank["params"][0].items():
            np.testing.assert_array_equal(v, one.model_params(r)[k])


def test_fleet_refuses_models_that_do_not_divide():
    from vsnca_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"model": 2}, {"model": 0}, {"model": None})
    with pytest.raises(ValueError, match="n_models 3 must divide evenly over the 2-rank"):
        MultiStyleTrainer(_half_rate(), LossConfig(**LOSS), TrainConfig(**TRAIN), (1, 2, 3),
                          device="cpu", mesh=mesh)
