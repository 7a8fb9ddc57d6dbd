"""The port's data-parallel trainer (``DyNCATrainer(mesh=...)``,
``parallel/train_dp.py``, ``parallel/fused_dp.py``) on the CPU, in 2 gloo
ranks spawned once for every case of the file:

- against JAX's single-device ``DyNCATrainer`` and its
  ``DyNCATrainer(mesh=4 devices, rollout_path="xla")``, as
  ``tests/test_parallel.py:121-163`` holds JAX's own: c6/fc16, pos_emb,
  16^2, batch 4, pool 8, Gram + overflow, 3 iterations at update_rate 1
  (the masks do not matter), from JAX's parameters, pool and seed
  template: the same batch indices; loss rtol 1e-5; parameters and pool
  rtol 1e-4, atol 1e-6;
- against the port's single-process trainer at update_rate 0.5, through the
  eager steps and the training pair's plain version: every rank draws its
  rows' single-process masks, so the first iteration's pool write-back is
  the single-process one bit for bit; the gradient is summed in another
  order (a mean of two half-batch gradients), so the losses then agree to
  rtol 1e-5 and the parameters and pool, after three normalized-Adam
  updates, to rtol 1e-4, atol 1e-5; the two ranks hold the same bits;
- the reference tap schedule (chunks (1, 4, 4), MotionGram x 5 on MSOE)
  against JAX's single-device trainer, as ``test_parallel.py:178``:
  ``target_motion_frames`` is split on its batch dimension 1.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import LossConfig as JLossConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.config import TrainConfig as JTrainConfig
from vsnca_tpu.models import msoe as jmsoe
from vsnca_tpu.models.dynca import tap_schedule as jtap_schedule
from vsnca_tpu.parallel.mesh import make_mesh as jmake_mesh
from vsnca_tpu.train.trainer import DyNCATrainer as JTrainer
from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
from vsnca_tpu_torch.convert import vgg_from_jax
from vsnca_tpu_torch.parallel.mesh import run_ranks
from vsnca_tpu_torch.parallel.ranks import dp_train_rank
from vsnca_tpu_torch.train.trainer import DyNCATrainer

from test_torch_losses import np_vgg16

torch.set_num_threads(1)
N = 4
CELL = dict(c_in=6, fc_dim=16, conditioning="pos_emb", update_rate=1.0)
LOSS = dict(overflow_weight=100.0, appearance_weight=1.0, appearance_loss_type="Gram")
TRAIN = dict(img_size=(16, 16), batch_size=N, pool_size=8, step_range=(3, 4),
             step_buckets=(3,), max_iterations=3, remat="none", inject_seed_every=1,
             rollout_path="xla")
TAP_LOSS = dict(LOSS, video_motion_weight=5.0, video_motion_loss_type="MotionGram",
                motion_img_size=(16, 16))
TAP_TRAIN = dict(TRAIN, step_range=(9, 10), step_buckets=(9,), max_iterations=2)


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _style():
    return np.random.RandomState(1).rand(N, 16, 16, 3).astype(np.float32) * 2 - 1


def _jax_run(loss, train, inputs, iterations, mesh=None, msoe=None):
    jvgg = [{k: jnp.asarray(v) for k, v in d.items()} for d in np_vgg16(0)]
    t = JTrainer(JNCAConfig(**CELL), JLossConfig(**loss), JTrainConfig(**train),
                 vgg_params=jvgg, msoe_params=msoe, seed=7, mesh=mesh)
    start = dict(params={k: np.asarray(v) for k, v in t.params.items()},
                 pool=_nchw(t.pool.states), seed_template=_nchw(t._seed_template))
    logs, idx = [], []
    for kw in iterations:
        logs.append(t.train_iteration({k: jnp.asarray(v) for k, v in inputs.items()}, **kw))
        idx.append(np.asarray(t.last_batch_idx))
    return dict(start=start, losses=[log.loss for log in logs], idx=idx,
                params={k: np.asarray(v) for k, v in t.params.items()},
                pool=_nchw(t.pool.states))


@pytest.fixture(scope="module")
def runs():
    """JAX's runs and every port job, the port's in one 2-rank spawn."""
    style = _style()
    ref = _jax_run(LOSS, TRAIN, {"target_style": style}, [{}] * 3)
    on_mesh = _jax_run(LOSS, TRAIN, {"target_style": style}, [{}] * 3,
                       mesh=jmake_mesh({"data": N}, jax.devices()[:N]))
    chunks, tail = jtap_schedule(9, 4)
    tap_kw = dict(step_n=9, tap_chunks=chunks, tail_steps=tail)
    tgt = np.stack([style * (0.9 - 0.1 * k) for k in range(3)])
    msoe_np = {k: np.asarray(v) for k, v in jmsoe.msoe_random_init(
        jax.random.PRNGKey(1)).items()}
    taps = _jax_run(TAP_LOSS, TAP_TRAIN, {"target_style": style, "target_motion_frames": tgt},
                    [tap_kw] * 2, msoe={k: jnp.asarray(v) for k, v in msoe_np.items()})

    vgg = np_vgg16(0)
    jobs = [dict(nca=NCAConfig(**CELL), loss=LossConfig(**LOSS), train=TrainConfig(**TRAIN),
                 vgg=vgg, seed=7, inputs={"target_style": _nchw(style)},
                 iterations=[{}] * 3, keep_pools=True, **ref["start"]),
            dict(nca=NCAConfig(**CELL), loss=LossConfig(**TAP_LOSS),
                 train=TrainConfig(**TAP_TRAIN), vgg=vgg, msoe=msoe_np, seed=7,
                 inputs={"target_style": _nchw(style),
                         "target_motion_frames": np.stack([_nchw(f) for f in tgt])},
                 iterations=[tap_kw] * 2, **taps["start"])]
    for path in ("xla", "fused"):
        jobs.append(dict(nca=_half_rate_cell(), loss=LossConfig(**LOSS),
                         train=TrainConfig(**dict(TRAIN, rollout_path=path)), vgg=vgg,
                         seed=7, inputs={"target_style": _nchw(style)},
                         iterations=[{}] * 3, keep_pools=True))
    port = run_ranks(dp_train_rank, 2, "gloo", ["cpu"] * 2, args=(jobs,), threads=1,
                     timeout=300)
    return dict(ref=ref, on_mesh=on_mesh, taps=taps, port=port)


def _half_rate_cell():
    return NCAConfig(**dict(CELL, padding_mode="circular", update_rate=0.5))


def _close(got, want, what, rtol, atol):
    for k in want:
        print(f"{what} {k}: max |diff| {np.abs(got[k] - want[k]).max():.3g}")
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("jax_run", ["ref", "on_mesh"])
def test_dp_trainer_matches_jax(runs, jax_run):
    want = runs[jax_run]
    got = runs["port"][0][0]
    np.testing.assert_allclose([log["loss"] for log in got["logs"]], want["losses"],
                               rtol=1e-5)
    for i, idx in enumerate(want["idx"]):
        np.testing.assert_array_equal(got["batch_idx"][i], idx)
    _close(got["params"], want["params"], "params", 1e-4, 1e-6)
    _close({"pool": got["pools"][-1]}, {"pool": want["pool"]}, "pool", 1e-4, 1e-6)
    for k, v in runs["port"][1][0]["params"].items():  # the ranks hold the same bits
        np.testing.assert_array_equal(v, got["params"][k])


def test_dp_trainer_tap_schedule_matches_jax(runs):
    want = runs["taps"]
    got = runs["port"][0][1]
    np.testing.assert_allclose([log["loss"] for log in got["logs"]], want["losses"],
                               rtol=1e-5)
    _close(got["params"], want["params"], "params", 1e-4, 1e-6)


@pytest.mark.parametrize("job,path", [(2, "xla"), (3, "fused")])
def test_dp_trainer_matches_one_process_at_half_rate(runs, job, path):
    style = torch.from_numpy(_nchw(_style()))
    vgg = vgg_from_jax(np_vgg16(0), "cpu")
    one = DyNCATrainer(_half_rate_cell(), LossConfig(**LOSS),
                       TrainConfig(**dict(TRAIN, rollout_path=path)), vgg_params=vgg, seed=7,
                       device="cpu")
    losses, pools = [], []
    for _ in range(3):
        losses.append(one.train_iteration({"target_style": style}).loss)
        pools.append(one.pool.states.numpy().copy())
    got = runs["port"][0][job]
    # the first write-back comes from the same parameters and masks
    np.testing.assert_array_equal(got["pools"][0], pools[0])
    print(f"{path}: losses {losses} vs {[log['loss'] for log in got['logs']]}")
    np.testing.assert_allclose([log["loss"] for log in got["logs"]], losses, rtol=1e-5)
    _close(got["params"], {k: v.detach().numpy() for k, v in one.params.items()}, "params",
           1e-4, 1e-5)
    _close({"pool": got["pools"][-1]}, {"pool": pools[-1]}, "pool", 1e-4, 1e-5)
    for k, v in runs["port"][1][job]["params"].items():
        np.testing.assert_array_equal(v, got["params"][k])


def test_dp_trainer_refuses_a_batch_that_does_not_divide():
    from vsnca_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 3}, {"data": 0}, {"data": None})
    with pytest.raises(ValueError, match="batch_size 4 must divide evenly over the 3-rank"):
        DyNCATrainer(NCAConfig(**CELL), LossConfig(overflow_weight=1.0),
                     TrainConfig(**TRAIN), device="cpu", mesh=mesh)
