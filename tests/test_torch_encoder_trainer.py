"""The port's encoder trainer (vsnca_tpu_torch.train.encoder_trainer) and its
losses against the JAX package on the CPU.

- OT, SlW and Gram appearance losses on the same VGG16 feature arrays at
  32^2 (no OT subsample there: no layer is taller than 32; the SlW
  projections are the ones the JAX loss draws from its key, passed in).
  Tolerance rtol 1e-5 (sums of many float32 terms in another order).
- ``ConditionedNCATrainer`` against the JAX trainer over 2 iterations at
  fire rate 1, with Gram and content on the same VGG16 arrays, from the JAX
  trainer's initial parameters: loss rtol 1e-5, parameters atol 1e-4 (one
  normalized-Adam update moves a parameter by up to lr = 2e-3; float32
  rounding of the VGG and loss sums enters each normalized element).
- The port's device pool against its ListPool path, the host dead check,
  damage, collapse recovery, and the CLI on the CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import ConditionedNCAConfig as JCfg
from vsnca_tpu.data.dataset import ConditioningDataset as JDataset
from vsnca_tpu.losses import appearance as jap
from vsnca_tpu.models import vgg as jvgg
from vsnca_tpu.train.encoder_trainer import ConditionedNCATrainer as JTrainer
from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.convert import cnca_params_from_jax, vgg_from_jax
from vsnca_tpu_torch.data.dataset import ConditioningDataset
from vsnca_tpu_torch.losses import appearance as ap
from vsnca_tpu_torch.models import conditioned_nca as cn
from vsnca_tpu_torch.models.vgg import vgg16_random_init, vgg16_style_features
from vsnca_tpu_torch.train import encoder_trainer as et

from test_torch_losses import np_vgg16

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32).transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def feats():
    """VGG16 style features (NHWC for JAX, NCHW for the port) of 2
    generated and 2 style images at 32^2, with the image as a feature."""
    arrays = np_vgg16(0)
    jv = [{k: jnp.asarray(v) for k, v in d.items()} for d in arrays]
    rng = np.random.RandomState(4)
    gen = rng.rand(2, 32, 32, 3).astype(np.float32)
    tgt = rng.rand(2, 32, 32, 3).astype(np.float32)
    jg = jvgg.vgg16_style_features(jv, jnp.asarray(gen), include_image_as_feat=True)
    jt = jvgg.vgg16_style_features(jv, jnp.asarray(tgt), include_image_as_feat=True)
    to_t = lambda fs: [torch.from_numpy(np.asarray(f).transpose(0, 3, 1, 2).copy())  # noqa: E731
                       for f in fs]
    return jg, jt, to_t(jg), to_t(jt)


def test_ot_loss_matches_jax(feats):
    jg, jt, g, t = feats
    want = float(jap.ot_style_loss(jg[1:], jt[1:], jax.random.PRNGKey(0)))
    got = float(ap.ot_style_loss(g[1:], t[1:], torch.Generator().manual_seed(0)))
    print(f"\nOT: port {got:.7f} JAX {want:.7f}")
    assert got == pytest.approx(want, rel=1e-5)


def test_ot_subsample_draws_without_replacement():
    """A layer taller than the threshold with more than ``subsample`` pixels
    is cut to ``subsample`` distinct pixels, the same for both sides: a
    feature map against itself scores 0, against another one does not."""
    g = torch.rand((2, 4, 40, 40), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    assert float(ap.ot_style_loss([g], [g.clone()], gen, subsample=100)) == pytest.approx(
        0.0, abs=1e-5)
    assert float(ap.ot_style_loss([g], [g.flip(-1)], gen, subsample=100)) > 1e-3


def test_slw_loss_matches_jax_with_its_projections(feats):
    jg, jt, g, t = feats
    key = jax.random.PRNGKey(3)
    want = float(jap.sliced_wasserstein_loss(jg, jt, key))
    projs, k = [], key
    for f in jg:  # the JAX loss's own draws, in its order
        k, sub = jax.random.split(k)
        projs.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (f.shape[-1], 32), f.dtype))))
    got = float(ap.sliced_wasserstein_loss(g, t, projections=projs))
    print(f"\nSlW: port {got:.5f} JAX {want:.5f}")
    assert got == pytest.approx(want, rel=1e-5)
    drawn = float(ap.sliced_wasserstein_loss(g, t, torch.Generator().manual_seed(0)))
    assert np.isfinite(drawn) and drawn > 0


def test_gram_loss_matches_jax(feats):
    jg, jt, g, t = feats
    assert float(ap.gram_loss(g, t)) == pytest.approx(float(jap.gram_loss(jg, jt)), rel=1e-5)


def test_resize_nearest_matches_jax():
    from vsnca_tpu.ops.resize import resize_nearest_1d as j_resize
    from vsnca_tpu_torch.ops.resize import resize_nearest_1d

    x = np.random.RandomState(0).rand(2, 3, 17).astype(np.float32)
    for n in (5, 17, 40):
        np.testing.assert_array_equal(resize_nearest_1d(torch.from_numpy(x), n).numpy(),
                                      np.asarray(j_resize(jnp.asarray(x), n)))


TINY = dict(image_size=32, num_hidden_channels=4, update_hidden_dim=16, cell_fire_rate=1.0)
TRAIN = dict(nca_steps=(4, 8), step_buckets=(4, 8), pool_size=16, appearance_loss_type="Gram")


def _port_trainer(**kw):
    imgs = np.random.RandomState(0).rand(5, 32, 32, 3).astype(np.float32)
    style = _nchw(np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32))
    vgg = vgg_from_jax(np_vgg16(0), "cpu")
    args = dict(TRAIN, **kw)
    return et.ConditionedNCATrainer(ConditionedNCAConfig(**TINY), ConditioningDataset(imgs, "cpu"),
                                    style, vgg, device="cpu", **args)


def test_trainer_matches_jax_over_two_iterations():
    """Same seed, same VGG arrays, the JAX trainer's initial parameters: the
    same batch indices and goal images (random.Random and RandomState in
    the JAX order), the same losses and parameters after 2
    iterations of train-twice, and the same pool."""
    imgs = np.random.RandomState(0).rand(5, 32, 32, 3).astype(np.float32)
    style = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    jv = [{k: jnp.asarray(v) for k, v in d.items()} for d in np_vgg16(0)]
    jt = JTrainer(JCfg(**TINY), JDataset(imgs), jnp.asarray(style), jv, **TRAIN)
    pt = _port_trainer()
    with torch.no_grad():
        for k, v in cnca_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params),
                                         "cpu").items():
            pt.params[k].copy_(v)
    for _ in range(2):
        lj, mj = jt.train_iteration(batch_size=4, num_steps=4)
        lp, mp = pt.train_iteration(batch_size=4, num_steps=4)
        print(f"\nloss port {lp:.7f} JAX {lj:.7f}")
        assert lp == pytest.approx(lj, rel=1e-5)
        assert {k: mp[k] for k in mj} == pytest.approx(mj, rel=1e-4)
    assert pt.py_rng.getstate() == jt.py_rng.getstate()
    for a, b in zip(pt.rng.get_state()[1:], jt.rng.get_state()[1:]):
        np.testing.assert_array_equal(a, b)
    want = cnca_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), "cpu")
    for k, v in want.items():
        np.testing.assert_allclose(pt.params[k].detach().numpy(), v.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(pt.pool_states.numpy(),
                               np.asarray(jt.pool_states).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4)


def test_device_pool_matches_list_pool():
    """device_pool=True reproduces the ListPool trainer: same draws, same
    dead reseeds, same losses, params and pool (None entries read as fresh
    seeds)."""
    host, dev = _port_trainer(device_pool=False), _port_trainer()
    for _ in range(3):
        lh, _ = host.train_iteration(batch_size=4, num_steps=4)
        ld, _ = dev.train_iteration(batch_size=4, num_steps=4)
        assert lh == pytest.approx(ld, rel=1e-6)
    for k in host.params:
        torch.testing.assert_close(host.params[k], dev.params[k], rtol=1e-6, atol=1e-7)
    seed1 = cn.conditioned_nca_seed(host.cfg, 1, device="cpu")[0]
    for i, e in enumerate(host.pool.entries):
        want = seed1 if e is None else torch.from_numpy(e)
        torch.testing.assert_close(dev.pool_states[i], want, rtol=1e-6, atol=1e-7)
    assert sum(e is not None for e in host.pool.entries) >= 4


def test_dead_check_matches_the_alive_mask():
    """The host dead check equals sum(alive_mask) == 0 for alive, dead and
    exactly-at-threshold states (the comparison is in float32), and the
    device pool reseeds dead entries."""
    tr = _port_trainer()
    cfg = tr.cfg
    rng = np.random.RandomState(0)
    shape = (cfg.num_channels, 32, 32)
    cases = [rng.rand(*shape).astype(np.float32) * s for s in (0.0, 0.05, 0.2, 1.0)]
    e = np.zeros(shape, np.float32)
    e[cfg.alive_channel] = cfg.alpha_living_threshold
    cases.append(e)
    e2 = e.copy()
    e2[cfg.alive_channel, 3, 3] = cfg.alpha_living_threshold + 1e-4
    cases.append(e2)
    for entry in cases:
        dead = int(cn.alive_mask(torch.from_numpy(entry)[None], cfg).sum()) == 0
        assert tr._is_dead(entry) == dead
    tr.pool_states[5] = torch.from_numpy(cases[4])   # dead: exactly at the threshold
    tr.pool_states[6] = torch.from_numpy(cases[5])   # alive
    batch = tr._gather([0, 1, 5, 6])
    seed1 = cn.conditioned_nca_seed(cfg, 1, device="cpu")[0]
    torch.testing.assert_close(batch[2], seed1)
    torch.testing.assert_close(batch[3], torch.from_numpy(cases[5]))


def test_damage_and_collapse_recovery():
    """Damage zeroes disks in the last entries; recovery after
    ``recovery_patience`` plateaued epochs restores the best params, reseeds
    the pool and resets the optimizer, and training goes on."""
    tr = _port_trainer(num_damaged=2, device_pool=False)
    batch = torch.ones((4, tr.cfg.num_channels, 32, 32))
    out = tr.damage(batch)
    assert float(out[:2].min()) == 1.0 and float(out[2:].min()) == 0.0
    assert 0 < int((out[3, 0] == 0).sum()) <= np.pi * 16
    tr.recovery_patience, tr.recovery_factor = 2, 1.0
    tr.train_iteration(batch_size=4, num_steps=4)
    best = {k: v.clone() for k, v in tr._best_params.items()}
    tr.best_loss = 0.0  # unbeatable: every epoch plateaus
    tr.train_iteration(batch_size=4, num_steps=4)
    assert tr._plateau == 1 and not tr.recoveries
    _, metrics = tr.train_iteration(batch_size=4, num_steps=4)
    assert metrics.get("recovered") == 1.0 and len(tr.recoveries) == 1
    assert all(e is None for e in tr.pool.entries)
    for k, v in best.items():
        torch.testing.assert_close(tr.params[k].detach(), v, rtol=0, atol=0)
    assert not tr.optimizer.adam.state
    loss, metrics = tr.train_iteration(batch_size=4, num_steps=4)
    assert np.isfinite(loss) and 0.0 <= metrics["alive_frac"] <= 1.0
    assert {"overflow", "appearance", "content", "log10loss"} <= set(metrics)


def test_loss_fn_and_grow_preview():
    """Content of identical images is 0; OT and SlW losses run through the
    loss function; grow_preview returns RGB in [0, 1]."""
    vgg = vgg16_random_init(torch.Generator().manual_seed(0), "cpu")
    style = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    img = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    fn = et.make_encoder_loss_fn(vgg, style, appearance_weight=0.0, content_weight=1.0,
                                 overflow_weight=0.0)
    assert float(fn(img, img, img, torch.Generator())[0]) < 1e-10
    for kind in ("OT", "SlW"):
        fn = et.make_encoder_loss_fn(vgg, style, kind)
        total, logs = fn(img, img, img, torch.Generator().manual_seed(2))
        assert np.isfinite(float(total)) and float(logs["appearance"]) > 0
    with pytest.raises(ValueError):
        et.make_encoder_loss_fn(vgg, style, "MotionOT")
    tr = _port_trainer()
    rgb = tr.grow_preview(img, num_steps=4)
    assert rgb.shape == (2, 3, 32, 32) and 0.0 <= float(rgb.min()) <= float(rgb.max()) <= 1.0
    assert len(vgg16_style_features(vgg, img)) == 5


def test_encoder_cli_runs_on_cpu(tmp_path):
    """Two epochs of the CLI at a small size; the checkpoint loads."""
    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.train import encoder_cli

    out = tmp_path / "run"
    encoder_cli.main(["--image-size", "16", "--num-hidden-channels", "4", "--epochs", "2",
                      "--batch-size", "4", "--pool-size", "8", "--min-steps", "2",
                      "--max-steps", "3", "--appearance-loss-type", "Gram",
                      "--log-every", "1", "--out", str(out), "--device", "cpu"])
    params = load_params_pickle(str(out / "checkpoint"), "cpu")
    assert set(params) == set(cn.conditioned_nca_init(
        torch.Generator(), ConditionedNCAConfig(num_hidden_channels=4), "cpu"))
    assert (out / "args.json").exists()
