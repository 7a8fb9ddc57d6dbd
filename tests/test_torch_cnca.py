"""The port's ConditionedNCA (vsnca_tpu_torch.models.conditioned_nca, the
encoder, the rollout's plain version and the grower) against the JAX
package on the CPU, from the same numpy inputs and the JAX package's own
initial parameters (``convert.cnca_params_from_jax``).

Tolerances: float32 rtol 1e-5 / atol 1e-5 for whole grows and the grower
(the percept's 9-tap sums and the MLP's products are summed in another
order than XLA's; measured at most ~1e-6, printed with ``-s``), 1e-6 for one
step and the pieces. The fire mask: at rate 1 every route fires everywhere,
so grows compare exactly; at rate < 1 the port draws its own hash masks
(``jax.random``'s bits are not reproducible), so the step is compared with
the JAX step's own mask passed in explicitly, and the rollout by its mask
fraction. The JAX fused kernel runs in interpret mode under
``pltpu.force_tpu_interpret_mode()``, as tests/test_pallas_cnca.py runs it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import ConditionedNCAConfig as JCfg
from vsnca_tpu.infer.grower import InteractiveGrower as JGrower
from vsnca_tpu.models import conditioned_nca as jcn
from vsnca_tpu.models.encoder import image_encoder_apply as j_encoder_apply
from vsnca_tpu.ops.pallas_cnca import fused_cnca_rollout as j_fused_rollout
from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.convert import cnca_params_from_jax
from vsnca_tpu_torch.infer.grower import InteractiveGrower
from vsnca_tpu_torch.models import conditioned_nca as cn
from vsnca_tpu_torch.models.encoder import image_encoder_apply
from vsnca_tpu_torch.ops import fused_cnca as fc
from vsnca_tpu_torch.ops import fused_step as fs

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32).transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _setup(size=16, b=2, hidden=4, d=16, rate=1.0, use_life=True, h=None, seed=0):
    kw = dict(image_size=size, num_hidden_channels=hidden, update_hidden_dim=d,
              cell_fire_rate=rate, use_living_channel=use_life)
    jcfg, cfg = JCfg(**kw), ConditionedNCAConfig(**kw)
    jp = jcn.conditioned_nca_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + 1)
    hh = h or size
    x = np.zeros((b, hh, size, cfg.num_channels), np.float32)
    x[:, hh // 2, size // 2, cfg.alive_channel:] = 1.0
    x += 0.3 * rng.randn(*x.shape).astype(np.float32)
    goal = rng.rand(b, hh, size, 3).astype(np.float32)
    params = cnca_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, params, x, goal


def test_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(ConditionedNCAConfig()) == dataclasses.asdict(JCfg())
    for kw in ({}, {"living_channel_dim": 5}, {"num_hidden_channels": 4}):
        a, b = ConditionedNCAConfig(**kw), JCfg(**kw)
        assert (a.num_channels, a.alive_channel) == (b.num_channels, b.alive_channel)


def test_pieces_match_jax():
    """_depthwise_perceive (channel-major c*3+s), alive_mask, the encoder and
    encode_goal on a non-square 12 x 20 grid."""
    jcfg, cfg, jp, params, x, goal = _setup(size=20, h=12, hidden=16, d=64)
    got = cn._depthwise_perceive(_nchw(x), params["perception_w"])
    want = jcn._depthwise_perceive(jnp.asarray(x), jp["perception_w"])
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    xa = x.copy()
    xa[..., cfg.alive_channel] = np.where(np.random.RandomState(3).rand(*x.shape[:3]) < 0.9,
                                          0.05, 0.2)
    np.testing.assert_array_equal(_nhwc(cn.alive_mask(_nchw(xa), cfg)),
                                  np.asarray(jcn.alive_mask(jnp.asarray(xa), jcfg)))
    enc = {k[len("encoder."):]: v for k, v in params.items() if k.startswith("encoder.")}
    np.testing.assert_allclose(_nhwc(image_encoder_apply(enc, _nchw(goal))),
                               np.asarray(j_encoder_apply(jp["encoder"], jnp.asarray(goal))),
                               rtol=1e-5, atol=1e-6)
    genc = cn.encode_goal(params, cfg, _nchw(goal))
    assert float(genc[:, :cfg.num_channels - cfg.num_hidden_channels].abs().max()) == 0.0
    np.testing.assert_allclose(_nhwc(genc),
                               np.asarray(jcn.encode_goal(jp, jcfg, jnp.asarray(goal))),
                               rtol=1e-5, atol=1e-6)


def test_init_draws_the_reference_distribution():
    """The port's own init (a torch.Generator): the JAX init's shapes and
    torch's default bounds (perception ±1/3, UpdateNet ±1/sqrt(fan_in), zero
    biases)."""
    cfg = ConditionedNCAConfig()
    p = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = cnca_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcn.conditioned_nca_init(jax.random.PRNGKey(0), JCfg())), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    assert float(p["perception_w"].abs().max()) <= 1 / 3
    assert float(p["update1.w"].abs().max()) <= 1 / np.sqrt(60)
    assert float(p["update1.b"].abs().max()) == 0.0 == float(p["update2.b"].abs().max())


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_step_with_explicit_mask_matches_jax(rate):
    """One step, the JAX step's own Bernoulli mask passed to the port's."""
    jcfg, cfg, jp, params, x, goal = _setup(size=16, hidden=16, d=64, rate=rate)
    genc = jcn.encode_goal(jp, jcfg, jnp.asarray(goal))
    key = jax.random.PRNGKey(5)
    want = jcn.conditioned_nca_step(jp, jnp.asarray(x), genc, key, jcfg)
    mask = np.asarray(jax.random.uniform(key, (2, 16, 16, 1)) < rate, np.float32)
    got = cn.conditioned_nca_step(params, _nchw(x), _nchw(genc), _nchw(mask), cfg)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,use_life", [(16, True), (32, True), (16, False)])
def test_grow_at_fire_rate_one_matches_jax(size, use_life):
    """conditioned_nca_grow on the CPU (eager steps, and the pair's and the
    rollout's plain versions) against the JAX scan, 6 steps."""
    jcfg, cfg, jp, params, x, goal = _setup(size=size, hidden=16, d=64, use_life=use_life)
    want = np.asarray(jcn.conditioned_nca_grow(jp, jnp.asarray(x), jnp.asarray(goal),
                                               jax.random.PRNGKey(3), jcfg, 6))
    for path in ("auto", "fused"):
        got = cn.conditioned_nca_grow(params, _nchw(x), _nchw(goal), 9, cfg, 6,
                                      rollout_path=path)
        print(f"\ngrow {size}^2 living={use_life} {path}: max |port - JAX| "
              f"{np.abs(_nhwc(got) - want).max():.2e}")
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_plain_rollout_matches_interpret_kernel():
    """fused_cnca_rollout's plain version against the TPU kernel in interpret
    mode (fire rate 1), with and without the living channel, and the bf16
    plain version against the bf16 kernel (same rounding places; 1e-2)."""
    for use_life in (True, False):
        jcfg, cfg, jp, params, x, goal = _setup(size=16, hidden=16, d=64, use_life=use_life)
        genc = jcn.encode_goal(jp, jcfg, jnp.asarray(goal))
        for cdt, tol in (("float32", 1e-5), ("bfloat16", 1e-2)):
            if cdt == "bfloat16" and not use_life:
                continue
            with pltpu.force_tpu_interpret_mode():
                want = np.asarray(j_fused_rollout(jp, jnp.asarray(x), genc, 7, jcfg, 4,
                                                  interpret=True, compute_dtype=cdt))
            got = fc.fused_cnca_rollout(params, _nchw(x), _nchw(genc), 7, cfg, 4, cdt)
            print(f"\nrollout living={use_life} {cdt}: max |port - interpret kernel| "
                  f"{np.abs(_nhwc(got) - want).max():.2e}")
            np.testing.assert_allclose(_nhwc(got), want, rtol=tol, atol=tol)


def test_grower_matches_jax_grower():
    """InteractiveGrower at fire rate 1, 32^2: seed, 5 steps, goal switch,
    damage, 3 steps, reset — every readout and state as the JAX grower's."""
    jcfg, cfg, jp, params, x, goal = _setup(size=32, hidden=16, d=64)
    g1, g2 = goal[:1], goal[1:]
    jg = JGrower(jp, jcfg, jnp.asarray(g1), size=32, key=jax.random.PRNGKey(0))
    pg = InteractiveGrower(params, cfg, g1, size=32, device="cpu")
    assert tuple(pg.state.shape) == (1, cfg.num_channels, 32, 32)
    np.testing.assert_array_equal(_nhwc(pg.state), np.asarray(jg.state))

    def same(tol=1e-5):
        np.testing.assert_allclose(_nhwc(pg.state), np.asarray(jg.state), rtol=tol, atol=tol)

    np.testing.assert_allclose(pg.step(5), jg.step(5), rtol=1e-5, atol=1e-5)
    same()
    jg.set_goal(jnp.asarray(g2))
    pg.set_goal(g2)
    np.testing.assert_allclose(pg.goal_encoding.numpy(),
                               np.asarray(jg.goal_encoding).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)
    jg.damage(16, 16, 5)
    pg.damage(16, 16, 5)
    assert float(pg.state[0, :, 16, 16].abs().max()) == 0.0
    same()
    pg.step(1)
    jg.step(1)
    np.testing.assert_allclose(pg.step(2), jg.step(2), rtol=1e-5, atol=1e-5)
    same()
    rgb = pg.rgb()
    assert rgb.shape == (32, 32, 3) and rgb.min() >= 0.0 and rgb.max() <= 1.0
    pg.reset()
    jg.reset()
    np.testing.assert_array_equal(_nhwc(pg.state), np.asarray(jg.state))


def test_rollout_mask_fraction_at_half_rate():
    """At fire rate 0.5 the hash masks fire about half the pixels, differ by
    step and batch entry, and the rollout's plain version equals the eager
    steps with those masks."""
    masks = [fs.update_mask(3, bi, s, 32, 32, 0.5) for bi in range(2) for s in range(3)]
    fracs = [float(m.mean()) for m in masks]
    assert all(0.42 < f < 0.58 for f in fracs), fracs
    assert float((masks[0] - masks[1]).abs().sum()) > 0
    assert float((masks[0] - masks[3]).abs().sum()) > 0
    jcfg, cfg, jp, params, x, goal = _setup(size=16, rate=0.5)
    genc = cn.encode_goal(params, cfg, _nchw(goal))
    with torch.no_grad():
        got = fc.fused_cnca_rollout(params, _nchw(x), genc, 3, cfg, 4)
        want = cn.grow_from_encoding(params, _nchw(x), genc, 3, cfg, 4, remat="none")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_compute():
    for kw, match in (({"alpha_living_threshold": 0.0}, "threshold"),
                      ({"num_hidden_channels": 24}, "limits"),
                      ({"update_hidden_dim": 80}, "limits")):
        cfg = ConditionedNCAConfig(image_size=8, **kw)
        params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, "cpu")
        x = cn.conditioned_nca_seed(cfg, 1, 8, "cpu")
        with pytest.raises(ValueError, match=match):
            fc.fused_cnca_rollout(params, x, torch.zeros_like(x), 0, cfg, 2)
    cfg = ConditionedNCAConfig(image_size=8)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = cn.conditioned_nca_seed(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="n_steps"):
        fc.fused_cnca_rollout(params, x, torch.zeros_like(x), 0, cfg, 0)
    with pytest.raises(ValueError, match="no kernel"):
        fs.check_card_inputs(x)
