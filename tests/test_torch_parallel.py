"""The port's multi-device paths (``vsnca_tpu_torch/parallel``) on the CPU,
in gloo ranks spawned once per rank count for every case of the file:

- ``spatial_rollout`` over 2 and 4 ranks against JAX's ``spatial_rollout``
  over as many virtual devices and against JAX's dense rollout, at
  update_rate 1, in the three padding modes, for perception scales (0, 1)
  and with conditioning: rtol 1e-4, atol 1e-5 (as the rollout tests);
  and against the port's dense eager rollout at update_rate 0.5, bit for
  bit (the masks are keyed by the global pixel index);
- ``fused_rollout_train_flat_dp`` over 2 ranks against ``fused_rollout_train``
  of the whole batch (the pair's plain version) at update_rate 0.5: the
  states bit for bit, the x gradient bit for bit once scaled by the rank
  count (a rank's loss is a mean over its half of the batch), the averaged
  parameter gradients within 1e-6 of their largest element (another order
  of the batch sum);
- the training CLI's ``--dp`` refused on a machine with fewer cards (its
  gloo run is in ``tests/test_torch_cli_dp.py``);
- the port's new modules import neither JAX nor the JAX package.
"""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.parallel.mesh import make_mesh as jmake_mesh
from vsnca_tpu.parallel.spatial import spatial_rollout as jspatial_rollout
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.models.dynca import dynca_init, dynca_rollout, make_conditioning
from vsnca_tpu_torch.ops.fused_train import fused_rollout_train
from vsnca_tpu_torch.parallel.mesh import run_ranks
from vsnca_tpu_torch.parallel.ranks import fused_dp_rank, spatial_rank

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
# (name, config fields, H): every padding at scales (0,), multiscale (circular,
# its slab >= the 6-row halo at 4 ranks), conditioning at scales (0,) and (0, 1)
CASES = [
    ("circular", dict(padding_mode="circular"), 16),
    ("replicate", dict(padding_mode="replicate"), 16),
    ("zeros", dict(padding_mode="zeros"), 16),
    ("multiscale", dict(padding_mode="circular", perception_scales=(0, 1)), 48),
    ("edges", dict(padding_mode="replicate", conditioning="edges"), 16),
    ("multiscale_pos_emb", dict(padding_mode="circular", perception_scales=(0, 1),
                                conditioning="pos_emb"), 48),
]
RATES = (1.0, 0.5)


def _cfg(fields, rate, cls=NCAConfig):
    return cls(**{"c_in": 6, "fc_dim": 16, "conditioning": None, "update_rate": rate,
                  **fields})


def _inputs(name, fields, h):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    cfg = _cfg(fields, 1.0)
    params = {k: v.numpy() for k, v in dynca_init(torch.Generator().manual_seed(3), cfg,
                                                  "cpu").items()}
    x = rng.uniform(-0.5, 0.5, (2, 6, h, 20)).astype(np.float32)
    cond = (rng.uniform(-1, 1, (2, cfg.c_cond, h, 20)).astype(np.float32)
            if cfg.c_cond else None)
    return params, x, cond


@pytest.fixture(scope="module")
def spatial_runs():
    """{(world, name, rate): the gathered state} from one spawn a rank count."""
    jobs, keys = [], []
    for name, fields, h in CASES:
        params, x, cond = _inputs(name, fields, h)
        for rate in RATES:
            jobs.append(dict(cfg=_cfg(fields, rate), params=params, x=x, cond=cond, seed=11,
                             n_steps=STEPS))
            keys.append((name, rate))
    out = {}
    for world in (2, 4):
        res = run_ranks(spatial_rank, world, "gloo", ["cpu"] * world, args=(jobs,),
                        threads=1, timeout=300)
        for key, r in zip(keys, res[0]):
            out[(world,) + key] = r["state"]
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,fields,h", CASES, ids=[c[0] for c in CASES])
def test_spatial_rollout_matches_jax(spatial_runs, world, name, fields, h):
    params, x, cond = _inputs(name, fields, h)
    jcfg = _cfg(fields, 1.0, JNCAConfig)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    jc = None if cond is None else jnp.asarray(cond.transpose(0, 2, 3, 1))
    mesh = jmake_mesh({"space": world}, jax.devices()[:world])
    key = jax.random.PRNGKey(0)
    sharded, _ = jspatial_rollout(jp, jx, key, jcfg, STEPS, mesh, cond=jc)
    dense, _ = jdynca.dynca_rollout(jp, jx, key, jcfg, STEPS, cond=jc, remat="none")
    got = spatial_runs[(world, name, 1.0)].transpose(0, 2, 3, 1)
    print(f"{name} x{world}: vs JAX sharded {np.abs(got - np.asarray(sharded)).max():.3g}, "
          f"vs JAX dense {np.abs(got - np.asarray(dense)).max():.3g}")
    np.testing.assert_allclose(got, np.asarray(sharded), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,fields,h", CASES, ids=[c[0] for c in CASES])
def test_spatial_rollout_equals_the_dense_rollout_bit_for_bit(spatial_runs, world, name,
                                                              fields, h, rate):
    params, x, cond = _inputs(name, fields, h)
    want, _ = dynca_rollout({k: torch.from_numpy(v) for k, v in params.items()},
                            torch.from_numpy(x), 11, _cfg(fields, rate), STEPS,
                            None if cond is None else torch.from_numpy(cond),
                            rollout_path="xla")
    np.testing.assert_array_equal(spatial_runs[(world, name, rate)], want.numpy())


def test_spatial_rollout_refuses_what_jax_refuses():
    from vsnca_tpu_torch.parallel.mesh import Mesh
    from vsnca_tpu_torch.parallel.spatial import spatial_rollout

    mesh = Mesh({"space": 2}, {"space": 0}, {"space": None})
    params = dynca_init(torch.Generator().manual_seed(0), _cfg({}, 1.0), "cpu")
    x = torch.zeros((1, 6, 8, 8))
    with pytest.raises(ValueError, match="circular"):
        spatial_rollout(params, x, 0, _cfg({"perception_scales": (0, 1),
                                            "padding_mode": "zeros"}, 1.0), 1, mesh)
    with pytest.raises(ValueError, match="even slab of at least 6"):
        spatial_rollout(params, torch.zeros((1, 6, 4, 8)), 0,
                        _cfg({"perception_scales": (0, 1), "padding_mode": "circular"}, 1.0),
                        1, mesh)
    with pytest.raises(ValueError, match="perception_scales"):
        spatial_rollout(params, x, 0, _cfg({"perception_scales": (0, 2)}, 1.0), 1, mesh)


def test_fused_dp_pair_matches_the_whole_batch():
    cfg = NCAConfig(c_in=8, fc_dim=16, padding_mode="circular", conditioning="pos_emb",
                    update_rate=0.5)
    params = {k: v.numpy() for k, v in dynca_init(torch.Generator().manual_seed(0), cfg,
                                                  "cpu").items()}
    rng = np.random.RandomState(1)
    x = rng.uniform(-0.5, 0.5, (4, 8, 16, 16)).astype(np.float32)
    gy = rng.randn(4, 8, 16, 16).astype(np.float32)
    cond = make_conditioning(cfg, (16, 16), batch=4, device="cpu").numpy()
    got = run_ranks(fused_dp_rank, 2, "gloo", ["cpu"] * 2,
                    args=(dict(cfg=cfg, params=params, x=x, gy=gy, cond=cond, seed=123,
                               n_steps=5),), threads=1, timeout=300)
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    state = fused_rollout_train(pt, xt, 123, cfg, 5, torch.from_numpy(cond), cond_no_grad=True)
    ((state * torch.from_numpy(gy)).sum() / 4).backward()
    np.testing.assert_array_equal(got[0]["state"], state.detach().numpy())
    np.testing.assert_array_equal(got[0]["grad_x"] / 2, xt.grad.numpy())
    for k, v in pt.items():
        err = np.abs(got[0]["grads"][k] - v.grad.numpy()).max() / np.abs(v.grad.numpy()).max()
        print(f"{k}: averaged gradient within {err:.3g} of its largest element")
        assert err < 1e-6, k
        np.testing.assert_array_equal(got[0]["grads"][k], got[1]["grads"][k])


def test_cli_dp_refuses_more_ranks_than_cards(tmp_path):
    from vsnca_tpu_torch.train import cli

    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"--dp {n + 1} needs {n + 1} CUDA devices, "
                                           f"{n} visible"):
        cli.main(["--dp", str(n + 1), "--out", str(tmp_path)])


NEW_MODULES = [
    "vsnca_tpu_torch.parallel.mesh", "vsnca_tpu_torch.parallel.fused_dp",
    "vsnca_tpu_torch.parallel.train_dp", "vsnca_tpu_torch.parallel.spatial",
    "vsnca_tpu_torch.parallel.ranks", "vsnca_tpu_torch.train.multi",
    "vsnca_tpu_torch.train.cli", "vsnca_tpu_torch.examples.export_webgl",
    "vsnca_tpu_torch.examples.interactive_growth", "vsnca_tpu_torch.examples.learning_proof",
    "vsnca_tpu_torch.examples.train_encoder", "vsnca_tpu_torch.examples.train_vector_field",
    "vsnca_tpu_torch.examples.train_video_motion",
]


def test_new_modules_import_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'vsnca_tpu' or m.startswith('vsnca_tpu.'))\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
