"""The repository root conftest's ``serial_dispatch`` keeps an eager
multi-device TPU-interpret program from deadlocking on a warm compile
cache."""

import subprocess
import sys
from pathlib import Path

# __graft_entry__.py's fused-dp section as a standalone script: the eager
# value_and_grad of the 2-device shard_map'd custom-VJP pair, in interpret
# mode, under the suite's JAX set-up and ``serial_dispatch``, with its
# persistent compile cache at argv[1].
_FUSED_DP_SCRIPT = """
import runpy
import sys
sys.path[:0] = [{tests!r}, {repo!r}]
import conftest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import NCAConfig
from vsnca_tpu.models.dynca import dynca_init, make_conditioning
from vsnca_tpu.parallel.fused_dp import fused_rollout_train_flat_dp
from vsnca_tpu.parallel.mesh import make_mesh

serial_dispatch = runpy.run_path({harness!r})["serial_dispatch"]
jax.config.update("jax_compilation_cache_dir", sys.argv[1])
mesh = make_mesh({{"data": 2}}, jax.devices()[:2])
cfg = NCAConfig(c_in=8, fc_dim=16, padding_mode="circular",
                conditioning="pos_emb", update_rate=1.0)
params = dynca_init(jax.random.PRNGKey(8), cfg)
x = jax.random.uniform(jax.random.PRNGKey(9), (2, 8, 128, 8)) - 0.5
cond = make_conditioning(cfg, (8, 128), batch=2)


def loss(p):
    s, _ = fused_rollout_train_flat_dp(
        mesh, "data", p, x, jnp.float32(7.0), cfg, 2,
        cond_nhwc=cond, cond_no_grad=True,
    )
    return jnp.sum(s * s)


with serial_dispatch(), pltpu.force_tpu_interpret_mode():
    value, _ = jax.value_and_grad(loss)(params)
print(f"loss={{float(value):.2f}}")
"""


def test_fused_dp_eager_reruns_on_a_warm_cache_under_serial_dispatch(tmp_path):
    """The second of two runs over one compile cache must not deadlock.

    The first run fills the cache; without ``serial_dispatch`` the second
    loads the eager multi-device interpret-mode programs from it and hangs.
    """
    tests = Path(__file__).resolve().parent
    script = tmp_path / "fused_dp.py"
    script.write_text(_FUSED_DP_SCRIPT.format(
        tests=str(tests), repo=str(tests.parent),
        harness=str(tests.parent / "conftest.py"),
    ))
    cache = tmp_path / "cache"
    losses = []
    for _ in range(2):
        run = subprocess.run(
            [sys.executable, str(script), str(cache)], cwd=tmp_path,
            capture_output=True, text=True, timeout=120,
        )
        assert run.returncode == 0, run.stderr[-4000:]
        losses.append(run.stdout.strip().splitlines()[-1])
    assert any(cache.iterdir()), "the first run wrote no cache entry"
    assert losses == ["loss=1452.79"] * 2
