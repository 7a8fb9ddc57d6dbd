"""Checkpoints across the two packages (``vsnca_tpu_torch/export/checkpoint.py``
and ``convert.py``) on the CPU:

- a JAX training checkpoint (optax state, NHWC pool) loads in the port in a
  process where ``jax`` and ``optax`` cannot be imported, exactly;
- the port's DyNCA and encoder checkpoints load through JAX's
  ``load_checkpoint`` in the JAX trees and shapes, exactly;
- a JAX encoder tree loads through ``convert.load_params_pickle``;
- an orbax checkpoint and any class outside containers, numpy arrays and
  optax states are refused, by name.

Every comparison is exact: the files carry float32 arrays unchanged.
"""

import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import optax
import torch

from vsnca_tpu.config import ConditionedNCAConfig as JConditionedNCAConfig
from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.export.checkpoint import load_checkpoint as jload_checkpoint
from vsnca_tpu.export.checkpoint import save_checkpoint as jsave_checkpoint
from vsnca_tpu.models.conditioned_nca import conditioned_nca_init as jcnca_init
from vsnca_tpu.models.dynca import dynca_init as jdynca_init
from vsnca_tpu.train.optim import make_optimizer as jmake_optimizer
from vsnca_tpu_torch.config import ConditionedNCAConfig, NCAConfig
from vsnca_tpu_torch.convert import (
    cnca_params_from_jax,
    cnca_params_to_jax,
    load_params_pickle,
    pool_from_jax,
)
from vsnca_tpu_torch.export.checkpoint import load_checkpoint, save_checkpoint
from vsnca_tpu_torch.models.conditioned_nca import conditioned_nca_init
from vsnca_tpu_torch.models.dynca import dynca_init
from vsnca_tpu_torch.pool.sample_pool import DevicePool
from vsnca_tpu_torch.train import cli, encoder_cli
from vsnca_tpu_torch.train.optim import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_training_state(seed=0):
    """A JAX CLI checkpoint's state: params, an optax state one update in
    (so that mu and nu are not zero), an NHWC pool, the iteration."""
    cfg = JNCAConfig(c_in=6, fc_dim=8, conditioning="pos_emb")
    params = jdynca_init(jax.random.PRNGKey(seed), cfg)
    opt = jmake_optimizer(1e-3, (500, 1000), 0.5)
    opt_state = opt.init(params)
    grads = jax.tree_util.tree_map(
        lambda p: jax.random.normal(jax.random.PRNGKey(seed + 1), p.shape), params)
    _, opt_state = opt.update(grads, opt_state, params)
    pool = np.random.RandomState(seed).randn(4, 8, 10, 6).astype(np.float32)
    return {"params": params, "opt_state": opt_state, "pool": pool, "iteration": 7}


_BLOCKED_LOAD = """
import sys
sys.modules["jax"] = sys.modules["optax"] = None
import numpy as np
from vsnca_tpu_torch.convert import load_params_pickle, pool_from_jax
from vsnca_tpu_torch.export.checkpoint import load_checkpoint

path, out = sys.argv[1], sys.argv[2]
assert "vsnca_tpu" not in sys.modules
state = load_checkpoint(path)
adam = state["opt_state"][1][0]
params = load_params_pickle(path, "cpu")
arrays = {"pool": pool_from_jax(state["pool"], "cpu").numpy(), "count": adam.count,
          "iteration": state["iteration"]}
arrays.update({f"p_{k}": v.numpy() for k, v in params.items()})
arrays.update({f"mu_{k}": v for k, v in adam.mu.items()})
arrays.update({f"nu_{k}": v for k, v in adam.nu.items()})
np.savez(out, **arrays)
print(type(adam).__name__, adam._fields, type(state["opt_state"][0]).__name__,
      type(state["opt_state"][1][1]).__name__)
"""


def test_jax_training_checkpoint_loads_without_jax_or_optax(tmp_path):
    state = _jax_training_state()
    jsave_checkpoint(str(tmp_path / "ck"), state, backend="pickle")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, str(tmp_path / "ck"),
                        str(tmp_path / "got.npz")], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["ScaleByAdamState", "('count',", "'mu',", "'nu')",
                                "EmptyState", "ScaleByScheduleState"]
    got = np.load(tmp_path / "got.npz")
    np.testing.assert_array_equal(got["pool"], state["pool"].transpose(0, 3, 1, 2))
    assert int(got["iteration"]) == 7
    adam = state["opt_state"][1][0]
    assert int(got["count"]) == int(adam.count) == 1
    for k, v in state["params"].items():
        assert got[f"p_{k}"].dtype == np.float32
        np.testing.assert_array_equal(got[f"p_{k}"], np.asarray(v))
        np.testing.assert_array_equal(got[f"mu_{k}"], np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(got[f"nu_{k}"], np.asarray(adam.nu[k]))
        assert float(np.abs(got[f"nu_{k}"]).max()) > 0.0


def _stepped_optimizer(params, seed=0):
    """The port's optimizer after one update on seeded gradients."""
    opt = make_optimizer(params, 1e-3)
    g = torch.Generator().manual_seed(seed)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    return opt


def test_port_dynca_checkpoint_loads_in_jax(tmp_path):
    cfg = NCAConfig(c_in=6, fc_dim=8, conditioning="edges")
    params = {k: v.requires_grad_() for k, v in
              dynca_init(torch.Generator().manual_seed(0), cfg, "cpu").items()}
    opt = _stepped_optimizer(params)
    pool = torch.randn((4, 6, 8, 10), generator=torch.Generator().manual_seed(1))
    trainer = types.SimpleNamespace(params=params, optimizer=opt, pool=DevicePool(pool),
                                    iteration=1)
    save_checkpoint(str(tmp_path / "ck"), cli.checkpoint_state(trainer),
                    metadata={"nca": {"c_in": 6}})
    got = jload_checkpoint(str(tmp_path / "ck"))
    want = jdynca_init(jax.random.PRNGKey(0), JNCAConfig(c_in=6, fc_dim=8, conditioning="edges"))
    assert jax.tree_util.tree_structure(got["params"]) == jax.tree_util.tree_structure(want)
    for k, v in want.items():
        assert got["params"][k].shape == v.shape and got["params"][k].dtype == np.float32
        np.testing.assert_array_equal(got["params"][k], params[k].detach().numpy())
        st = opt.adam.state[params[k]]
        np.testing.assert_array_equal(got["opt_state"]["mu"][k], st["exp_avg"].numpy())
        np.testing.assert_array_equal(got["opt_state"]["nu"][k], st["exp_avg_sq"].numpy())
    assert int(got["opt_state"]["count"]) == 1 and int(got["iteration"]) == 1
    assert got["pool"].shape == (4, 8, 10, 6)  # NHWC, as the JAX trainer's pool
    np.testing.assert_array_equal(got["pool"], pool.numpy().transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(pool_from_jax(got["pool"], "cpu").numpy(), pool.numpy())
    with open(tmp_path / "ck" / "metadata.json") as f:
        assert json.load(f) == {"nca": {"c_in": 6}}


def test_port_encoder_checkpoint_loads_in_jax_and_back(tmp_path):
    cfg = ConditionedNCAConfig(num_hidden_channels=4)
    params = {k: v.requires_grad_() for k, v in
              conditioned_nca_init(torch.Generator().manual_seed(2), cfg, "cpu").items()}
    opt = _stepped_optimizer(params, 3)
    trainer = types.SimpleNamespace(params=params, optimizer=opt, iteration=5)
    save_checkpoint(str(tmp_path / "ck"), encoder_cli.checkpoint_state(trainer))
    got = jload_checkpoint(str(tmp_path / "ck"))
    want = jcnca_init(jax.random.PRNGKey(0), JConditionedNCAConfig(num_hidden_channels=4))
    tree = jax.tree_util.tree_structure
    assert tree(got["params"]) == tree(want)
    assert tree(got["opt_state"]["mu"]) == tree(got["opt_state"]["nu"]) == tree(want)
    shapes = jax.tree_util.tree_map(np.shape, want)
    assert jax.tree_util.tree_map(np.shape, got["params"]) == shapes
    back = cnca_params_from_jax(got["params"], "cpu")
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v.detach().numpy())
    mu = cnca_params_from_jax(got["opt_state"]["mu"], "cpu")
    for k, p in params.items():
        np.testing.assert_array_equal(mu[k].numpy(), opt.adam.state[p]["exp_avg"].numpy())
    for k, v in load_params_pickle(str(tmp_path / "ck"), "cpu").items():
        np.testing.assert_array_equal(v.numpy(), params[k].detach().numpy())
    assert int(got["iteration"]) == 5 and int(got["opt_state"]["count"]) == 1


def test_jax_encoder_tree_loads_through_load_params_pickle(tmp_path):
    jcfg = JConditionedNCAConfig(num_hidden_channels=4)
    jp = jcnca_init(jax.random.PRNGKey(3), jcfg)
    opt_state = optax.adam(2e-3).init(jp)
    jsave_checkpoint(str(tmp_path / "ck"),
                     {"params": jp, "opt_state": opt_state, "iteration": 2}, backend="pickle")
    got = load_params_pickle(str(tmp_path / "ck" / "state.pkl"), "cpu")
    want = cnca_params_from_jax(_np_tree(jp), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    # and the inverse of cnca_params_from_jax gives the JAX tree back
    again = cnca_params_to_jax(got)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(jp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, _np_tree(jp))


def test_unlisted_optax_state_loads_as_positional_stand_in(tmp_path):
    params = {"w": np.arange(3, dtype=np.float32)}
    st = _np_tree(optax.lion(1e-3).init(params))
    with open(tmp_path / "state.pkl", "wb") as f:
        pickle.dump({"opt_state": st}, f)
    got = load_checkpoint(str(tmp_path))["opt_state"]
    lion = got[0]
    assert type(lion).__name__ == type(st[0]).__name__
    assert lion._fields == tuple(f"field{i}" for i in range(len(st[0])))
    for a, b in zip(lion, st[0]):
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


def test_orbax_checkpoint_is_refused_by_name(tmp_path):
    jsave_checkpoint(str(tmp_path / "ck"), {"params": {"w1": np.ones((2, 2), np.float32)}},
                     backend="orbax")
    assert (tmp_path / "ck" / "orbax").is_dir()
    with pytest.raises(ValueError, match=r"orbax checkpoint, which needs JAX.*backend='pickle'"):
        load_checkpoint(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="orbax"):
        load_params_pickle(str(tmp_path / "ck"), "cpu")


class _Calls:
    """Pickles as a call of ``fn`` on ``args``."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("obj, name", [
    (_Calls(os.system, "exit 3"), f"{os.system.__module__}.system"),
    (_Calls(eval, "1 + 1"), "builtins.eval"),
    (_Calls(getattr, "abc", "upper"), "builtins.getattr"),
    (types.SimpleNamespace(a=1), "types.SimpleNamespace"),
], ids=["os.system", "eval", "getattr", "SimpleNamespace"])
def test_unknown_module_is_refused_by_name(tmp_path, obj, name):
    with open(tmp_path / "state.pkl", "wb") as f:
        pickle.dump({"params": {"w1": np.zeros(2, np.float32)}, "x": obj}, f)
    with pytest.raises(pickle.UnpicklingError, match=f"refusing to unpickle {name}"):
        load_checkpoint(str(tmp_path))
