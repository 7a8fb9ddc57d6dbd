"""Checkpoints in the JAX package's pickle layout — the port's copy of
``vsnca_tpu/export/checkpoint.py``'s pickle backend: ``state.pkl`` holds a
tree (dicts, lists, tuples) of numpy arrays, ``metadata.json`` the config.

Both packages read each other's files:

- DyNCA: ``{params, opt_state, pool, iteration}``, the params in the
  layout both packages keep (``w1: [P, F]``, ...), the pool NHWC
  ``[N, H, W, C]`` as the JAX trainer keeps it (``convert.pool_from_jax``
  gives the port's NCHW).
- ConditionedNCA: ``{params, opt_state, iteration}``, the params in the
  JAX tree (``convert.cnca_params_to_jax`` / ``cnca_params_from_jax``).
- The port writes its Adam state as ``{"count", "mu", "nu"}`` (mu and nu
  in the params' layout); the JAX package writes optax's named tuples.

``load_checkpoint`` unpickles through ``RestrictedUnpickler``, so a JAX
checkpoint loads without JAX or optax: each ``optax.*`` class becomes a
plain named tuple (``OPTAX_STATE_FIELDS``), and any class outside
``builtins``, ``collections`` and numpy's arrays is refused. Orbax
checkpoints (the JAX CLI's default where orbax imports) need JAX: re-save
them there with ``save_checkpoint(..., backend="pickle")``.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

# the field names of the optax states a checkpoint may hold, by class name
# (optax/_src/base.py, transform.py): the stand-in named tuples take them
OPTAX_STATE_FIELDS = {
    "EmptyState": (),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "ScaleByRmsState": ("nu",),
    "ScaleByRStdDevState": ("mu", "nu"),
    "TraceState": ("trace",),
}

_BUILTINS = frozenset({"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
                       "bool", "str", "bytes", "bytearray", "slice", "range"})
_COLLECTIONS = frozenset({"OrderedDict", "defaultdict", "deque"})
# what numpy's arrays, dtypes and scalars pickle through (numpy 1 and 2)
_NUMPY = frozenset(
    (mod, name)
    for mod in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                "numpy.core.numeric", "numpy._core.numeric")
    for name in ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")
)

_named_tuples: Dict[tuple, type] = {}


def _named_tuple(name: str, fields: tuple) -> type:
    key = (name, fields)
    if key not in _named_tuples:
        _named_tuples[key] = collections.namedtuple(name, fields)
    return _named_tuples[key]


def optax_stand_in(name: str) -> type:
    """The plain class an ``optax.*`` class ``name`` unpickles into: a named
    tuple with the fields of ``OPTAX_STATE_FIELDS``, or, for a state not
    listed, ``field0``, ``field1``, ... for the values the pickle holds."""
    if name in OPTAX_STATE_FIELDS:
        return _named_tuple(name, OPTAX_STATE_FIELDS[name])

    class StandIn(tuple):
        def __new__(cls, *values):
            return _named_tuple(name, tuple(f"field{i}" for i in range(len(values))))(*values)

    StandIn.__name__ = StandIn.__qualname__ = name
    return StandIn


class RestrictedUnpickler(pickle.Unpickler):
    """Unpickles trees of numpy arrays: ``builtins``' and ``collections``'
    containers, numpy's arrays, dtypes and scalars, and optax's states as
    stand-ins (``optax_stand_in``). Every other class is refused, by name."""

    def find_class(self, module: str, name: str):
        if module == "optax" or module.startswith("optax."):
            return optax_stand_in(name)
        if ((module == "builtins" and name in _BUILTINS)
                or (module == "collections" and name in _COLLECTIONS)
                or (module, name) in _NUMPY):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: a checkpoint holds containers, numpy "
            "arrays and optax states only")


def _to_numpy_tree(tree):
    """Every leaf as a numpy array (tensors through ``.detach().cpu()``),
    containers kept: the pickle needs no torch to load."""
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy_tree(v) for v in tree)
    if tree is None:
        return None
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, state: Dict[str, Any], metadata: Optional[dict] = None):
    """``state``: a dict of trees (params, opt_state, pool, iteration, ...)
    of tensors, arrays or numbers; written as numpy arrays to
    ``path/state.pkl``, ``metadata`` to ``path/metadata.json``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.pkl"), "wb") as f:
        pickle.dump(_to_numpy_tree(state), f)
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The state of a pickle checkpoint: ``path`` is its directory (holding
    ``state.pkl``) or the file itself. Raises for an orbax checkpoint."""
    if os.path.isdir(path):
        if os.path.isdir(os.path.join(path, "orbax")):
            raise ValueError(
                f"{path} holds an orbax checkpoint, which needs JAX to read; re-save it on the "
                "JAX side with vsnca_tpu.export.checkpoint.save_checkpoint(..., "
                "backend='pickle')")
        path = os.path.join(path, "state.pkl")
    with open(path, "rb") as f:
        return RestrictedUnpickler(f).load()


def load_metadata(path: str) -> Optional[dict]:
    p = os.path.join(path, "metadata.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
