"""Parameters from the JAX package.

The JAX package's DyNCA parameters are a plain dict of arrays in the layout
the port keeps (``w1: [P, F]``, ``b1: [F]``, ``w2: [F, C]``, ``b2: [C]``), so
carrying them across is a copy; its VGG16 kernels are HWIO and become OIHW;
its ConditionedNCA tree becomes the port's flat dict and back; its DyNCA
pool is NHWC and becomes NCHW. Its pickle checkpoints
(``vsnca_tpu/export/checkpoint.py``, the ``state.pkl`` backend) load
without JAX through the port's ``export.checkpoint.load_checkpoint``;
orbax checkpoints are refused there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.export.checkpoint import load_checkpoint


def params_from_jax(np_params: dict, device=None) -> Dict[str, torch.Tensor]:
    """{name: array} (numpy, or anything ``np.asarray`` takes) → {name:
    float32 tensor on ``device``}."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in np_params.items()
    }


def vgg_from_jax(np_vgg: List[dict], device=None) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's VGG16 parameters (a list of {"w": HWIO, "b": [O]}
    arrays, e.g. ``vgg16_random_init``'s or a converted npz's) → the port's
    list of {"w": OIHW, "b": [O]} float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [
        {
            "w": torch.from_numpy(
                np.array(layer["w"], dtype=np.float32).transpose(3, 2, 0, 1).copy()
            ).to(dev),
            "b": torch.from_numpy(np.array(layer["b"], dtype=np.float32)).to(dev),
        }
        for layer in np_vgg
    ]


def cnca_params_from_jax(np_params: dict, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ConditionedNCA tree (``conditioned_nca_init``'s:
    ``perception_w`` [C, 3, 3, 3], ``update{1,2,3}`` {"w": [1, 1, in, out],
    "b"}, ``encoder`` {"embed1": {"w": HWIO, "b"}, "embed2": {"w": HWIO}})
    → the port's flat dict (``models.conditioned_nca``): the 1x1 kernels as
    [in, out] matrices, the encoder's convolutions OIHW, float32 on
    ``device``."""
    dev = resolve_device(device)

    def t(a, perm=None):
        a = np.array(a, dtype=np.float32)
        if perm is not None:
            a = a.transpose(perm).copy()
        return torch.from_numpy(a).to(dev)

    out = {"perception_w": t(np_params["perception_w"])}
    for name in ("update1", "update2", "update3"):
        out[f"{name}.w"] = t(np.asarray(np_params[name]["w"])[0, 0])
        if "b" in np_params[name]:
            out[f"{name}.b"] = t(np_params[name]["b"])
    enc = np_params["encoder"]
    out["encoder.embed1.w"] = t(enc["embed1"]["w"], (3, 2, 0, 1))
    out["encoder.embed1.b"] = t(enc["embed1"]["b"])
    out["encoder.embed2.w"] = t(enc["embed2"]["w"], (3, 2, 0, 1))
    return out


def cnca_params_to_jax(params: dict) -> dict:
    """The inverse of ``cnca_params_from_jax``: the port's flat
    ConditionedNCA dict (tensors or arrays) → the JAX package's tree of
    float32 numpy arrays (1x1 kernels [1, 1, in, out], convolutions HWIO).
    Also maps any dict keyed alike (Adam's moments)."""

    def a(k, perm=None):
        v = params[k]
        v = np.array(v.detach().cpu() if hasattr(v, "detach") else v, dtype=np.float32)
        return v.transpose(perm).copy() if perm is not None else v

    out = {"perception_w": a("perception_w")}
    for name in ("update1", "update2", "update3"):
        out[name] = {"w": a(f"{name}.w")[None, None]}
        if f"{name}.b" in params:
            out[name]["b"] = a(f"{name}.b")
    out["encoder"] = {"embed1": {"w": a("encoder.embed1.w", (2, 3, 1, 0)),
                                 "b": a("encoder.embed1.b")},
                      "embed2": {"w": a("encoder.embed2.w", (2, 3, 1, 0))}}
    return out


def load_params_pickle(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The ``params`` of a pickle checkpoint of either package, in the
    port's layout: ``path`` is the checkpoint directory (holding
    ``state.pkl``) or the file itself. A ConditionedNCA tree (the JAX
    layout, which both CLIs write) becomes the port's flat dict; flat
    dicts (DyNCA, or an older port encoder checkpoint) load as they are."""
    np_params = load_checkpoint(path)["params"]
    if isinstance(np_params.get("encoder"), dict):  # the JAX ConditionedNCA tree
        return cnca_params_from_jax(np_params, device)
    return params_from_jax(np_params, device)


def pool_from_jax(np_pool, device=None) -> torch.Tensor:
    """A DyNCA pool as checkpoints hold it, NHWC [N, H, W, C] → the port's
    NCHW float32 tensor on ``device``."""
    dev = resolve_device(device)
    return torch.from_numpy(np.array(np_pool, dtype=np.float32)).permute(0, 3, 1, 2) \
        .contiguous().to(dev)


def msoe_from_jax(np_msoe: dict, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's MSOE parameters (``msoe_random_init``'s or a
    converted npz's: {name: array}, kernels HWIO) → the port's float32
    tensors, kernels OIHW, on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, a in np_msoe.items():
        a = np.array(a, dtype=np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1).copy()
        out[name] = torch.from_numpy(a).to(dev)
    return out
