"""WebGL JSON export — the port's copy of ``vsnca_tpu/export/webgl.py``,
byte-compatible with the in-browser runtime (docs/dynca.js), replicating
the notebook exporter (ConditioneDyNCA/convert_models_to_webgl.ipynb cells
0-3):

- layer 1 = [P+1, fc] (update-MLP w1 with the bias as the last input row;
  the last rows double as the pos-emb / edge-conditioning taps read by the
  dense shader), layer 2 = [fc+1, c_in].
- multiple models stack on axis 0 and are tiled into a near-square texture
  atlas (tile2d), with the minor dim packed into RGBA quads (groups of 4).
- values are affinely normalized to [0, 1] (scale/center recorded);
  ``data_flatten`` stores the normalized floats of the tiled atlas (the
  notebook quantizes to uint8 only to compute data_shape — the JSON itself
  carries floats), and the runtime dequantizes with scale/center.

Parameters may be tensors (on any device) or arrays: for equal values the
payload equals the JAX exporter's.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np


def tile2d(a: np.ndarray, w: Optional[int] = None) -> np.ndarray:
    """Tile [N, th, tw, ...] into a [th*h, tw*w, ...] atlas (notebook cell 0)."""
    a = np.asarray(a)
    if w is None:
        w = int(np.ceil(np.sqrt(len(a))))
    th, tw = a.shape[1:3]
    pad = (w - len(a)) % w
    a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), "constant")
    h = len(a) // w
    a = a.reshape([h, w] + list(a.shape[1:]))
    a = np.rollaxis(a, 2, 1).reshape([th * h, tw * w] + list(a.shape[4:]))
    return a


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float32)


def params_to_layer_mats(params: dict) -> List[np.ndarray]:
    """DyNCA params → the two WebGL layer matrices (notebook cell 1).

    The storage is already input-major ([in, out]); the bias becomes the
    last input row.
    """
    w1 = _np(params["w1"])  # [P, fc]
    b1 = _np(params["b1"])[None, :]  # [1, fc]
    layer1 = np.concatenate([w1, b1], axis=0)[None]  # [1, P+1, fc]
    w2 = _np(params["w2"])  # [fc, C]
    b2 = _np(params["b2"])[None, :]
    layer2 = np.concatenate([w2, b2], axis=0)[None]  # [1, fc+1, C]
    return [layer1, layer2]


def export_models_to_webgl_json(
    params_list: Sequence[dict],
    model_names: Sequence[str],
    pos_emb: bool = False,
    edge_conditioning: bool = False,
    n_perception_scales: int = 1,
) -> dict:
    """Stack models and emit the docs/dynca.js JSON payload (notebook
    cells 1-3).

    ``n_perception_scales``: multiscale models (video-motion, scales
    (0,1)) must carry the top-level key — dynca.js:881 reads it to enable
    the bilinear_downsample/perception1/upsample_add passes; the
    reference's own video_models/*.json all include it, vec-field models
    omit it (runtime default 1), so we only emit it when > 1."""
    np_models = None
    for params in params_list:
        mats = params_to_layer_mats(params)
        if np_models is None:
            np_models = mats
        else:
            np_models = [
                np.concatenate([acc, m], axis=0) for acc, m in zip(np_models, mats)
            ]

    models_js = {"model_names": list(model_names), "layers": []}
    if n_perception_scales > 1:
        models_js["n_perception_scales"] = int(n_perception_scales)
    for i, layer in enumerate(np_models):
        shape = layer[0].shape
        layer = np.array(layer)  # [n, rows, cols]
        s = layer.shape
        layer = np.pad(layer, ((0, 0), (0, 0), (0, (4 - s[2]) % 4)), mode="constant")
        layer = layer.reshape(s[0], s[1], -1, 4)
        n, ht, wt = layer.shape[:3]
        w = 1
        while w < n and w * wt < (n + w - 1) // w * ht:
            w += 1
        layer = tile2d(layer, w)
        layout = (w, (n + w - 1) // w)

        scale = float(layer.max() - layer.min())
        center = float(-layer.min() / scale)
        layer = layer - layer.min()
        layer = layer / scale
        layer_flatten = layer.flatten()

        quant = np.uint8(np.round(layer * 255.0).clip(0, 255))

        models_js["layers"].append(
            {
                "scale": scale,
                "center": center,
                "data_flatten": [float(v) for v in layer_flatten],
                "data_shape": list(quant.shape),
                "shape": list(shape),
                "layout": list(layout),
                "pos_emb": (i == 0) and pos_emb,
                "edge_conditioning": (i == 0) and edge_conditioning,
                "bias": True,
            }
        )
    return models_js


def save_webgl_model(
    path: str,
    params_list: Sequence[dict],
    model_names: Sequence[str],
    pos_emb: bool = False,
    edge_conditioning: bool = False,
    metadata_json_path: Optional[str] = None,
    texture_name: Optional[str] = None,
    n_perception_scales: int = 1,
):
    """Write the model JSON and optionally register the texture in the demo
    page's metadata.json (notebook cell 3)."""
    js = export_models_to_webgl_json(
        params_list, model_names, pos_emb, edge_conditioning,
        n_perception_scales=n_perception_scales,
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(js, f)
    if metadata_json_path and texture_name:
        md = {}
        if os.path.exists(metadata_json_path):
            with open(metadata_json_path) as f:
                md = json.load(f)
        names = set(md.get("texture_names", []))
        names.add(texture_name)
        md["texture_names"] = sorted(names)
        with open(metadata_json_path, "w", encoding="utf-8") as f:
            json.dump(md, f, indent=4)
    return js


def load_webgl_model(path: str, quantize_uint8: bool = False) -> List[np.ndarray]:
    """Inverse of the exporter (round-trip checks): dequantized
    [P+1, fc] / [fc+1, C] matrices of model 0 (the atlas's first tile).
    ``quantize_uint8`` rounds the normalized atlas through uint8 first, the
    texture precision of the browser upload."""
    with open(path) as f:
        js = json.load(f)
    mats = []
    for layer in js["layers"]:
        data = np.asarray(layer["data_flatten"], np.float32).reshape(
            layer["data_shape"]
        )
        if quantize_uint8:
            data = np.round(data * 255.0).clip(0, 255) / 255.0
        denorm = data * layer["scale"] - layer["center"] * layer["scale"]
        rows, cols = layer["shape"]
        quads = (cols + 3) // 4
        tile = denorm[:rows, :quads, :].reshape(rows, -1)[:, :cols]
        mats.append(tile)
    return mats
