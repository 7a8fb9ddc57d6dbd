"""The WebGL export (``vsnca_tpu_torch/export/webgl.py``) and its validator
(``export/webgl_sim.py``) against the JAX package's on the CPU, for the
same seeded numpy params:

- the JSON payload is equal (``json.dumps``) for pos_emb, edges, a stack of
  three models and a multiscale model (``n_perception_scales`` 2), with the
  port given tensors and JAX numpy arrays; the files and the demo page's
  metadata are byte-equal;
- ``load_webgl_model`` and ``params_from_webgl`` (float and uint8) give
  JAX's arrays exactly;
- ``validate_export`` at update_rate 1 (all masks one on both sides, 16^2,
  4 steps) gives JAX's metrics within 1e-5; at rate 0.5 the weights stay
  within half a uint8 step of the atlas' scale.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.export import webgl as jwebgl
from vsnca_tpu.export import webgl_sim as jsim
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.export import webgl, webgl_sim

torch.set_num_threads(1)

CASES = {
    "pos_emb": (dict(c_in=12, fc_dim=96, conditioning="pos_emb"), 1, dict(pos_emb=True)),
    "edges": (dict(c_in=12, fc_dim=96, conditioning="edges", padding_mode="circular"), 1,
              dict(edge_conditioning=True)),
    "stack3": (dict(c_in=12, fc_dim=96, conditioning="pos_emb"), 3, dict(pos_emb=True)),
    "multiscale": (dict(c_in=16, fc_dim=128, conditioning="pos_emb", perception_scales=(0, 1)),
                   1, dict(pos_emb=True, n_perception_scales=2)),
}


def _np_params(cfg, seed):
    rng = np.random.RandomState(seed)
    p, f, c = cfg.perception_dim, cfg.fc_dim, cfg.c_in
    return {"w1": (0.2 * rng.randn(p, f)).astype(np.float32),
            "b1": rng.uniform(-0.1, 0.1, f).astype(np.float32),
            "w2": (0.1 * rng.randn(f, c)).astype(np.float32),
            "b2": (0.01 * rng.randn(c)).astype(np.float32)}


def _tensors(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_payload_equals_jax(tmp_path, case):
    kw, n_models, flags = CASES[case]
    cfg = NCAConfig(**kw)
    plist = [_np_params(cfg, s) for s in range(n_models)]
    names = [f"m{s}" for s in range(n_models)]
    got = webgl.export_models_to_webgl_json([_tensors(p) for p in plist], names, **flags)
    want = jwebgl.export_models_to_webgl_json(plist, names, **flags)
    assert json.dumps(got) == json.dumps(want)
    assert ("n_perception_scales" in got) == (case == "multiscale")
    for pkg, name in ((webgl, "port"), (jwebgl, "jax")):
        md = dict(metadata_json_path=str(tmp_path / f"{name}_md.json"), texture_name="tex")
        (tmp_path / f"{name}_md.json").write_text(json.dumps({"texture_names": ["a"]}))
        pkg.save_webgl_model(str(tmp_path / name / "model.json"),
                             plist if pkg is jwebgl else [_tensors(p) for p in plist], names,
                             **flags, **md)
    assert (tmp_path / "port" / "model.json").read_bytes() == \
        (tmp_path / "jax" / "model.json").read_bytes()
    assert (tmp_path / "port_md.json").read_bytes() == (tmp_path / "jax_md.json").read_bytes()
    mats = webgl.load_webgl_model(str(tmp_path / "port" / "model.json"))
    jmats = jwebgl.load_webgl_model(str(tmp_path / "jax" / "model.json"))
    for a, b in zip(mats, jmats):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize_uint8", [False, True])
@pytest.mark.parametrize("case", ["edges", "multiscale"])
def test_params_from_webgl_equal_jax(tmp_path, case, quantize_uint8):
    kw, _, flags = CASES[case]
    cfg = NCAConfig(**kw)
    params = _np_params(cfg, 4)
    path = str(tmp_path / "model.json")
    jwebgl.save_webgl_model(path, [params], ["m"], **flags)
    got = webgl_sim.params_from_webgl(path, cfg, quantize_uint8, device="cpu")
    want = jsim.params_from_webgl(path, JNCAConfig(**kw), quantize_uint8)
    assert set(got) == set(want) == set(params)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def _uint8_bound(path):
    with open(path) as f:
        js = json.load(f)
    return max(layer["scale"] for layer in js["layers"]) / 510.0 + 1e-6


@pytest.mark.parametrize("case", ["pos_emb", "edges", "multiscale"])
def test_validate_export_matches_jax_at_rate_1(tmp_path, case):
    kw, _, flags = CASES[case]
    kw = dict(kw, c_in=6, fc_dim=16, update_rate=1.0)
    cfg = NCAConfig(**kw)
    params = _np_params(cfg, 5)
    path = str(tmp_path / "model.json")
    webgl.save_webgl_model(path, [_tensors(params)], ["m"], **flags)
    got = webgl_sim.validate_export(path, _tensors(params), cfg, size=16, n_steps=4,
                                    device="cpu")
    want = jsim.validate_export(path, {k: jnp.asarray(v) for k, v in params.items()},
                                JNCAConfig(**kw), size=16, n_steps=4)
    print(case, got, want)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert 0.0 < got["weight_max_abs_diff"] <= _uint8_bound(path)
    assert got["state_max_abs_diff"] > 0.0


@pytest.mark.parametrize("quantize_uint8", [False, True])
@pytest.mark.parametrize("case", ["edges", "multiscale"])
def test_validate_export_at_rate_half_stays_within_the_uint8_step(tmp_path, case,
                                                                   quantize_uint8):
    kw, _, flags = CASES[case]
    cfg = NCAConfig(**dict(kw, update_rate=0.5))
    params = _np_params(cfg, 6)
    path = str(tmp_path / "model.json")
    webgl.save_webgl_model(path, [_tensors(params)], ["m"], **flags)
    got = webgl_sim.validate_export(path, _tensors(params), cfg, size=16, n_steps=4,
                                    quantize_uint8=quantize_uint8, device="cpu")
    print(case, quantize_uint8, got)
    assert got["weight_max_abs_diff"] <= _uint8_bound(path)
    if not quantize_uint8:  # the float atlas round-trips to float32 rounding
        assert got["weight_max_abs_diff"] <= 1e-6
    assert np.isfinite(got["state_max_abs_diff"]) and np.isfinite(got["rgb_mean_abs_diff"])
