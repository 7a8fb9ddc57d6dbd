"""The port's stylizer, server and parameter conversion on the CPU, against
the JAX stylizer (its scan path on the CPU) at update_rate=1, where the
masks are all ones on both sides. Tolerance rtol 1e-4 / atol 1e-5 on the
state and the RGB frames."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.export.checkpoint import save_checkpoint
from vsnca_tpu.infer import stylize as jstylize
from vsnca_tpu.models.dynca import dynca_init as jdynca_init
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import load_params_pickle, params_from_jax
from vsnca_tpu_torch.infer.server import StylizeServer
from vsnca_tpu_torch.infer.stylize import (
    VideoStylizer,
    generate_control_frames,
    stylize_frames,
)
from vsnca_tpu_torch.models.dynca import dynca_init

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _frames(n, h, w, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(c_in=6, fc_dim=16, conditioning="edges"),
    dict(c_in=6, seed_channels=5, fc_dim=16),
    dict(c_in=6, fc_dim=16, conditioning="pos_emb", perception_scales=(0, 1)),
], ids=["edge_conditioned", "extra_channel", "multiscale"])
def test_stylizer_matches_jax(kw):
    kw = dict(kw, update_rate=1.0)
    jp = jdynca_init(jax.random.PRNGKey(0), JNCAConfig(**kw))
    jst = jstylize.VideoStylizer(jp, JNCAConfig(**kw), 16, step_n=4)
    assert not jst._fused  # the CPU runs the scan path
    st = VideoStylizer(params_from_jax(jp, "cpu"), NCAConfig(**kw), 16, step_n=4,
                       device="cpu", compute_dtype="float32")
    for f in _frames(3, 16, 16):
        want_rgb = np.asarray(jst.step_frame(jnp.asarray(f)[None]))
        got_rgb = st.step_frame(f[None]).numpy()
        np.testing.assert_allclose(got_rgb, want_rgb, **TOL)
        np.testing.assert_allclose(st.state_nhwc.numpy(), np.asarray(jst.state_nhwc), **TOL)
    assert st.state.shape == (1, JNCAConfig(**kw).n_seed_channels, 16, 16)


def test_stylize_frames_with_size_factor_matches_jax():
    kw = dict(c_in=6, fc_dim=16, conditioning="pos_emb", update_rate=1.0)
    jp = jdynca_init(jax.random.PRNGKey(1), JNCAConfig(**kw))
    frames = _frames(2, 8, 8, seed=1)
    want = list(jstylize.stylize_frames(jp, JNCAConfig(**kw), frames, step_n=2,
                                        size_factor=2.0))
    got = list(stylize_frames(params_from_jax(jp, "cpu"), NCAConfig(**kw), frames,
                              step_n=2, size_factor=2.0, device="cpu",
                              compute_dtype="float32"))
    assert len(got) == 2 and got[0].shape == (16, 16, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_generate_control_frames():
    cfg = NCAConfig(c_in=6, fc_dim=8, conditioning="edges")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    style = np.random.RandomState(2).uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    s, b = generate_control_frames(params, cfg, style, n_frames=2, step_n=2, device="cpu")
    assert len(s) == len(b) == 2 and s[0].shape == (8, 8, 3)
    assert all(0.0 <= f.min() and f.max() <= 1.0 for f in s + b)


def test_damage_and_reset():
    cfg = NCAConfig(c_in=6, fc_dim=8, conditioning="edges", seed_mode="random")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = VideoStylizer(params, cfg, 16, step_n=2, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    seeded = st.state.clone()
    st.step_frame(_frames(1, 16, 16))
    st.damage(8, 8, 3)
    assert float(st.state[..., 8, 8].abs().max()) == 0.0
    assert float(st.state[..., 0, 0].abs().max()) > 0.0
    st.reset()  # the generator moved on: a fresh random seed state
    assert st.state.shape == seeded.shape and not torch.equal(st.state, seeded)


def test_convert_pickle_checkpoint(tmp_path):
    """A pickle checkpoint written by the JAX package loads into the port
    unchanged."""
    jp = jdynca_init(jax.random.PRNGKey(4), JNCAConfig(c_in=6, fc_dim=8))
    save_checkpoint(str(tmp_path / "ck"), {"params": jp, "iteration": 3},
                    backend="pickle")
    got = load_params_pickle(str(tmp_path / "ck"), device="cpu")
    assert set(got) == {"w1", "b1", "w2", "b2"}
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]))


# -------------------------------------------------------------- server

def _jpeg_bytes(h, w, seed=0):
    from PIL import Image

    img = Image.fromarray((np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    return buf.getvalue()


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


@pytest.fixture(scope="module")
def server():
    cfg = NCAConfig(c_in=6, fc_dim=16, conditioning="edges", padding_mode="circular")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    srv = StylizeServer(params, cfg, port=0, default_size=32, step_n=4,
                        device="cpu").start()
    yield srv
    srv.stop()


def test_server_round_trip(server):
    from PIL import Image

    base = f"http://127.0.0.1:{server.port}"
    body, _ = _post(f"{base}/session", json.dumps({"size": 32, "step_n": 4}).encode())
    sid = json.loads(body)["session"]
    out1, ctype = _post(f"{base}/frame/{sid}", _jpeg_bytes(32, 32, 1))
    assert ctype == "image/jpeg"
    assert np.asarray(Image.open(io.BytesIO(out1))).shape == (32, 32, 3)
    out2, _ = _post(f"{base}/frame/{sid}", _jpeg_bytes(32, 32, 1))
    assert out1 != out2  # the state persists between frames
    body, _ = _post(f"{base}/damage/{sid}?x=16&y=16&r=6")
    assert json.loads(body) == {"ok": True}
    assert float(server.sessions[sid].stylizer.state[..., 16, 16].abs().max()) == 0.0
    _post(f"{base}/reset/{sid}")
    assert float(server.sessions[sid].stylizer.state.abs().max()) == 0.0
    with urllib.request.urlopen(f"{base}/stream/{sid}?frames=3", timeout=120) as r:
        assert "multipart/x-mixed-replace" in r.headers.get("Content-Type")
        data = r.read()
    assert data.count(b"--vsnca") == 3 and data.count(b"\xff\xd8") == 3
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["sessions"][sid] == {"frames": 5, "size": [32, 32], "step_n": 4}


@pytest.mark.parametrize("path", ["/frame/nope", "/damage/nope?x=1&y=1", "/reset/nope",
                                  "/unknown"])
def test_server_errors_are_404(server, path):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"http://127.0.0.1:{server.port}{path}", _jpeg_bytes(32, 32))
    assert e.value.code == 404


def test_server_stream_unknown_session_is_clean_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stream/nope?frames=2",
                               timeout=30)
    assert e.value.code == 404 and "json" in e.value.headers.get("Content-Type", "")


def test_server_damage_needs_xy(server):
    base = f"http://127.0.0.1:{server.port}"
    sid = json.loads(_post(f"{base}/session", b"{}")[0])["session"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/damage/{sid}")
    assert e.value.code == 400
