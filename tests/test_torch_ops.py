"""The port's ops (vsnca_tpu_torch.ops, models.dynca) against the JAX ops on
the same numpy inputs, on the CPU; plus the port's import guard and its
no-card rule for entry points.

Tolerances: rtol 1e-5 / atol 1e-6 for the stencils, padding, CPE and resize
(the same float32 operations in the same order; resize is a float32 product
on both sides).
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops import cpe as jcpe
from vsnca_tpu.ops import filters as jfilters
from vsnca_tpu.ops import padding as jpadding
from vsnca_tpu.ops import perception as jperception
from vsnca_tpu.ops import resize as jresize
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import cpe, filters, padding, perception, resize

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


def _nhwc(rng, shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _t(x_nhwc):
    """numpy NHWC → torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _n(t_nchw):
    """torch NCHW → numpy NHWC."""
    return t_nchw.permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_filters_match():
    for name in ("SOBEL_X", "SOBEL_Y", "LAPLACIAN"):
        np.testing.assert_array_equal(getattr(filters, name), getattr(jfilters, name))


@pytest.mark.parametrize("mode", ["circular", "replicate", "zeros"])
def test_pad2d(mode):
    x = _nhwc(np.random.RandomState(0), (2, 5, 7, 3))
    _close(_n(padding.pad2d(_t(x), 1, mode)), jpadding.pad2d(jnp.asarray(x), 1, mode))


@pytest.mark.parametrize("mode", ["circular", "replicate", "zeros"])
def test_perceive(mode):
    x = _nhwc(np.random.RandomState(1), (2, 9, 11, 4))
    _close(_n(perception.perceive(_t(x), mode)),
           jperception.perceive(jnp.asarray(x), mode))


def test_perceive_multiscale():
    x = _nhwc(np.random.RandomState(2), (1, 12, 16, 3))
    _close(_n(perception.perceive_multiscale(_t(x), (0, 1), "circular")),
           jperception.perceive_multiscale(jnp.asarray(x), (0, 1), "circular"))


@pytest.mark.parametrize("transform", ["none", "tanh"])
def test_edge_extract(transform):
    g = _nhwc(np.random.RandomState(3), (2, 10, 13, 1))
    _close(_n(perception.edge_extract(_t(g), transform)),
           jperception.edge_extract(jnp.asarray(g), transform))


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_cpe(hw):
    got = cpe.cartesian_positional_encoding(*hw).permute(1, 2, 0).numpy()
    _close(got, jcpe.cartesian_positional_encoding(*hw))


@pytest.mark.parametrize("src,dst", [((16, 16), (8, 8)), ((8, 8), (16, 16)),
                                     ((12, 10), (7, 15))])
def test_resize_bilinear(src, dst):
    x = _nhwc(np.random.RandomState(4), (2,) + src + (3,))
    _close(_n(resize.resize_bilinear(_t(x), dst)),
           jresize.resize_bilinear(jnp.asarray(x), dst))


@pytest.mark.parametrize("conditioning", ["pos_emb", "edges"])
def test_make_conditioning(conditioning):
    kw = dict(c_in=6, fc_dim=8, conditioning=conditioning)
    g = _nhwc(np.random.RandomState(5), (2, 9, 12, 1))
    got = dynca.make_conditioning(NCAConfig(**kw), (9, 12), cond_img=_t(g), batch=2)
    want = jdynca.make_conditioning(JNCAConfig(**kw), (9, 12),
                                    cond_img=jnp.asarray(g), batch=2)
    _close(_n(got), want)


def test_dynca_step_matches_jax_at_full_rate():
    """update_rate=1: jax's floor(U + 1) mask is all ones."""
    from vsnca_tpu_torch.convert import params_from_jax

    kw = dict(c_in=8, fc_dim=16, padding_mode="circular", conditioning="pos_emb",
              update_rate=1.0)
    jp = jdynca.dynca_init(jax.random.PRNGKey(0), JNCAConfig(**kw))
    x = _nhwc(np.random.RandomState(6), (2, 8, 10, 8))
    cfg = NCAConfig(**kw)
    cond = dynca.make_conditioning(cfg, (8, 10), batch=2, device="cpu")
    got = dynca.dynca_step(params_from_jax(jp, "cpu"), _t(x), torch.ones(1), cfg, cond)
    want = jdynca.dynca_step(jp, jnp.asarray(x), jax.random.PRNGKey(1), JNCAConfig(**kw),
                             jnp.asarray(_n(cond)))
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_dynca_init_shapes_and_seed():
    cfg = NCAConfig(c_in=12, fc_dim=96, conditioning="edges")
    a = dynca.dynca_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    b = dynca.dynca_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "w1": (51, 96), "b1": (96,), "w2": (96, 12), "b2": (12,)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["b1"].abs().max()) <= 1.0 / np.sqrt(51)


@pytest.mark.parametrize("seed_mode", ["zeros", "center_on", "random"])
def test_dynca_seed(seed_mode):
    cfg = NCAConfig(c_in=6, seed_channels=5, seed_mode=seed_mode)
    s = dynca.dynca_seed(cfg, 2, (6, 8), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert s.shape == (2, 5, 6, 8)
    if seed_mode == "center_on":
        assert float(s.sum()) == 2 * 5 and float(s[0, :, 3, 4].min()) == 1.0
    if seed_mode == "random":
        assert torch.equal(s[0], s[1]) and float(s.abs().max()) <= 0.5


# --------------------------------------------------------------- guards

_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|vsnca_tpu)\b", re.M)


def _port_sources():
    return sorted((ROOT / "vsnca_tpu_torch").rglob("*.py")) + [ROOT / "tests/test_torch_cuda.py"]


def test_port_imports_no_jax_source_scan():
    """No file of the port, nor the card tests (run on a machine without
    JAX), imports jax or vsnca_tpu
    (the pattern's word boundary does not match vsnca_tpu_torch)."""
    assert _FORBIDDEN.search("from vsnca_tpu.ops import x")
    assert not _FORBIDDEN.search("from vsnca_tpu_torch.ops import x")
    files = _port_sources()
    assert len(files) > 10
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_port_imports_no_jax_at_runtime():
    """Importing every port module pulls neither jax nor vsnca_tpu in."""
    mods = [
        ".".join(f.relative_to(ROOT).with_suffix("").parts)
        for f in (ROOT / "vsnca_tpu_torch").rglob("*.py")
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vsnca_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_card_tests_skip_every_case_without_card():
    """The card tests' command, as the README gives it, exits 0 on a machine
    without a card, every case skipped (none collected at import, none
    failed)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
                        "no:cacheprovider", "tests/test_torch_cuda.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = r.stdout.strip().splitlines()[-1]
    counts = dict((k.rstrip("s"), int(n)) for n, k in re.findall(r"(\d+) (\w+)", summary))
    assert counts.pop("skipped") > 200 and set(counts) <= {"warning"}, summary


def _entry_points():
    from vsnca_tpu_torch.convert import params_from_jax
    from vsnca_tpu_torch.infer.server import StylizeServer
    from vsnca_tpu_torch.infer.stylize import VideoStylizer, stylize_frames

    cfg = NCAConfig(c_in=6, fc_dim=8, conditioning="pos_emb")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    frames = np.zeros((1, 8, 8, 3), np.float32)
    return {
        "VideoStylizer": lambda: VideoStylizer(params, cfg, 8),
        "StylizeServer": lambda: StylizeServer(params, cfg),
        "stylize_frames": lambda: next(stylize_frames(params, cfg, frames)),
        "dynca_init": lambda: dynca.dynca_init(torch.Generator(), cfg),
        "dynca_seed": lambda: dynca.dynca_seed(cfg, 1, 8),
        "make_conditioning": lambda: dynca.make_conditioning(cfg, (8, 8)),
        "params_from_jax": lambda: params_from_jax({"w": np.zeros(2)}),
    }


@pytest.mark.parametrize("name", ["VideoStylizer", "StylizeServer", "stylize_frames",
                                  "dynca_init", "dynca_seed", "make_conditioning",
                                  "params_from_jax"])
def test_entry_points_raise_without_card(name):
    """Without a card, an entry point not told device='cpu' raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
