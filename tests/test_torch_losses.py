"""The port's VGG16, losses and optimizer against the JAX package on the CPU,
on the same numpy arrays (VGG weights carried across with
``convert.vgg_from_jax``).

Tolerances: VGG features rtol 1e-4 / atol 1e-5 of the largest activation of
each tap (float32 convolutions summed in another order); their gradients
w.r.t. the image 1e-4 of the largest element (both packages split a
max-pool tie's gradient evenly; tests/test_torch_vgg_pool.py holds the
ties themselves); the golden torch-mirror fixture
rtol 1e-3 / atol 1e-4 (as tests/test_golden_fixtures.py); Gram and overflow
losses rtol 1e-5; one Adam step and a schedule across its boundaries
atol 1e-7 (updates of 1e-3). The JAX side runs under ``jax.jit`` (one
compile a function, shared across tests). ``-s`` prints the measured
differences.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vsnca_tpu.losses import appearance as jappearance
from vsnca_tpu.losses.overflow import overflow_loss as joverflow
from vsnca_tpu.models import vgg as jvgg
from vsnca_tpu.train import optim as joptim
from vsnca_tpu_torch.convert import vgg_from_jax
from vsnca_tpu_torch.losses import appearance
from vsnca_tpu_torch.losses.overflow import overflow_loss
from vsnca_tpu_torch.models import vgg
from vsnca_tpu_torch.train import optim

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_vgg16.npz")

_jax_vgg_init = jax.jit(jvgg.vgg16_random_init)
_jax_gram_loss = jax.jit(lambda p, gen, tgt: jappearance.appearance_loss(p, gen, tgt, "Gram"))


def np_vgg16(seed: int):
    """He-normal VGG16 arrays (HWIO), drawn with numpy: the same weights for
    both packages without the cost of an eager jax.random init."""
    rng = np.random.RandomState(seed)
    out, c_in = [], 3
    for c_out, _ in jvgg.VGG16_CONVS:
        w = rng.randn(3, 3, c_in, c_out) * np.sqrt(2.0 / (9 * c_in))
        out.append({"w": w.astype(np.float32), "b": np.zeros(c_out, np.float32)})
        c_in = c_out
    return out


@pytest.fixture(scope="module")
def vgg_pair():
    arrays = np_vgg16(0)
    return ([{k: jnp.asarray(v) for k, v in d.items()} for d in arrays],
            vgg_from_jax(arrays, "cpu"))


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def test_vgg_features_and_image_gradients_match_jax(vgg_pair):
    jp, tp = vgg_pair
    rng = np.random.RandomState(0)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    layers = vgg.STYLE_LAYERS + (vgg.CONTENT_LAYER,)
    weights = None

    def jloss(x, weights):
        feats = jvgg.vgg16_features(jp, x, layers)
        return sum(jnp.sum(f * w) for f, w in zip(feats, weights)), feats

    shapes = jax.eval_shape(lambda x: jvgg.vgg16_features(jp, x, layers), img)
    weights = [jnp.asarray(rng.randn(*f.shape).astype(np.float32)) for f in shapes]
    jgrad, want_feats = jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(img), weights)

    x = _nchw(img).requires_grad_()
    feats = vgg.vgg16_features(tp, x, layers)
    assert len(feats) == 6
    for f, w in zip(feats, want_feats):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        scale = np.abs(w).max()
        np.testing.assert_allclose(f.detach().numpy() / scale, w / scale, rtol=1e-4, atol=1e-5)
    sum((f * _nchw(np.asarray(w))).sum() for f, w in zip(feats, weights)).backward()
    g, jg = x.grad.numpy(), np.asarray(jgrad).transpose(0, 3, 1, 2)
    print(f"\nVGG16 image gradient, max |port - JAX| / max |JAX|: "
          f"{np.abs(g - jg).max() / np.abs(jg).max():.2e}")
    np.testing.assert_allclose(g / np.abs(jg).max(), jg / np.abs(jg).max(), rtol=1e-4,
                               atol=1e-4)
    # include_image_as_feat: the normalized image comes first
    first = vgg.vgg16_style_features(tp, x.detach()[:, :, :16, :16], True)[0]
    want = (img[:, :16, :16] - vgg.IMAGENET_MEAN) / vgg.IMAGENET_STD
    np.testing.assert_allclose(first.numpy(), want.transpose(0, 3, 1, 2), rtol=1e-6)


def test_vgg_matches_golden_torch_mirror_fixture():
    fx = np.load(FIX)
    jp = _jax_vgg_init(jax.random.PRNGKey(int(fx["seed"])))
    tp = vgg_from_jax([{k: np.asarray(v) for k, v in d.items()} for d in jp], "cpu")
    x = _nchw(fx["input"])
    for i, f in enumerate(vgg.vgg16_style_features(tp, x)):
        np.testing.assert_allclose(f.numpy(), fx[f"style_{i}"].transpose(0, 3, 1, 2),
                                   rtol=1e-3, atol=1e-4, err_msg=f"style tap {i}")
    np.testing.assert_allclose(vgg.vgg16_content_features(tp, x).numpy(),
                               fx["content_0"].transpose(0, 3, 1, 2), rtol=1e-3, atol=1e-4)


def test_vgg_fallback_is_he_normal_and_npz_loads(tmp_path):
    """The fallback draws He-normal weights, the JAX fallback's
    distribution (per-layer weight std within 5 % of JAX's PRNGKey(16)
    draw) but not its numbers (RNG class: the Gram loss of one image pair
    differs between the two, printed with ``-s``); an npz in the JAX layout
    loads transposed to OIHW."""
    params, pretrained = vgg.load_vgg16(str(tmp_path / "missing.npz"), device="cpu")
    assert not pretrained and len(params) == 13
    w = params[7]["w"]  # 512 x 256 x 3 x 3
    assert w.shape == (512, 256, 3, 3)
    assert abs(float(w.std()) / np.sqrt(2.0 / (256 * 9)) - 1.0) < 0.01
    assert not params[7]["b"].any()
    jfall = _jax_vgg_init(jax.random.PRNGKey(16))
    ratios = [float(p["w"].std()) / float(np.asarray(j["w"]).std())
              for p, j in zip(params, jfall)]
    assert all(abs(r - 1.0) < 0.05 for r in ratios)
    rng = np.random.RandomState(5)
    gen = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lj = float(_jax_gram_loss(jfall, jnp.asarray(gen), jnp.asarray(tgt)))
    lp = float(appearance.appearance_loss(params, _nchw(gen), _nchw(tgt), "Gram"))
    print(f"\nVGG16 fallbacks: weight std port/JAX per layer {min(ratios):.4f} .. "
          f"{max(ratios):.4f}; Gram appearance loss of one 32^2 pair {lj:.6g} (JAX "
          f"PRNGKey(16)) against {lp:.6g} (torch.Generator(16))")
    jp = np_vgg16(1)
    np.savez(tmp_path / "v.npz", **{f"{k}{i}": d[k] for i, d in enumerate(jp)
                                    for k in ("w", "b")})
    loaded, pretrained = vgg.load_vgg16(str(tmp_path / "v.npz"), device="cpu")
    assert pretrained
    np.testing.assert_array_equal(loaded[3]["w"].numpy(),
                                  np.asarray(jp[3]["w"]).transpose(3, 2, 0, 1))


def test_gram_and_overflow_losses_match_jax():
    rng = np.random.RandomState(4)
    gen = [rng.randn(2, 6, 6, c).astype(np.float32) for c in (4, 8)]
    tgt = [rng.randn(2, 6, 6, c).astype(np.float32) for c in (4, 8)]
    want = float(jappearance.gram_loss([jnp.asarray(a) for a in gen],
                                       [jnp.asarray(a) for a in tgt]))
    got = float(appearance.gram_loss([_nchw(a) for a in gen], [_nchw(a) for a in tgt]))
    assert got == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(appearance.gram_matrix(_nchw(gen[1])).numpy(),
                               np.asarray(jappearance.gram_matrix(jnp.asarray(gen[1]))),
                               rtol=1e-5, atol=1e-6)
    state = (rng.randn(2, 8, 8, 12) * 1.5).astype(np.float32)
    assert float(overflow_loss(_nchw(state))) == pytest.approx(
        float(joverflow(jnp.asarray(state))), rel=1e-5)


def test_appearance_loss_matches_jax(vgg_pair):
    """Gram appearance through VGG16, with the target's features computed
    inside and precomputed; generated batch 4 against a style batch of 2."""
    jp, tp = vgg_pair
    rng = np.random.RandomState(5)
    gen = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = float(_jax_gram_loss(jp, jnp.asarray(gen), jnp.asarray(tgt)))
    got = appearance.appearance_loss(tp, _nchw(gen), _nchw(tgt), "Gram")
    assert float(got) == pytest.approx(want, rel=1e-5)
    feats = appearance.precompute_target_style_features(tp, _nchw(tgt), "Gram", (32, 32))
    got2 = appearance.appearance_loss(tp, _nchw(gen), None, "Gram", target_features=feats)
    assert float(got2) == pytest.approx(want, rel=1e-5)


def test_normalize_grads_matches_jax():
    rng = np.random.RandomState(6)
    grads = {"a": rng.randn(5, 3).astype(np.float32), "b": np.zeros(4, np.float32)}
    want = joptim.normalize_grads({k: jnp.asarray(v) for k, v in grads.items()})
    got = optim.normalize_grads({k: torch.from_numpy(v) for k, v in grads.items()})
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


def test_adam_with_schedule_matches_optax():
    """Five normalized Adam updates across MultiStep boundaries (2, 4) with
    gamma 0.5: the port's NormalizedAdam against the JAX optax chain."""
    rng = np.random.RandomState(7)
    p0 = {"w": rng.randn(6, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    tx = joptim.make_optimizer(1e-3, (2, 4), 0.5)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
    opt = optim.make_optimizer(params, 1e-3, (2, 4), 0.5)
    lrs = []
    for g in grads:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        lrs.append(opt.lr)
        for k, v in params.items():
            v.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, v in params.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-7)
    assert lrs == pytest.approx([1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4])
