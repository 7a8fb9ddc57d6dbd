"""The port's segment-checkpointed CHW training pair
(vsnca_tpu_torch.ops.fused_train: ``fused_rollout_train_chw``,
``fused_rollout_train_nhwc``, ``pick_segment``) on the CPU — its plain
versions — against the JAX package: ``jax.grad`` through the interpret-mode
CHW pair ``pallas_train.fused_rollout_train`` (K = 8, 24 steps, pos_emb, as
tests/test_pallas_train.py::test_fused_train_grads_match_scan_multisegment_cond
runs it), and K > 1 against K = 1 of the port itself.

Tolerances: against JAX, gradients scaled by the largest element of JAX's
(as test_pallas_train.py::_grads_match does), 1e-5 — summation order only,
since both recompute each segment from its checkpoint with the same masks
(measured at most 3.9e-7, on x); states rtol 1e-4 / atol 1e-5. Against K = 1: bit
for bit (the same plain steps, masks and sums in the same order; also at
update rate 0.5, where the recomputed masks matter, at perception scales
(0, 1), and with frame taps). ``-s`` prints the measured differences.

The kernels under this schedule are held against the plain version on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops import pallas_train
from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.convert import params_from_jax
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_train as ft

torch.set_num_threads(1)

KW = dict(c_in=8, fc_dim=16, padding_mode="circular", conditioning="pos_emb",
          update_rate=1.0)


def test_chw_pair_matches_jax_grad_through_interpret_pair():
    jcfg = JNCAConfig(**KW)
    params = {k: np.asarray(v) for k, v in
              jdynca.dynca_init(jax.random.PRNGKey(0), jcfg).items()}
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (1, 16, 128, 8)) - 0.5)
    cond = np.asarray(jdynca.make_conditioning(jcfg, (16, 128), batch=1))
    assert pallas_train.pick_segment(jcfg, 16, 128, 24) == 8
    assert ft.pick_segment(NCAConfig(**KW), 16, 128, 24) == 8

    def loss(p, x, c):
        s, rgb = pallas_train.fused_rollout_train(p, x, 5.0, jcfg, 24, cond_nhwc=c,
                                                  interpret=True)
        return jnp.sum(rgb ** 2) + 0.1 * jnp.sum(s ** 2), s

    with pltpu.force_tpu_interpret_mode():
        (_, js), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jnp.asarray(cond))

    p = {k: v.requires_grad_() for k, v in params_from_jax(params, "cpu").items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    ct = torch.from_numpy(cond.copy()).requires_grad_()
    before = ft.LAUNCHES
    s, rgb = ft.fused_rollout_train_nhwc(p, xt, 5, NCAConfig(**KW), 24, ct)
    (torch.sum(rgb ** 2) + 0.1 * torch.sum(s ** 2)).backward()
    assert ft.LAUNCHES == before  # the CPU path launches no kernel
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    pairs = {k: (p[k].grad.numpy(), np.asarray(jg[0][k])) for k in p}
    pairs["x"] = (xt.grad.numpy(), np.asarray(jg[1]))
    pairs["cond"] = (ct.grad.numpy(), np.asarray(jg[2]))
    errs = {}
    for name, (got, want) in pairs.items():
        scale = float(np.abs(want).max()) + 1e-12
        errs[name] = float(np.abs(got - want).max()) / scale
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    print("\nCHW pair K=8 vs jax.grad, scaled: "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))


def _run(cfg, k, x, cond, params, n_steps, rate, taps=()):
    p = {n: v.clone().requires_grad_() for n, v in params.items()}
    xt = x.clone().requires_grad_()
    ct = None if cond is None else cond.clone().requires_grad_()
    out = ft.fused_rollout_train(p, xt, 11, cfg, n_steps, ct, update_rate=rate,
                                 tap_steps=taps, segment=k, first_step=3)
    y, tap_states = (out if taps else (out, []))
    loss = (y ** 2).sum() + sum(0.5 * (t ** 3).sum() for t in tap_states)
    loss.backward()
    grads = [p[n].grad for n in sorted(p)] + [xt.grad] + ([] if ct is None else [ct.grad])
    return [y.detach(), *[t.detach() for t in tap_states], *grads]


CASES = [  # (scales, conditioning, n_steps, K, rate, taps)
    ((0,), "pos_emb", 24, 8, 0.5, ()),
    ((0,), "pos_emb", 24, 2, 0.5, ()),
    ((0,), None, 16, 16, 1.0, ()),
    ((0, 1), "pos_emb", 8, 4, 0.5, ()),
    ((0,), "pos_emb", 12, 4, 0.5, (1, 6, 9)),
]


@pytest.mark.parametrize("scales,conditioning,n_steps,k,rate,taps", CASES)
def test_segments_are_bit_identical_to_every_step_checkpoint(scales, conditioning, n_steps,
                                                             k, rate, taps):
    cfg = NCAConfig(c_in=6, fc_dim=12, padding_mode="circular", conditioning=conditioning,
                    perception_scales=scales)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 6, 12, 16), generator=g) - 0.5
    cond = dynca.make_conditioning(cfg, (12, 16), batch=2, device="cpu")
    want = _run(cfg, 1, x, cond, params, n_steps, rate, taps)
    got = _run(cfg, k, x, cond, params, n_steps, rate, taps)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("k", [2, 8])
def test_reference_segment_walk_is_bit_identical(k):
    cfg = NCAConfig(c_in=6, fc_dim=12, padding_mode="circular", conditioning="pos_emb")
    params = dynca.dynca_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.rand((1, 6, 8, 8), generator=g) - 0.5
    cond = dynca.make_conditioning(cfg, (8, 8), batch=1, device="cpu")
    gy = torch.randn(x.shape, generator=g)
    run = lambda seg: ft.fused_rollout_train_reference(  # noqa: E731
        params, x, 4, cfg, 16, cond, gy, update_rate=0.5, need_dcond=True, segment=seg)
    (y1, g1, dx1, dc1), (yk, gk, dxk, dck) = run(1), run(k)
    for a, b in [(y1, yk), (dx1, dxk), (dc1, dck)] + [(g1[n], gk[n]) for n in g1]:
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n_steps", [24, 63, 32, 6, 128, 1])
def test_pick_segment_matches_jax_where_vmem_does_not_bind(n_steps):
    jcfg = JNCAConfig(**KW)
    assert ft.pick_segment(NCAConfig(**KW), 16, 128, n_steps) == \
        pallas_train.pick_segment(jcfg, 16, 128, n_steps)


@pytest.mark.parametrize("kw,h,w,n_steps", [
    (dict(c_in=12, fc_dim=96, padding_mode="circular"), 128, 128, 64),
    (dict(c_in=12, fc_dim=96, padding_mode="replicate"), 128, 128, 64),
    (dict(c_in=12, fc_dim=96, padding_mode="circular", perception_scales=(0, 1)),
     128, 128, 64),
    (dict(c_in=12, fc_dim=96, padding_mode="circular"), 128, 128, 63),
])
def test_chw_supported_matches_jax_on_lane_aligned_grids(kw, h, w, n_steps):
    assert ft.fused_train_chw_supported(NCAConfig(**kw), h, w, n_steps) == \
        pallas_train.fused_train_supported(JNCAConfig(**kw), h, w, n_steps)


def test_chw_scope_and_errors():
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular")
    # TPU layout rules dropped: any W, any H
    assert ft.fused_train_chw_supported(cfg, 100, 37, 64)
    assert not ft.fused_train_chw_supported(NCAConfig(c_in=20, fc_dim=96), 64, 64, 64)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.zeros((1, 12, 8, 8))
    with pytest.raises(ValueError, match="segment must divide"):
        ft.fused_rollout_train(params, x, 0, cfg, 12, segment=8)
    with pytest.raises(ValueError, match="fused_train_chw_supported"):
        ft.fused_rollout_train_nhwc(params, x.permute(0, 2, 3, 1), 0, cfg, 63)
    ms = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", perception_scales=(0, 1))
    with pytest.raises(ValueError, match=r"perception_scales \(0,\)"):
        ft.fused_rollout_train_chw(params, x, None, 0, ms, 8, 4)
