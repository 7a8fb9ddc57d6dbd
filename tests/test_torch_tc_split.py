"""The arithmetic the training backward kernels feed the tensor cores,
emulated in plain torch on the CPU (``csrc/nca_mma.cuh``).

Under float32 compute ``nca_bwd_mlp`` and ``cnca_bwd_mlp`` form every
product after the relu gates in split TF32: each operand a = a_hi + a_lo,
a_hi rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
from zero, on the float32 bits), a_lo = a - a_hi truncated to TF32, and
a b = a_hi b_hi + a_hi b_lo + a_lo b_hi summed in float32 (the kernels sum
each depth block of 16 in the tensor core and add the blocks with float32
adds; how the tensor core accumulates is held on the card only). The
recomputed forward (z1, h1, h2, the gates) stays float32 on the CUDA
cores. These tests run one step of each kernel's
function with its products so emulated and hold it to the plain version at
the kernels' float32 tolerances: ``TRAIN_TOL`` 1e-5 of the largest element
(the card tests', tighter than chip_smoke's 1e-4) for the DyNCA backward,
``CNCA_TOL`` 1e-6 for the ConditionedNCA backward (chip_smoke's). ``-s``
prints the measured ratios. The kernels themselves are held against their
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from vsnca_tpu_torch.config import ConditionedNCAConfig, NCAConfig
from vsnca_tpu_torch.models import conditioned_nca as cn
from vsnca_tpu_torch.models.dynca import dynca_init
from vsnca_tpu_torch.ops import fused_cnca as fc
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops import fused_train as ft
from vsnca_tpu_torch.ops.conv import depthwise_perceive
from vsnca_tpu_torch.ops.perception import perceive

torch.set_num_threads(1)

TRAIN_TOL = 1e-5
CNCA_TOL = 1e-6


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 of float32's 23 mantissa bits, rounding to
    nearest with ties away from zero (add half of the dropped range to the
    magnitude bits, then clear them; the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 by clearing the 13 low mantissa bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: a_lo b_hi + a_hi b_lo + a_hi b_hi, each
    a float32 product of TF32 values, summed in float32."""
    (ah, al), (bh, bl) = split(a.float()), split(b.float())
    return al @ bh + ah @ bl + ah @ bh


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[B, K, H, W] → [B*H*W, K]: one row a pixel."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _ratio(got, want) -> float:
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)


def test_tf32_rounding_and_split_reconstruct():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    # exactly half a TF32 ulp above 1 and below -1: ties go away from zero
    assert tf32_rna(one + ulp / 2).item() == 1.0 + ulp
    assert tf32_rna(-(one + ulp / 2)).item() == -(1.0 + ulp)
    assert tf32_rna(one + ulp / 4).item() == 1.0
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    rel = float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max())
    print(f"\n  split reconstruction max rel err {rel:.3e} (bound 2^-21 = {2.0 ** -21:.3e})")
    assert rel <= 2.0 ** -21


def _emulated_nca_bwd_mlp(packed, x, cond, gx, seed, step, rate, multiscale):
    """nca_bwd_mlp_reference's function with the kernel's tensor-core
    products emulated (float32 compute)."""
    w1, b1, w2, _ = packed
    c = x.shape[1]
    p = fs.multiscale_percept(x, "circular") if multiscale else perceive(x, "circular")
    if cond is not None:
        p = torch.cat([p, cond], dim=1)
    z1 = torch.einsum("bphw,pf->bfhw", p, w1) + b1[:, None, None]
    gdx = gx * fs.batch_mask(seed, step, x.shape, rate, x.device)
    pr, zr, gr = _rows(p), _rows(z1), _rows(gdx)
    hid = torch.relu(zr)
    gz1 = torch.where(zr > 0, mm3(gr, w2.t()), torch.zeros_like(zr))
    gp = mm3(gz1, w1.t())
    b, _, h, w = x.shape
    gp = gp.reshape(b, h, w, -1).permute(0, 3, 1, 2)
    ones = torch.ones((1, pr.shape[0]))
    return (gp[:, : 4 * c], gp[:, 4 * c:], mm3(pr.t(), gz1), mm3(ones, gz1)[0],
            mm3(hid.t(), gr), gr.sum(0))


@pytest.mark.parametrize("c_in,fc_dim,scales", [(16, 128, (0, 1)), (12, 96, (0,))])
def test_nca_bwd_mlp_split_tf32_within_train_tol(c_in, fc_dim, scales):
    cfg = NCAConfig(c_in=c_in, fc_dim=fc_dim, padding_mode="circular",
                    conditioning="pos_emb", perception_scales=scales)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.RandomState(1)
    shape = (2, c_in, 32, 32)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32) - 0.5)
    gx = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    cond = torch.from_numpy(rng.rand(2, 2, 32, 32).astype(np.float32) - 0.5)
    packed = fs.pack_weights(params, c_in, 2, "float32")
    ms = scales == (0, 1)
    want = ft.nca_bwd_mlp_reference(packed, x, cond, gx, 3, 5, 0.5, "float32", True, ms)
    got = _emulated_nca_bwd_mlp(packed, x, cond, gx, 3, 5, 0.5, ms)
    names = ("gp", "dcond", "dW1", "db1", "dW2", "db2")
    ratios = {k: _ratio(a, b) for k, a, b in zip(names, got, want)}
    print(f"\n  c{c_in}/fc{fc_dim} scales {scales}: split TF32 vs float32, "
          "max|diff|/max|plain|: " + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items())
          + f" (tol {TRAIN_TOL:.0e})")
    assert all(float(b.abs().max()) > 0 for b in want)
    assert max(ratios.values()) <= TRAIN_TOL


def _emulated_cnca_bwd_mlp(packed, x, goal, life, g, cfg, seed, step, rate):
    """cnca_bwd_mlp_reference's function (float32) with the kernel's
    tensor-core products emulated; the recompute and the depthwise weight
    gradient as the plain version forms them."""
    wcol, w1, b1, w2, b2, w3 = packed
    b, c, h, w = x.shape
    xg = x + goal * fc._alive(x, cfg)
    p = depthwise_perceive(xg, wcol.reshape(c, 3, 3, 3))
    h1 = torch.relu(torch.einsum("bkhw,kf->bfhw", p, w1) + b1[:, None, None])
    h2 = torch.relu(torch.einsum("bfhw,fe->behw", h1, w2) + b2[:, None, None])
    w3c = w3[:, :c]
    m = fs.batch_mask(seed, step, x.shape, rate, x.device)
    xn = x + torch.einsum("behw,ec->bchw", h2, w3c) * m
    lf = torch.ones_like(m) if life is None else life[:, None].float()
    xl = xn * lf
    g_xn = g * ((xl >= -cfg.clamp_value) & (xl <= cfg.clamp_value)).float() * lf
    pr, h1r, h2r, gdx = _rows(p), _rows(h1), _rows(h2), _rows(g_xn * m)
    gh2 = torch.where(h2r > 0, mm3(gdx, w3c.t()), torch.zeros_like(h2r))
    gh1 = torch.where(h1r > 0, mm3(gh2, w2.t()), torch.zeros_like(h1r))
    gp = mm3(gh1, w1.t()).reshape(b, h, w, -1).permute(0, 3, 1, 2)
    xgp = torch.nn.functional.pad(xg, (1, 1, 1, 1))
    gps = gp.reshape(b, c, 3, h, w)
    dwcol = torch.stack([
        (xgp[:, :, di:di + h, dj:dj + w] * gps[:, :, s]).sum(dim=(0, 2, 3))
        for s in range(3) for di in range(3) for dj in range(3)
    ], dim=1)
    ones = torch.ones((1, pr.shape[0]))
    grads = [dwcol, mm3(pr.t(), gh1), mm3(ones, gh1)[0], mm3(h1r.t(), gh2),
             mm3(ones, gh2)[0], mm3(h2r.t(), gdx)]
    return g_xn, gp, grads


def test_cnca_bwd_mlp_split_tf32_within_cnca_tol():
    cfg = ConditionedNCAConfig(image_size=32, cell_fire_rate=0.5)
    assert (cfg.num_channels, cfg.update_hidden_dim) == (20, 64)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.RandomState(2)
    b, c = 2, cfg.num_channels
    x = np.zeros((b, c, 32, 32), np.float32)
    x[:, cfg.alive_channel:, 16, 16] = 1.0
    x = torch.from_numpy(x + 0.3 * rng.randn(*x.shape).astype(np.float32))
    goal = torch.from_numpy(0.3 * rng.randn(b, c, 32, 32).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, c, 32, 32).astype(np.float32))
    packed = fc.pack_weights(params, cfg, "float32")
    _, life = fc.cnca_step_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5)
    want = fc.cnca_bwd_mlp_reference(packed, x, goal, life, g, cfg, "float32", 3, 5, 0.5)
    got = _emulated_cnca_bwd_mlp(packed, x, goal, life, g, cfg, 3, 5, 0.5)
    names = ("g_xn", "gp", "dwcol", "dW1", "db1", "dW2", "db2", "dW3")
    flat = lambda r: [r[0], r[1], *r[2]]  # noqa: E731
    ratios = {k: _ratio(a, w) for k, a, w in zip(names, flat(got), flat(want))}
    print("\n  cnca C20/D64: split TF32 vs float32, max|diff|/max|plain|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items()) + f" (tol {CNCA_TOL:.0e})")
    assert all(float(w.abs().max()) > 0 for w in flat(want))
    assert max(ratios.values()) <= CNCA_TOL
