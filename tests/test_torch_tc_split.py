"""The arithmetic the DyNCA and ConditionedNCA kernels feed the tensor
cores, emulated in plain torch on the CPU (``csrc/nca_mma.cuh``).

Under float32 compute every product runs in split TF32: each operand
a = a_hi + a_lo, a_hi rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to
nearest, ties away from zero, on the float32 bits), a_lo = a - a_hi
truncated to TF32, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi summed in
float32 (the kernels sum each depth block of 16 in the tensor core and add
the blocks with float32 adds; how the tensor core accumulates is held on
the card only). Under bf16 compute the operands are already bf16, so the
products are exact.

The backward kernels: one step of each kernel's function with its products
so emulated, held to the plain version at the kernels' float32 tolerances:
``TRAIN_TOL`` 1e-5 of the largest element (the card tests', tighter than
chip_smoke's 1e-4) for the DyNCA backward, ``CNCA_TOL`` 1e-6 for the
ConditionedNCA backward (chip_smoke's).

The rollout step ``nca_step`` / ``nca_step_ms`` (tensor-core form): z1 and
the second layer as the kernel forms them, z1 through the certificate of
``z1_finish`` (an element whose relu input lies within Z1_KAPPA * max|p| *
sum|W1| of zero takes the plain chain's value), 1 and 8 steps at
c12/fc96/cc3 scales (0,) and c16/fc128/cc2 scales (0, 1), held to the
port's plain rollout and to the JAX reference (``dynca_step``, and
``fused_rollout_chw`` in interpret mode) at update rate 1: float32 within
``MS_STATE_TOL`` 1e-6 of the largest element, bf16 within ``TOL['bfloat16']``
1e-3. The certificate's bound against the product's measured error, and a
gate stress in which a tenth of z1 lies within 1e-6 of zero: the certified
gates are the plain version's, the raw product's are not. Last, why the
training pair's forward stays the FMA chain (``nca_step_chain_kernel``): a
pair whose forward ran the tensor-core step reaches slightly different
states, relu gates flip on that trajectory, and its gradients leave the
plain pair's tolerance; the pair as it runs (chain forward, the certified
tensor-core backward) stays within ``TRAIN_TOL``. ``-s`` prints the
measured ratios. The kernels themselves are held against their plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vsnca_tpu.config import NCAConfig as JNCAConfig
from vsnca_tpu.models import dynca as jdynca
from vsnca_tpu.ops.pallas_step import fused_rollout_chw as j_fused_rollout_chw

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
MS_STATE_TOL = 1e-6  # chip_smoke.py's multiscale state tolerance
BF16_TOL = 1e-3  # chip_smoke.py's TOL["bfloat16"], absolute
Z1_KAPPA = 2.0 ** -16  # csrc/nca_mma.cuh


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


# ------------------------------------------------- the rollout step's MLP


def mm_blocks(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a [M, K] @ b [K, N] as z1_mma and the second layer form it: per depth
    block of 16, (a_lo b_hi + a_hi b_lo) + a_hi b_hi into fresh float32
    accumulators, added into the running sum; bf16 operands (already
    rounded) give exact products, summed in float32."""
    if bf16:
        return a @ b
    out = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], 16):
        (ah, al), (bh, bl) = split(a[:, k0:k0 + 16]), split(b[k0:k0 + 16])
        out = out + ((al @ bh + ah @ bl) + ah @ bh)
    return out


def _step_parts(x, cond, packed, pad, cdt, multiscale):
    """The percept rows [N, P] (rounded as the kernel rounds them), the plain
    z1 + b1 and the emulated product's z1 + b1, with the certificate's bound
    Z1_KAPPA * max|p| * sum|W1| a (pixel, unit)."""
    w1, b1, _, _ = packed
    rnd = fs.rounder(cdt)
    p = fs.multiscale_percept(x, pad) if multiscale else perceive(x, pad)
    if cond is not None:
        p = torch.cat([p, cond], dim=1)
    pr = _rows(rnd(p.float()))
    z_plain = pr @ w1 + b1
    z_tc = mm_blocks(pr, w1, cdt == "bfloat16") + b1
    bound = Z1_KAPPA * pr.abs().amax(1, keepdim=True) * w1.abs().sum(0)
    return pr, z_plain, z_tc, bound


def tc_step(x, cond, packed, pad, cdt, seed, step, rate, multiscale):
    """One step of the tensor-core ``nca_step`` (``launch_step``'s function
    in the kernel's arithmetic)."""
    _, _, w2, b2 = packed
    rnd = fs.rounder(cdt)
    _, z_plain, z_tc, bound = _step_parts(x, cond, packed, pad, cdt, multiscale)
    z = torch.where(z_tc.abs() < bound, z_plain, z_tc)
    dx = mm_blocks(rnd(torch.relu(z)), w2, cdt == "bfloat16")
    b, _, h, w = x.shape
    dx = dx.reshape(b, h, w, -1).permute(0, 3, 1, 2) + b2[:, None, None]
    return x + dx * fs.batch_mask(seed, step, x.shape, rate, x.device)


def _model(c_in, fc_dim, cc, scales, rate=1.0, seed=0):
    cond_kind = {2: "pos_emb", 3: "edges"}[cc]
    kw = dict(c_in=c_in, fc_dim=fc_dim, padding_mode="circular", conditioning=cond_kind,
              perception_scales=scales, update_rate=rate)
    params = dynca_init(torch.Generator().manual_seed(seed), NCAConfig(**kw), device="cpu")
    return kw, params


def _state(rng, b, c, cc, h, w):
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, c, h, w)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, cc, h, w)).astype(np.float32))
    return x, cond


MODELS = [(12, 96, 3, (0,)), (16, 128, 2, (0, 1))]


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,fc_dim,cc,scales", MODELS)
def test_tc_step_matches_plain_and_jax(c_in, fc_dim, cc, scales, cdt):
    kw, params = _model(c_in, fc_dim, cc, scales)
    cfg, ms = NCAConfig(**kw), scales == (0, 1)
    x, cond = _state(np.random.RandomState(5), 1, c_in, cc, 16, 128)
    packed = fs.pack_weights(params, c_in, cc, cdt)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jcfg = JNCAConfig(**kw)
    got = x
    for n in (1, 8):
        while n > getattr(got, "_steps", 0):
            steps = getattr(got, "_steps", 0)
            got = tc_step(got, cond, packed, "circular", cdt, 7, steps, 1.0, ms)
            got._steps = steps + 1
        plain = fs.fused_rollout_chw_reference(params, x, 7, cfg, n, cond, None, cdt)
        with pltpu.force_tpu_interpret_mode():
            jk = np.asarray(j_fused_rollout_chw(jp, jnp.asarray(x.numpy()), jnp.int32(0), jcfg,
                                                n, jnp.asarray(cond.numpy()),
                                                compute_dtype=cdt))
        if cdt == "float32":
            js = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
            jc = jnp.asarray(cond.numpy().transpose(0, 2, 3, 1))
            for i in range(n):
                js = jdynca.dynca_step(jp, js, jax.random.PRNGKey(i), jcfg, jc)
            js = np.asarray(js).transpose(0, 3, 1, 2)
        refs = {"plain": plain.numpy(), "jax interpret kernel": jk}
        if cdt == "float32":
            refs["jax dynca_step"] = js
        g = got.detach().numpy()
        errs = {k: (float(np.abs(g - r).max()), float(np.abs(g - r).max() / np.abs(r).max()))
                for k, r in refs.items()}
        print(f"\n  tc step c{c_in}/fc{fc_dim}/cc{cc} {scales} {cdt} x{n}: "
              + ", ".join(f"{k} {a:.2e} ({r:.2e} of max)" for k, (a, r) in errs.items()))
        for a, r in errs.values():
            assert (r <= MS_STATE_TOL) if cdt == "float32" else (a <= BF16_TOL)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,fc_dim,cc,scales", MODELS)
def test_z1_certificate_bounds_the_product_error(c_in, fc_dim, cc, scales, cdt):
    """|product - plain| of z1 stays under half the certificate's bound, and
    the certificate recomputes a small share of the elements."""
    _, params = _model(c_in, fc_dim, cc, scales)
    x, cond = _state(np.random.RandomState(6), 2, c_in, cc, 32, 32)
    packed = fs.pack_weights(params, c_in, cc, cdt)
    _, z_plain, z_tc, bound = _step_parts(x, cond, packed, "circular", cdt, scales == (0, 1))
    ratio = float(((z_tc - z_plain).abs() / bound).max())
    share = float((z_tc.abs() < bound).float().mean())
    print(f"\n  c{c_in}/fc{fc_dim} {cdt}: max |product - plain| / bound {ratio:.2e} "
          f"(<= 0.5), certificate recomputes {share:.2e} of z1")
    assert ratio <= 0.5 and share < 1e-2


@pytest.mark.parametrize("c_in,fc_dim,cc,scales", MODELS)
def test_gate_stress_certified_gates_are_the_plain_gates(c_in, fc_dim, cc, scales):
    """A tenth of the pixels share one percept (a constant patch of state and
    conditioning, away from the edge of the multiscale footprint), and b1
    puts their z1 within 1e-6 of zero: the raw product's gates differ from
    the plain version's there, the certified gates do not."""
    _, params = _model(c_in, fc_dim, cc, scales)
    rng = np.random.RandomState(7)
    x, cond = _state(rng, 1, c_in, cc, 64, 64)
    x[..., 4:36, 4:36] = torch.from_numpy(rng.uniform(-0.5, 0.5, (c_in, 1, 1)).astype(np.float32))
    cond[..., 4:36, 4:36] = 0.25
    packed = list(fs.pack_weights(params, c_in, cc, "float32"))
    pr, z_plain, _, _ = _step_parts(x, cond, packed, "circular", "float32", scales == (0, 1))
    inner = torch.zeros((64, 64), dtype=torch.bool)
    inner[10:30, 10:30] = True  # 400 of 4096 pixels
    inner = inner.flatten()
    assert torch.equal(pr[inner].amin(0), pr[inner].amax(0))
    offset = torch.from_numpy(rng.uniform(-1e-8, 1e-8, packed[1].shape).astype(np.float32))
    packed[1] = offset - (z_plain[inner][0] - packed[1])
    _, z_plain, z_tc, bound = _step_parts(x, cond, packed, "circular", "float32",
                                          scales == (0, 1))
    near = float((z_plain.abs() <= 1e-6).float().mean())
    z_cert = torch.where(z_tc.abs() < bound, z_plain, z_tc)
    raw = int(((z_tc > 0) != (z_plain > 0)).sum())
    certified = int(((z_cert > 0) != (z_plain > 0)).sum())
    print(f"\n  c{c_in}/fc{fc_dim}: {near:.3f} of z1 within 1e-6 of zero; gates unlike the "
          f"plain version's: raw product {raw}, certified {certified}")
    assert near >= 0.09 and raw > 0 and certified == 0


def _pair_grads(params, x, cond, gy, n_steps, tc_forward):
    """Gradients of sum(gy * rollout), scales (0,): the backward is autograd
    through the plain products, so only the relu gates and the forward
    states differ. With ``tc_forward`` z1 and dx take the tensor-core
    step's values (the certified z1); without, the plain forward, and the
    certified product's gates are counted where they differ from it (what
    the pair's backward would see)."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr = x.clone().requires_grad_()
    y, flips = xr, 0
    for s in range(n_steps):
        pr = _rows(torch.cat([perceive(y, "circular"), cond], dim=1))
        z = pr @ p["w1"] + p["b1"]
        zd, pd, w1 = z.detach(), pr.detach(), p["w1"].detach()
        z_tc = mm_blocks(pd, w1, False) + p["b1"].detach()
        bound = Z1_KAPPA * pd.abs().amax(1, keepdim=True) * w1.abs().sum(0)
        z_cert = torch.where(z_tc.abs() < bound, zd, z_tc)
        h = torch.relu(z + (z_cert - zd)) if tc_forward else torch.relu(z)
        flips += int(((z_cert > 0) != (zd > 0)).sum())
        dx = h @ p["w2"]
        if tc_forward:
            dx = dx + (mm_blocks(h.detach(), p["w2"].detach(), False) - dx.detach())
        b, _, hh, ww = y.shape
        dx = dx.reshape(b, hh, ww, -1).permute(0, 3, 1, 2) + p["b2"][:, None, None]
        y = y + dx * fs.batch_mask(7, s, y.shape, 0.5, y.device)
    (y * gy).sum().backward()
    return y.detach(), {"x0": xr.grad, **{k: v.grad for k, v in p.items() if k != "b2"}}, flips


def test_pair_keeps_the_chain_forward():
    """static_texture's cell, 128^2 b2, 32 steps at rate 0.5 (chip_smoke's
    largest scales-(0,) pair case at half its batch). The pair as it runs —
    the chain forward, which is the plain forward, and the certified
    tensor-core gates in the backward — meets no gate unlike the forward's, so its gradients are the
    plain pair's within TRAIN_TOL. A pair whose forward ran the tensor-core
    step keeps its states within MS_STATE_TOL, but gates flip on its
    trajectory and its gradients leave TRAIN_TOL."""
    _, params = _model(12, 96, 2, (0,))
    rng = np.random.RandomState(1)
    x, cond = _state(rng, 2, 12, 2, 128, 128)
    gy = torch.from_numpy(rng.randn(2, 12, 128, 128).astype(np.float32))
    y0, g0, flips = _pair_grads(params, x, cond, gy, 32, False)
    y2, g2, _ = _pair_grads(params, x, cond, gy, 32, True)
    r2 = {k: _ratio(g2[k], g0[k]) for k in g0}
    s2 = _ratio(y2, y0)
    print(f"\n  chain forward: certified gates unlike the forward's: {flips}"
          f"\n  tensor-core forward: states {s2:.1e} of max, grads "
          + ", ".join(f"{k} {v:.1e}" for k, v in r2.items()) + f" (TRAIN_TOL {TRAIN_TOL:.0e})")
    assert flips == 0
    assert s2 <= MS_STATE_TOL and max(r2.values()) > TRAIN_TOL
