"""The differentiable training rollout: N DyNCA steps on NCHW state whose
forward runs the inference kernel ``csrc/nca_step.cu`` and whose backward
runs the kernels of ``csrc/nca_train.cu``, with the plain PyTorch version of
each beside it.

Counterpart of ``vsnca_tpu/ops/pallas_train.py::fused_rollout_train_flat``
(:2535) and its custom VJPs ``fused_rollout_train_flat_hw`` (:2403) and
``fused_rollout_train_flat_taps_hw`` (:2458):

- forward (``_make_fwd_kernel_flat`` :942, and for perception_scales (0, 1)
  ``_make_fwd_kernel_flat_tiled_ms`` :1031): one ``nca_step`` (or
  ``nca_step_ms``) launch a step in its chain form (the MLP as float32 FMAs
  in the plain version's order, so the pair's states and relu gates are the
  plain pair's bits), each step's input state written into a
  checkpoint buffer [n_steps, B, C, H, W] — the TPU's segment 1, with no
  recompute. The masks are the hash of (seed, batch, step, pixel)
  (``fused_step.mask_bits``), so the backward regenerates them exactly;
- backward (``_make_bwd_kernel_flat`` :1139, ``_make_bwd_kernel_flat_scatter``
  :1657 and ``_make_bwd_kernel_flat_tiled`` :1301 with its multiscale adjoint
  ``_flat_percept_ms_adj`` :185): two launches a step, steps in reverse —
  ``nca_bwd_mlp`` (MLP cotangents, perception cotangent gp, per-block
  weight-gradient partials, dcond) and ``nca_bwd_adjoint`` (gx += the
  flipped-stencil adjoint of gp), or their multiscale forms
  ``nca_bwd_mlp_ms`` and ``nca_bwd_adjoint_ms``. The wrapper sums the
  per-block partials once per call;
- frame taps (``tap_steps``): tap t is the checkpoint of state t, free in the
  forward; the backward adds each tap's cotangent inside the adjoint launch
  of step t, where gx has just become the cotangent of that state.

The segment-checkpointed CHW pair (``pallas_train.py::fused_rollout_train_chw``
:878, ``_fwd_call`` :759 → ``_make_fwd_kernel`` :390 and ``_bwd_call`` :843 →
``_make_bwd_kernel`` :485) is the same pair with a segment K > 1: the
forward keeps only the states at steps 0, K, 2K, … in an
[n/K, B, C, H, W] checkpoint, and the backward walks the segments in reverse,
recomputes each segment's K states into a K-slot scratch with ``nca_step``
launches that draw the same absolute-step masks, then runs ``nca_bwd_mlp`` +
``nca_bwd_adjoint`` down the segment: memory for n/K + K states instead of
n, for one more forward's launches. The TPU backend recomputes inside its
kernel; the port recomputes by launches, so rows 5 and 6 need no kernel
source of their own. The kernels and the order of every sum are those of
K = 1, so every K gives bit-identical results. The JAX names map so:

=============================================  =================================
``pallas_train.py``                            here
=============================================  =================================
``fused_rollout_train_chw`` :878               ``fused_rollout_train_chw``
``pick_segment`` :686                          ``pick_segment``
``fused_train_supported`` :703 (CHW pair)      ``fused_train_chw_supported``
``fused_rollout_train`` :2617 (NHWC, CHW)      ``fused_rollout_train_nhwc``
``fused_train_flat_supported`` :2014           ``fused_train_supported``
``fused_rollout_train_flat`` :2535             ``fused_rollout_train``
=============================================  =================================

Scope (``fused_train_supported``): circular padding and perception_scales
(0,) or (0, 1), as the TPU pair; its ``W % 128`` rule and VMEM plans are TPU
layout and do not apply (scales (0, 1) need even H and W, as the TPU pair
asserts). ``fused_rollout_train`` launches the kernels for CUDA tensors and
runs the plain versions only for CPU tensors; there is no fallback.
``LAUNCHES`` counts every launch the pair makes, and ``KERNEL_LAUNCHES``
splits it by kernel (the forward's launches also count in
``fused_step.LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.ops import _build
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops.filters import LAPLACIAN, SOBEL_X, SOBEL_Y
from vsnca_tpu_torch.ops.perception import perceive, stencil_3x3

LAUNCHES = 0
KERNEL_LAUNCHES: Dict[str, int] = {
    "nca_step": 0, "nca_bwd_mlp": 0, "nca_bwd_adjoint": 0,
    "nca_step_ms": 0, "nca_bwd_mlp_ms": 0, "nca_bwd_adjoint_ms": 0,
}

C_MAX, CC_MAX, F_MAX = fs.C_MAX, fs.CC_MAX, fs.F_MAX
SEGMENTS = (16, 8, 4, 2)  # pick_segment's candidates, largest first
TILE = 16  # NCA_TILE: the kernels' blocks are TILE x TILE pixels


def _flip(k: np.ndarray) -> np.ndarray:
    """180-degree rotation: the adjoint of a correlation is the correlation
    with the flipped filter (pallas_train.py::_flip :68)."""
    return np.ascontiguousarray(k[::-1, ::-1])


SOBEL_X_F, SOBEL_Y_F, LAPLACIAN_F = _flip(SOBEL_X), _flip(SOBEL_Y), _flip(LAPLACIAN)


def fused_train_supported(cfg: NCAConfig, n_steps: int) -> bool:
    """True when the training pair applies — the port's rule for
    ``fused_train_flat_supported`` (pallas_train.py:2014): circular padding,
    perception_scales (0,) or (0, 1), at least one step, and the kernels'
    size limits. Any H and W (even for (0, 1); the wrapper raises on odd)."""
    return (
        cfg.padding_mode == "circular"
        and tuple(cfg.perception_scales) in fs.SCALES
        and n_steps >= 1
        and fs.kernel_cfg_ok(cfg)
    )


def pick_segment(cfg: NCAConfig, h: int, w: int, n_steps: int) -> Optional[int]:
    """The checkpoint interval of the CHW pair — the port's rule for
    ``pick_segment`` (pallas_train.py:686): the largest K in (16, 8, 4, 2)
    that divides ``n_steps``, else None. The TPU's
    ``bwd_vmem_bytes_estimate`` (:665) budget and row-tile rule are VMEM
    and do not apply: the port's scratch of K states lives in device
    memory."""
    return next((k for k in SEGMENTS if n_steps % k == 0), None)


def fused_train_chw_supported(cfg: NCAConfig, h: int, w: int, n_steps: int) -> bool:
    """True when the segment-checkpointed CHW pair applies — the port's rule
    for ``fused_train_supported`` (pallas_train.py:703): circular padding,
    perception_scales (0,), a segment K from ``pick_segment``, within the
    kernels' limits. Dropped as TPU layout: ``W % 128`` and ``H % 8``."""
    return (tuple(cfg.perception_scales) == (0,)
            and fused_train_supported(cfg, n_steps)
            and pick_segment(cfg, h, w, n_steps) is not None)


@dataclasses.dataclass(frozen=True)
class _Spec:
    seed: int
    n_steps: int
    update_rate: float
    compute_dtype: str
    cond_no_grad: bool
    multiscale: bool = False
    tap_steps: Tuple[int, ...] = ()
    first_step: int = 0
    segment: int = 1

    @property
    def thr(self) -> int:
        return fs.uniform_threshold(self.update_rate)


def fused_rollout_train(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    compute_dtype: str = "float32",
    cond_no_grad: bool = False,
    tap_steps: Sequence[int] = (),
    first_step: int = 0,
    segment: int = 1,
):
    """``n_steps`` NCA steps, x [B, C, H, W] float32 → final state, with
    gradients to ``params`` (w1, b1, w2, b2), ``x`` and ``cond``
    ([B, c_cond, H, W] or None; no gradient when ``cond_no_grad``, the
    trainer's case). ``seed`` keys the masks as in
    ``fused_step.fused_rollout_chw``, whose function the forward is (step i
    of the call draws the mask of absolute step ``first_step + i``).

    ``tap_steps`` (strictly increasing, in [1, n_steps)): return
    ``(state, [tap states])`` instead, tap t being the state after t steps
    ([B, C, H, W], a copy of its checkpoint); the gradient flows through the
    taps too, in one reverse walk (``fused_rollout_train_flat`` with
    ``tap_steps``, pallas_train.py:2579-2606).

    ``segment`` K (dividing ``n_steps``) checkpoints every K-th state and
    recomputes each segment in the backward (the CHW pair's schedule, see
    the module docstring); K = 1 keeps every state. Any K gives the same
    results bit for bit, at scales (0,) and (0, 1), with or without taps."""
    fs._check(params, x, cfg, cond, compute_dtype)
    if not fused_train_supported(cfg, n_steps):
        raise ValueError(
            "the training pair takes circular padding, perception_scales (0,) or "
            f"(0, 1), n_steps >= 1, C <= {C_MAX}, c_cond <= {CC_MAX}, fc_dim <= {F_MAX}"
        )
    taps = tuple(int(t) for t in tap_steps)
    if any(not 1 <= t < n_steps for t in taps) or list(taps) != sorted(set(taps)):
        raise ValueError(f"tap_steps must be strictly increasing in [1, {n_steps}), "
                         f"got {taps}")
    if segment < 1 or n_steps % segment:
        raise ValueError(f"segment must divide n_steps = {n_steps}, got {segment}")
    if x.dtype != torch.float32:
        raise ValueError(f"the training pair takes a float32 state, got {x.dtype}")
    if x.device.type != "cpu":
        fs.check_card_inputs(x, (cond,), limits=train_kernel_limits(),
                             fc_dim=cfg.fc_dim)
    rate = cfg.update_rate if update_rate is None else update_rate
    spec = _Spec(seed, n_steps, rate, compute_dtype, cond_no_grad,
                 fs.is_multiscale(cfg), taps, first_step, segment)
    out = _TrainRollout.apply(params["w1"], params["b1"], params["w2"], params["b2"],
                              x, cond, spec)
    return (out[0], list(out[1:])) if taps else out


class _TrainRollout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1, b1, w2, b2, x, cond, spec: _Spec):
        cc = cond.shape[1] if cond is not None else 0
        packed = fs.pack_weights({"w1": w1, "b1": b1, "w2": w2, "b2": b2},
                                 x.shape[1], cc, spec.compute_dtype)
        run = _forward_card if x.device.type == "cuda" else _forward_reference
        y, ckpt, taps = run(packed, x, cond, spec)
        ctx.spec = spec
        ctx.w1_shape = w1.shape
        ctx.save_for_backward(*packed, ckpt, cond)
        if not spec.tap_steps:
            return y
        ctx.set_materialize_grads(False)
        return (y, *taps)

    @staticmethod
    def backward(ctx, gy, *gtaps):
        w1, b1, w2, b2, ckpt, cond = ctx.saved_tensors
        spec = ctx.spec
        need_dcond = cond is not None and ctx.needs_input_grad[5] and not spec.cond_no_grad
        gy = torch.zeros_like(ckpt[0]) if gy is None else gy.contiguous()
        taps = {t: g.contiguous() for t, g in zip(spec.tap_steps, gtaps) if g is not None}
        run = _backward_card if gy.device.type == "cuda" else _backward_reference
        dw1, db1, dw2, db2, dx0, dcond = run(
            (w1, b1, w2, b2), ckpt, cond, gy, spec, need_dcond, taps
        )
        p, f = ctx.w1_shape
        # the conditioning rows of W1 get no gradient from a call without cond
        dw1 = F.pad(dw1[:, :f], (0, 0, 0, p - dw1.shape[0]))
        return dw1, db1[:f], dw2[:f], db2, dx0, dcond, None


# ------------------------------------------------------------------ forward


def _forward_card(packed, x, cond, spec: _Spec):
    """Returns (final state, checkpoint [n/K, B, C, H, W] of the states at
    steps 0, K, 2K, …, [tap states]). Step s writes its output straight
    into the checkpoint slot when s + 1 is a multiple of K, else into one of
    two scratch buffers."""
    n, k = spec.n_steps, spec.segment
    ckpt = torch.empty((n // k,) + tuple(x.shape), device=x.device)
    ckpt[0].copy_(x)
    y = torch.empty_like(x)
    bufs = [torch.empty_like(x) for _ in range(min(k - 1, 2))]
    taps = []
    src = ckpt[0]
    for s in range(n):
        nxt = s + 1
        dst = y if nxt == n else ckpt[nxt // k] if nxt % k == 0 else bufs[s % 2]
        fs.launch_step(src, dst, cond, packed, "circular", spec.compute_dtype,
                       spec.seed, spec.first_step + s, spec.thr, spec.multiscale, chain=True)
        _count("nca_step_ms" if spec.multiscale else "nca_step")
        if nxt in spec.tap_steps:
            taps.append(dst.clone())
        src = dst
    return y, ckpt, taps


def _forward_reference(packed, x, cond, spec: _Spec):
    states = []
    for s in range(spec.n_steps):
        states.append(x)
        x = fs.reference_step(x, cond, packed, "circular", spec.compute_dtype,
                              spec.seed, spec.first_step + s, spec.update_rate,
                              spec.multiscale)
    states.append(x)
    taps = [states[t] for t in spec.tap_steps]
    return x, torch.stack(states[:-1:spec.segment]), taps


# ----------------------------------------------------------------- backward


def _segment_states(ckpt, seg: int, cond, packed, spec: _Spec, scratch, step):
    """The K input states of segment ``seg``: its checkpoint, then K - 1
    recomputed by ``step(src, dst, cond, packed, …, absolute step)`` (a
    kernel launch or the plain step) drawing the forward's masks."""
    states = [ckpt[seg]]
    for j in range(spec.segment - 1):
        s = seg * spec.segment + j
        nxt = step(states[-1], scratch[j] if scratch is not None else None, cond, packed, spec,
                   spec.first_step + s)
        states.append(nxt)
    return states


def _recompute_card(src, dst, cond, packed, spec: _Spec, step: int):
    fs.launch_step(src, dst, cond, packed, "circular", spec.compute_dtype, spec.seed,
                   step, spec.thr, spec.multiscale, chain=True)
    _count("nca_step_ms" if spec.multiscale else "nca_step")
    return dst


def _recompute_reference(src, dst, cond, packed, spec: _Spec, step: int):
    return fs.reference_step(src, cond, packed, "circular", spec.compute_dtype, spec.seed,
                             step, spec.update_rate, spec.multiscale)


def _backward_card(packed, ckpt, cond, gy, spec: _Spec, need_dcond: bool, taps=None):
    _, b, c, h, w = ckpt.shape
    taps = taps or {}
    gx = gy.clone()
    gp = torch.empty((b, 4 * c, h, w), device=gy.device)
    dcond = torch.zeros_like(cond) if need_dcond else None
    slots = _zero_slots(b, c, h, w, packed)
    k = spec.segment
    scratch = torch.empty((k - 1, b, c, h, w), device=gy.device) if k > 1 else None
    for seg in reversed(range(ckpt.shape[0])):
        states = _segment_states(ckpt, seg, cond, packed, spec, scratch, _recompute_card)
        for j in reversed(range(k)):
            s = seg * k + j
            _launch_mlp(states[j], cond, gx, gp, dcond, slots, packed, spec.compute_dtype,
                        spec.seed, spec.first_step + s, spec.thr, spec.multiscale)
            _launch_adjoint(gp, gx, taps.get(s), spec.multiscale)
    return (*_split_slots(slots, packed, c), gx, dcond)


def _backward_reference(packed, ckpt, cond, gy, spec: _Spec, need_dcond: bool,
                        taps=None):
    taps = taps or {}
    gx = gy
    dcond = torch.zeros_like(cond) if need_dcond else None
    sums = None
    k = spec.segment
    for seg in reversed(range(ckpt.shape[0])):
        states = _segment_states(ckpt, seg, cond, packed, spec, None, _recompute_reference)
        for j in reversed(range(k)):
            s = seg * k + j
            gp, dc, *dparams = nca_bwd_mlp_reference(
                packed, states[j], cond, gx, spec.seed, spec.first_step + s,
                spec.update_rate, spec.compute_dtype, need_dcond, spec.multiscale,
            )
            sums = dparams if sums is None else [a + d for a, d in zip(sums, dparams)]
            if need_dcond:
                dcond = dcond + dc
            gx = nca_bwd_adjoint_reference(gp, gx, taps.get(s), spec.multiscale)
    return (*sums, gx, dcond)


def fused_rollout_train_reference(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor],
    gy: torch.Tensor,
    update_rate: Optional[float] = None,
    compute_dtype: str = "float32",
    need_dcond: bool = False,
    tap_steps: Sequence[int] = (),
    gtaps: Sequence[torch.Tensor] = (),
    segment: int = 1,
):
    """The whole pair in plain PyTorch as explicit steps: the forward
    (keeping every ``segment``-th state), then the reverse walk over the
    segments, each recomputed from its checkpoint, with
    ``nca_bwd_mlp_reference`` and ``nca_bwd_adjoint_reference`` for
    cotangent ``gy`` of the final state and ``gtaps[i]`` of the state after
    ``tap_steps[i]`` steps. Returns (state, {w1, b1, w2, b2: gradient}, dx0,
    dcond or None), and with taps (state, [tap states], grads, dx0,
    dcond)."""
    fs._check(params, x, cfg, cond, compute_dtype)
    if segment < 1 or n_steps % segment:
        raise ValueError(f"segment must divide n_steps = {n_steps}, got {segment}")
    rate = cfg.update_rate if update_rate is None else update_rate
    spec = _Spec(seed, n_steps, rate, compute_dtype, not need_dcond,
                 fs.is_multiscale(cfg), tuple(tap_steps), segment=segment)
    cc = cond.shape[1] if cond is not None else 0
    packed = fs.pack_weights(params, x.shape[1], cc, compute_dtype)
    y, ckpt, tap_states = _forward_reference(packed, x, cond, spec)
    dw1, db1, dw2, db2, dx0, dcond = _backward_reference(
        packed, ckpt, cond, gy, spec, need_dcond, dict(zip(spec.tap_steps, gtaps)))
    p, f = params["w1"].shape
    grads = {"w1": F.pad(dw1[:, :f], (0, 0, 0, p - dw1.shape[0])), "b1": db1[:f],
             "w2": dw2[:f], "b2": db2}
    if spec.tap_steps:
        return y, tap_states, grads, dx0, dcond
    return y, grads, dx0, dcond


def fused_rollout_train_chw(params: dict, x: torch.Tensor, cond: Optional[torch.Tensor],
                            seed: int, cfg: NCAConfig, n_steps: int, segment: int,
                            compute_dtype: str = "float32") -> torch.Tensor:
    """The segment-checkpointed CHW pair (pallas_train.py:878): ``n_steps``
    steps of x [B, C, H, W] float32 at ``cfg.update_rate``, checkpointed
    every ``segment`` steps, the final state returned with gradients to
    ``params``, ``x`` and ``cond`` (always to cond when it requires one, as
    the JAX pair returns dcond whenever cond is given). Scope
    ``fused_train_chw_supported``: circular, perception_scales (0,); the
    same code takes (0, 1) and taps through ``fused_rollout_train``."""
    if tuple(cfg.perception_scales) != (0,):
        raise ValueError("the CHW pair takes perception_scales (0,); "
                         "fused_rollout_train takes (0, 1)")
    return fused_rollout_train(params, x, seed, cfg, n_steps, cond,
                               compute_dtype=compute_dtype, segment=segment)


def fused_rollout_train_nhwc(params: dict, x_nhwc: torch.Tensor, seed: int,
                             cfg: NCAConfig, n_steps: int,
                             cond_nhwc: Optional[torch.Tensor] = None,
                             compute_dtype: str = "float32"):
    """NHWC wrapper of the CHW pair (``fused_rollout_train``,
    pallas_train.py:2617): returns (state, rgb) NHWC like ``dynca_rollout``,
    differentiable, with the segment ``pick_segment`` gives; raises
    ValueError where ``fused_train_chw_supported`` does not hold."""
    b, h, w, _ = x_nhwc.shape
    if not fused_train_chw_supported(cfg, h, w, n_steps):
        raise ValueError("the CHW training pair does not apply to this config "
                         "(fused_train_chw_supported)")
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    cond = None if cond_nhwc is None else cond_nhwc.permute(0, 3, 1, 2).contiguous()
    out = fused_rollout_train_chw(params, x, cond, seed, cfg, n_steps,
                                  pick_segment(cfg, h, w, n_steps), compute_dtype)
    state = out.permute(0, 2, 3, 1)
    return state, state[..., : cfg.c_out] * 2.0


# ------------------------------------------------------ the backward kernels


def nca_bwd_mlp(packed, x, cond, gx, seed: int, step: int, update_rate: float,
                compute_dtype: str = "float32", need_dcond: bool = False,
                multiscale: bool = False):
    """The first backward pass of one step (absolute step ``step``): x the
    step's input state and gx the cotangent of its output, [B, C, H, W];
    ``packed`` from ``fused_step.pack_weights``. Returns (gp [B, 4C, H, W],
    dcond [B, cc, H, W] or None, dW1 [4C + cc, F4], db1 [F4], dW2 [F4, C],
    db2 [C]) — this step's contributions; with ``multiscale`` the percept is
    scales (0, 1)'s average and gp its cotangent. One ``nca_bwd_mlp`` (or
    ``nca_bwd_mlp_ms``) launch for CUDA tensors; the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return nca_bwd_mlp_reference(packed, x, cond, gx, seed, step, update_rate,
                                     compute_dtype, need_dcond, multiscale)
    b, c, h, w = x.shape
    fs.check_card_inputs(x, (cond,), (gx,), packed)
    _check_even(x, multiscale)
    gp = torch.empty((b, 4 * c, h, w), device=x.device)
    dcond = torch.zeros_like(cond) if need_dcond else None
    slots = _zero_slots(b, c, h, w, packed)
    _launch_mlp(x, cond, gx, gp, dcond, slots, packed, compute_dtype, seed, step,
                fs.uniform_threshold(update_rate), multiscale)
    return (gp, dcond, *_split_slots(slots, packed, c))


def nca_bwd_mlp_reference(packed, x, cond, gx, seed: int, step: int,
                          update_rate: float, compute_dtype: str = "float32",
                          need_dcond: bool = False, multiscale: bool = False):
    """``nca_bwd_mlp``'s function in plain PyTorch (float32 products, TF32
    off; bf16 rounding of the percept, hid, gdx and gz1 as the kernel)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w1, b1, w2, _ = packed
    c = x.shape[1]
    rnd = fs.rounder(compute_dtype)
    p = fs.multiscale_percept(x, "circular") if multiscale else perceive(x, "circular")
    if cond is not None:
        p = torch.cat([p, cond], dim=1)
    p = rnd(p)
    z1 = torch.einsum("bphw,pf->bfhw", p, w1) + b1[:, None, None]
    hid = rnd(torch.relu(z1))
    gdx = rnd(gx * fs.batch_mask(seed, step, x.shape, update_rate, x.device))
    g2 = torch.einsum("bchw,fc->bfhw", gdx, w2)
    gz1 = rnd(torch.where(z1 > 0, g2, torch.zeros_like(g2)))
    gp = torch.einsum("bfhw,pf->bphw", gz1, w1)
    return (
        gp[:, : 4 * c].contiguous(),
        gp[:, 4 * c:].contiguous() if need_dcond else None,
        torch.einsum("bphw,bfhw->pf", p, gz1),
        gz1.sum(dim=(0, 2, 3)),
        torch.einsum("bfhw,bchw->fc", hid, gdx),
        gdx.sum(dim=(0, 2, 3)),
    )


def nca_bwd_adjoint(gp: torch.Tensor, gx: torch.Tensor,
                    gtap: Optional[torch.Tensor] = None,
                    multiscale: bool = False) -> torch.Tensor:
    """The second backward pass of one step: gx + the state cotangent of the
    percept cotangent gp — gp[:, :C] + the adjoint Sobel-x, Sobel-y and
    Laplacian stencils of gp[:, C:4C] (flipped filters, circular), or with
    ``multiscale`` the transpose of scales (0, 1)'s percept — plus ``gtap``
    [B, C, H, W] when given (a frame tap's cotangent). One
    ``nca_bwd_adjoint`` (or ``nca_bwd_adjoint_ms``) launch, on a copy of gx,
    for CUDA tensors; the plain version for CPU tensors."""
    if gx.device.type == "cpu":
        return nca_bwd_adjoint_reference(gp, gx, gtap, multiscale)
    fs.check_card_inputs(gx, (gp,), () if gtap is None else (gtap,))
    _check_even(gx, multiscale)
    if gp.shape[1] != 4 * gx.shape[1]:
        raise ValueError(f"gp must have 4C = {4 * gx.shape[1]} channels, got {gp.shape[1]}")
    out = gx.clone()
    _launch_adjoint(gp, out, gtap, multiscale)
    return out


def _stencil_adjoint(g: torch.Tensor, c: int) -> torch.Tensor:
    """g[:, :C] + the flipped-stencil correlations of g's three stencil
    blocks, circular, in the JAX term order (pallas_train.py:1274-1280)."""
    sx, = stencil_3x3(g[:, c:2 * c], [SOBEL_X_F], "circular")
    sy, = stencil_3x3(g[:, 2 * c:3 * c], [SOBEL_Y_F], "circular")
    lap, = stencil_3x3(g[:, 3 * c:], [LAPLACIAN_F], "circular")
    return g[:, :c] + sx + sy + lap


def upsample2_adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """Transpose of ``fused_step.upsample2`` along ``dim`` (2m → m): half
    pixel i gathers its children 2i and 2i + 1 at 0.75 and the neighbours'
    0.25 taps, 2i - 1 and 2i + 2 (at the clamped edges its own child 2i
    for i = 0 and 2i + 1 for i = m - 1), summed as
    (0.75 a + 0.75 b) + (0.25 l + 0.25 r) — nca_train.cu's upsample2_t."""
    dim %= g.dim()
    n = g.shape[dim]
    a = g.narrow(dim, 0, n).unfold(dim, 1, 2).squeeze(-1)       # g[2i]
    b = g.narrow(dim, 1, n - 1).unfold(dim, 1, 2).squeeze(-1)   # g[2i + 1]
    left = torch.cat([a.narrow(dim, 0, 1), b.narrow(dim, 0, b.shape[dim] - 1)], dim)
    right = torch.cat([a.narrow(dim, 1, a.shape[dim] - 1), b.narrow(dim, b.shape[dim] - 1, 1)],
                      dim)
    return (a * 0.75 + b * 0.75) + (left * 0.25 + right * 0.25)


def nca_bwd_adjoint_reference(gp: torch.Tensor, gx: torch.Tensor,
                              gtap: Optional[torch.Tensor] = None,
                              multiscale: bool = False) -> torch.Tensor:
    """``nca_bwd_adjoint``'s function in plain PyTorch: shifted-slice sums in
    the JAX term order; for scales (0, 1) the transpose of
    ``fused_step.multiscale_percept`` as the kernel forms it,
    gx + (gx0 + 0.25 g_h[parent]) * 0.5 with gx0 the scale-0 adjoint of gp
    and g_h the half-resolution stencil adjoint of U^T gp (over W, then
    H)."""
    c = gx.shape[1]
    if multiscale:
        g_h = _stencil_adjoint(upsample2_adjoint(upsample2_adjoint(gp, -1), -2), c)
        up = g_h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        out = gx + (_stencil_adjoint(gp, c) + up * 0.25) * 0.5
    else:
        out = gx + _stencil_adjoint(gp, c)
    return out if gtap is None else out + gtap


# ------------------------------------------------------------ kernel plumbing


def _count(name: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES[name] += 1


def _check_even(x: torch.Tensor, multiscale: bool) -> None:
    if multiscale and (x.shape[-2] % 2 or x.shape[-1] % 2):
        raise ValueError(f"perception_scales (0, 1) needs even H and W, got "
                         f"{tuple(x.shape[-2:])}")


def n_blocks(b: int, h: int, w: int) -> int:
    """Blocks of one ``nca_bwd_mlp(_ms)`` or ``nca_bwd_adjoint_ms`` launch:
    ceil(W/16) x ceil(H/16) x B (``adjoint_geometry`` gives the scales-(0,)
    adjoint's)."""
    return -(-w // TILE) * -(-h // TILE) * b


def _zero_slots(b, c, h, w, packed) -> torch.Tensor:
    """The per-block weight-gradient partials [n_blocks, S]: S floats per
    block, dW1 [P, F4] | db1 [F4] | dW2 [F4, C] | db2 [C]."""
    p, f4 = packed[0].shape
    return torch.zeros((n_blocks(b, h, w), p * f4 + f4 + f4 * c + c),
                       device=packed[0].device)


def _split_slots(slots: torch.Tensor, packed, c: int):
    """Sum the blocks' partials (once per call) and cut the sum into
    (dW1 [P, F4], db1 [F4], dW2 [F4, C], db2 [C])."""
    p, f4 = packed[0].shape
    total = slots.sum(dim=0)
    dw1, db1, dw2, db2 = torch.split(total, [p * f4, f4, f4 * c, c])
    return dw1.reshape(p, f4), db1, dw2.reshape(f4, c), db2


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch_mlp(x, cond, gx, gp, dcond, slots, packed, compute_dtype, seed, step, thr,
                multiscale=False):
    w1, b1, w2, _ = packed
    b, c, h, w = x.shape
    cc = cond.shape[1] if cond is not None else 0
    name = "nca_bwd_mlp_ms" if multiscale else "nca_bwd_mlp"
    with torch.cuda.device(x.device):
        err = _lib().nca_bwd_mlp_launch(
            _ptr(x), _ptr(cond), _ptr(gx), _ptr(gp), _ptr(dcond), _ptr(slots),
            _ptr(w1), _ptr(b1), _ptr(w2), b, c, h, w, cc, w1.shape[1],
            int(compute_dtype == "bfloat16"), int(multiscale), seed & 0xFFFFFFFF, step,
            thr, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)


def _launch_adjoint(gp, gx, gtap=None, multiscale=False):
    b, c, h, w = gx.shape
    name = "nca_bwd_adjoint_ms" if multiscale else "nca_bwd_adjoint"
    with torch.cuda.device(gx.device):
        err = _lib().nca_bwd_adjoint_launch(_ptr(gp), _ptr(gx), _ptr(gtap), b, c, h, w,
                                            int(multiscale), _stream(gx.device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)


def _lib() -> ctypes.CDLL:
    lib = _build.load("nca_train")
    if lib.nca_bwd_mlp_launch.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.nca_bwd_mlp_launch.argtypes = [ptr] * 9 + [i32] * 8 + [u32] * 3 + [ptr]
        lib.nca_bwd_mlp_launch.restype = ctypes.c_int
        lib.nca_bwd_adjoint_launch.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        lib.nca_bwd_adjoint_launch.restype = ctypes.c_int
        lib.nca_train_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.nca_train_limits.restype = ctypes.c_int
        lib.nca_bwd_adjoint_ms_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.nca_bwd_adjoint_ms_occupancy.restype = ctypes.c_int
        lib.nca_bwd_adjoint_geometry.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.nca_bwd_adjoint_geometry.restype = ctypes.c_int
    return lib


def adjoint_ms_occupancy() -> Tuple[int, int]:
    """(blocks an SM, dynamic shared-memory bytes) of ``nca_bwd_adjoint_ms``
    (the same at every width), from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = _lib().nca_bwd_adjoint_ms_occupancy(ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"nca_bwd_adjoint_ms_occupancy failed: CUDA error {err}")
    return blocks.value, smem.value


def adjoint_geometry(b: int, c: int, h: int, w: int) -> Tuple[int, int, int]:
    """(blocks of the launch, blocks an SM, dynamic shared-memory bytes) of
    the scales-(0,) ``nca_bwd_adjoint`` at [b, c, h, w], from the built
    library (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().nca_bwd_adjoint_geometry(b, c, h, w, ctypes.byref(n), ctypes.byref(blocks),
                                          ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"nca_bwd_adjoint_geometry failed: CUDA error {err}")
    return n.value, blocks.value, smem.value


def train_kernel_limits() -> Tuple[int, int, int]:
    """The largest (C, c_cond, fc_dim) the backward kernels take, read from
    the built library; ``C_MAX``, ``CC_MAX``, ``F_MAX`` state the same."""
    vals = [ctypes.c_int() for _ in range(3)]
    _lib().nca_train_limits(*[ctypes.byref(v) for v in vals])
    return tuple(v.value for v in vals)
