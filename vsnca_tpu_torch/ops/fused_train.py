"""The differentiable training rollout: N DyNCA steps on NCHW state whose
forward runs the inference kernel ``csrc/nca_step.cu`` and whose backward
runs the two kernels of ``csrc/nca_train.cu``, with the plain PyTorch
version of each beside it.

Counterpart of ``vsnca_tpu/ops/pallas_train.py::fused_rollout_train_flat``
(:2535) and its custom VJP ``fused_rollout_train_flat_hw`` (:2403):

- forward (``_make_fwd_kernel_flat`` :942): one ``nca_step`` launch a step,
  each step's input state written into a checkpoint buffer
  [n_steps, B, C, H, W] — the TPU's segment 1, with no recompute. The masks
  are the hash of (seed, batch, step, pixel) (``fused_step.mask_bits``), so
  the backward regenerates them exactly;
- backward (``_make_bwd_kernel_flat`` :1139, ``_make_bwd_kernel_flat_scatter``
  :1657 and ``_make_bwd_kernel_flat_tiled`` :1301 at scales (0,)): two
  launches a step, steps in reverse — ``nca_bwd_mlp`` (MLP cotangents,
  perception cotangent gp, per-block weight-gradient partials, dcond) and
  ``nca_bwd_adjoint`` (gx += the flipped-stencil adjoint of gp). The
  wrapper sums the per-block partials once per call.

Scope (``fused_train_supported``): circular padding and perception_scales
(0,), as the TPU pair; its ``W % 128`` rule and VMEM plans are TPU layout
and do not apply. ``fused_rollout_train`` launches the kernels for CUDA
tensors and runs the plain versions only for CPU tensors; there is no
fallback. ``LAUNCHES`` counts every launch the pair makes, and
``KERNEL_LAUNCHES`` splits it by kernel (the forward's ``nca_step``
launches also count in ``fused_step.LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.ops import _build
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops.filters import LAPLACIAN, SOBEL_X, SOBEL_Y
from vsnca_tpu_torch.ops.perception import perceive, stencil_3x3

LAUNCHES = 0
KERNEL_LAUNCHES: Dict[str, int] = {"nca_step": 0, "nca_bwd_mlp": 0, "nca_bwd_adjoint": 0}

# NCA_C_MAX, NCA_CC_MAX, NCA_F_MAX of csrc/nca_common.cuh (the card tests
# check them against the built library): enough for every preset.
C_MAX, CC_MAX, F_MAX = 16, 4, 128
TILE = 16  # NCA_TILE: the kernels' blocks are TILE x TILE pixels


def _flip(k: np.ndarray) -> np.ndarray:
    """180-degree rotation: the adjoint of a correlation is the correlation
    with the flipped filter (pallas_train.py::_flip :68)."""
    return np.ascontiguousarray(k[::-1, ::-1])


SOBEL_X_F, SOBEL_Y_F, LAPLACIAN_F = _flip(SOBEL_X), _flip(SOBEL_Y), _flip(LAPLACIAN)


def fused_train_supported(cfg: NCAConfig, n_steps: int) -> bool:
    """True when the training pair applies — the port's rule for
    ``fused_train_flat_supported`` (pallas_train.py:2014): circular padding,
    perception_scales (0,) (the multiscale pair is not ported), at least one
    step, and the kernels' size limits. Any H and W."""
    return (
        cfg.padding_mode == "circular"
        and tuple(cfg.perception_scales) == (0,)
        and n_steps >= 1
        and cfg.c_in <= C_MAX
        and cfg.c_cond <= CC_MAX
        and cfg.fc_dim <= F_MAX
    )


@dataclasses.dataclass(frozen=True)
class _Spec:
    seed: int
    n_steps: int
    update_rate: float
    compute_dtype: str
    cond_no_grad: bool

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
) -> torch.Tensor:
    """``n_steps`` NCA steps, x [B, C, H, W] float32 → final state, with
    gradients to ``params`` (w1, b1, w2, b2), ``x`` and ``cond``
    ([B, c_cond, H, W] or None; no gradient when ``cond_no_grad``, the
    trainer's case). ``seed`` keys the masks as in
    ``fused_step.fused_rollout_chw``, whose function the forward is."""
    fs._check(params, x, cfg, cond, compute_dtype)
    if not fused_train_supported(cfg, n_steps):
        raise ValueError(
            "the training pair takes circular padding, perception_scales (0,), "
            f"n_steps >= 1, C <= {C_MAX}, c_cond <= {CC_MAX}, fc_dim <= {F_MAX}"
        )
    if x.device.type != "cpu":
        fs.check_card_inputs(x, (cond,), limits=train_kernel_limits(),
                             fc_dim=cfg.fc_dim)
    rate = cfg.update_rate if update_rate is None else update_rate
    spec = _Spec(seed, n_steps, rate, compute_dtype, cond_no_grad)
    return _TrainRollout.apply(params["w1"], params["b1"], params["w2"], params["b2"],
                               x, cond, spec)


class _TrainRollout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1, b1, w2, b2, x, cond, spec: _Spec):
        cc = cond.shape[1] if cond is not None else 0
        packed = fs.pack_weights({"w1": w1, "b1": b1, "w2": w2, "b2": b2},
                                 x.shape[1], cc, spec.compute_dtype)
        run = _forward_card if x.device.type == "cuda" else _forward_reference
        y, ckpt = run(packed, x, cond, spec)
        ctx.spec = spec
        ctx.w1_shape = w1.shape
        ctx.save_for_backward(*packed, ckpt, cond)
        return y

    @staticmethod
    def backward(ctx, gy):
        w1, b1, w2, b2, ckpt, cond = ctx.saved_tensors
        spec = ctx.spec
        need_dcond = cond is not None and ctx.needs_input_grad[5] and not spec.cond_no_grad
        run = _backward_card if gy.device.type == "cuda" else _backward_reference
        dw1, db1, dw2, db2, dx0, dcond = run(
            (w1, b1, w2, b2), ckpt, cond, gy.contiguous(), spec, need_dcond
        )
        p, f = ctx.w1_shape
        # the conditioning rows of W1 get no gradient from a call without cond
        dw1 = F.pad(dw1[:, :f], (0, 0, 0, p - dw1.shape[0]))
        return dw1, db1[:f], dw2[:f], db2, dx0, dcond, None


# ------------------------------------------------------------------ forward


def _forward_card(packed, x, cond, spec: _Spec):
    n = spec.n_steps
    ckpt = torch.empty((n,) + tuple(x.shape), device=x.device)
    ckpt[0].copy_(x)
    y = torch.empty_like(x)
    for s in range(n):
        dst = ckpt[s + 1] if s + 1 < n else y
        fs.launch_step(ckpt[s], dst, cond, packed, "circular", spec.compute_dtype,
                       spec.seed, s, spec.thr)
        _count("nca_step")
    return y, ckpt


def _forward_reference(packed, x, cond, spec: _Spec):
    states = []
    for s in range(spec.n_steps):
        states.append(x)
        x = fs.reference_step(x, cond, packed, "circular", spec.compute_dtype,
                              spec.seed, s, spec.update_rate)
    return x, torch.stack(states)


# ----------------------------------------------------------------- backward


def _backward_card(packed, ckpt, cond, gy, spec: _Spec, need_dcond: bool):
    n, b, c, h, w = ckpt.shape
    gx = gy.clone()
    gp = torch.empty((b, 4 * c, h, w), device=gy.device)
    dcond = torch.zeros_like(cond) if need_dcond else None
    slots = _zero_slots(b, c, h, w, packed)
    for s in reversed(range(n)):
        _launch_mlp(ckpt[s], cond, gx, gp, dcond, slots, packed, spec.compute_dtype,
                    spec.seed, s, spec.thr)
        _launch_adjoint(gp, gx)
    return (*_split_slots(slots, packed, c), gx, dcond)


def _backward_reference(packed, ckpt, cond, gy, spec: _Spec, need_dcond: bool):
    gx = gy
    dcond = torch.zeros_like(cond) if need_dcond else None
    sums = None
    for s in reversed(range(spec.n_steps)):
        gp, dc, *dparams = nca_bwd_mlp_reference(
            packed, ckpt[s], cond, gx, spec.seed, s, spec.update_rate,
            spec.compute_dtype, need_dcond,
        )
        sums = dparams if sums is None else [a + d for a, d in zip(sums, dparams)]
        if need_dcond:
            dcond = dcond + dc
        gx = nca_bwd_adjoint_reference(gp, gx)
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
):
    """The whole pair in plain PyTorch as explicit steps: the forward, then
    the reverse walk with ``nca_bwd_mlp_reference`` and
    ``nca_bwd_adjoint_reference`` for cotangent ``gy`` of the final state.
    Returns (state, {w1, b1, w2, b2: gradient}, dx0, dcond or None)."""
    fs._check(params, x, cfg, cond, compute_dtype)
    rate = cfg.update_rate if update_rate is None else update_rate
    spec = _Spec(seed, n_steps, rate, compute_dtype, not need_dcond)
    cc = cond.shape[1] if cond is not None else 0
    packed = fs.pack_weights(params, x.shape[1], cc, compute_dtype)
    y, ckpt = _forward_reference(packed, x, cond, spec)
    dw1, db1, dw2, db2, dx0, dcond = _backward_reference(packed, ckpt, cond, gy,
                                                         spec, need_dcond)
    p, f = params["w1"].shape
    grads = {"w1": F.pad(dw1[:, :f], (0, 0, 0, p - dw1.shape[0])), "b1": db1[:f],
             "w2": dw2[:f], "b2": db2}
    return y, grads, dx0, dcond


# ------------------------------------------------- the two backward kernels


def nca_bwd_mlp(packed, x, cond, gx, seed: int, step: int, update_rate: float,
                compute_dtype: str = "float32", need_dcond: bool = False):
    """The first backward pass of one step (absolute step ``step``): x the
    step's input state and gx the cotangent of its output, [B, C, H, W];
    ``packed`` from ``fused_step.pack_weights``. Returns (gp [B, 4C, H, W],
    dcond [B, cc, H, W] or None, dW1 [4C + cc, F4], db1 [F4], dW2 [F4, C],
    db2 [C]) — this step's contributions. One ``nca_bwd_mlp`` launch for CUDA
    tensors; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return nca_bwd_mlp_reference(packed, x, cond, gx, seed, step, update_rate,
                                     compute_dtype, need_dcond)
    b, c, h, w = x.shape
    fs.check_card_inputs(x, (cond,), (gx,), packed)
    gp = torch.empty((b, 4 * c, h, w), device=x.device)
    dcond = torch.zeros_like(cond) if need_dcond else None
    slots = _zero_slots(b, c, h, w, packed)
    _launch_mlp(x, cond, gx, gp, dcond, slots, packed, compute_dtype, seed, step,
                fs.uniform_threshold(update_rate))
    return (gp, dcond, *_split_slots(slots, packed, c))


def nca_bwd_mlp_reference(packed, x, cond, gx, seed: int, step: int,
                          update_rate: float, compute_dtype: str = "float32",
                          need_dcond: bool = False):
    """``nca_bwd_mlp``'s function in plain PyTorch (float32 products, TF32
    off; bf16 rounding of the percept, hid, gdx and gz1 as the kernel)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w1, b1, w2, _ = packed
    c = x.shape[1]
    rnd = fs.rounder(compute_dtype)
    p = perceive(x, "circular")
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


def nca_bwd_adjoint(gp: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """The second backward pass of one step: gx + gp[:, :C] + the adjoint
    Sobel-x, Sobel-y and Laplacian stencils of gp[:, C:4C] (flipped filters,
    circular). One ``nca_bwd_adjoint`` launch, on a copy of gx, for CUDA
    tensors; the plain version for CPU tensors."""
    if gx.device.type == "cpu":
        return nca_bwd_adjoint_reference(gp, gx)
    fs.check_card_inputs(gx, (gp,))
    if gp.shape[1] != 4 * gx.shape[1]:
        raise ValueError(f"gp must have 4C = {4 * gx.shape[1]} channels, got {gp.shape[1]}")
    out = gx.clone()
    _launch_adjoint(gp, out)
    return out


def nca_bwd_adjoint_reference(gp: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """``nca_bwd_adjoint``'s function in plain PyTorch: shifted-slice sums in
    the JAX term order (pallas_train.py:1274-1280)."""
    c = gx.shape[1]
    sx, = stencil_3x3(gp[:, c:2 * c], [SOBEL_X_F], "circular")
    sy, = stencil_3x3(gp[:, 2 * c:3 * c], [SOBEL_Y_F], "circular")
    lap, = stencil_3x3(gp[:, 3 * c:], [LAPLACIAN_F], "circular")
    return gx + (gp[:, :c] + sx + sy + lap)


# ------------------------------------------------------------ kernel plumbing


def _count(name: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES[name] += 1


def n_blocks(b: int, h: int, w: int) -> int:
    """Blocks of one backward launch: ceil(W/16) x ceil(H/16) x B."""
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


def _launch_mlp(x, cond, gx, gp, dcond, slots, packed, compute_dtype, seed, step, thr):
    w1, b1, w2, _ = packed
    b, c, h, w = x.shape
    cc = cond.shape[1] if cond is not None else 0
    with torch.cuda.device(x.device):
        err = _lib().nca_bwd_mlp_launch(
            _ptr(x), _ptr(cond), _ptr(gx), _ptr(gp), _ptr(dcond), _ptr(slots),
            _ptr(w1), _ptr(b1), _ptr(w2), b, c, h, w, cc, w1.shape[1],
            int(compute_dtype == "bfloat16"), seed & 0xFFFFFFFF, step, thr,
            _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"nca_bwd_mlp launch failed: CUDA error {err}")
    _count("nca_bwd_mlp")


def _launch_adjoint(gp, gx):
    b, c, h, w = gx.shape
    with torch.cuda.device(gx.device):
        err = _lib().nca_bwd_adjoint_launch(_ptr(gp), _ptr(gx), b, c, h, w,
                                            _stream(gx.device))
    if err != 0:
        raise RuntimeError(f"nca_bwd_adjoint launch failed: CUDA error {err}")
    _count("nca_bwd_adjoint")


def _lib() -> ctypes.CDLL:
    lib = _build.load("nca_train")
    if lib.nca_bwd_mlp_launch.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.nca_bwd_mlp_launch.argtypes = [ptr] * 9 + [i32] * 7 + [u32] * 3 + [ptr]
        lib.nca_bwd_mlp_launch.restype = ctypes.c_int
        lib.nca_bwd_adjoint_launch.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
        lib.nca_bwd_adjoint_launch.restype = ctypes.c_int
        lib.nca_train_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.nca_train_limits.restype = ctypes.c_int
    return lib


def train_kernel_limits() -> Tuple[int, int, int]:
    """The largest (C, c_cond, fc_dim) the backward kernels take, read from
    the built library; ``C_MAX``, ``CC_MAX``, ``F_MAX`` state the same."""
    vals = [ctypes.c_int() for _ in range(3)]
    _lib().nca_train_limits(*[ctypes.byref(v) for v in vals])
    return tuple(v.value for v in vals)
