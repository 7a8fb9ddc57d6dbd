"""The ConditionedNCA (encoder-conditioned) rollout and its differentiable
training pair, through the CUDA kernels of ``csrc/nca_cnca.cu``, with the
plain PyTorch version of each beside it.

Counterpart of ``vsnca_tpu/ops/pallas_cnca.py``:

- ``fused_cnca_rollout`` (:211, ``_make_cnca_kernel`` :47): N steps on NCHW
  state with a precomputed goal encoding; two launches a step —
  ``cnca_update`` (alive pre-mask, x + goal·pre, the learnable depthwise
  3x3 percept, the three-layer MLP, the per-pixel fire mask: the updated
  state before its life gate) and ``cnca_gate`` (pre ∧ post alive, the
  clamp). The gate is a launch of its own because the post-alive pool reads
  the updated alpha of each pixel's neighbours (``csrc/nca_cnca.cu`` says
  why).
- ``fused_cnca_train`` (:754, ``_make_cnca_fwd_train_kernel`` :350 and
  ``_make_cnca_bwd_train_kernel`` :434): a ``torch.autograd.Function``
  whose forward runs the same two kernels a step, writing every step's
  input state into a trace [n_steps, B, C, H, W] and its life mask into
  [n_steps, B, H, W] bytes, and whose backward walks the steps in reverse
  with ``cnca_bwd_mlp`` (recompute the step at each pixel; the adjoints of
  clamp, life gate, mask and the three layers; per-block weight-gradient
  partials) and ``cnca_bwd_adjoint`` (the 27-tap depthwise adjoint into
  the state cotangent and the goal cotangent).

Parameters are the port's flat ConditionedNCA dict
(``models.conditioned_nca``): ``perception_w`` [C, 3, 3, 3],
``update1.w`` [3C, D] with rows in torch grouped-conv order c*3 + s,
``update1.b`` [D], ``update2.w`` [D, D], ``update2.b`` [D], ``update3.w``
[D, C]. The kernels keep that row order (no permutation: the TPU kernel's
slot-major fold, ``_fold_weights`` :183, is a TPU layout). Masks are the
port's hash of (seed, batch, step, pixel) (``fused_step.mask_bits``): the
kernels and the plain versions draw the same ones, and the backward
replays them. ``compute_dtype="bfloat16"`` rounds where the TPU kernels
cast: the percept and both hidden activations (pallas_cnca.py:129, 136,
141) and, in the backward, g_dx, g_h2 and g_h1 (:520, :529, :538), with
W1..W3 rounded by the packing.

A wrapper launches its kernels for CUDA tensors and runs the plain version
only for CPU tensors; there is no fallback. ``LAUNCHES`` counts every launch
of the four kernels and ``KERNEL_LAUNCHES`` splits it by kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.ops import _build
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops.conv import alive_pool, depthwise_perceive

LAUNCHES = 0
KERNEL_LAUNCHES: Dict[str, int] = {
    "cnca_update": 0, "cnca_gate": 0, "cnca_bwd_mlp": 0, "cnca_bwd_adjoint": 0,
}

# CNCA_C_MAX and CNCA_D_MAX of csrc/nca_cnca.cu (the card tests check them
# against the built library): the reference's 20 channels and 64 hidden
# units, with room for 24 channels.
C_MAX, D_MAX = 24, 64
MLP_TILE = (16, 8)  # cnca_update's and cnca_bwd_mlp's blocks are 16 x 8 pixels
WEIGHT_KEYS = ("perception_w", "update1.w", "update1.b", "update2.w", "update2.b",
               "update3.w")


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def check_supported(cfg: ConditionedNCAConfig, n_steps: int = 1) -> None:
    """Raise ValueError unless the kernels compute this config: at least one
    step, C <= C_MAX, D <= D_MAX and, with the living channel, a positive
    threshold (the alive pools fill the edge with zeros, which equals the
    reference's -inf padding only when the threshold is above 0 — the TPU
    kernel asserts the same, pallas_cnca.py:56)."""
    if n_steps < 1:
        raise ValueError("the cnca kernels take n_steps >= 1")
    if cfg.num_channels > C_MAX or cfg.update_hidden_dim > D_MAX:
        raise ValueError(f"cnca kernel limits: C <= {C_MAX}, D <= {D_MAX}")
    if cfg.use_living_channel and cfg.alpha_living_threshold <= 0:
        raise ValueError("the zero-filled alive pool needs alpha_living_threshold > 0")


def pack_weights(params: dict, cfg: ConditionedNCAConfig, compute_dtype: str
                 ) -> Tuple[torch.Tensor, ...]:
    """(wcol [C, 27], w1 [3C, D4], b1 [D4], w2 [D4, D4], b2 [D4], w3 [D4, C4]),
    float32 and contiguous. wcol is ``perception_w`` with the 27 weights of
    channel c in (slot, kh, kw) order; D and C are padded to multiples of 4
    with zero units (exact no-ops: relu(0) = 0). bf16 mode rounds W1..W3 to
    bfloat16 (held as float32), as ``_fold_weights`` casts them; wcol and the
    biases stay float32."""
    c, d = cfg.num_channels, cfg.update_hidden_dim
    d4, c4 = _round4(d), _round4(c)
    rnd = fs.rounder(compute_dtype)
    w1 = rnd(params["update1.w"].detach().float())
    w2 = rnd(params["update2.w"].detach().float())
    w3 = rnd(params["update3.w"].detach().float())
    return (
        params["perception_w"].detach().float().reshape(c, 27).contiguous(),
        F.pad(w1, (0, d4 - d)).contiguous(),
        F.pad(params["update1.b"].detach().float(), (0, d4 - d)).contiguous(),
        F.pad(w2, (0, d4 - d, 0, d4 - d)).contiguous(),
        F.pad(params["update2.b"].detach().float(), (0, d4 - d)).contiguous(),
        F.pad(w3, (0, c4 - c, 0, d4 - d)).contiguous(),
    )


def _check(params, x, goal, cfg, compute_dtype):
    if compute_dtype not in fs.COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {fs.COMPUTE_DTYPES}")
    c = cfg.num_channels
    if x.dim() != 4 or x.shape[1] != c or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [B, {c}, H, W], got {x.dtype} {tuple(x.shape)}")
    if goal.shape != x.shape or goal.dtype != torch.float32 or goal.device != x.device:
        raise ValueError(f"goal must be float32 {tuple(x.shape)} on {x.device}")
    for k in WEIGHT_KEYS:
        if params[k].device != x.device:
            raise ValueError(f"params[{k!r}] is on {params[k].device}, x on {x.device}")


# ------------------------------------------------------------ plain versions


def _alive(x: torch.Tensor, cfg: ConditionedNCAConfig) -> torch.Tensor:
    """The alive mask of a state, float 0/1 [B, 1, H, W] (ones without the
    living channel)."""
    if not cfg.use_living_channel:
        return torch.ones_like(x[:, :1])
    a = cfg.alive_channel
    return alive_pool(x[:, a : a + 1], cfg.alpha_living_threshold).float()


def cnca_update_reference(x, goal, packed, cfg: ConditionedNCAConfig, compute_dtype: str,
                          seed: int, step: int, fire_rate: float) -> torch.Tensor:
    """``cnca_update``'s function in plain PyTorch: the updated state before
    the life gate, x + dx·mask (float32 products, TF32 off; bf16 rounding at
    the kernel's places)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wcol, w1, b1, w2, b2, w3 = packed
    c = cfg.num_channels
    rnd = fs.rounder(compute_dtype)
    xg = x + goal * _alive(x, cfg)
    p = rnd(depthwise_perceive(xg, wcol.reshape(c, 3, 3, 3)))
    h1 = rnd(torch.relu(torch.einsum("bkhw,kf->bfhw", p, w1) + b1[:, None, None]))
    h2 = rnd(torch.relu(torch.einsum("bfhw,fe->behw", h1, w2) + b2[:, None, None]))
    dx = torch.einsum("behw,ec->bchw", h2, w3[:, :c])
    return x + dx * fs.batch_mask(seed, step, x.shape, fire_rate, x.device)


def cnca_gate_reference(x, xn, cfg: ConditionedNCAConfig):
    """``cnca_gate``'s function in plain PyTorch: (clamp(xn · life), life
    [B, H, W] uint8 or None) with life = alive(x) ∧ alive(xn)."""
    life = None
    if cfg.use_living_channel:
        lf = _alive(x, cfg) * _alive(xn, cfg)
        xn = xn * lf
        life = lf[:, 0].to(torch.uint8)
    return torch.clamp(xn, -cfg.clamp_value, cfg.clamp_value), life


def cnca_step_reference(x, goal, packed, cfg, compute_dtype, seed, step, fire_rate):
    """One whole step in plain PyTorch: (new state, life mask or None)."""
    xn = cnca_update_reference(x, goal, packed, cfg, compute_dtype, seed, step, fire_rate)
    return cnca_gate_reference(x, xn, cfg)


def fused_cnca_rollout_reference(params, x, goal, seed: int, cfg: ConditionedNCAConfig,
                                 n_steps: int, compute_dtype: str = "float32") -> torch.Tensor:
    """The rollout kernels' function in plain PyTorch, on any device."""
    _check(params, x, goal, cfg, compute_dtype)
    packed = pack_weights(params, cfg, compute_dtype)
    with torch.no_grad():
        for step in range(n_steps):
            x, _ = cnca_step_reference(x, goal, packed, cfg, compute_dtype, seed, step,
                                       cfg.cell_fire_rate)
    return x


def cnca_bwd_mlp_reference(packed, x, goal, life, g, cfg: ConditionedNCAConfig,
                           compute_dtype: str, seed: int, step: int, fire_rate: float):
    """``cnca_bwd_mlp``'s function in plain PyTorch for one step (absolute
    step ``step``): x the step's input, ``life`` its life mask (uint8
    [B, H, W] or None), g the cotangent of its output. Returns (g_xn, the
    cotangent of the updated state through clamp and life gate; gp
    [B, 3C, H, W], the percept's cotangent; [dwcol [C, 27], dW1 [3C, D4],
    db1 [D4], dW2 [D4, D4], db2 [D4], dW3 [D4, C]], this step's weight
    gradients)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wcol, w1, b1, w2, b2, w3 = packed
    b, c, h, w = x.shape
    rnd = fs.rounder(compute_dtype)
    xg = x + goal * _alive(x, cfg)
    p = rnd(depthwise_perceive(xg, wcol.reshape(c, 3, 3, 3)))
    h1 = torch.relu(torch.einsum("bkhw,kf->bfhw", p, w1) + b1[:, None, None])
    h2 = torch.relu(torch.einsum("bfhw,fe->behw", rnd(h1), w2) + b2[:, None, None])
    w3c = w3[:, :c]
    dx = torch.einsum("behw,ec->bchw", rnd(h2), w3c)
    m = fs.batch_mask(seed, step, x.shape, fire_rate, x.device)
    xn = x + dx * m
    lf = torch.ones_like(m) if life is None else life[:, None].float()
    xl = xn * lf
    in_range = ((xl >= -cfg.clamp_value) & (xl <= cfg.clamp_value)).float()
    g_xn = g * in_range * lf
    gdx = rnd(g_xn * m)
    gh2 = rnd(torch.where(h2 > 0, torch.einsum("bchw,ec->behw", gdx, w3c),
                          torch.zeros_like(h2)))
    gh1 = rnd(torch.where(h1 > 0, torch.einsum("behw,fe->bfhw", gh2, w2),
                          torch.zeros_like(h1)))
    gp = torch.einsum("bfhw,kf->bkhw", gh1, w1).contiguous()
    xgp = F.pad(xg, (1, 1, 1, 1))
    gps = gp.reshape(b, c, 3, h, w)
    dwcol = torch.stack([
        (xgp[:, :, di : di + h, dj : dj + w] * gps[:, :, s]).sum(dim=(0, 2, 3))
        for s in range(3) for di in range(3) for dj in range(3)
    ], dim=1)
    grads = [
        dwcol,
        torch.einsum("bkhw,bfhw->kf", p, gh1),
        gh1.sum(dim=(0, 2, 3)),
        torch.einsum("bfhw,behw->fe", rnd(h1), gh2),
        gh2.sum(dim=(0, 2, 3)),
        torch.einsum("behw,bchw->ec", rnd(h2), gdx),
    ]
    return g_xn, gp, grads


def cnca_bwd_adjoint_reference(x, gp, g_xn, wcol, cfg: ConditionedNCAConfig):
    """``cnca_bwd_adjoint``'s function in plain PyTorch: g_xg, the adjoint of
    the depthwise percept (zero padding; the 27 terms summed in (slot, kh,
    kw) order), and returns (g_xn + g_xg, the cotangent of the step's input
    state; g_xg·pre, this step's goal cotangent)."""
    b, c, h, w = x.shape
    gps = F.pad(gp, (1, 1, 1, 1)).reshape(b, c, 3, h + 2, w + 2)
    acc = None
    for k in range(27):
        s, t = divmod(k, 9)
        di, dj = divmod(t, 3)
        term = gps[:, :, s, 2 - di : 2 - di + h, 2 - dj : 2 - dj + w] * wcol[None, :, k, None, None]
        acc = term if acc is None else acc + term
    return g_xn + acc, acc * _alive(x, cfg)


@dataclasses.dataclass(frozen=True)
class _Spec:
    cfg: ConditionedNCAConfig
    seed: int
    n_steps: int
    compute_dtype: str

    @property
    def fire_rate(self) -> float:
        return self.cfg.cell_fire_rate

    @property
    def thr(self) -> int:
        return fs.uniform_threshold(self.fire_rate)


def _forward_reference(packed, x, goal, spec: _Spec):
    states, lives = [], []
    for s in range(spec.n_steps):
        states.append(x)
        x, life = cnca_step_reference(x, goal, packed, spec.cfg, spec.compute_dtype,
                                      spec.seed, s, spec.fire_rate)
        lives.append(life)
    return x, torch.stack(states), (torch.stack(lives) if spec.cfg.use_living_channel
                                    else None)


def _backward_reference(packed, trace, life, goal, gy, spec: _Spec):
    g = gy
    dgoal = torch.zeros_like(goal)
    sums = None
    for s in reversed(range(spec.n_steps)):
        g_xn, gp, grads = cnca_bwd_mlp_reference(
            packed, trace[s], goal, None if life is None else life[s], g, spec.cfg,
            spec.compute_dtype, spec.seed, s, spec.fire_rate)
        sums = grads if sums is None else [a + d for a, d in zip(sums, grads)]
        g, dg = cnca_bwd_adjoint_reference(trace[s], gp, g_xn, packed[0], spec.cfg)
        dgoal = dgoal + dg
    return sums, g, dgoal


def _unpack_grads(sums, cfg: ConditionedNCAConfig):
    """Kernel-layout sums → gradients in the params' shapes (the padding
    units cut off), keyed as ``WEIGHT_KEYS``."""
    c, d = cfg.num_channels, cfg.update_hidden_dim
    dwcol, dw1, db1, dw2, db2, dw3 = sums
    return {
        "perception_w": dwcol.reshape(c, 3, 3, 3),
        "update1.w": dw1[:, :d], "update1.b": db1[:d],
        "update2.w": dw2[:d, :d], "update2.b": db2[:d],
        "update3.w": dw3[:d, :c],
    }


def fused_cnca_train_reference(params, x, goal, seed: int, cfg: ConditionedNCAConfig,
                               n_steps: int, gy: torch.Tensor,
                               compute_dtype: str = "float32"):
    """The whole pair in plain PyTorch as explicit steps: the forward, then
    the reverse walk for cotangent ``gy`` of the final state. Returns
    (state, {WEIGHT_KEYS: gradient}, dx0, dgoal)."""
    _check(params, x, goal, cfg, compute_dtype)
    check_supported(cfg, n_steps)
    spec = _Spec(cfg, seed, n_steps, compute_dtype)
    packed = pack_weights(params, cfg, compute_dtype)
    with torch.no_grad():
        y, trace, life = _forward_reference(packed, x, goal, spec)
        sums, dx0, dgoal = _backward_reference(packed, trace, life, goal, gy, spec)
    return y, _unpack_grads(sums, cfg), dx0, dgoal


# ---------------------------------------------------------------- wrappers


def fused_cnca_rollout(params, x, goal, seed: int, cfg: ConditionedNCAConfig, n_steps: int,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """``n_steps`` ConditionedNCA steps: x [B, C, H, W] float32 with its
    goal encoding ``goal`` (same shape, ``encode_goal``) → the new state,
    without gradients (``fused_cnca_train`` is the differentiable pair).
    ``seed`` keys the fire masks. On a CUDA tensor two launches a step,
    ping-ponging between new buffers (``x`` is never written); on a CPU
    tensor the plain version."""
    _check(params, x, goal, cfg, compute_dtype)
    check_supported(cfg, n_steps)
    if x.device.type == "cpu":
        return fused_cnca_rollout_reference(params, x, goal, seed, cfg, n_steps,
                                            compute_dtype)
    fs.check_card_inputs(x, exact=(goal,))
    packed = pack_weights(params, cfg, compute_dtype)
    tmp = torch.empty_like(x)
    bufs = [torch.empty_like(x) for _ in range(min(n_steps, 2))]
    src = x
    for step in range(n_steps):
        dst = bufs[step % 2]
        launch_update(src, goal, tmp, packed, cfg, compute_dtype, seed, step,
                      fs.uniform_threshold(cfg.cell_fire_rate))
        launch_gate(src, tmp, dst, None, cfg)
        src = dst
    return src


def fused_cnca_train(params, x, goal, seed: int, cfg: ConditionedNCAConfig, n_steps: int,
                     compute_dtype: str = "float32") -> torch.Tensor:
    """``n_steps`` ConditionedNCA steps with gradients to the update
    weights (``WEIGHT_KEYS`` of ``params``), ``x`` and ``goal``; the
    encoder's gradients arrive through autograd of whatever made ``goal``.
    Masks and alive gates are constants of the backward and the clamp passes
    the gradient on [-clamp, clamp] inclusive (the reference's semantics).
    The kernels on a CUDA tensor, the plain versions on a CPU tensor."""
    _check(params, x, goal, cfg, compute_dtype)
    check_supported(cfg, n_steps)
    if x.device.type != "cpu":
        fs.check_card_inputs(x, exact=(goal,))
    spec = _Spec(cfg, seed, n_steps, compute_dtype)
    return _CncaTrain.apply(*(params[k] for k in WEIGHT_KEYS), x, goal, spec)


class _CncaTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pw, w1, b1, w2, b2, w3, x, goal, spec: _Spec):
        params = dict(zip(WEIGHT_KEYS, (pw, w1, b1, w2, b2, w3)))
        packed = pack_weights(params, spec.cfg, spec.compute_dtype)
        run = _forward_card if x.device.type == "cuda" else _forward_reference
        y, trace, life = run(packed, x, goal, spec)
        ctx.spec = spec
        ctx.save_for_backward(*packed, trace, life, goal)
        return y

    @staticmethod
    def backward(ctx, gy):
        *packed, trace, life, goal = ctx.saved_tensors
        run = _backward_card if gy.device.type == "cuda" else _backward_reference
        sums, dx0, dgoal = run(tuple(packed), trace, life, goal, gy.contiguous(), ctx.spec)
        grads = _unpack_grads(sums, ctx.spec.cfg)
        return (*(grads[k] for k in WEIGHT_KEYS), dx0, dgoal, None)


def _forward_card(packed, x, goal, spec: _Spec):
    n = spec.n_steps
    trace = torch.empty((n,) + tuple(x.shape), device=x.device)
    trace[0].copy_(x)
    life = None
    if spec.cfg.use_living_channel:
        b, _, h, w = x.shape
        life = torch.empty((n, b, h, w), dtype=torch.uint8, device=x.device)
    tmp = torch.empty_like(x)
    y = torch.empty_like(x)
    for s in range(n):
        dst = trace[s + 1] if s + 1 < n else y
        launch_update(trace[s], goal, tmp, packed, spec.cfg, spec.compute_dtype, spec.seed,
                      s, spec.thr)
        launch_gate(trace[s], tmp, dst, None if life is None else life[s], spec.cfg)
    return y, trace, life


def _backward_card(packed, trace, life, goal, gy, spec: _Spec):
    n, b, c, h, w = trace.shape
    g = gy.clone()
    gp = torch.empty((b, 3 * c, h, w), device=gy.device)
    dgoal = torch.zeros_like(goal)
    slots = _zero_slots(b, h, w, packed)
    for s in reversed(range(n)):
        _launch_bwd_mlp(trace[s], goal, None if life is None else life[s], g, gp, slots,
                        packed, spec.cfg, spec.compute_dtype, spec.seed, s, spec.thr)
        _launch_bwd_adjoint(trace[s], gp, packed[0], g, dgoal, spec.cfg)
    return _split_slots(slots, packed), g, dgoal


# ------------------------------------------------ the kernels one at a time


def cnca_bwd_mlp(packed, x, goal, life, g, cfg: ConditionedNCAConfig, compute_dtype: str,
                 seed: int, step: int, fire_rate: float):
    """One launch of the first backward pass (returns as
    ``cnca_bwd_mlp_reference``); the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return cnca_bwd_mlp_reference(packed, x, goal, life, g, cfg, compute_dtype, seed,
                                      step, fire_rate)
    b, c, h, w = x.shape
    fs.check_card_inputs(x, exact=(goal, g), weights=packed)
    g_xn = g.clone()
    gp = torch.empty((b, 3 * c, h, w), device=x.device)
    slots = _zero_slots(b, h, w, packed)
    _launch_bwd_mlp(x, goal, life, g_xn, gp, slots, packed, cfg, compute_dtype, seed, step,
                    fs.uniform_threshold(fire_rate))
    return g_xn, gp, list(_split_slots(slots, packed))


def cnca_bwd_adjoint(x, gp, g_xn, wcol, cfg: ConditionedNCAConfig):
    """One launch of the second backward pass (returns as
    ``cnca_bwd_adjoint_reference``); the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return cnca_bwd_adjoint_reference(x, gp, g_xn, wcol, cfg)
    fs.check_card_inputs(x, exact=(g_xn,), weights=(gp, wcol))
    g = g_xn.clone()
    dgoal = torch.zeros_like(x)
    _launch_bwd_adjoint(x, gp, wcol, g, dgoal, cfg)
    return g, dgoal


# ------------------------------------------------------------ kernel plumbing


def _count(name: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES[name] += 1


def n_mlp_blocks(b: int, h: int, w: int) -> int:
    """Blocks of one ``cnca_bwd_mlp`` launch: ceil(W/16) x ceil(H/8) x B."""
    tx, ty = MLP_TILE
    return -(-w // tx) * -(-h // ty) * b


def _slot_sizes(packed):
    wcol, w1 = packed[0], packed[1]
    c, (p, d4) = wcol.shape[0], w1.shape
    return [c * 27, p * d4, d4, d4 * d4, d4, d4 * c]


def _zero_slots(b, h, w, packed) -> torch.Tensor:
    """The per-block weight-gradient partials [n_blocks, S]: dwcol [C, 27] |
    dW1 [3C, D4] | db1 [D4] | dW2 [D4, D4] | db2 [D4] | dW3 [D4, C]."""
    return torch.zeros((n_mlp_blocks(b, h, w), sum(_slot_sizes(packed))),
                       device=packed[0].device)


def _split_slots(slots: torch.Tensor, packed):
    """Sum the blocks' partials (once per call) and cut the sum into the
    six gradients in kernel layout."""
    c, (p, d4) = packed[0].shape[0], packed[1].shape
    shapes = [(c, 27), (p, d4), (d4,), (d4, d4), (d4,), (d4, c)]
    parts = torch.split(slots.sum(dim=0), _slot_sizes(packed))
    return [t.reshape(s) for t, s in zip(parts, shapes)]


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _gate_args(cfg: ConditionedNCAConfig):
    return (cfg.alive_channel, ctypes.c_float(cfg.alpha_living_threshold),
            int(cfg.use_living_channel))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)


def launch_update(x, goal, xn, packed, cfg, compute_dtype, seed, step, thr) -> None:
    """One ``cnca_update`` launch on the current stream: x → xn (distinct
    buffers) with the fire mask of absolute step ``step``."""
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _lib().cnca_update_launch(
            _ptr(x), _ptr(goal), _ptr(xn), *(_ptr(t) for t in packed),
            b, c, h, w, packed[1].shape[1], *_gate_args(cfg),
            int(compute_dtype == "bfloat16"), seed & 0xFFFFFFFF, step, thr,
            _stream(x.device))
    _raise_on(err, "cnca_update")


def launch_gate(x, xn, out, life, cfg) -> None:
    """One ``cnca_gate`` launch: out = clamp(xn · life), life = alive(x) ∧
    alive(xn), written to ``life`` (uint8 [B, H, W]) when it is given."""
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _lib().cnca_gate_launch(
            _ptr(x), _ptr(xn), _ptr(out), _ptr(life), b, c, h, w, *_gate_args(cfg),
            ctypes.c_float(cfg.clamp_value), _stream(x.device))
    _raise_on(err, "cnca_gate")


def _launch_bwd_mlp(x, goal, life, g, gp, slots, packed, cfg, compute_dtype, seed, step,
                    thr) -> None:
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _lib().cnca_bwd_mlp_launch(
            _ptr(x), _ptr(goal), _ptr(life), _ptr(g), _ptr(gp), _ptr(slots),
            *(_ptr(t) for t in packed), b, c, h, w, packed[1].shape[1], *_gate_args(cfg),
            ctypes.c_float(cfg.clamp_value), int(compute_dtype == "bfloat16"),
            seed & 0xFFFFFFFF, step, thr, _stream(x.device))
    _raise_on(err, "cnca_bwd_mlp")


def _launch_bwd_adjoint(x, gp, wcol, g, dgoal, cfg) -> None:
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _lib().cnca_bwd_adjoint_launch(
            _ptr(x), _ptr(gp), _ptr(wcol), _ptr(g), _ptr(dgoal), b, c, h, w,
            *_gate_args(cfg), _stream(x.device))
    _raise_on(err, "cnca_bwd_adjoint")


def _lib() -> ctypes.CDLL:
    lib = _build.load("nca_cnca")
    if lib.cnca_update_launch.argtypes is None:
        ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        gate = [i32, f32, i32]  # alive channel, threshold, use_living_channel
        lib.cnca_update_launch.argtypes = ([ptr] * 9 + [i32] * 5 + gate + [i32]
                                           + [u32] * 3 + [ptr])
        lib.cnca_gate_launch.argtypes = [ptr] * 4 + [i32] * 4 + gate + [f32, ptr]
        lib.cnca_bwd_mlp_launch.argtypes = ([ptr] * 12 + [i32] * 5 + gate + [f32, i32]
                                            + [u32] * 3 + [ptr])
        lib.cnca_bwd_adjoint_launch.argtypes = [ptr] * 5 + [i32] * 4 + gate + [ptr]
        for fn in (lib.cnca_update_launch, lib.cnca_gate_launch, lib.cnca_bwd_mlp_launch,
                   lib.cnca_bwd_adjoint_launch, lib.cnca_limits):
            fn.restype = ctypes.c_int
        lib.cnca_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.cnca_update_occupancy.argtypes = [i32] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        lib.cnca_update_occupancy.restype = ctypes.c_int
        for fn in (lib.cnca_bwd_adjoint_geometry, lib.cnca_gate_geometry):
            fn.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
            fn.restype = ctypes.c_int
    return lib


def update_occupancy(c: int, d: int, compute_dtype: str = "float32") -> Tuple[int, int]:
    """(blocks an SM, dynamic shared-memory bytes) of ``cnca_update`` at C
    channels and D hidden units, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = _lib().cnca_update_occupancy(c, _round4(d), int(compute_dtype == "bfloat16"),
                                       ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"cnca_update_occupancy failed: CUDA error {err}")
    return blocks.value, smem.value


def bwd_adjoint_geometry(b: int, c: int, h: int, w: int) -> Tuple[int, int, int]:
    """(blocks of the launch, blocks an SM, dynamic shared-memory bytes) of
    ``cnca_bwd_adjoint`` at [b, c, h, w], from the built library
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _geometry("cnca_bwd_adjoint_geometry", b, c, h, w)


def gate_geometry(b: int, c: int, h: int, w: int) -> Tuple[int, int, int]:
    """The same for ``cnca_gate``."""
    return _geometry("cnca_gate_geometry", b, c, h, w)


def _geometry(fn: str, b: int, c: int, h: int, w: int) -> Tuple[int, int, int]:
    n, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = getattr(_lib(), fn)(b, c, h, w, ctypes.byref(n), ctypes.byref(blocks),
                              ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")
    return n.value, blocks.value, smem.value


def kernel_limits() -> Tuple[int, int]:
    """The largest (C, D) the cnca kernels take, read from the built
    library; ``C_MAX`` and ``D_MAX`` state the same."""
    vals = [ctypes.c_int() for _ in range(2)]
    _lib().cnca_limits(*[ctypes.byref(v) for v in vals])
    return tuple(v.value for v in vals)
