"""The inference rollout: N DyNCA steps on NCHW state through the CUDA kernel
``csrc/nca_step.cu``, with its plain PyTorch version beside it.

Counterpart of ``vsnca_tpu/ops/pallas_step.py::fused_rollout_flat_chw``
(:1541) and ``fused_rollout_stream_flat_chw`` (:1819) for perception_scales
(0,), and of ``fused_rollout_chw`` (:590) with its multiscale builder
``_make_kernel_roll_ms`` (:308) for perception_scales (0, 1): x [B, C, H, W]
float32 → [B, C, H, W]. Unlike the TPU kernels it takes any H and W (no
``W % 128`` rule; even H and W for (0, 1), as the TPU kernel asserts) and
every padding mode at every size.

The (0, 1) percept (``multiscale_percept``) is ``perceive_multiscale``'s
function in the kernel's operation order: the half state is the exact 2x2
mean, the half-resolution stencils resolve their halo under the padding mode,
the 2x upsample is the 0.75/0.25 two-tap rule with edge clamping (rows and
columns 0 and last read one half row or column with weight 1 whatever the
padding), and the two scales average as ``(p0 + p1) * 0.5``.

The stochastic mask is a pure function of (seed, batch, step, pixel): a
murmur3 ``fmix32`` chain written once in CUDA and once here in int64 torch
ops, so the kernel and the plain version draw bit-identical masks at any
update rate. ``jax.random``'s bits cannot be reproduced, so parity with the
JAX package holds at ``update_rate=1`` and otherwise only in distribution.

``fused_rollout_chw`` launches the kernel for a CUDA tensor and runs
``fused_rollout_chw_reference`` only for a CPU tensor; there is no fallback.
``LAUNCHES`` counts kernel launches (one per step); ``KERNEL_LAUNCHES``
splits them into the scale-0 step (``nca_step``) and the multiscale step
(``nca_step_ms``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.ops import _build
from vsnca_tpu_torch.ops.perception import perceive

LAUNCHES = 0
KERNEL_LAUNCHES: Dict[str, int] = {"nca_step": 0, "nca_step_ms": 0}

PAD_CODES = {"circular": 0, "replicate": 1, "zeros": 2}
COMPUTE_DTYPES = ("float32", "bfloat16")
SCALES = ((0,), (0, 1))  # the perception scales the kernels take

_M32 = 0xFFFFFFFF
_STEP_MUL = 7919  # the step's multiplier in pallas_train.py::_step_seed


def uniform_threshold(update_rate: float) -> int:
    """u24 threshold such that P(bits24 >= thr) == update_rate."""
    thr = int(round((1.0 - update_rate) * (1 << 24)))
    return max(0, min(thr, 1 << 24))


def _fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mask_bits(seed: int, batch: int, step: int, h: int, w: int,
              device=None) -> torch.Tensor:
    """The 32 hash bits of every pixel, int64 [H, W] in [0, 2^32).

    The batch index enters as ``prng_seed(seed + bidx)`` does in the TPU
    kernel (pallas_step.py:1439), the step as in ``_step_seed``
    (pallas_train.py:82); then ``fmix32(fmix32(key) ^ pixel)``.
    """
    key = _fmix32_int(seed + batch + step * _STEP_MUL)
    pix = torch.arange(h * w, dtype=torch.int64, device=device)
    return _fmix32(pix ^ key).reshape(h, w)


def update_mask(seed: int, batch: int, step: int, h: int, w: int,
                update_rate: float, device=None) -> torch.Tensor:
    """float32 [H, W] of 0/1: 1 where the top 24 hash bits >= threshold."""
    thr = uniform_threshold(update_rate)
    return ((mask_bits(seed, batch, step, h, w, device) >> 8) >= thr).float()


def pack_weights(params: dict, c: int, cc: int, compute_dtype: str
                 ) -> Tuple[torch.Tensor, ...]:
    """(w1 [4C + cc, F4], b1 [F4], w2 [F4, C], b2 [C]), float32, contiguous —
    counterpart of ``_flat_pad_weights`` (pallas_step.py:1516).

    W1 keeps the percept's block order [raw | sobel_x | sobel_y | lap | cond]
    and drops the conditioning rows when the call has no conditioning, as
    the TPU wrapper does. The hidden width F is padded to F4, a multiple of
    4, with zero units (relu(0) = 0 contributes nothing). In bf16 mode W1 and
    W2 are rounded to bfloat16 (round to nearest even) and held as float32;
    the biases stay float32.
    """
    w1 = params["w1"][: 4 * c + cc].float()
    w2 = params["w2"].float()
    if compute_dtype == "bfloat16":
        w1 = w1.to(torch.bfloat16).float()
        w2 = w2.to(torch.bfloat16).float()
    f = w1.shape[1]
    pad = -f % 4
    return (
        F.pad(w1, (0, pad)).contiguous(),
        F.pad(params["b1"].float(), (0, pad)).contiguous(),
        F.pad(w2, (0, 0, 0, pad)).contiguous(),
        params["b2"].float().contiguous(),
    )


def is_multiscale(cfg: NCAConfig) -> bool:
    return tuple(cfg.perception_scales) == (0, 1)


def _check(params, x, cfg, cond, compute_dtype):
    if tuple(cfg.perception_scales) not in SCALES:
        raise ValueError("the rollout kernels take perception_scales (0,) or (0, 1)")
    if cfg.padding_mode not in PAD_CODES:
        raise ValueError(f"unknown padding_mode {cfg.padding_mode!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
    if x.dim() != 4 or x.shape[1] != cfg.c_in or x.dtype != torch.float32:
        raise ValueError(
            f"x must be float32 [B, {cfg.c_in}, H, W], got {x.dtype} {tuple(x.shape)}"
        )
    b, c, h, w = x.shape
    if is_multiscale(cfg) and (h % 2 or w % 2):
        raise ValueError(f"perception_scales (0, 1) needs even H and W, got {h} x {w}")
    if cond is not None:
        if cond.shape != (b, cfg.c_cond, h, w) or cond.dtype != torch.float32:
            raise ValueError(
                f"cond must be float32 [{b}, {cfg.c_cond}, {h}, {w}], "
                f"got {cond.dtype} {tuple(cond.shape)}"
            )
        if cond.device != x.device:
            raise ValueError("cond and x are on different devices")
    f = params["w1"].shape[1]
    if params["w1"].shape[0] != cfg.perception_dim or f != cfg.fc_dim:
        raise ValueError("params do not match cfg (w1 must be [P, F])")
    for k, v in params.items():
        if v.device != x.device:
            raise ValueError(f"params[{k!r}] is on {v.device}, x on {x.device}")


def check_card_inputs(x: torch.Tensor, batched=(), exact=(), weights=(),
                      limits: Optional[Tuple[int, int, int]] = None,
                      fc_dim: int = 0) -> None:
    """What a kernel launch needs: ``x`` [B, C, H, W] on a CUDA device,
    ``exact`` tensors of x's shape, ``batched`` ones (or None) of its batch
    and grid, and ``weights``, all contiguous float32 on x's device; given
    ``limits``, C, the channels of ``batched[0]`` (the conditioning) and
    ``fc_dim`` within the kernel's (C, c_cond, fc_dim) limits. Every kernel
    wrapper of the port calls it before a launch."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if limits is not None:
        c_max, cc_max, f_max = limits
        cc = batched[0].shape[1] if batched and batched[0] is not None else 0
        if x.shape[1] > c_max or cc > cc_max or fc_dim > f_max:
            raise ValueError(
                f"kernel limits: C <= {c_max}, c_cond <= {cc_max}, fc_dim <= {f_max}"
            )
    for t in exact:
        if t.shape != x.shape:
            raise ValueError(f"expected shape {tuple(x.shape)}, got {tuple(t.shape)}")
    for t in batched:
        if t is not None and (t.shape[0] != x.shape[0] or t.shape[2:] != x.shape[2:]):
            raise ValueError(f"{tuple(t.shape)} does not match {tuple(x.shape)}")
    for t in (x, *exact, *batched, *weights):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"a kernel takes contiguous float32 tensors on {dev}")


def fused_rollout_chw(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    compute_dtype: str = "float32",
    first_step: int = 0,
) -> torch.Tensor:
    """``n_steps`` NCA steps: x [B, C, H, W] float32 → [B, C, H, W].

    ``cond`` is [B, c_cond, H, W] or None; ``seed`` keys the update masks
    (the stylizer passes its frame counter), step ``i`` of the call drawing
    the mask of absolute step ``first_step + i``. On a CUDA tensor this
    launches ``nca_step`` (perception_scales (0,)) or ``nca_step_ms`` ((0,
    1)) once per step, ping-ponging between two new buffers; on a CPU tensor
    it runs the plain version. ``x`` is never written.
    """
    _check(params, x, cfg, cond, compute_dtype)
    if x.device.type == "cpu":
        return fused_rollout_chw_reference(
            params, x, seed, cfg, n_steps, cond, update_rate, compute_dtype, first_step
        )
    check_card_inputs(x, (cond,), limits=kernel_limits(), fc_dim=cfg.fc_dim)
    if n_steps == 0:
        return x.clone()
    rate = cfg.update_rate if update_rate is None else update_rate
    packed = pack_weights(params, x.shape[1], cond.shape[1] if cond is not None else 0,
                          compute_dtype)
    bufs = [torch.empty_like(x) for _ in range(min(n_steps, 2))]
    src = x
    for i in range(n_steps):
        dst = bufs[i % 2]
        launch_step(src, dst, cond, packed, cfg.padding_mode, compute_dtype,
                    seed, first_step + i, uniform_threshold(rate), is_multiscale(cfg))
        src = dst
    return src


def launch_step(src: torch.Tensor, dst: torch.Tensor, cond: Optional[torch.Tensor],
                packed: Tuple[torch.Tensor, ...], padding_mode: str,
                compute_dtype: str, seed: int, step: int, thr: int,
                multiscale: bool = False) -> None:
    """One ``nca_step`` (or, with ``multiscale``, ``nca_step_ms``) launch on
    the current stream: ``src`` → ``dst`` (distinct contiguous CUDA buffers
    [B, C, H, W]) with the mask of absolute step ``step``; ``packed`` from
    ``pack_weights``. Counts the launch in ``LAUNCHES`` and
    ``KERNEL_LAUNCHES``."""
    global LAUNCHES
    w1, b1, w2, b2 = packed
    b, c, h, w = src.shape
    cc = cond.shape[1] if cond is not None else 0
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    lib = _launcher()
    name = "nca_step_ms" if multiscale else "nca_step"
    with torch.cuda.device(src.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(src.device).cuda_stream)
        err = lib.nca_step_launch(
            ptr(src), ptr(dst), ptr(cond) if cc else ctypes.c_void_p(None),
            ptr(w1), ptr(b1), ptr(w2), ptr(b2),
            b, c, h, w, cc, w1.shape[1], PAD_CODES[padding_mode],
            int(compute_dtype == "bfloat16"), int(multiscale),
            seed & 0xFFFFFFFF, step, thr, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[name] += 1


def _launcher() -> ctypes.CDLL:
    lib = _build.load("nca_step")
    if lib.nca_step_launch.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.nca_step_launch.argtypes = [ptr] * 7 + [i32] * 9 + [u32] * 3 + [ptr]
        lib.nca_step_launch.restype = ctypes.c_int
        lib.nca_step_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.nca_step_limits.restype = ctypes.c_int
    return lib


def kernel_limits() -> Tuple[int, int, int]:
    """The largest (C, c_cond, fc_dim) the kernel takes, read from the built
    library (``NCA_C_MAX``, ``NCA_CC_MAX``, ``NCA_F_MAX`` in nca_step.cu):
    16, 4 and 128, enough for every preset (video_motion is c16/fc128)."""
    vals = [ctypes.c_int() for _ in range(3)]
    _launcher().nca_step_limits(*[ctypes.byref(v) for v in vals])
    return tuple(v.value for v in vals)


def fused_rollout_chw_reference(
    params: dict,
    x: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    compute_dtype: str = "float32",
    first_step: int = 0,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch, on any device: perception as
    shifted-slice sums (``multiscale_percept`` for scales (0, 1)), the MLP
    as float32 products (TF32 off), bf16 rounding at the kernels' places,
    and the same hash masks."""
    _check(params, x, cfg, cond, compute_dtype)
    cc = cond.shape[1] if cond is not None else 0
    rate = cfg.update_rate if update_rate is None else update_rate
    packed = pack_weights(params, x.shape[1], cc, compute_dtype)
    for i in range(n_steps):
        x = reference_step(x, cond, packed, cfg.padding_mode, compute_dtype,
                           seed, first_step + i, rate, is_multiscale(cfg))
    return x


def half_state(x: torch.Tensor) -> torch.Tensor:
    """The exact 2x2 mean [B, C, H/2, W/2] (``resize_bilinear`` to half size
    at factor 2), summed in the kernels' order: ((x00 + x01) + x10) + x11,
    then times 0.25."""
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) * 0.25


def _neighbour_index(m: int, step: int, device) -> torch.Tensor:
    """Index i + step clamped to [0, m)."""
    return torch.clamp(torch.arange(m, device=device) + step, 0, m - 1)


def upsample2(s: torch.Tensor, dim: int) -> torch.Tensor:
    """2x bilinear upsample (align_corners=False) along ``dim``: output 2i is
    0.75 s[i] + 0.25 s[i - 1], output 2i + 1 is 0.75 s[i] + 0.25 s[i + 1],
    the neighbour clamped at the edges — ``resize_matrix(2m, m)``'s rows."""
    dim %= s.dim()
    m = s.shape[dim]
    lo = s.index_select(dim, _neighbour_index(m, -1, s.device))
    hi = s.index_select(dim, _neighbour_index(m, 1, s.device))
    even = s * 0.75 + lo * 0.25
    odd = s * 0.75 + hi * 0.25
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def multiscale_percept(x: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """perception_scales (0, 1) in the kernels' order: the scale-0 percept
    p0, the half state's percept upsampled over W then H (p1), and
    ``(p0 + p1) * 0.5``. Even H and W."""
    p0 = perceive(x, padding_mode)
    p1 = upsample2(upsample2(perceive(half_state(x), padding_mode), -1), -2)
    return (p0 + p1) * 0.5


def rounder(compute_dtype: str):
    """The kernels' operand rounding: to bfloat16 and back in bf16 mode,
    the identity in float32."""
    if compute_dtype == "bfloat16":
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def batch_mask(seed: int, step: int, shape, update_rate: float, device) -> torch.Tensor:
    """[B, 1, H, W] update masks of absolute step ``step`` for a batch."""
    b, _, h, w = shape
    return torch.stack(
        [update_mask(seed, i, step, h, w, update_rate, device) for i in range(b)]
    )[:, None]


def reference_step(x: torch.Tensor, cond: Optional[torch.Tensor],
                   packed: Tuple[torch.Tensor, ...], padding_mode: str,
                   compute_dtype: str, seed: int, step: int,
                   update_rate: float, multiscale: bool = False) -> torch.Tensor:
    """``launch_step``'s function in plain PyTorch (one step, the mask of
    absolute step ``step``): perception as shifted-slice sums, the MLP as
    float32 products (TF32 off), bf16 rounding at the kernel's places."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w1, b1, w2, b2 = packed
    rnd = rounder(compute_dtype)
    p = multiscale_percept(x, padding_mode) if multiscale else perceive(x, padding_mode)
    if cond is not None:
        p = torch.cat([p, cond], dim=1)
    p = rnd(p)
    hid = rnd(torch.relu(torch.einsum("bphw,pf->bfhw", p, w1) + b1[:, None, None]))
    dx = torch.einsum("bfhw,fc->bchw", hid, w2) + b2[:, None, None]
    return x + dx * batch_mask(seed, step, x.shape, update_rate, x.device)
