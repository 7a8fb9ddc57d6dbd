"""The inference rollout: N DyNCA steps on NCHW state through the CUDA kernels
of ``csrc/nca_step.cu``, with the plain PyTorch version of each beside it,
and the rollout entries and kernel registry of the JAX package.

Counterpart of ``vsnca_tpu/ops/pallas_step.py``'s public rollout entries,
x [B, C, H, W] → [B, C, H, W]:

- ``fused_rollout_chw`` (:590) with its ``algo`` and ``state_dtype``
  options: ``roll`` with a float32 state (``_make_kernel_roll`` :175)
  launches ``nca_step``, and for perception_scales (0, 1)
  (``_make_kernel_roll_ms`` :308) ``nca_step_ms``; ``mat``
  (``_make_kernel_roll(mat_stencil=True)``, W1 folded by
  ``stencil_folded_w1`` :148) launches ``nca_step_mat``; a bfloat16 state
  (``_make_kernel`` :498, algo ``padded``) launches the bf16-state form of
  ``nca_step`` (``padded`` with a float32 state is ``nca_step``: the same
  function);
- ``fused_rollout_flat_chw`` (:1541), ``fused_rollout_stream_flat_chw``
  (:1819) and ``fused_rollout_stream_chw`` (:1008) launch ``nca_step``,
  which keeps nothing on chip between steps and so has no resident-state cap
  to stream past;
- the support predicates, ``select_rollout_kernel`` (:1976),
  ``ROLLOUT_KERNELS`` (:1998) and the NHWC ``fused_rollout`` (:784), with
  the port's own rules (each predicate says which TPU layout rule it drops).

Unlike the TPU kernels these take any H and W (no ``W % 128`` or row-tile
rule; even H and W for (0, 1), as the TPU kernel asserts) and every padding
mode at every size.

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

``nca_step``, ``nca_step_ms`` and ``nca_step_mat`` come in two forms of
one template: the tensor-core form (the MLP as ``mma.sync``, split TF32 or
bf16; ``nca_step_mat``'s first layer an implicit GEMM over the raw taps)
and the chain form (the MLP as float32 FMAs in the plain version's order,
bit for bit). The training pair launches the chain form; so do the
scales-(0,) rollout and the folded-stencil rollout under bf16 compute
(``chain_form`` says why); every other rollout launches the tensor-core
form.

Every entry launches a kernel for a CUDA tensor and runs the plain version
(``fused_rollout_chw_reference``) only for a CPU tensor; there is no
fallback. ``fused_rollout`` runs ``dynca_rollout``'s eager steps where
``select_rollout_kernel`` returns None, as the JAX wrapper runs its scan:
that is the reference's semantics for a config no kernel takes. ``LAUNCHES``
counts kernel launches (one per step); ``KERNEL_LAUNCHES`` splits them by
kernel form (``nca_step_chain``, ``nca_step_ms_chain`` and
``nca_step_mat_chain`` the chain forms).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.ops import _build
from vsnca_tpu_torch.ops.filters import LAPLACIAN, SOBEL_X, SOBEL_Y
from vsnca_tpu_torch.ops.padding import pad2d
from vsnca_tpu_torch.ops.perception import perceive

LAUNCHES = 0
KERNEL_LAUNCHES: Dict[str, int] = {
    "nca_step": 0, "nca_step_ms": 0, "nca_step_mat": 0, "nca_step_bf16_state": 0,
    "nca_step_chain": 0, "nca_step_ms_chain": 0, "nca_step_mat_chain": 0,
}

PAD_CODES = {"circular": 0, "replicate": 1, "zeros": 2}
COMPUTE_DTYPES = ("float32", "bfloat16")
STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ALGOS = ("roll", "mat", "padded")
SCALES = ((0,), (0, 1))  # the perception scales the kernels take
# NCA_C_MAX, NCA_CC_MAX, NCA_F_MAX of csrc/nca_common.cuh (the card tests
# check them against the built library): enough for every preset.
C_MAX, CC_MAX, F_MAX = 16, 4, 128

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
              device=None, row0: int = 0) -> torch.Tensor:
    """The 32 hash bits of every pixel, int64 [H, W] in [0, 2^32).

    The batch index enters as ``prng_seed(seed + bidx)`` does in the TPU
    kernel (pallas_step.py:1439), the step as in ``_step_seed``
    (pallas_train.py:82); then ``fmix32(fmix32(key) ^ pixel)``. ``row0``:
    the rows are rows ``row0 ..`` of a taller grid (a spatial shard), whose
    pixel indices they take.
    """
    key = _fmix32_int(seed + batch + step * _STEP_MUL)
    pix = torch.arange(row0 * w, (row0 + h) * w, dtype=torch.int64, device=device)
    return _fmix32(pix ^ key).reshape(h, w)


def update_mask(seed: int, batch: int, step: int, h: int, w: int,
                update_rate: float, device=None, row0: int = 0) -> torch.Tensor:
    """float32 [H, W] of 0/1: 1 where the top 24 hash bits >= threshold."""
    thr = uniform_threshold(update_rate)
    return ((mask_bits(seed, batch, step, h, w, device, row0) >> 8) >= thr).float()


def stencil_folded_w1(w1: torch.Tensor, c: int) -> torch.Tensor:
    """Fold the fixed perception stencils into the first dense layer
    (``stencil_folded_w1``, pallas_step.py:148), in float32:
    z1 = W1^T [x | Sx*x | Sy*x | L*x | cond] == W_eff^T [x(di, dj) taps | cond]
    with W_eff[(di*3 + dj)*C + ch] = 1{di == dj == 1} W1[ch]
    + Sx[di, dj] W1[C + ch] + Sy[di, dj] W1[2C + ch] + L[di, dj] W1[3C + ch],
    summed in JAX's order; the conditioning rows follow unchanged.
    [4C + cc, F] → [9C + cc, F]."""
    w1 = w1.float()
    cc = w1.shape[0] - 4 * c
    blocks = []
    for di in range(3):
        for dj in range(3):
            acc = (float(SOBEL_X[di][dj]) * w1[c:2 * c]
                   + float(SOBEL_Y[di][dj]) * w1[2 * c:3 * c]
                   + float(LAPLACIAN[di][dj]) * w1[3 * c:4 * c])
            if di == 1 and dj == 1:
                acc = acc + w1[0:c]
            blocks.append(acc)
    if cc:
        blocks.append(w1[4 * c:])
    return torch.cat(blocks, dim=0)


def pack_weights(params: dict, c: int, cc: int, compute_dtype: str,
                 mat: bool = False) -> Tuple[torch.Tensor, ...]:
    """(w1 [4C + cc, F4], b1 [F4], w2 [F4, C], b2 [C]), float32, contiguous —
    counterpart of ``_flat_pad_weights`` (pallas_step.py:1516).

    W1 keeps the percept's block order [raw | sobel_x | sobel_y | lap | cond]
    and drops the conditioning rows when the call has no conditioning, as
    the TPU wrapper does; with ``mat`` it is ``stencil_folded_w1`` of those
    rows, [9C + cc, F4]. The hidden width F is padded to F4, a multiple of
    4, with zero units (relu(0) = 0 contributes nothing). In bf16 mode W1
    (after the fold) and W2 are rounded to bfloat16 (round to nearest even)
    and held as float32; the biases stay float32.
    """
    w1 = params["w1"][: 4 * c + cc].float()
    if mat:
        w1 = stencil_folded_w1(w1, c)
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


def rollout_form(cfg: NCAConfig, state_dtype: str = "float32", algo: str = "roll") -> str:
    """The kernel form ``fused_rollout_chw`` launches, by pallas_step.py:590's
    rules: ``algo`` is one of ``ALGOS``; 'mat' needs a float32 state (the
    bf16-state kernel has no folded form); a multiscale config runs the
    multiscale step whatever ``algo`` says, as the JAX entry does, with a
    float32 state only. Returns 'nca_step_ms', 'nca_step_mat',
    'nca_step_bf16_state' or 'nca_step'."""
    if algo not in ALGOS:
        raise ValueError(f"unknown kernel algo {algo!r}; one of {ALGOS}")
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype must be one of {tuple(STATE_DTYPES)}")
    bf16_state = state_dtype == "bfloat16"
    if is_multiscale(cfg):
        if bf16_state:
            raise ValueError("perception_scales (0, 1) takes a float32 state only")
        return "nca_step_ms"
    if algo == "mat":
        if bf16_state:
            raise ValueError("algo='mat' requires a float32 state (the bf16-state "
                             "kernel has no folded-stencil form)")
        return "nca_step_mat"
    return "nca_step_bf16_state" if bf16_state else "nca_step"


def _check(params, x, cfg, cond, compute_dtype):
    if tuple(cfg.perception_scales) not in SCALES:
        raise ValueError("the rollout kernels take perception_scales (0,) or (0, 1)")
    if cfg.padding_mode not in PAD_CODES:
        raise ValueError(f"unknown padding_mode {cfg.padding_mode!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
    dtypes = tuple(STATE_DTYPES.values())
    if x.dim() != 4 or x.shape[1] != cfg.c_in or x.dtype not in dtypes:
        raise ValueError(
            f"x must be float32 or bfloat16 [B, {cfg.c_in}, H, W], "
            f"got {x.dtype} {tuple(x.shape)}"
        )
    b, c, h, w = x.shape
    if is_multiscale(cfg) and (h % 2 or w % 2):
        raise ValueError(f"perception_scales (0, 1) needs even H and W, got {h} x {w}")
    if cond is not None:
        if cond.shape != (b, cfg.c_cond, h, w) or cond.dtype not in dtypes:
            raise ValueError(
                f"cond must be float32 or bfloat16 [{b}, {cfg.c_cond}, {h}, {w}], "
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
                      fc_dim: int = 0, dtype: torch.dtype = torch.float32) -> None:
    """What a kernel launch needs: ``x`` [B, C, H, W] on a CUDA device,
    ``exact`` tensors of x's shape and ``batched`` ones (or None) of its
    batch and grid, all of ``dtype`` (float32, or bfloat16 for the
    bf16-state step), and float32 ``weights``, all contiguous on x's
    device; given ``limits``, C, the channels of ``batched[0]`` (the
    conditioning) and ``fc_dim`` within the kernel's (C, c_cond, fc_dim)
    limits. Every kernel wrapper of the port calls it before a launch."""
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
    for t, want in [(t, dtype) for t in (x, *exact, *batched)] + [
            (t, torch.float32) for t in weights]:
        if t is not None and (t.device != dev or t.dtype != want
                              or not t.is_contiguous()):
            raise ValueError(f"a kernel takes contiguous {want} tensors on {dev}, "
                             f"got {t.dtype} on {t.device}")


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
    state_dtype: str = "float32",
    algo: str = "roll",
) -> torch.Tensor:
    """``n_steps`` NCA steps: x [B, C, H, W] → [B, C, H, W] in ``state_dtype``.

    ``cond`` is [B, c_cond, H, W] or None; ``seed`` keys the update masks
    (the stylizer passes its frame counter), step ``i`` of the call drawing
    the mask of absolute step ``first_step + i``. ``algo`` and
    ``state_dtype`` pick the kernel form as ``rollout_form`` says (x and
    cond are cast to the state dtype first, as the JAX entry does); a
    bfloat16 state returns a bfloat16 tensor. On a CUDA tensor this launches
    that form once per step, ping-ponging between two new buffers; on a CPU
    tensor it runs the plain version. ``x`` is never written.
    """
    form = rollout_form(cfg, state_dtype, algo)
    _check(params, x, cfg, cond, compute_dtype)
    sdt = STATE_DTYPES[state_dtype]
    x = x.to(sdt)
    cond = None if cond is None else cond.to(sdt)
    if x.device.type == "cpu":
        return fused_rollout_chw_reference(
            params, x, seed, cfg, n_steps, cond, update_rate, compute_dtype, first_step,
            state_dtype, algo,
        )
    check_card_inputs(x, (cond,), limits=kernel_limits(), fc_dim=cfg.fc_dim, dtype=sdt)
    if n_steps == 0:
        return x.clone()
    rate = cfg.update_rate if update_rate is None else update_rate
    mat = form == "nca_step_mat"
    packed = pack_weights(params, x.shape[1], cond.shape[1] if cond is not None else 0,
                          compute_dtype, mat)
    bufs = [torch.empty_like(x) for _ in range(min(n_steps, 2))]
    src = x
    for i in range(n_steps):
        dst = bufs[i % 2]
        launch_step(src, dst, cond, packed, cfg.padding_mode, compute_dtype,
                    seed, first_step + i, uniform_threshold(rate),
                    form == "nca_step_ms", mat, chain_form(form, compute_dtype))
        src = dst
    return src


def chain_form(form: str, compute_dtype: str) -> bool:
    """Whether a rollout of ``form`` runs its chain form rather than its
    tensor-core form: the scales-(0,) step (``nca_step``) and the
    folded-stencil step (``nca_step_mat``) with a float32 state under bf16
    compute. Their percept or raw taps and their hidden activations are
    rounded to bf16 every step, so a one-ulp difference (the tensor cores
    sum in another order than the plain version) flips those roundings, and
    over 24 steps at 256^2 the state drifted from the plain version's past
    ``TOL['bfloat16']`` 1e-3: 2.07e-3 for ``nca_step`` (the served step),
    1.01e-2 for ``nca_step_mat``, in all 18 of its bf16 cases (H100,
    chip_smoke.py); the chain forms reproduce the plain version's bits at
    those shapes. Under float32 compute ``nca_step_mat``'s tensor-core form
    (split TF32) stays within 4.8e-6 of it against 1e-4. The multiscale step
    (whose average damps the flips: 7.0e-4 over 24 steps at 256^2 b3), the
    float32 steps and the bf16-state step run on the tensor cores."""
    return form in ("nca_step", "nca_step_mat") and compute_dtype == "bfloat16"


def launch_step(src: torch.Tensor, dst: torch.Tensor, cond: Optional[torch.Tensor],
                packed: Tuple[torch.Tensor, ...], padding_mode: str,
                compute_dtype: str, seed: int, step: int, thr: int,
                multiscale: bool = False, mat: bool = False, chain: bool = False) -> None:
    """One step launch on the current stream: ``src`` → ``dst`` (distinct
    contiguous CUDA buffers [B, C, H, W]) with the mask of absolute step
    ``step``; ``packed`` from ``pack_weights`` (with its ``mat`` for
    ``mat``). The form: ``nca_step_ms`` with ``multiscale``,
    ``nca_step_mat`` with ``mat``, the bf16-state ``nca_step`` for bfloat16
    buffers (cond bfloat16 too), else ``nca_step``. ``nca_step``,
    ``nca_step_ms`` and ``nca_step_mat`` run the MLP on the tensor cores;
    with ``chain`` (a float32 state) they run it as float32 FMAs in the
    plain version's order instead (``nca_step_chain``, ``nca_step_ms_chain``,
    ``nca_step_mat_chain``): the training pair's forward, whose states, and
    so its relu gates, must be the plain pair's bits (see csrc/nca_step.cu),
    and the bf16 scales-(0,) and folded-stencil rollouts (``chain_form``).
    ``nca_step_mat``'s chain form exists under bf16 compute only; without
    ``chain`` it runs the tensor-core form under either compute type.
    Counts the launch in ``LAUNCHES`` and ``KERNEL_LAUNCHES``."""
    global LAUNCHES
    w1, b1, w2, b2 = packed
    b, c, h, w = src.shape
    cc = cond.shape[1] if cond is not None else 0
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    lib = _launcher()
    bf16_state = src.dtype == torch.bfloat16
    cond_ptr = ptr(cond) if cc else ctypes.c_void_p(None)
    head = (ptr(src), ptr(dst), cond_ptr, ptr(w1), ptr(b1), ptr(w2), ptr(b2),
            b, c, h, w, cc, w1.shape[1], PAD_CODES[padding_mode],
            int(compute_dtype == "bfloat16"))
    tail = (seed & 0xFFFFFFFF, step, thr)
    if mat:
        if chain and compute_dtype != "bfloat16":
            raise ValueError("nca_step_mat has a chain form under bf16 compute only")
        name = "nca_step_mat" + ("_chain" if chain else "")
        fn, ms = lib.nca_step_mat_launch, (int(not chain),)
    elif bf16_state:
        name, fn, ms = "nca_step_bf16_state", lib.nca_step_bf16_state_launch, ()
    else:
        name = ("nca_step_ms" if multiscale else "nca_step") + ("_chain" if chain else "")
        fn, ms = lib.nca_step_launch, (int(multiscale), int(chain))
    with torch.cuda.device(src.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(src.device).cuda_stream)
        err = fn(*head, *ms, *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[name] += 1


def _launcher() -> ctypes.CDLL:
    lib = _build.load("nca_step")
    if lib.nca_step_launch.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.nca_step_launch.argtypes = [ptr] * 7 + [i32] * 10 + [u32] * 3 + [ptr]
        lib.nca_step_launch.restype = ctypes.c_int
        lib.nca_step_occupancy.argtypes = [i32] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
        lib.nca_step_occupancy.restype = ctypes.c_int
        lib.nca_step_mat_launch.argtypes = [ptr] * 7 + [i32] * 9 + [u32] * 3 + [ptr]
        lib.nca_step_bf16_state_launch.argtypes = [ptr] * 7 + [i32] * 8 + [u32] * 3 + [ptr]
        for fn in (lib.nca_step_mat_launch, lib.nca_step_bf16_state_launch):
            fn.restype = ctypes.c_int
        lib.nca_step_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.nca_step_limits.restype = ctypes.c_int
    return lib


STEP_OCCUPANCY_FORMS = ("tc", "bf16_state", "chain", "mat")


def step_occupancy(c: int, cc: int, fc_dim: int, compute_dtype: str, multiscale: bool,
                   form: str) -> Tuple[int, int]:
    """(blocks an SM, dynamic shared-memory bytes) of a step kernel at these
    widths, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: ``form``
    'tc' (``nca_step``/``nca_step_ms``), 'bf16_state', 'chain', or 'mat'
    (``nca_step_mat`` in the form its compute type takes: ``chain_form``)."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = _launcher().nca_step_occupancy(
        c, cc, fc_dim + (-fc_dim % 4), int(compute_dtype == "bfloat16"), int(multiscale),
        STEP_OCCUPANCY_FORMS.index(form), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"nca_step_occupancy failed: CUDA error {err}")
    return blocks.value, smem.value


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
    state_dtype: str = "float32",
    algo: str = "roll",
) -> torch.Tensor:
    """The kernels' function in plain PyTorch, on any device: perception as
    shifted-slice sums (``multiscale_percept`` for scales (0, 1), the raw
    3x3 taps for 'mat', bf16 arithmetic on a bf16 state), the MLP as float32
    products (TF32 off), bf16 rounding at the kernels' places, and the same
    hash masks."""
    form = rollout_form(cfg, state_dtype, algo)
    _check(params, x, cfg, cond, compute_dtype)
    sdt = STATE_DTYPES[state_dtype]
    x = x.to(sdt)
    cond = None if cond is None else cond.to(sdt)
    cc = cond.shape[1] if cond is not None else 0
    rate = cfg.update_rate if update_rate is None else update_rate
    mat = form == "nca_step_mat"
    packed = pack_weights(params, x.shape[1], cc, compute_dtype, mat)
    for i in range(n_steps):
        x = reference_step(x, cond, packed, cfg.padding_mode, compute_dtype,
                           seed, first_step + i, rate, form == "nca_step_ms", mat)
    return x


def kernel_cfg_ok(cfg: NCAConfig) -> bool:
    """C, c_cond and fc_dim within the kernels' limits."""
    return cfg.c_in <= C_MAX and cfg.c_cond <= CC_MAX and cfg.fc_dim <= F_MAX


def fused_rollout_flat_chw(params: dict, x: torch.Tensor, seed: int, cfg: NCAConfig,
                           n_steps: int, cond: Optional[torch.Tensor] = None,
                           update_rate: Optional[float] = None,
                           compute_dtype: str = "float32") -> torch.Tensor:
    """``fused_rollout_flat_chw`` (pallas_step.py:1541): the same contract as
    ``fused_rollout_chw``, perception_scales (0,) only; launches
    ``nca_step``. The TPU's flat [ceil8(C), H*W] layout has no counterpart
    here: the kernel reads NCHW."""
    if tuple(cfg.perception_scales) != (0,):
        raise ValueError("fused_rollout_flat_chw takes perception_scales (0,) only")
    return fused_rollout_chw(params, x, seed, cfg, n_steps, cond, update_rate,
                             compute_dtype)


def fused_rollout_stream_chw(params: dict, x: torch.Tensor, seed: int, cfg: NCAConfig,
                             n_steps: int, cond: Optional[torch.Tensor] = None,
                             update_rate: Optional[float] = None,
                             compute_dtype: str = "float32") -> torch.Tensor:
    """``fused_rollout_stream_chw`` (pallas_step.py:1008): circular padding
    and perception_scales (0,) only, as its asserts say; launches
    ``nca_step``, which reads each step's state from device memory and so
    streams every grid (the TPU kernel's row bands, double-buffered DMA and
    ≥ 2 bands rule are VMEM layout and do not apply)."""
    if tuple(cfg.perception_scales) != (0,) or cfg.padding_mode != "circular":
        raise ValueError("the streaming entry is circular-only, perception_scales (0,)")
    return fused_rollout_chw(params, x, seed, cfg, n_steps, cond, update_rate,
                             compute_dtype)


def fused_rollout_stream_flat_chw(params: dict, x: torch.Tensor, seed: int,
                                  cfg: NCAConfig, n_steps: int,
                                  cond: Optional[torch.Tensor] = None,
                                  update_rate: Optional[float] = None,
                                  compute_dtype: str = "float32") -> torch.Tensor:
    """``fused_rollout_stream_flat_chw`` (pallas_step.py:1819): circular and
    perception_scales (0,) only; launches ``nca_step``, as
    ``fused_rollout_stream_chw`` does."""
    return fused_rollout_stream_chw(params, x, seed, cfg, n_steps, cond, update_rate,
                                    compute_dtype)


def fused_rollout_supported(cfg: NCAConfig, h: int, w: int,
                            state_dtype: str = "float32") -> bool:
    """The port's rule for ``fused_rollout_supported`` (pallas_step.py:756):
    perception_scales (0,), or (0, 1) at even H and W with a float32 state,
    within the kernels' C, c_cond and fc_dim limits. Dropped as TPU layout:
    ``W % 128``, the row-tile divisor and the VMEM budget; and the v5e
    measurement that kept multiscale off auto-selection (on the H100 the
    multiscale kernel is the only one that takes (0, 1))."""
    scales = tuple(cfg.perception_scales)
    if scales not in SCALES or state_dtype not in STATE_DTYPES or not kernel_cfg_ok(cfg):
        return False
    if scales == (0, 1):
        return h % 2 == 0 and w % 2 == 0 and state_dtype == "float32"
    return True


def fused_flat_supported(cfg: NCAConfig, h: int, w: int) -> bool:
    """The port's rule for ``fused_flat_supported`` (pallas_step.py:1943):
    perception_scales (0,) within the kernels' limits, at any padding and
    size. Dropped as TPU layout: ``W % 128``, the row-tile divisor and the
    15 MB VMEM budget (the kernel keeps nothing resident)."""
    return tuple(cfg.perception_scales) == (0,) and kernel_cfg_ok(cfg)


def fused_stream_supported(cfg: NCAConfig, h: int, w: int) -> bool:
    """The port's rule for ``fused_stream_supported`` (pallas_step.py:1966):
    circular padding, perception_scales (0,), within the kernels' limits.
    Dropped as TPU layout: ``W % 128``, the band divisor and the ≥ 2 bands
    rule."""
    return cfg.padding_mode == "circular" and fused_flat_supported(cfg, h, w)


def fused_stream_flat_supported(cfg: NCAConfig, h: int, w: int) -> bool:
    """The port's rule for ``fused_stream_flat_supported``
    (pallas_step.py:1923): as ``fused_stream_supported``. Dropped as TPU
    layout: ``W % 128``, the even band count and the 14 MB band budget."""
    return fused_stream_supported(cfg, h, w)


def select_rollout_kernel(cfg: NCAConfig, h: int, w: int) -> Optional[str]:
    """The inference rollout's kernel for a config and grid, re-derived on
    the H100 (pallas_step.py:1976 encodes v5e's measurements):

    - 'flat' for perception_scales (0,) within the kernels' limits, at any
      padding and size: it launches ``nca_step``, which every scales-(0,)
      entry launches, so 'roll', 'stream_flat' and 'stream' run the same
      kernel at the same speed (PERF.md gives each at 256² and 1024²), and
      nothing is resident, so no grid needs streaming;
    - 'roll' for (0, 1) at even H and W: the multiscale kernel is row 1's
      ``_make_kernel_roll_ms``;
    - None elsewhere (other scales, odd sizes at (0, 1), past the limits):
      ``fused_rollout`` then runs the eager steps.
    """
    if fused_flat_supported(cfg, h, w):
        return "flat"
    if fused_rollout_supported(cfg, h, w):
        return "roll"
    if fused_stream_flat_supported(cfg, h, w):
        return "stream_flat"
    return None


ROLLOUT_KERNELS = {
    "flat": fused_rollout_flat_chw,
    "roll": fused_rollout_chw,
    "stream_flat": fused_rollout_stream_flat_chw,
}


def fused_rollout(
    params: dict,
    x_nhwc: torch.Tensor,
    seed: int,
    cfg: NCAConfig,
    n_steps: int,
    cond_nhwc: Optional[torch.Tensor] = None,
    update_rate: Optional[float] = None,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC wrapper (pallas_step.py:784): returns (state, rgb) NHWC like
    ``dynca_rollout``, through ``ROLLOUT_KERNELS[select_rollout_kernel(...)]``.
    Where the policy returns None it runs ``dynca_rollout``'s eager steps on
    the same device, as the JAX wrapper runs its scan (the same masks: both
    key them by absolute step). A kernel that fails to build or launch
    raises."""
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    cond = None if cond_nhwc is None else cond_nhwc.permute(0, 3, 1, 2).contiguous()
    kernel = select_rollout_kernel(cfg, x.shape[2], x.shape[3])
    if kernel is None:
        from vsnca_tpu_torch.models.dynca import dynca_rollout

        state, _ = dynca_rollout(params, x, seed, cfg, n_steps, cond=cond,
                                 update_rate=update_rate, rollout_path="xla")
    else:
        state = ROLLOUT_KERNELS[kernel](params, x, seed, cfg, n_steps, cond, update_rate,
                                        compute_dtype=compute_dtype)
    state = state.permute(0, 2, 3, 1)
    return state, state[..., : cfg.c_out] * 2.0


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


def batch_mask(seed: int, step: int, shape, update_rate: float, device,
               row0: int = 0) -> torch.Tensor:
    """[B, 1, H, W] update masks of absolute step ``step`` for a batch
    (rows ``row0 ..`` of a taller grid: see ``mask_bits``)."""
    b, _, h, w = shape
    return torch.stack(
        [update_mask(seed, i, step, h, w, update_rate, device, row0) for i in range(b)]
    )[:, None]


def mat_taps(x: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """The raw 3x3 neighbourhood of every channel under the padding mode,
    [B, 9C, H, W], row (di*3 + dj)*C + c: the 'mat' kernel's percept, whose
    rows W_eff (``stencil_folded_w1``) multiplies."""
    h, w = x.shape[-2:]
    p = pad2d(x, 1, padding_mode)
    return torch.cat([p[..., di:di + h, dj:dj + w] for di in range(3) for dj in range(3)],
                     dim=1)


def reference_step(x: torch.Tensor, cond: Optional[torch.Tensor],
                   packed: Tuple[torch.Tensor, ...], padding_mode: str,
                   compute_dtype: str, seed: int, step: int,
                   update_rate: float, multiscale: bool = False,
                   mat: bool = False) -> torch.Tensor:
    """``launch_step``'s function in plain PyTorch (one step, the mask of
    absolute step ``step``): perception as shifted-slice sums (the raw taps
    with ``mat``; on a bfloat16 state in bf16 arithmetic, every product and
    partial sum rounded, as JAX computes it), the MLP as float32 products
    (TF32 off), bf16 rounding at the kernel's places, a float32 residual
    add, and a bfloat16 state rounded on store."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w1, b1, w2, b2 = packed
    rnd = rounder(compute_dtype)
    if mat:
        p = mat_taps(x, padding_mode)
    elif multiscale:
        p = multiscale_percept(x, padding_mode)
    else:
        p = perceive(x, padding_mode)
    if cond is not None:
        p = torch.cat([p, cond], dim=1)
    p = rnd(p.float())
    hid = rnd(torch.relu(torch.einsum("bphw,pf->bfhw", p, w1) + b1[:, None, None]))
    dx = torch.einsum("bfhw,fc->bchw", hid, w2) + b2[:, None, None]
    out = x.float() + dx * batch_mask(seed, step, x.shape, update_rate, x.device)
    return out.to(x.dtype)
