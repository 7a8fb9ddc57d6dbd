#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``vsnca_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, each printing its results; any failure ends the run with a non-zero
exit and no result line:

1. the card's name and power limit, and the build of every kernel from
   ``vsnca_tpu_torch/csrc`` (one nvcc per source, all started together),
   with ptxas' registers and spills of each kernel;
2. each kernel against its plain PyTorch version on the card: the rollout
   step across padding modes, conditioning, update rates and compute types at
   a ragged size, at the served shape (256^2), past the TPU's resident
   cap (512^2) and at the trainers' vector-field pre-roll (the
   extra_channels cell, C 13 without conditioning, at 40x72 b2, rates 1 and
   0.5, f32 and bf16, and 256^2 b2 f32; the edge_conditioned cell at 256^2
   b2 f32); the stylizer on the card against the CPU; the training pair
   (forward through nca_step, backward through nca_bwd_mlp and
   nca_bwd_adjoint) across conditioning, rates and compute types at 40x72,
   and at the static_texture shape (128^2, batch 4, 32 steps), with each
   backward kernel alone there, and the redesigned nca_bwd_adjoint alone at
   128^2 b4 and at 8^2, 18^2, 34x66 (the 4-byte staging) and 40x72 b2, C 12
   and 5, tap on and off; one train step on the card against the CPU;
   the ConditionedNCA kernels (cnca_update, cnca_gate, cnca_bwd_mlp,
   cnca_bwd_adjoint): the rollout at 64^2 b1 and b8 and 40x72 b2, rates 1
   and 0.5, living channel on and off, f32 and bf16, the training pair's
   state, dx0, dgoal and weight gradients, and each kernel alone at 64^2 b8,
   the redesigned cnca_bwd_adjoint alone at 64^2 b8 and at 8^2, 24x40 and
   34x66 b2, C 20 and 7, living channel on (a sparse alpha plane) and off;
   the multiscale kernels of the video_motion cell (c16/fc128, perception
   scales (0, 1)): nca_step_ms at 40x72 b2 under the three paddings, pos_emb
   on and off, rates 1 and 0.5, f32 and bf16, and at 256^2 b3; the
   multiscale pair (nca_step_ms forward, nca_bwd_mlp_ms and
   nca_bwd_adjoint_ms backward) at 40x72 and at 256^2 b3 x 16 steps, the
   step's chain form (the training forward) against the plain step at the
   static_texture and video_motion shapes, the
   tapped pair at scales (0,) and (0, 1), each multiscale backward kernel
   alone at 256^2 b3; one video_motion train step on the card against the
   CPU at 32^2; the TPU-layout forms: nca_step_mat (algo 'mat': its
   tensor-core form under f32 compute, its chain form under bf16) and the
   bf16-state nca_step (algo 'padded', state_dtype 'bfloat16') at 40x72 b2 x 4
   steps and 256^2 b1 x 24 steps under the three paddings, conditioning none /
   pos_emb / edges, rates 1 and 0.5, f32 and bf16 compute, and the 24-step
   drift of nca_step_mat's tensor-core form under bf16 (printed, not held:
   no entry launches it); the streaming entry
   at 1024^2 b1 x 4 steps; the segment-checkpointed CHW pair at the
   static_texture cell (128^2 b4 x 128 steps, K = 16) against K = 1 and
   against its plain segment walk; the redesigned nca_bwd_adjoint_ms at
   256^2 b3 and at 16^2, 18^2, 40x72 and 34x66 b2 (footprints that wrap or
   are ragged) with a tap and without, and the redesigned cnca_update at
   64^2 b8 and b1, 8^2 and 24x40 b2, living channel on and off, f32 and bf16,
   rates 1 and 0.5; the ConditionedNCA pair at 64^2 b8 x 24 steps with b1
   and b2 set so that a tenth of h1's and h2's pre-activations lie within
   1e-6 of zero (the guard that the update and the backward's recompute
   share their bits); the training pair at the extra_channels cell (C 13,
   12 seed channels, no conditioning) at 40x72 b2 x 4 steps (rates 1 and
   0.5, f32 and bf16) and 256^2 b2 x 16 steps, and at the edge_conditioned
   cell at 256^2 b2 x 32 steps without a conditioning cotangent, with each
   backward kernel alone at both cells' 256^2 b2 shape;
3. the serving path: ``StylizeServer`` with the edge-conditioned model at
   full width (c12/fc96, random weights from a seed) answers session, frame,
   damage, reset, stream and stats requests at 256^2 with 24 steps a frame;
   the kernel launch counts must equal frames x 24 (nca_step's chain form
   under bf16 compute). The same cell at float32 compute through
   ``VideoStylizer``: 12 frames, the tensor-core nca_step. The training path:
   ``DyNCATrainer`` with the static_texture preset at full width (c12/fc96,
   128^2, batch 4, pool 256, full VGG16 from its seeded fallback) trains four
   iterations (32, 128 and two sampled step counts); each training kernel's
   launches must equal the sum of the step counts; then the training CLI
   runs 3 iterations in a subprocess and its checkpoint must load. The
   grower path: ``InteractiveGrower`` at full width (C 20 / D 64, 64^2)
   grows 96 steps in chunks with a goal switch and a damage, 2 cnca launches
   a step. The encoder training path: ``ConditionedNCATrainer`` as the
   encoder CLI sets it up (64^2, batch 8, pool 1024, OT + content + overflow,
   steps 48-96) trains 3 iterations, each cnca kernel launched once a step;
   then the encoder CLI runs 3 epochs in a subprocess. The video_motion
   path: ``DyNCATrainer`` with the video_motion preset at full width
   (c16/fc128, pos_emb, scales (0, 1), 256^2, batch 3, pool 256, OT +
   MotionOT + overflow, VGG16 and MSOE from their seeded fallbacks, a
   synthetic 16-frame video, precomputed target features) trains at step_n
   80, 144 and one sampled with the reference's tap schedule, each
   multiscale kernel launched once a step; the CLI trains 2 iterations of
   it in a subprocess; ``VideoMotionProtocol`` runs warmup 2, calibrates,
   re-initializes and runs 1 main iteration; ``VideoStylizer`` with the
   multiscale cell stylizes 12 frames at 256^2, 24 nca_step_ms launches a
   frame. The TPU-layout entries: bench.py's cell through
   ``ROLLOUT_KERNELS[select_rollout_kernel(...)]``, the edge_conditioned
   cell through ``fused_rollout_chw`` with algo 'mat' (bf16 and f32
   compute) and with a bf16 state (24 steps each), ``fused_rollout_stream_chw`` at 1024^2, and the
   static_texture cell through ``fused_rollout_train_nhwc`` (K = 16) with a
   backward, each kernel's launches counted exactly. The conditioned
   presets: one edge_conditioned train step on the card against the CPU at
   32^2, against a target field along the step's own flow (the
   vector-field term's strength part open); ``DyNCATrainer`` with edge_conditioned at full width (c12/fc96,
   edges, 256^2, batch 2, pool 256, OT + auxiliary VGG + vector field +
   overflow, VGG16 and MSOE from their seeded fallbacks, 8 synthetic content
   frames drawn as the CLI draws them) trains at step_n 32, 128 and two
   sampled, the pair's three kernels each launched once a step and the
   tensor-core nca_step once an iteration (the vector-field pre-roll); the
   CLI trains 2 iterations of it in a subprocess; extra_channels trains 2
   iterations (the pair sees 13 channels, the pool keeps 12);
   vector_field_motion (128^2, batch 4) 2 iterations; ``VectorFieldProtocol``
   with recalibrate_every 1 runs 2 iterations, its recalibrated weight
   median(appearance log) / 50. The lifecycle at edge_conditioned's widths:
   the training CLI in a subprocess (128^2, 2 iterations, ``--save-every 1
   --make-videos --eval-videos``) writes its args, metrics, previews, the
   loss plot where matplotlib is installed, its checkpoint and its videos,
   and ``--video-only --checkpoint`` writes the same control-video frames;
   the checkpoint loads, exports to WebGL JSON and ``validate_export`` runs
   it at 256^2 x 24 steps on the card (48 nca_step launches; a
   video_motion-cell export, 48 nca_step_ms launches) within half a uint8
   step and within 1e-4 of the CPU; ``VectorFieldProtocol`` with
   ``save_every`` 1 writes its 1x and 2x videos and flow images, 770
   tensor-core nca_step launches; timed: the CLI's wall time, a
   checkpoint's write time and bytes, the control videos' frames/s and
   validate_export's device time. The multi-device paths, each in 2 gloo
   ranks sharing cuda:0 (NCCL takes one rank a card): ``DyNCATrainer(mesh=
   ...)`` at static_texture (128^2, batch 4) and edge_conditioned (256^2,
   batch 2) against one process (each rank's pair kernels sum(step_n)
   times, the first write-back within TOL, static_texture's losses and
   parameters within TRAIN_TOL), the CLI's ``--dp 1`` over NCCL and ``--dp
   2`` refused on one card; ``spatial_rollout`` of the video_motion cell
   (6-row halo) and the served edges cell (1-row halo) at 256^2 against the
   dense rollout; ``MultiStyleTrainer`` with 4 static_texture models on the
   card and 2 over a model axis of 2 ranks; every example's ``main`` at
   64^2 on the kernels; timed: the iterations, the gradient all-reduce, the
   sharded step and its halo bytes, the fleet, each example's wall time;
4. times with CUDA events (median of repeats after warm-up): kernel and plain
   ms/step at 256^2 and 512^2, stylizer frames/s, the cell-update rate of
   ``bench.py``'s primary metric; on the host clock the server's frames/s and
   latency (p50, p90) including the JPEG round trip, split into its parts;
   a ``torch.profiler`` window over stylizer frames (device busy share, time
   by kernel); each training kernel's ms per launch at 128^2 / batch 4
   beside its bound and its plain version, one static_texture iteration at
   32 and 128 steps split into its parts, training iterations/s, peak device
   memory, and a profiler window over two 128-step iterations; each cnca
   kernel's ms per launch at 64^2 b8 (and the forward's at b1) beside its
   bound and its plain version, the grower's steps/s, one 96-step encoder
   iteration split into its parts, encoder iterations/s, peak memory and a
   profiler window over one iteration; each multiscale kernel's ms per launch
   at 256^2 b3 (and nca_step_ms at the stylizer's b1 bf16) beside its bound
   and its plain version, one 144-step video_motion iteration split into its
   parts and its two loss forwards (VGG16 + OT, MSOE + MotionOT) alone,
   video_motion iterations/s, peak memory and a profiler window over one
   iteration, the multiscale stylizer's frames/s and a profiler window over
   its frames; one 128-step edge_conditioned iteration split into its
   parts, each of its loss terms' forward alone (OT appearance, auxiliary
   VGG, vector field with MSOE, overflow), its iterations/s, peak memory and
   a profiler window over one iteration, and one 128-step
   vector_field_motion iteration split into its parts; nca_step_mat (f32: tensor cores; bf16: chain) and the
   bf16-state nca_step per launch at 256^2 b1 beside nca_step, their bounds
   and plain versions, every registry
   entry per step at 256^2 and 1024^2, the segment trade-off (forward +
   backward time and added peak memory at K = 1 and 16, for static_texture
   and the video_motion pair), the benchmark harness
   (``benchmark_serving`` with 8 streams at 256^2, ``benchmark_train_step``
   for static_texture) once each; the tensor-core kernels (the step's
   tensor-core forms, nca_step at 128^2 b4 f32 and 256^2 b1 bf16, its
   bf16-state form, nca_step_ms at 256^2 b3 f32 and b1 bf16, and its chain
   forms at the training and served shapes; nca_bwd_mlp at 128^2 b4 f32,
   nca_bwd_mlp_ms at 256^2 b3 f32 and b1 bf16, cnca_bwd_mlp at 64^2 b8 and
   b1 f32) by CUDA events and by the profiler's device time, beside their
   float32 and tensor-core bounds, with ptxas' registers and spills, blocks
   an SM, and two launches checked for the same bits; the same for the
   redesigned CUDA-core kernels, nca_bwd_adjoint_ms at 256^2 b3 and
   cnca_update at 64^2 b8 and b1, beside their float32 bounds, and the
   redesigned single-scale adjoints, nca_bwd_adjoint at 128^2 b4 and
   cnca_bwd_adjoint at 64^2 b8, with their blocks and blocks an SM, beside
   row 12's library yardstick F.conv_transpose2d (cnca_bwd_adjoint's g_xg
   alone, TF32 off); the redesigned nca_step_mat (256^2 b1 edges, both
   compute types) and cnca_gate (64^2 b8 and b1) by CUDA events and device
   time, beside their bounds (nca_step_mat's float32 and tensor-core bounds
   too), with blocks an SM and ptxas' registers; VGG16's loss
   forward and backward with the equality-mask pool and with F.max_pool2d,
   in turns.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs one card; exits non-zero without
one. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core peak
H100_F32_FLOPS = 67e12  # CUDA cores
TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# the training pair's gradients, relative to the largest element of the plain
# version's: the kernel sums the weight gradients by 256-pixel block, then
# over blocks; bf16 rounds at the same places, but one float32 ulp before a
# rounding moves a value by one bf16 ulp (2^-8)
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
STEPS = 24


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def step_bound_ms(c: int, cc: int, f: int, hw: int, compute_dtype: str):
    """Least time of one step on an H100: each input read once and the output
    written once (state in and out, conditioning, weights) over the memory
    rate, against the MLP's FLOPs over the peak for the operand type."""
    p = 4 * c + cc
    n_bytes = (2 * c + cc) * hw * 4 + (p * f + f + f * c + c) * 4
    flops = 2 * hw * (p * f + f * c)
    peak = H100_BF16_FLOPS if compute_dtype == "bfloat16" else H100_F32_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def jpeg(arr01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def decode(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def post(url: str, data: bytes = b"") -> bytes:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise RuntimeError(f"POST {url}: HTTP {r.status}")
        return r.read()


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=300) as r:
        if r.status != 200:
            raise RuntimeError(f"GET {url}: HTTP {r.status}")
        return r.read()


def reset_counts(*mods):
    """Set every launch count of the wrapper modules ``mods`` to 0 (just
    before a path is driven)."""
    for m in mods:
        m.LAUNCHES = 0
        m.KERNEL_LAUNCHES.update({k: 0 for k in m.KERNEL_LAUNCHES})


def phase_compare(torch, fs, NCAConfig, dynca_init):
    """Kernel vs plain on the card; returns the largest difference seen."""
    dev = "cuda"
    worst = 0.0

    def case(name, cfg, shape, n_steps, rate, cdt, seed=7):
        nonlocal worst
        g = torch.Generator().manual_seed(1)
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device=dev)
        x = (torch.rand(shape, generator=g) - 0.5).to(dev)
        cond = None
        if cfg.conditioning:
            b, _, h, w = shape
            cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(dev)
        got = fs.fused_rollout_chw(params, x, seed, cfg, n_steps, cond, rate, cdt)
        want = fs.fused_rollout_chw_reference(params, x, seed, cfg, n_steps, cond,
                                              rate, cdt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        moved = (want - x).abs().max().item()
        ok = err <= TOL[cdt] and bool(torch.isfinite(got).all()) and moved > 0.0
        print(f"  {name:<44} max|kernel-plain| {err:.3e} tol {TOL[cdt]:.0e} "
              f"(rollout moved the state by up to {moved:.3f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel disagrees with its plain version: {name}")
        worst = max(worst, err)

    for pad in ("circular", "replicate", "zeros"):
        for cond in (None, "edges", "pos_emb"):
            cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode=pad, conditioning=cond)
            for rate in (1.0, 0.5):
                for cdt in ("float32", "bfloat16"):
                    case(f"40x72 b2 {pad} {cond} rate {rate} {cdt}", cfg,
                         (2, 12, 40, 72), 4, rate, cdt)
    served = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular",
                       conditioning="edges")
    for cdt in ("float32", "bfloat16"):
        case(f"256^2 edges circular 24 steps {cdt}", served, (1, 12, 256, 256),
             STEPS, None, cdt)
    case("512^2 edges circular 24 steps bfloat16", served, (1, 12, 512, 512),
         STEPS, None, "bfloat16")
    # the trainers' vector-field pre-roll: the extra_channels cell (C 13, a
    # percept of 52 rows, so the tensor-core form's last depth block of 16 is
    # ragged; no conditioning) and the edge_conditioned cell, at batch 2
    extra = NCAConfig(c_in=13, seed_channels=12, fc_dim=96, padding_mode="circular")
    for rate in (1.0, 0.5):
        for cdt in ("float32", "bfloat16"):
            case(f"C13 40x72 b2 circular None rate {rate} {cdt}", extra, (2, 13, 40, 72), 4,
                 rate, cdt)
    case("C13 256^2 b2 circular None 4 steps float32", extra, (2, 13, 256, 256), 4, None,
         "float32")
    case("256^2 b2 edges circular 4 steps float32", served, (2, 12, 256, 256), 4, None,
         "float32")
    return worst


def report_tc_bf16_drift(torch, fs, NCAConfig, dynca_init):
    """Why the scales-(0,) rollout under bf16 compute runs nca_step's chain
    form (fused_step.chain_form): the tensor-core form's state against the
    plain version's on phase_compare's served case (256^2 edges circular, 24
    steps, bf16), printed beside TOL['bfloat16'] and not held to it, since
    no rollout entry launches this form. Returns the difference."""
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    g = torch.Generator().manual_seed(1)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    x = (torch.rand((1, 12, 256, 256), generator=g) - 0.5).cuda()
    cond = (torch.rand((1, 3, 256, 256), generator=g) - 0.5).cuda()
    packed = fs.pack_weights(params, 12, 3, "bfloat16")
    src, dst = x, torch.empty_like(x)
    for i in range(STEPS):
        fs.launch_step(src, dst, cond, packed, "circular", "bfloat16", 7, i,
                       fs.uniform_threshold(cfg.update_rate))
        src, dst = dst, (torch.empty_like(x) if src is x else src)
    want = fs.fused_rollout_chw_reference(params, x, 7, cfg, STEPS, cond,
                                          compute_dtype="bfloat16")
    torch.cuda.synchronize()
    err = float((src - want).abs().max())
    print(f"  the tensor-core nca_step on that case, which no rollout entry launches under "
          f"bf16 compute: max|kernel-plain| {err:.3e} against TOL {TOL['bfloat16']:.0e} "
          f"(the chain form's 0: fused_step.chain_form)")
    return err


def phase_f32_stylizer(torch, fs, VideoStylizer, cfg, params):
    """VideoStylizer at float32 compute, the edge_conditioned cell at 256^2,
    12 frames of 24 steps: the path of the tensor-core scales-(0,) step.
    Returns its launches."""
    styl = VideoStylizer(params, cfg, 256, step_n=STEPS, device="cuda",
                         compute_dtype="float32")
    frames = (torch.rand((12, 1, 256, 256, 3), generator=torch.Generator().manual_seed(4))
              * 2 - 1).cuda()
    reset_counts(fs)
    rgbs = [styl.step_frame(f) for f in frames]
    torch.cuda.synchronize()
    launches = dict(fs.KERNEL_LAUNCHES)
    checks = {
        "nca_step (tensor cores) == 12 x 24, nothing else": launches["nca_step"] == 12 * STEPS
        and fs.LAUNCHES == 12 * STEPS,
        "rgb [1, 256, 256, 3] in [0, 1], state finite": all(
            tuple(r.shape) == (1, 256, 256, 3) and float(r.min()) >= 0
            and float(r.max()) <= 1 for r in rgbs) and bool(torch.isfinite(styl.state).all()),
    }
    print(f"  12 frames, {STEPS} steps a frame, float32: launches {launches}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("float32 stylizer phase failed")
    return launches["nca_step"]


def phase_stylizer_parity(torch, VideoStylizer, NCAConfig, dynca_init):
    """The whole stylizer on the card (kernel) against the stylizer on the
    CPU (plain version), float32, 64^2, 3 frames."""
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular",
                    conditioning="edges")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    frames = np.random.RandomState(3).uniform(-1, 1, (3, 1, 64, 64, 3)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        s = VideoStylizer(params, cfg, 64, step_n=STEPS, device=dev,
                          compute_dtype="float32")
        rgb = [s.step_frame(f).cpu() for f in frames]
        runs[dev] = (s.state.cpu(), torch.stack(rgb))
    err = max((a - b).abs().max().item() for a, b in zip(runs["cuda"], runs["cpu"]))
    ok = err <= 1e-4 and bool(torch.isfinite(runs["cuda"][0]).all())
    print(f"  stylizer cuda vs cpu, 3 frames x 24 steps, 64^2 f32: max diff {err:.3e} "
          f"tol 1e-04 {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("stylizer on the card disagrees with the CPU path")


def phase_serve(torch, fs, server_mod, cfg, params):
    """The served path; returns (kernel launches while it served 12 frames,
    request timings on the host clock)."""
    srv = server_mod.StylizeServer(params, cfg, port=0, default_size=256,
                                   step_n=STEPS, device="cuda").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        rng = np.random.RandomState(0)
        bodies = [jpeg(rng.rand(256, 256, 3)) for _ in range(8)]
        reset_counts(fs)
        sid = json.loads(post(f"{base}/session",
                              json.dumps({"size": 256, "step_n": STEPS}).encode()))["session"]
        outs = [post(f"{base}/frame/{sid}", b) for b in bodies]
        post(f"{base}/damage/{sid}?x=128&y=128&r=32")
        post(f"{base}/reset/{sid}")
        stream = get(f"{base}/stream/{sid}?frames=4")
        stats = json.loads(get(f"{base}/stats"))
        state = srv.sessions[sid].stylizer.state
        torch.cuda.synchronize()
        launches = fs.LAUNCHES
        frames = 8 + 4
        if fs.KERNEL_LAUNCHES["nca_step_chain"] != launches:
            raise SystemExit("the served bf16 step did not run nca_step's chain form")
        for o in outs:
            if decode(o).shape != (256, 256, 3):
                raise SystemExit("a served frame is not 256x256x3")
        parts = [p for p in stream.split(b"--vsnca") if p.strip()]
        for p in parts:
            img = p[p.index(b"\xff\xd8"):]
            if decode(img).shape != (256, 256, 3):
                raise SystemExit("a streamed frame is not 256x256x3")
        checks = {
            "launches == frames x 24": launches == frames * STEPS,
            "stream frames == 4": len(parts) == 4,
            "stats frames == 12": stats["sessions"][sid]["frames"] == frames,
            "state finite": bool(torch.isfinite(state).all()),
        }
        print(f"  session {sid}: 8 frames, damage, reset, stream of 4, stats; "
              f"launches {launches} for {frames} frames x {STEPS} steps")
        for k, v in checks.items():
            print(f"  {k}: {'ok' if v else 'FAIL'}")
        if not all(checks.values()):
            raise SystemExit("serving phase failed")

        # one client in a closed loop, JPEG round trip included (host clock,
        # after warm-up): frames/s, and latency median and p90 of 100
        # requests (10 samples lie beyond the p90). An untrained cell's state
        # grows without bound on noise frames (so does the JAX package's),
        # so the session is reset, untimed, every 24 frames.
        post(f"{base}/frame/{sid}", bodies[0])
        lat = []
        for i in range(100):
            if i % STEPS == 0:
                post(f"{base}/reset/{sid}")
            t0 = time.perf_counter()
            post(f"{base}/frame/{sid}", bodies[i % len(bodies)])
            lat.append(1e3 * (time.perf_counter() - t0))
        serve = {"fps": 1e3 * len(lat) / sum(lat),
                 "latency_ms_p50": float(np.percentile(lat, 50)),
                 "latency_ms_p90": float(np.percentile(lat, 90)),
                 "requests": len(lat)}

        # where a request's time goes: the server's own pieces, host clock
        def host_ms(fn, reps=10):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn()
                ts.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(ts), out

        sess = srv.sessions[sid]
        dec_ms, frame = host_ms(lambda: server_mod._decode_image(bodies[0], (256, 256)))
        step_ms, out = host_ms(lambda: srv._step(sess, frame))
        enc_ms, _ = host_ms(lambda: server_mod._encode_jpeg(out))
        serve.update(decode_ms=dec_ms, stylize_and_copy_ms=step_ms, encode_ms=enc_ms)
        serve["http_and_rest_ms"] = serve["latency_ms_p50"] - dec_ms - step_ms - enc_ms
        return launches, serve
    finally:
        srv.stop()


def train_bound_ms(kernel: str, c: int, cc: int, f: int, hw: int):
    """Least time of one launch of a training kernel on an H100, float32
    operands: the bytes it must move (each input read once, each output
    written once, as float32) over the memory rate, against its FLOPs over
    the float32 peak. ``nca_bwd_mlp`` reads the state, cond and gx and
    writes gp; its FLOPs a pixel are the recomputed z1 = W1^T p (2 P*F),
    the two backward products W2 gdx and W1 gz1 (2 F*C + 2 P*F) and the
    two weight-gradient products (2 P*F + 2 F*C): 2 (3 P*F + 2 F*C).
    ``nca_bwd_adjoint`` reads gp and gx and writes gx: 2 x (4 + 6 + 6 + 9)
    FLOP a pixel and channel."""
    p = 4 * c + cc
    weights = (p * f + f + f * c + c) * 4
    if kernel == "nca_bwd_mlp":
        n_bytes = (c + cc + c + 4 * c) * hw * 4 + weights
        flops = 2 * hw * (3 * p * f + 2 * f * c)
    else:
        n_bytes = (4 * c + 2 * c) * hw * 4
        flops = 2 * 25 * c * hw
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)


# (b, h, w) of the redesigned single-scale adjoints' cases: nca_bwd_adjoint
# at the static_texture shape and at 8^2 (the footprint wraps more than
# once), 18^2 and 34x66 (rows not a multiple of 4 floats: the 4-byte
# staging) and 40x72 (ragged against 32 x 16 tiles); cnca_bwd_adjoint at the
# encoder trainer's shape and at 8^2, 24x40 and 34x66 (zero padding)
SA_SHAPES = ((4, 128, 128), (2, 8, 8), (2, 18, 18), (2, 34, 66), (2, 40, 72))
CA_SHAPES = ((8, 64, 64), (2, 8, 8), (2, 24, 40), (2, 34, 66))


def check_train_pair(torch, ft, NCAConfig, dynca_init, name, cell, shape, n_steps, rate, cdt,
                     cond_no_grad=False):
    """The training pair (forward through nca_step, backward through
    nca_bwd_mlp and nca_bwd_adjoint) of the fc 96 circular cell ``cell``
    (NCAConfig fields) on random card tensors against its plain version:
    the final state within TOL, every gradient within TRAIN_TOL of the
    largest element of the plain one's. ``cond_no_grad``: the trainer's
    conditioning, which takes no cotangent. Returns the largest absolute
    difference."""
    dev = "cuda"
    cfg = NCAConfig(fc_dim=96, padding_mode="circular", **cell)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device=dev)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(shape, generator=g) - 0.5).to(dev)
    gy = torch.randn(shape, generator=g).to(dev)
    cond = None
    if cfg.conditioning:
        b, _, h, w = shape
        cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(dev)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr = x.clone().requires_grad_()
    cr = None if cond is None or cond_no_grad else cond.clone().requires_grad_()
    y = ft.fused_rollout_train(p, xr, 7, cfg, n_steps, cond if cr is None else cr, rate, cdt,
                               cond_no_grad=cond_no_grad)
    (y * gy).sum().backward()
    want_y, grads, dx0, dcond = ft.fused_rollout_train_reference(
        params, x, 7, cfg, n_steps, cond, gy, rate, cdt, need_dcond=cr is not None)
    torch.cuda.synchronize()
    pairs = {"dx0": (xr.grad, dx0), **{f"d{k}": (p[k].grad, grads[k]) for k in grads}}
    if cr is not None:
        pairs["dcond"] = (cr.grad, dcond)
    errs = {k: scaled_err(a, b) for k, (a, b) in pairs.items()}
    absd = max(float((a - b).abs().max()) for a, b in pairs.values())
    nonzero = all(float(b.abs().max()) > 0 for _, b in pairs.values())
    y_err = float((y.detach() - want_y).abs().max())
    tol = TRAIN_TOL[cdt]
    ok = max(errs.values()) <= tol and y_err <= TOL[cdt] and nonzero and \
        all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
    print(f"  {name:<40} state {y_err:.2e}; grads max|kernel-plain|/max|plain|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {tol:.0e}; all non-zero: {nonzero}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"training pair disagrees with its plain version: {name}")
    return y_err, absd


def check_backward_kernels(torch, ft, NCAConfig, dynca_init, c, cc, shape, seed=2):
    """Each backward kernel alone at one shape (c channels, cc conditioning
    channels, fc 96), against its plain version on the same inputs. Returns
    (nca_bwd_mlp's, nca_bwd_adjoint's) largest absolute difference and their
    largest difference over the plain version's largest element."""
    dev = "cuda"
    cond_kind = {0: None, 2: "pos_emb", 3: "edges"}[cc]
    cfg = NCAConfig(c_in=c, fc_dim=96, padding_mode="circular", conditioning=cond_kind)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device=dev)
    g = torch.Generator().manual_seed(seed)
    b, _, h, w = shape
    x = (torch.rand(shape, generator=g) - 0.5).to(dev)
    gx = torch.randn(shape, generator=g).to(dev)
    cond = (torch.rand((b, cc, h, w), generator=g) - 0.5).to(dev) if cc else None
    packed = ft.fs.pack_weights(params, c, cc, "float32")
    args = (packed, x, cond, gx, 5, 17, 0.5, "float32", cc > 0)
    got, want = ft.nca_bwd_mlp(*args), ft.nca_bwd_mlp_reference(*args)
    adj, adj_want = ft.nca_bwd_adjoint(want[0], gx), ft.nca_bwd_adjoint_reference(want[0], gx)
    torch.cuda.synchronize()
    pairs = [(a, b_) for a, b_ in zip(got, want) if b_ is not None]
    mlp_abs = max(float((a - b_).abs().max()) for a, b_ in pairs)
    mlp_rel = max(scaled_err(a, b_) for a, b_ in pairs)
    return (mlp_abs, float((adj - adj_want).abs().max()), mlp_rel, scaled_err(adj, adj_want))


def phase_compare_train(torch, ft, NCAConfig, dynca_init):
    """The training pair against its plain version on the same card tensors
    (``check_train_pair``); then each backward kernel alone at the
    static_texture shape. Returns the largest absolute difference of each
    kernel's outputs."""
    dev = "cuda"
    worst = {"nca_bwd_mlp": 0.0, "nca_bwd_adjoint": 0.0}

    def case(name, cond_kind, shape, n_steps, rate, cdt):
        return check_train_pair(torch, ft, NCAConfig, dynca_init, name,
                                dict(c_in=12, conditioning=cond_kind), shape, n_steps, rate, cdt)

    for cond_kind in (None, "pos_emb", "edges"):
        for rate in (1.0, 0.5):
            for cdt in ("float32", "bfloat16"):
                case(f"40x72 b2 4 steps {cond_kind} rate {rate} {cdt}", cond_kind,
                     (2, 12, 40, 72), 4, rate, cdt)
    case("128^2 b4 32 steps pos_emb rate 0.5 float32", "pos_emb", (4, 12, 128, 128),
         32, 0.5, "float32")

    # each backward kernel alone at the static_texture shape, against its
    # plain version on the same inputs
    worst["nca_bwd_mlp"], worst["nca_bwd_adjoint"], mlp_err, adj_err = check_backward_kernels(
        torch, ft, NCAConfig, dynca_init, 12, 2, (4, 12, 128, 128))
    ok = mlp_err <= TRAIN_TOL["float32"] and adj_err <= TRAIN_TOL["float32"]
    print(f"  one launch each at 128^2 b4 pos_emb f32: nca_bwd_mlp max|kernel-plain| "
          f"{worst['nca_bwd_mlp']:.3e} ({mlp_err:.2e} of max|plain|), nca_bwd_adjoint "
          f"{worst['nca_bwd_adjoint']:.3e} ({adj_err:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("a backward kernel disagrees with its plain version")

    g = torch.Generator().manual_seed(2)
    # the redesigned nca_bwd_adjoint alone at SA_SHAPES, C 12 and 5, with a
    # tap and without
    rel, n = 0.0, 0
    for b, h, w in SA_SHAPES:
        for c in (12, 5):
            gp = torch.randn((b, 4 * c, h, w), generator=g).to(dev)
            gx = torch.randn((b, c, h, w), generator=g).to(dev)
            gtap = torch.randn((b, c, h, w), generator=g).to(dev)
            for tap in (None, gtap):
                got = ft.nca_bwd_adjoint(gp, gx, tap)
                want = ft.nca_bwd_adjoint_reference(gp, gx, tap)
                torch.cuda.synchronize()
                err, r = float((got - want).abs().max()), scaled_err(got, want)
                worst["nca_bwd_adjoint"] = max(worst["nca_bwd_adjoint"], err)
                rel, n = max(rel, r), n + 1
                if not (r <= TRAIN_TOL["float32"] and bool(torch.isfinite(got).all())):
                    raise SystemExit(f"nca_bwd_adjoint disagrees with its plain version at "
                                     f"{h}x{w} b{b} C{c}, tap {tap is not None}: {r:.2e} of max")
    print(f"  nca_bwd_adjoint alone: {n} cases (128^2 b4, 8^2, 18^2, 34x66, 40x72 b2 x C 12/5 x "
          f"tap on/off): max|kernel-plain|/max|plain| {rel:.2e} (tol "
          f"{TRAIN_TOL['float32']:.0e}), max|kernel-plain| {worst['nca_bwd_adjoint']:.3e} ok")
    return worst


def phase_train_step_parity(torch, make_train_step, LossState, LossConfig, NCAConfig,
                            dynca_init, vgg16_random_init, make_optimizer):
    """One static_texture-shaped train step through the kernels against the
    same step on the CPU (eager steps), float32, 32^2, update rate 1."""
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="pos_emb",
                    update_rate=1.0)
    loss_cfg = LossConfig(overflow_weight=100.0, appearance_weight=1.0,
                          appearance_loss_type="Gram")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    vgg = vgg16_random_init(torch.Generator().manual_seed(16), device="cpu")
    g = torch.Generator().manual_seed(1)
    states = torch.rand((2, 12, 32, 32), generator=g) - 0.5
    style = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().clone().to(dev).requires_grad_() for k, v in params.items()}
        vg = [{k: v.to(dev) for k, v in d.items()} for d in vgg]
        step = make_train_step(cfg, LossState(cfg=loss_cfg, vgg_params=vg), "none", "auto")
        _, _, new_states, loss, _ = step(p, make_optimizer(p, 1e-3), states.to(dev), 4,
                                         {"target_style": style.to(dev)}, step_n=8)
        out[dev] = (float(loss), {k: v.detach().cpu() for k, v in p.items()},
                    new_states.cpu())
    (lc, pc, sc), (lg, pg, sg) = out["cpu"], out["cuda"]
    p_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    s_err = float((sg - sc).abs().max())
    ok = abs(lg - lc) <= 1e-4 * abs(lc) and p_err <= 5e-5 and s_err <= 1e-4
    print(f"  train step card vs CPU, 32^2 b2 8 steps f32: loss {lg:.6f} vs {lc:.6f}, "
          f"params max diff {p_err:.2e} (tol 5e-05), new states {s_err:.2e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the train step on the card disagrees with the CPU")


def static_texture_trainer(torch, presets, DyNCATrainer, load_vgg16, synthetic_style_image,
                           precompute_target_style_features):
    """DyNCATrainer with the static_texture preset at full width (c12/fc96,
    128^2, batch 4, pool 256), the full VGG16 (seed-16 fallback), and the
    precomputed style features of the synthetic style image."""
    nca, loss, train = presets.static_texture()
    vgg, _ = load_vgg16(device="cuda")
    trainer = DyNCATrainer(nca, loss, train, vgg_params=vgg, device="cuda")
    style = synthetic_style_image(train.img_size, train.batch_size)
    style = torch.from_numpy(style * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().cuda()
    inputs = {"target_style": style,
              "target_style_features": precompute_target_style_features(
                  vgg, style, loss.appearance_loss_type, train.img_size)}
    return trainer, inputs


def phase_train(torch, ft, fs, trainer, inputs):
    """The training path: iterations at 32 and 128 steps and two sampled
    lengths. Returns (launches by kernel, the step counts)."""
    steps = [32, 128, trainer.sample_step_n(), trainer.sample_step_n()]
    reset_counts(ft, fs)
    logs, written = [], []
    for n in steps:
        log = trainer.train_iteration(inputs, step_n=n)
        idx = trainer.last_batch_idx
        written.append(bool(torch.isfinite(trainer.pool.states[idx]).all())
                       and float(trainer.pool.states[idx].abs().max()) > 0)
        logs.append(log)
    torch.cuda.synchronize()
    launches = dict(ft.KERNEL_LAUNCHES)
    total = sum(steps)
    checks = {
        "loss finite": all(np.isfinite(l.loss) for l in logs),
        "fused_train.LAUNCHES == 3 x sum(step_n)": ft.LAUNCHES == 3 * total,
        "nca_step == nca_bwd_mlp == nca_bwd_adjoint == sum(step_n)":
            launches["nca_step"] == launches["nca_bwd_mlp"]
            == launches["nca_bwd_adjoint"] == total,
        "fused_step.LAUNCHES == nca_step_chain == sum(step_n)":
            fs.LAUNCHES == fs.KERNEL_LAUNCHES["nca_step_chain"] == total,
        "pool written back (finite, non-zero)": all(written),
    }
    for log, n in zip(logs, steps):
        terms = " ".join(f"{k}={v:.4f}" for k, v in log.logs.items())
        print(f"  iter {log.iteration} step_n {n}: loss={log.loss:.4f} {terms}")
    print(f"  launches {launches} for sum(step_n) = {total}; fused_train.LAUNCHES "
          f"{ft.LAUNCHES}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("training phase failed")
    return launches, steps


def phase_cli(load_params_pickle):
    """``python -m vsnca_tpu_torch.train.cli`` in a subprocess, 3 iterations;
    its checkpoint must load. The run's directory (the checkpoint holds the
    201 MB pool) is removed afterwards."""
    import shutil

    out = "out/chip_smoke_cli"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vsnca_tpu_torch.train.cli", "--preset", "static_texture",
         "--max-iterations", "3", "--log-every", "1", "--out", out],
        capture_output=True, text=True, timeout=600,
    )
    print("\n".join(f"    {line}" for line in r.stdout.strip().splitlines()))
    if r.returncode != 0:
        print(r.stderr[-4000:])
        raise SystemExit(f"the training CLI exited {r.returncode}")
    params = load_params_pickle(f"{out}/checkpoint", "cpu")
    shutil.rmtree(out)
    ok = set(params) == {"w1", "b1", "w2", "b2"} and tuple(params["w1"].shape) == (50, 96)
    print(f"  CLI: 3 iterations in {time.perf_counter() - t0:.1f} s (process start and "
          f"kernel load included); checkpoint loads with load_params_pickle: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the CLI's checkpoint does not load")


def time_train_iteration(torch, trainer, inputs, step_n: int, reps: int = 3, **iter_kw):
    """One training iteration (``DyNCATrainer.train_iteration``, with
    ``iter_kw``'s tap schedule when given) split with CUDA events, recorded
    by the train step's ``mark`` hook, into rollout forward, loss forward,
    loss backward, rollout backward and optimizer (median of ``reps`` after
    one warm-up). Returns ms by part."""
    runs = []
    for _ in range(reps + 1):
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        trainer.train_iteration(inputs, step_n=step_n, mark=mark, **iter_kw)
        torch.cuda.synchronize()
        names = list(events)
        runs.append({a: events[a].elapsed_time(events[b])
                     for a, b in zip(names, names[1:])})
    runs = runs[1:]
    return {n: statistics.median(r[n] for r in runs) for n in runs[0]}


def profile_frames(torch, next_frame, n_frames: int = 10, unit: str = "frame"):
    """torch.profiler over ``n_frames`` calls of ``next_frame`` (stylizer
    frames, or training iterations): device time by kernel and the device's
    busy share of the window (the profiler's own cost is inside the window,
    so the busy share is a lower bound). Returns (busy ms, window ms), or
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    next_frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            next_frame()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    from torch.autograd import DeviceType

    by_name = {}  # device-side events only (kernels, copies): no double count
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms == 0.0:
        print("  profiler: no device time recorded; busy share not measured")
        return
    print(f"  profiler, {n_frames} {unit}s: device busy {busy_ms:.3f} of {wall_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); by kernel (ms per {unit}, launches per {unit}):")
    for us, key, count in rows[:8]:
        if us > 0:
            print(f"    {us / 1e3 / n_frames:.4f} ms  {count / n_frames:g}x  {key[:70]}")
    return busy_ms, wall_ms


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (the kernels it launches, summed by
    torch.profiler over ``reps`` calls): the kernel's own time, whatever the
    host's pace of launching. CUDA events over back-to-back launches read
    the larger of the two, and a launch's host work is about a 30-50 us
    kernel's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


# --------------------------------------------------------------- ConditionedNCA

CNCA_STEPS = 96  # the grower's chunked run and the timed training iteration
# the cnca kernels against their plain versions, relative to the largest
# element: float32 1e-6 (the kernels sum the weight gradients by 128-pixel
# block, then over blocks); bfloat16 5e-3 (same rounding places, as the
# DyNCA pair's)
CNCA_TOL = {"float32": 1e-6, "bfloat16": 5e-3}


def cnca_bound_ms(kernel: str, c: int, d: int, hw: int):
    """Least time of one launch of a ConditionedNCA kernel on an H100,
    float32 operands, ``hw`` pixels over the batch: the bytes it must move
    (each input read once, each output written once) over the memory rate,
    against its FLOPs over the float32 peak. Per pixel, with P = 3C and the
    weights W = 27C + P*D + D + D*D + D + D*C floats:
    cnca_update reads x and goal, writes xn, and does the percept (2*27*C)
    and the MLP (2*(P*D + D*D + D*C)) FLOP; cnca_gate reads alpha and xn,
    writes the state and the life byte; cnca_bwd_mlp reads x, goal, life
    and g, writes g and gp (3C), and the weight gradients once, and does the
    recomputed forward plus the three transposed products and the three
    weight-gradient products (3 x the MLP) and twice the percept's taps;
    cnca_bwd_adjoint reads gp, alpha, g and dgoal and writes g and dgoal,
    2*27*C FLOP."""
    p = 3 * c
    weights = (27 * c + p * d + d + d * d + d + d * c) * 4
    mlp = 2 * (p * d + d * d + d * c)
    n_bytes, flops = {
        "cnca_update": ((3 * c) * hw * 4 + weights, hw * (mlp + 2 * 27 * c)),
        "cnca_gate": ((1 + 2 * c) * hw * 4 + hw, hw * 2 * c),
        "cnca_bwd_mlp": ((5 * c + 3 * c) * hw * 4 + hw + 2 * weights,
                         hw * (3 * mlp + 4 * 27 * c)),
        "cnca_bwd_adjoint": ((3 * c + 1 + 4 * c) * hw * 4, hw * 2 * 27 * c),
    }[kernel]
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cnca_case(torch, cn, ConditionedNCAConfig, shape, rate=0.5, use_life=True, seed=0):
    """Full-width ConditionedNCA (C 20, D 64) params, a state grown around the
    seed pixel plus noise, and a goal encoding, on the card."""
    b, h, w = shape
    cfg = ConditionedNCAConfig(image_size=w, cell_fire_rate=rate, use_living_channel=use_life)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(seed), cfg, device="cuda")
    g = torch.Generator().manual_seed(seed + 1)
    c = cfg.num_channels
    x = torch.zeros((b, c, h, w))
    x[:, cfg.alive_channel:, h // 2, w // 2] = 1.0
    x = (x + 0.3 * torch.randn((b, c, h, w), generator=g)).cuda()
    goal = (0.3 * torch.randn((b, c, h, w), generator=g)).cuda()
    return cfg, params, x, goal


def phase_compare_cnca(torch, fc, cn, ConditionedNCAConfig):
    """The ConditionedNCA kernels against their plain versions on the same
    card tensors: the rollout (cnca_update + cnca_gate) at 64^2 b1 and b8
    and 40x72 b2, rates 1 and 0.5, living channel on and off, f32 and bf16;
    the training pair's state, dx0, dgoal and weight gradients; then one
    launch of each kernel alone at the trainer's shape (64^2 b8). Returns the
    largest absolute difference of each kernel's outputs."""
    worst = {k: 0.0 for k in fc.KERNEL_LAUNCHES}
    n_cases = 0
    for shape in ((1, 64, 64), (8, 64, 64), (2, 40, 72)):
        for rate in (1.0, 0.5):
            for use_life in (True, False):
                cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, shape, rate,
                                                 use_life)
                for cdt in ("float32", "bfloat16"):
                    got = fc.fused_cnca_rollout(params, x, goal, 3, cfg, 8, cdt)
                    want = fc.fused_cnca_rollout_reference(params, x, goal, 3, cfg, 8, cdt)
                    torch.cuda.synchronize()
                    err = scaled_err(got, want)
                    ok = err <= CNCA_TOL[cdt] and bool(torch.isfinite(got).all())
                    n_cases += 1
                    if not ok:
                        print(f"  rollout {shape} rate {rate} living {use_life} {cdt}: "
                              f"max|kernel-plain|/max|plain| {err:.2e} FAIL")
                        raise SystemExit("cnca rollout kernels disagree with their plain version")
    print(f"  rollout, 8 steps: {n_cases} cases (64^2 b1, 64^2 b8, 40x72 b2 x rate 1/0.5 x "
          f"living on/off x f32/bf16) within tol (f32 {CNCA_TOL['float32']:.0e}, bf16 "
          f"{CNCA_TOL['bfloat16']:.0e} of max|plain|) ok")

    def pair_case(name, shape, rate, use_life, cdt, n_steps):
        cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, shape, rate, use_life)
        gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).cuda()
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr, gr = x.clone().requires_grad_(), goal.clone().requires_grad_()
        y = fc.fused_cnca_train(p, xr, gr, 9, cfg, n_steps, cdt)
        (y * gy).sum().backward()
        want_y, grads, dx0, dgoal = fc.fused_cnca_train_reference(params, x, goal, 9, cfg,
                                                                  n_steps, gy, cdt)
        torch.cuda.synchronize()
        pairs = {"state": (y.detach(), want_y), "dx0": (xr.grad, dx0), "dgoal": (gr.grad, dgoal),
                 **{f"d{k}": (p[k].grad, grads[k]) for k in fc.WEIGHT_KEYS}}
        errs = {k: scaled_err(a, b) for k, (a, b) in pairs.items()}
        nonzero = all(float(b.abs().max()) > 0 for _, b in pairs.values())
        ok = max(errs.values()) <= CNCA_TOL[cdt] and nonzero and all(
            bool(torch.isfinite(a).all()) for a, _ in pairs.values())
        print(f"  pair {name:<34} max|kernel-plain|/max|plain|: "
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
              + f" (tol {CNCA_TOL[cdt]:.0e}; all non-zero: {nonzero}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"cnca training pair disagrees with its plain version: {name}")

    pair_case("64^2 b8 24 steps rate 0.5 f32", (8, 64, 64), 0.5, True, "float32", 24)
    for rate in (1.0, 0.5):
        for use_life in (True, False):
            for cdt in ("float32", "bfloat16"):
                pair_case(f"40x72 b2 6 steps rate {rate} living {use_life} "
                          f"{cdt[:4]}", (2, 40, 72), rate, use_life, cdt, 6)

    # each kernel alone at the trainer's shape, on the same inputs as its
    # plain version
    cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, (8, 64, 64))
    packed = fc.pack_weights(params, cfg, "float32")
    thr = fc.fs.uniform_threshold(0.5)
    xn = torch.empty_like(x)
    fc.launch_update(x, goal, xn, packed, cfg, "float32", 3, 5, thr)
    xn_want = fc.cnca_update_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5)
    out = torch.empty_like(x)
    life = torch.empty((8, 64, 64), dtype=torch.uint8, device="cuda")
    fc.launch_gate(x, xn_want, out, life, cfg)
    out_want, life_want = fc.cnca_gate_reference(x, xn_want, cfg)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).cuda()
    args = (packed, x, goal, life_want, gy, cfg, "float32", 3, 5, 0.5)
    got_b, want_b = fc.cnca_bwd_mlp(*args), fc.cnca_bwd_mlp_reference(*args)
    adj = fc.cnca_bwd_adjoint(x, want_b[1], want_b[0], packed[0], cfg)
    adj_want = fc.cnca_bwd_adjoint_reference(x, want_b[1], want_b[0], packed[0], cfg)
    torch.cuda.synchronize()
    flat = lambda r: [r[0], r[1], *r[2]]  # noqa: E731
    cmp = {
        "cnca_update": [(xn, xn_want)],
        "cnca_gate": [(out, out_want), (life.float(), life_want.float())],
        "cnca_bwd_mlp": list(zip(flat(got_b), flat(want_b))),
        "cnca_bwd_adjoint": list(zip(adj, adj_want)),
    }
    ok = True
    for name, pairs in cmp.items():
        worst[name] = max(float((a - b).abs().max()) for a, b in pairs)
        rel = max(scaled_err(a, b) for a, b in pairs)
        ok = ok and rel <= CNCA_TOL["float32"]
        print(f"  one {name} launch at 64^2 b8 f32: max|kernel-plain| {worst[name]:.3e} "
              f"({rel:.2e} of max|plain|)")
    if not ok:
        raise SystemExit("a cnca kernel disagrees with its plain version")

    # the redesigned cnca_bwd_adjoint alone at CA_SHAPES, C 20 and 7 (a
    # channel pair's tail), living channel on (a sparse alpha plane, so that
    # the mask has holes) and off
    rel, n = 0.0, 0
    for b, h, w in CA_SHAPES:
        for hidden in (16, 3):
            for use_life in (True, False):
                cfg = ConditionedNCAConfig(image_size=w, num_hidden_channels=hidden,
                                           use_living_channel=use_life)
                c = cfg.num_channels
                params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg,
                                                 device="cuda")
                g = torch.Generator().manual_seed(h + c)
                x = torch.randn((b, c, h, w), generator=g) * 0.3
                x[:, cfg.alive_channel] *= 0.15
                x = x.cuda()
                gp = torch.randn((b, 3 * c, h, w), generator=g).cuda()
                g_xn = torch.randn((b, c, h, w), generator=g).cuda()
                wcol = fc.pack_weights(params, cfg, "float32")[0]
                got = fc.cnca_bwd_adjoint(x, gp, g_xn, wcol, cfg)
                want = fc.cnca_bwd_adjoint_reference(x, gp, g_xn, wcol, cfg)
                torch.cuda.synchronize()
                err = max(float((a - r).abs().max()) for a, r in zip(got, want))
                rc = max(scaled_err(a, r) for a, r in zip(got, want))
                worst["cnca_bwd_adjoint"] = max(worst["cnca_bwd_adjoint"], err)
                rel, n = max(rel, rc), n + 1
                if not (rc <= CNCA_TOL["float32"]
                        and all(bool(torch.isfinite(a).all()) for a in got)):
                    raise SystemExit(f"cnca_bwd_adjoint disagrees with its plain version at "
                                     f"{h}x{w} b{b} C{c} living {use_life}: {rc:.2e} of max")
    print(f"  cnca_bwd_adjoint alone: {n} cases (64^2 b8, 8^2, 24x40, 34x66 b2 x C 20/7 x "
          f"living on/off): max|kernel-plain|/max|plain| {rel:.2e} (tol "
          f"{CNCA_TOL['float32']:.0e}), max|kernel-plain| {worst['cnca_bwd_adjoint']:.3e} ok")
    return worst


def phase_grower(torch, fc, cn, InteractiveGrower, ConditionedNCAConfig):
    """InteractiveGrower at full width, 64^2: 96 steps in chunks of 1, 7, 24,
    24 and 40, a goal switch after the second chunk and a damage after the
    third; every step through the rollout kernels (2 launches a step)."""
    cfg = ConditionedNCAConfig()
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    rng = np.random.RandomState(0)
    goals = rng.rand(2, 1, 64, 64, 3).astype(np.float32)
    grower = InteractiveGrower(params, cfg, goals[0], device="cuda")
    reset_counts(fc)
    chunks = [1, 7, 24, 24, 40]
    rgbs = []
    for i, n in enumerate(chunks):
        rgbs.append(grower.step(n))
        if i == 1:
            grower.set_goal(goals[1])
        if i == 2:  # off the centre, where an untrained cell's small blob grows
            grower.damage(16, 16, 6)
            if float(grower.state[0, :, 16, 16].abs().max()) != 0.0:
                raise SystemExit("damage left the patch alive")
    torch.cuda.synchronize()
    launches = dict(fc.KERNEL_LAUNCHES)
    checks = {
        "cnca_update == cnca_gate == 96": launches["cnca_update"] == launches["cnca_gate"]
        == sum(chunks),
        "no backward launches": launches["cnca_bwd_mlp"] == launches["cnca_bwd_adjoint"] == 0,
        "state finite": bool(torch.isfinite(grower.state).all()),
        "rgb [64, 64, 3] in [0, 1]": all(r.shape == (64, 64, 3) and r.min() >= 0 and r.max() <= 1
                                         for r in rgbs),
    }
    alive = float((grower.state[0, cfg.alive_channel] > cfg.alpha_living_threshold).float().mean())
    print(f"  chunks {chunks}, goal switch, damage at (16, 16) r 6; launches {launches}; "
          f"alive share {alive:.3f}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("grower phase failed")
    return launches, grower


def encoder_trainer(torch, ConditionedNCATrainer, ConditioningDataset, ConditionedNCAConfig,
                    load_vgg16, synthetic_style_image, synthetic_video):
    """ConditionedNCATrainer as the encoder CLI sets it up, at full width:
    C 20 / D 64, 64^2, batch 8, pool 1024, steps 48-96 bucketed, OT + VGG16
    content x 0.1 + overflow, the synthetic goal video and style image, the
    full VGG16 from its seeded fallback."""
    dataset = ConditioningDataset((synthetic_video((64, 64), 8) + 1.0) / 2.0, "cuda")
    style = torch.from_numpy(synthetic_style_image((64, 64), 1)).permute(0, 3, 1, 2)
    vgg, _ = load_vgg16(device="cuda")
    return ConditionedNCATrainer(ConditionedNCAConfig(), dataset, style.contiguous().cuda(), vgg,
                                 pool_size=1024, content_weight=0.1, device="cuda")


def phase_encoder_train(torch, fc, trainer):
    """Three iterations at sampled step counts (each trains its batch twice):
    finite losses, and each cnca kernel launched once a step."""
    drawn = []
    sample = trainer.sample_num_steps

    def recording():
        drawn.append(sample())
        return drawn[-1]

    trainer.sample_num_steps = recording
    reset_counts(fc)
    logs = [trainer.train_iteration(batch_size=8) for _ in range(3)]
    torch.cuda.synchronize()
    trainer.sample_num_steps = sample
    launches = dict(fc.KERNEL_LAUNCHES)
    total = sum(drawn)
    checks = {
        "losses finite": all(np.isfinite(l) for l, _ in logs),
        "every cnca kernel == sum(step counts)": set(launches.values()) == {total},
        "pool finite": bool(torch.isfinite(trainer.pool_states).all()),
    }
    for i, (loss, m) in enumerate(logs):
        print(f"  iteration {i}: loss={loss:.4f} "
              + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    print(f"  step counts {drawn}; launches {launches}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("encoder training phase failed")
    return launches, drawn


def phase_encoder_cli(load_params_pickle):
    """``python -m vsnca_tpu_torch.train.encoder_cli`` at its defaults (full
    width, 64^2, batch 8, pool 1024, OT) for 3 epochs; the checkpoint must
    load. The run's directory is removed afterwards."""
    import shutil

    out = "out/chip_smoke_encoder_cli"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vsnca_tpu_torch.train.encoder_cli", "--epochs", "3",
         "--log-every", "1", "--out", out],
        capture_output=True, text=True, timeout=600,
    )
    print("\n".join(f"    {line}" for line in r.stdout.strip().splitlines()))
    if r.returncode != 0:
        print(r.stderr[-4000:])
        raise SystemExit(f"the encoder CLI exited {r.returncode}")
    params = load_params_pickle(f"{out}/checkpoint", "cpu")
    shutil.rmtree(out)
    ok = tuple(params["update1.w"].shape) == (60, 64) and len(params) == 9
    print(f"  encoder CLI: 3 epochs in {time.perf_counter() - t0:.1f} s (process start "
          f"included); checkpoint loads with load_params_pickle: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the encoder CLI's checkpoint does not load")


def time_encoder_iteration(torch, trainer, num_steps: int, reps: int = 2):
    """One encoder iteration (two train steps) split with CUDA events from
    the trainer's ``mark`` hook: each part summed over the two steps, median
    of ``reps`` after one warm-up."""
    runs = []
    for _ in range(reps + 1):
        events = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

        trainer.train_iteration(batch_size=8, num_steps=num_steps, mark=mark)
        torch.cuda.synchronize()
        parts = {}
        for (a, ea), (_, eb) in zip(events, events[1:]):
            if a != "end":
                parts[a] = parts.get(a, 0.0) + ea.elapsed_time(eb)
        runs.append(parts)
    runs = runs[1:]
    return {n: statistics.median(r[n] for r in runs) for n in runs[0]}


def time_cnca(torch, fc, cn, ConditionedNCAConfig, grower):
    """Each cnca kernel's ms per launch at the trainer's shape (64^2 b8,
    f32) beside its bound and its plain version; the update and the gate at
    the grower's b1 too; the grower's steps/s."""
    out = {}
    for b in (8, 1):
        cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, (b, 64, 64))
        packed = fc.pack_weights(params, cfg, "float32")
        thr = fc.fs.uniform_threshold(0.5)
        xn, y = torch.empty_like(x), torch.empty_like(x)
        life = torch.empty((b, 64, 64), dtype=torch.uint8, device="cuda")
        xn_ref = fc.cnca_update_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5)
        _, life_ref = fc.cnca_gate_reference(x, xn_ref, cfg)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).cuda()
        gp = torch.empty((b, 60, 64, 64), device="cuda")
        slots = fc._zero_slots(b, 64, 64, packed)
        dgoal = torch.zeros_like(x)
        _, gp_ref = fc.cnca_bwd_mlp_reference(packed, x, goal, life_ref, g, cfg, "float32",
                                              3, 5, 0.5)[:2]
        runs = {
            "cnca_update": (lambda: fc.launch_update(x, goal, xn, packed, cfg, "float32", 3, 5,
                                                     thr),
                            lambda: fc.cnca_update_reference(x, goal, packed, cfg, "float32",
                                                             3, 5, 0.5)),
            "cnca_gate": (lambda: fc.launch_gate(x, xn_ref, y, life, cfg),
                          lambda: fc.cnca_gate_reference(x, xn_ref, cfg)),
        }
        if b == 8:
            runs["cnca_bwd_mlp"] = (
                lambda: fc._launch_bwd_mlp(x, goal, life_ref, g, gp, slots, packed, cfg,
                                           "float32", 3, 5, thr),
                lambda: fc.cnca_bwd_mlp_reference(packed, x, goal, life_ref, g, cfg, "float32",
                                                  3, 5, 0.5))
            runs["cnca_bwd_adjoint"] = (
                lambda: fc._launch_bwd_adjoint(x, gp_ref, packed[0], g, dgoal, cfg),
                lambda: fc.cnca_bwd_adjoint_reference(x, gp_ref, g, packed[0], cfg))
        for name, (kern, plain) in runs.items():
            bound, by = cnca_bound_ms(name, 20, 64, b * 64 * 64)
            k_ms, p_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
            out[(name, b)] = (k_ms, p_ms, bound, by)
            print(f"  {name} 64^2 b{b} f32: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, "
                  f"bound {bound:.5f} ms ({by}); {k_ms / bound:.1f}x the bound")
    grower.reset()
    chunk_ms = cuda_ms(lambda: grower.step(CNCA_STEPS), 1, rounds=3)
    steps_per_s = 1e3 * CNCA_STEPS / chunk_ms
    print(f"  grower 64^2 b1, {CNCA_STEPS}-step chunks: {chunk_ms:.3f} ms a chunk = "
          f"{steps_per_s:.0f} steps/s (host readout of each chunk's RGB included)")
    return out, steps_per_s


# ------------------------------------------- video_motion: multiscale kernels

# the multiscale kernels' states against their plain versions, float32,
# relative to the largest element
MS_STATE_TOL = 1e-6
VM_SIZE = 256  # the video_motion preset's frame size
# FLOPs a pixel and channel beyond the scale-0 step: the percept's half state
# and half-resolution stencils (2x2 mean 4, three stencils 42, over the 4
# pixels of a half pixel) and the upsample and average of its 4 blocks (4 x
# 11); the adjoint's transposed upsample over W and H of 4 blocks (56) and
# half-resolution stencil adjoint (50), over 4 pixels, plus the scale-0
# adjoint (50) and the average (3)
MS_PERCEPT_FLOP = (4 + 42) / 4 + 4 * 11
MS_ADJ_FLOP = (56 + 50) / 4 + 50 + 3


def ms_bound_ms(kernel: str, c: int, cc: int, f: int, hw: int, compute_dtype="float32"):
    """Least time of one launch of a multiscale kernel on an H100, ``hw``
    pixels over the batch: the bytes it must move (each input read once,
    each output written once, float32) over the memory rate, against its
    FLOPs over the peak for the operand type. nca_step_ms reads the state,
    cond and weights and writes the state: the scale-0 step's MLP
    (2 (P*F + F*C) a pixel) plus MS_PERCEPT_FLOP a pixel and channel;
    nca_bwd_mlp_ms moves what nca_bwd_mlp does and adds the same percept
    recompute to its 2 (3 P*F + 2 F*C); nca_bwd_adjoint_ms reads gp (4C)
    and gx and writes gx, MS_ADJ_FLOP a pixel and channel."""
    p = 4 * c + cc
    weights = (p * f + f + f * c + c) * 4
    if kernel == "nca_step_ms":
        n_bytes = (2 * c + cc) * hw * 4 + weights
        flops = 2 * hw * (p * f + f * c) + MS_PERCEPT_FLOP * c * hw
    elif kernel == "nca_bwd_mlp_ms":
        n_bytes = (c + cc + c + 4 * c) * hw * 4 + weights
        flops = 2 * hw * (3 * p * f + 2 * f * c) + MS_PERCEPT_FLOP * c * hw
    else:
        n_bytes = 6 * c * hw * 4
        flops = MS_ADJ_FLOP * c * hw
    peak = H100_BF16_FLOPS if compute_dtype == "bfloat16" else H100_F32_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ms_cfg(NCAConfig, pad="circular", conditioning="pos_emb", rate=0.5, scales=(0, 1)):
    """The video_motion preset's cell (c16/fc128) under other settings."""
    return NCAConfig(c_in=16, fc_dim=128, padding_mode=pad, conditioning=conditioning,
                     perception_scales=scales, update_rate=rate)


def ms_inputs(torch, cfg, dynca_init, shape, seed=0):
    params = dynca_init(torch.Generator().manual_seed(seed), cfg, device="cuda")
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.rand(shape, generator=g) - 0.5).cuda()
    cond = None
    if cfg.conditioning:
        b, _, h, w = shape
        cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).cuda()
    return params, x, cond


def phase_compare_ms(torch, fs, NCAConfig, dynca_init):
    """nca_step_ms against its plain version: 40x72 b2 (ragged, even) under
    the three padding modes, with and without pos_emb, rates 1 and 0.5, f32
    and bf16, 4 steps; then 256^2 b3 pos_emb, 24 steps, f32 and bf16. f32
    states within MS_STATE_TOL of the largest element, bf16 within
    TOL["bfloat16"]. Returns the largest absolute difference."""
    worst, n_cases, rows = 0.0, 0, []

    def case(cfg, shape, n_steps, cdt):
        nonlocal worst, n_cases
        params, x, cond = ms_inputs(torch, cfg, dynca_init, shape)
        before = fs.KERNEL_LAUNCHES["nca_step_ms"]
        got = fs.fused_rollout_chw(params, x, 7, cfg, n_steps, cond, None, cdt)
        launched = fs.KERNEL_LAUNCHES["nca_step_ms"] - before
        want = fs.fused_rollout_chw_reference(params, x, 7, cfg, n_steps, cond, None, cdt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = scaled_err(got, want)
        ok = (rel <= MS_STATE_TOL if cdt == "float32" else err <= TOL[cdt]) and \
            bool(torch.isfinite(got).all()) and launched == n_steps and \
            float((want - x).abs().max()) > 0
        n_cases += 1
        worst = max(worst, err)
        return ok, err, rel

    for pad in ("circular", "replicate", "zeros"):
        for cond in (None, "pos_emb"):
            for rate in (1.0, 0.5):
                for cdt in ("float32", "bfloat16"):
                    ok, err, rel = case(ms_cfg(NCAConfig, pad, cond, rate), (2, 16, 40, 72), 4,
                                        cdt)
                    rows.append((cdt, rel, err))
                    if not ok:
                        raise SystemExit(f"nca_step_ms disagrees with its plain version: 40x72 "
                                         f"{pad} {cond} rate {rate} {cdt}: {err:.3e} ({rel:.2e})")
    f32 = max(r[1] for r in rows if r[0] == "float32")
    bf = max(r[2] for r in rows if r[0] == "bfloat16")
    print(f"  nca_step_ms 40x72 b2 c16/fc128, 4 steps: {n_cases} cases (3 paddings x pos_emb "
          f"on/off x rate 1/0.5 x f32/bf16): f32 max|kernel-plain|/max|plain| {f32:.2e} (tol "
          f"{MS_STATE_TOL:.0e}), bf16 max|kernel-plain| {bf:.2e} (tol {TOL['bfloat16']:.0e}) ok")
    for cdt in ("float32", "bfloat16"):
        ok, err, rel = case(ms_cfg(NCAConfig), (3, 16, VM_SIZE, VM_SIZE), STEPS, cdt)
        print(f"  nca_step_ms {VM_SIZE}^2 b3 pos_emb rate 0.5, {STEPS} steps {cdt}: "
              f"max|kernel-plain| {err:.3e} ({rel:.2e} of max|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("nca_step_ms disagrees with its plain version at 256^2")
    return worst


def phase_compare_chain(torch, fs, NCAConfig, dynca_init):
    """The chain form of the step (the training pair's forward: float32 FMAs
    in the plain version's order) against the plain step, 8 steps at rate
    0.5, f32 and bf16: static_texture's cell at 128^2 b4 and video_motion's
    at 256^2 b3. Within TOL (f32) and TOL["bfloat16"]; the count of
    bit-identical cases is printed. Returns the largest difference of
    each form."""
    worst = {"nca_step_chain": 0.0, "nca_step_ms_chain": 0.0}
    same = 0
    for name, c, f, shape in (("nca_step_chain", 12, 96, (4, 12, 128, 128)),
                              ("nca_step_ms_chain", 16, 128, (3, 16, VM_SIZE, VM_SIZE))):
        ms = name == "nca_step_ms_chain"
        cfg = ms_cfg(NCAConfig, scales=(0, 1) if ms else (0,))
        cfg = dataclasses.replace(cfg, c_in=c, fc_dim=f)
        params, x, cond = ms_inputs(torch, cfg, dynca_init, shape)
        for cdt in ("float32", "bfloat16"):
            packed = fs.pack_weights(params, c, 2, cdt)
            src, got, want = x, torch.empty_like(x), x
            before = fs.KERNEL_LAUNCHES[name]
            for step in range(8):
                fs.launch_step(src, got, cond, packed, "circular", cdt, 7, step,
                               fs.uniform_threshold(0.5), ms, chain=True)
                want = fs.reference_step(want, cond, packed, "circular", cdt, 7, step, 0.5, ms)
                src, got = got, torch.empty_like(x)
            torch.cuda.synchronize()
            err = float((src - want).abs().max())
            same += int(err == 0.0)
            worst[name] = max(worst[name], err)
            ok = (err <= TOL[cdt] and fs.KERNEL_LAUNCHES[name] - before == 8
                  and bool(torch.isfinite(src).all()))
            if not ok:
                raise SystemExit(f"{name} {cdt} disagrees with the plain step: {err:.3e}")
    print(f"  the chain form (the training forward) against the plain step, 8 steps, 128^2 "
          f"b4 c12/fc96 and 256^2 b3 c16/fc128 scales (0, 1), f32 and bf16: max|kernel-plain| "
          f"{worst} (tol {TOL['float32']:.0e} f32, {TOL['bfloat16']:.0e} bf16); bit-identical "
          f"{same} of 4 ok")
    return worst


def phase_compare_ms_train(torch, ft, NCAConfig, dynca_init):
    """The multiscale pair (nca_step_ms forward, nca_bwd_mlp_ms and
    nca_bwd_adjoint_ms backward) against its plain version: states, dx0,
    dcond and weight gradients at 40x72 b2 (pos_emb on/off, rates 1 and
    0.5, f32 and bf16) and at 256^2 b3 x 16 steps; the tapped pair at
    scales (0,) and (0, 1); each multiscale backward kernel alone at
    256^2 b3. Returns the largest absolute difference of each backward
    kernel's outputs."""
    worst = {"nca_bwd_mlp_ms": 0.0, "nca_bwd_adjoint_ms": 0.0}

    def case(name, cfg, shape, n_steps, cdt, taps=()):
        params, x, cond = ms_inputs(torch, cfg, dynca_init, shape)
        g = torch.Generator().manual_seed(5)
        gy = torch.randn(shape, generator=g).cuda()
        gt = [torch.randn(shape, generator=g).cuda() for _ in taps]
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr = x.clone().requires_grad_()
        cr = None if cond is None else cond.clone().requires_grad_()
        before = ft.LAUNCHES
        out = ft.fused_rollout_train(p, xr, 7, cfg, n_steps, cr, None, cdt, tap_steps=taps)
        y, ys = (out[0], out[1]) if taps else (out, [])
        ((y * gy).sum() + sum((a * b).sum() for a, b in zip(ys, gt))).backward()
        launched = ft.LAUNCHES - before
        ref = ft.fused_rollout_train_reference(params, x, 7, cfg, n_steps, cond, gy, None, cdt,
                                               need_dcond=cond is not None, tap_steps=taps,
                                               gtaps=gt)
        want_y, want_taps, grads, dx0, dcond = ref if taps else (ref[0], [], *ref[1:])
        torch.cuda.synchronize()
        pairs = {"dx0": (xr.grad, dx0), **{f"d{k}": (p[k].grad, grads[k]) for k in grads}}
        if cond is not None:
            pairs["dcond"] = (cr.grad, dcond)
        errs = {k: scaled_err(a, b) for k, (a, b) in pairs.items()}
        states = [(y.detach(), want_y)] + [(a.detach(), b) for a, b in zip(ys, want_taps)]
        y_err = max(scaled_err(a, b) for a, b in states)
        y_tol = MS_STATE_TOL if cdt == "float32" else TRAIN_TOL[cdt]
        nonzero = all(float(b.abs().max()) > 0 for _, b in pairs.values())
        ok = max(errs.values()) <= TRAIN_TOL[cdt] and y_err <= y_tol and nonzero and \
            launched == 3 * n_steps and all(bool(torch.isfinite(a).all()) for a, _ in
                                            pairs.values())
        print(f"  {name:<42} states {y_err:.2e} of max; grads max|kernel-plain|/max|plain|: "
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
              + f" (tol {TRAIN_TOL[cdt]:.0e}; launches {launched}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"multiscale training pair disagrees with its plain version: {name}")

    for cond in (None, "pos_emb"):
        for rate in (1.0, 0.5):
            for cdt in ("float32", "bfloat16"):
                case(f"ms 40x72 b2 4 steps {cond} rate {rate} {cdt[:4]}",
                     ms_cfg(NCAConfig, conditioning=cond, rate=rate), (2, 16, 40, 72), 4, cdt)
    case(f"ms {VM_SIZE}^2 b3 16 steps pos_emb rate 0.5 f32", ms_cfg(NCAConfig),
         (3, 16, VM_SIZE, VM_SIZE), 16, "float32")
    for scales in ((0,), (0, 1)):
        case(f"tapped {scales} 40x72 b2 6 steps, taps 1 and 4", ms_cfg(NCAConfig, scales=scales),
             (2, 16, 40, 72), 6, "float32", taps=(1, 4))

    # each multiscale backward kernel alone at the video_motion shape
    cfg = ms_cfg(NCAConfig)
    params, x, cond = ms_inputs(torch, cfg, dynca_init, (3, 16, VM_SIZE, VM_SIZE), seed=2)
    g = torch.Generator().manual_seed(6)
    gx = torch.randn(x.shape, generator=g).cuda()
    gtap = torch.randn(x.shape, generator=g).cuda()
    packed = ft.fs.pack_weights(params, 16, 2, "float32")
    args = (packed, x, cond, gx, 5, 17, 0.5, "float32", True, True)
    got, want = ft.nca_bwd_mlp(*args), ft.nca_bwd_mlp_reference(*args)
    adj = ft.nca_bwd_adjoint(want[0], gx, gtap, True)
    adj_want = ft.nca_bwd_adjoint_reference(want[0], gx, gtap, True)
    torch.cuda.synchronize()
    mlp_err = max(scaled_err(a, b) for a, b in zip(got, want))
    adj_err = scaled_err(adj, adj_want)
    worst["nca_bwd_mlp_ms"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    worst["nca_bwd_adjoint_ms"] = float((adj - adj_want).abs().max())
    ok = mlp_err <= TRAIN_TOL["float32"] and adj_err <= MS_STATE_TOL
    print(f"  one launch each at {VM_SIZE}^2 b3 pos_emb f32: nca_bwd_mlp_ms max|kernel-plain| "
          f"{worst['nca_bwd_mlp_ms']:.3e} ({mlp_err:.2e} of max|plain|), nca_bwd_adjoint_ms "
          f"with a tap {worst['nca_bwd_adjoint_ms']:.3e} ({adj_err:.2e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("a multiscale backward kernel disagrees with its plain version")
    return worst


def vm_iteration(inputs, motion_feats, step_n: int, rng):
    """(inputs, train_iteration keywords) of one video_motion iteration as
    the CLI plans it: the reference's tap schedule for ``step_n`` (a frame
    after steps 1, 65, ...) and a window of the precomputed motion features
    from ``rng``."""
    from vsnca_tpu_torch.models.dynca import tap_schedule

    chunks, tail = tap_schedule(step_n, 64)
    nf = len(chunks)
    start = rng.randint(0, max(motion_feats.shape[0] + 1 - nf, 1))
    return ({**inputs, "target_motion_features": motion_feats[start:start + nf - 1]},
            dict(step_n=step_n, tap_chunks=chunks, tail_steps=tail))


def phase_vm_step_parity(torch, make_train_step, LossState, presets, dynca_init,
                         vgg16_random_init, msoe_random_init, make_optimizer, tap_schedule,
                         precompute_target_motion_features):
    """One video_motion train step on the card (the multiscale pair with
    in-kernel taps) against the same step on the CPU (eager steps a chunk):
    the preset's cell and losses at 32^2 (OT and MotionOT, nothing
    subsampled), batch 2, step_n 9 tapped every 4 steps, update rate 1,
    float32."""
    import dataclasses

    nca, loss_cfg, _ = presets.video_motion(32)
    cfg = dataclasses.replace(nca, update_rate=1.0)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    vgg = vgg16_random_init(torch.Generator().manual_seed(16), device="cpu")
    msoe = msoe_random_init(torch.Generator().manual_seed(175), device="cpu")
    g = torch.Generator().manual_seed(1)
    states = torch.rand((2, 16, 32, 32), generator=g) - 0.5
    style = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    video = torch.rand((4, 3, 32, 32), generator=g) * 2 - 1
    chunks, tail = tap_schedule(9, 4)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().clone().to(dev).requires_grad_() for k, v in params.items()}
        vg = [{k: v.to(dev) for k, v in d.items()} for d in vgg]
        ms = {k: v.to(dev) for k, v in msoe.items()}
        feats = precompute_target_motion_features(ms, video.to(dev), (32, 32))
        step = make_train_step(cfg, LossState(cfg=loss_cfg, vgg_params=vg, msoe_params=ms),
                               "none", "auto")
        _, _, new_states, loss, logs = step(
            p, make_optimizer(p, 1e-3), states.to(dev), 4,
            {"target_style": style.to(dev), "target_motion_features": feats[:len(chunks) - 1]},
            step_n=9, tap_chunks=chunks, tail_steps=tail)
        out[dev] = (float(loss), {k: float(v) for k, v in logs.items()},
                    {k: v.detach().cpu() for k, v in p.items()}, new_states.cpu())
    (lc, gc, pc, sc), (lg, gg, pg, sg) = out["cpu"], out["cuda"]
    p_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    s_err = float((sg - sc).abs().max())
    log_err = max(abs(gg[k] - gc[k]) / abs(gc[k]) for k in gc)
    ok = abs(lg - lc) <= 1e-4 * abs(lc) and log_err <= 1e-4 and p_err <= 5e-5 and s_err <= 1e-4
    print(f"  video_motion train step card vs CPU, 32^2 b2 c16/fc128 ms, step_n 9 tapped "
          f"{chunks}: loss {lg:.6f} vs {lc:.6f} (terms {sorted(gc)} within {log_err:.1e}), "
          f"params max diff {p_err:.2e} (tol 5e-05), new states {s_err:.2e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the video_motion train step on the card disagrees with the CPU")


def video_motion_trainer(torch, presets, DyNCATrainer, load_vgg16, load_msoe,
                         synthetic_style_image, synthetic_video,
                         precompute_target_style_features, precompute_target_motion_features):
    """DyNCATrainer with the video_motion preset at full width (c16/fc128,
    pos_emb, circular, scales (0, 1), 256^2, batch 3, pool 256, OT +
    MotionOT x 5 + overflow), the full VGG16 and MSOE from their seeded
    fallbacks, the synthetic style image and 16-frame video, and the
    target's VGG16 and MSOE features precomputed as the CLI does."""
    nca, loss, train = presets.video_motion()
    vgg, _ = load_vgg16(device="cuda")
    msoe, _ = load_msoe(device="cuda")
    trainer = DyNCATrainer(nca, loss, train, vgg_params=vgg, msoe_params=msoe, device="cuda")
    hw = train.img_size
    style = synthetic_style_image(hw, train.batch_size)
    style = torch.from_numpy(style * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().cuda()
    video = torch.from_numpy(synthetic_video(hw, 16)).permute(0, 3, 1, 2).contiguous().cuda()
    t0 = time.perf_counter()
    inputs = {"target_style": style,
              "target_style_features": precompute_target_style_features(
                  vgg, style, loss.appearance_loss_type, hw)}
    motion_feats = precompute_target_motion_features(msoe, video, loss.motion_img_size)
    torch.cuda.synchronize()
    print(f"  target features: VGG16 of the style batch and MSOE of the video's "
          f"{motion_feats.shape[0]} pairs {tuple(motion_feats.shape[1:])} in "
          f"{time.perf_counter() - t0:.2f} s")
    return trainer, inputs, motion_feats, (vgg, msoe, style, video)


def phase_vm_train(torch, ft, fs, trainer, inputs, motion_feats):
    """The video_motion training path: iterations at step_n 80, 144 and one
    sampled (at least 65), each with the reference's tap schedule, through
    the multiscale pair with in-kernel taps. Returns (launches by kernel,
    the step counts)."""
    rng = np.random.RandomState(0)
    steps = [80, 144, max(trainer.sample_step_n(), 65)]
    reset_counts(ft, fs)
    logs, written = [], []
    for n in steps:
        it_inputs, kw = vm_iteration(inputs, motion_feats, n, rng)
        logs.append(trainer.train_iteration(it_inputs, **kw))
        idx = trainer.last_batch_idx
        written.append(bool(torch.isfinite(trainer.pool.states[idx]).all())
                       and float(trainer.pool.states[idx].abs().max()) > 0)
    torch.cuda.synchronize()
    launches = dict(ft.KERNEL_LAUNCHES)
    total = sum(steps)
    ms_names = ("nca_step_ms", "nca_bwd_mlp_ms", "nca_bwd_adjoint_ms")
    checks = {
        "losses finite, with appearance and video_motion terms": all(
            np.isfinite(l.loss) and {"appearance", "video_motion"} <= set(l.logs)
            and all(np.isfinite(v) for v in l.logs.values()) for l in logs),
        "nca_step_ms == nca_bwd_mlp_ms == nca_bwd_adjoint_ms == sum(step_n)":
            all(launches[k] == total for k in ms_names),
        "no scale-0 launches": all(launches[k] == 0 for k in launches if k not in ms_names),
        "fused_step nca_step_ms_chain == sum(step_n), no tensor-core step":
            fs.KERNEL_LAUNCHES["nca_step_ms_chain"] == total == fs.LAUNCHES,
        "pool written back (finite, non-zero)": all(written),
    }
    for log, n in zip(logs, steps):
        terms = " ".join(f"{k}={v:.4f}" for k, v in log.logs.items())
        print(f"  iter {log.iteration} step_n {n}: loss={log.loss:.4f} {terms}")
    print(f"  launches {launches} for sum(step_n) = {total}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("video_motion training phase failed")
    return launches, steps


def phase_vm_cli(load_params_pickle):
    """``python -m vsnca_tpu_torch.train.cli --preset video_motion`` in a
    subprocess, 2 iterations; its checkpoint must load. The run's directory
    (the checkpoint holds the 1.07 GB pool) is removed afterwards."""
    import shutil

    out = "out/chip_smoke_vm_cli"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vsnca_tpu_torch.train.cli", "--preset", "video_motion",
         "--max-iterations", "2", "--log-every", "1", "--out", out],
        capture_output=True, text=True, timeout=600,
    )
    print("\n".join(f"    {line}" for line in r.stdout.strip().splitlines()))
    if r.returncode != 0:
        print(r.stderr[-4000:])
        raise SystemExit(f"the video_motion CLI exited {r.returncode}")
    params = load_params_pickle(f"{out}/checkpoint", "cpu")
    shutil.rmtree(out)
    ok = tuple(params["w1"].shape) == (66, 128) and tuple(params["w2"].shape) == (128, 16)
    print(f"  video_motion CLI: 2 iterations in {time.perf_counter() - t0:.1f} s (process "
          f"start, kernel load and target features included); checkpoint loads: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the video_motion CLI's checkpoint does not load")


def phase_vm_protocol(torch, ft, presets, VideoMotionProtocol, extractors):
    """VideoMotionProtocol at full width: warmup 2 -> calibrate -> reinit ->
    main 1, its windows of precomputed features; each multiscale kernel
    launched once a step."""
    import dataclasses

    vgg, msoe, style, video = extractors
    nca, loss, train = presets.video_motion()
    proto = VideoMotionProtocol(nca, loss, dataclasses.replace(train, max_iterations=3),
                                video, style, warmup_iters=2, device="cuda")
    drawn = []
    plan = proto._iteration_kwargs

    def recording(trainer):
        inputs, kw = plan(trainer)
        drawn.append(kw["step_n"])
        return inputs, kw

    proto._iteration_kwargs = recording
    reset_counts(ft)
    t0 = time.perf_counter()
    trainer = proto.run(vgg, msoe)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ft.KERNEL_LAUNCHES)
    w = proto.loss_cfg.video_motion_weight
    checks = {
        "two warm-up motion losses, finite": len(proto._motion_losses) == 2
        and all(np.isfinite(proto._motion_losses)),
        "calibrated weight in [2, 10] (the 256px rule)": 2.0 <= w <= 10.0,
        "main phase on a fresh trainer, loss finite": trainer.iteration == 1
        and np.isfinite(trainer.history[-1].loss),
        "each ms kernel == sum(step_n)": all(
            launches[k] == sum(drawn) for k in ("nca_step_ms", "nca_bwd_mlp_ms",
                                                "nca_bwd_adjoint_ms")),
    }
    print(f"  step counts {drawn}; warm-up motion losses {proto._motion_losses}; calibrated "
          f"video_motion weight {w:.4f}; main loss {trainer.history[-1].loss:.4f}; {secs:.2f} s")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("video_motion protocol phase failed")


def phase_ms_stylizer(torch, fs, presets, VideoStylizer, dynca_init):
    """VideoStylizer with the video_motion cell (c16/fc128, scales (0, 1),
    random weights from a seed) stylizes 12 frames at 256^2, 24 steps a
    frame through nca_step_ms. Returns (launches, the stylizer)."""
    cfg = presets.video_motion()[0]
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    styl = VideoStylizer(params, cfg, VM_SIZE, step_n=STEPS, device="cuda")
    frames = (torch.rand((12, 1, VM_SIZE, VM_SIZE, 3), generator=torch.Generator().manual_seed(3))
              * 2 - 1).cuda()
    reset_counts(fs)
    rgbs = [styl.step_frame(f) for f in frames]
    torch.cuda.synchronize()
    launches = dict(fs.KERNEL_LAUNCHES)
    checks = {
        "nca_step_ms == 12 x 24, no nca_step": launches["nca_step_ms"] == 12 * STEPS
        and launches["nca_step"] == 0,
        "rgb [1, 256, 256, 3] in [0, 1], state finite": all(
            tuple(r.shape) == (1, VM_SIZE, VM_SIZE, 3) and float(r.min()) >= 0
            and float(r.max()) <= 1 for r in rgbs) and bool(torch.isfinite(styl.state).all()),
    }
    print(f"  12 frames, {STEPS} steps a frame, bf16: launches {launches}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("multiscale stylizer phase failed")
    return launches["nca_step_ms"], styl


def time_ms_kernels(torch, fs, ft, params):
    """Each multiscale kernel's ms per launch at the video_motion training
    shape (256^2 b3, pos_emb, f32) beside its bound and its plain version
    (nca_step_ms in its tensor-core form and in the chain form the training
    forward runs), and nca_step_ms at the stylizer's (256^2 b1, bf16)."""
    g = torch.Generator().manual_seed(3)
    shape = (3, 16, VM_SIZE, VM_SIZE)
    x = (torch.rand(shape, generator=g) - 0.5).cuda()
    gx = torch.randn(shape, generator=g).cuda()
    gx_acc = gx.clone()
    dst = torch.empty_like(x)
    cond = (torch.rand((3, 2, VM_SIZE, VM_SIZE), generator=g) - 0.5).cuda()
    gp = torch.empty((3, 64, VM_SIZE, VM_SIZE), device="cuda")
    packed = fs.pack_weights(params, 16, 2, "float32")
    slots = ft._zero_slots(3, 16, VM_SIZE, VM_SIZE, packed)
    thr = fs.uniform_threshold(0.5)
    hw = 3 * VM_SIZE * VM_SIZE
    out = {}
    runs = {
        "nca_step_ms": (
            lambda: fs.launch_step(x, dst, cond, packed, "circular", "float32", 5, 17, thr, True),
            lambda: fs.reference_step(x, cond, packed, "circular", "float32", 5, 17, 0.5, True)),
        "nca_step_ms_chain": (
            lambda: fs.launch_step(x, dst, cond, packed, "circular", "float32", 5, 17, thr, True,
                                   chain=True),
            lambda: fs.reference_step(x, cond, packed, "circular", "float32", 5, 17, 0.5, True)),
        "nca_bwd_mlp_ms": (
            lambda: ft._launch_mlp(x, cond, gx, gp, None, slots, packed, "float32", 5, 17, thr,
                                   True),
            lambda: ft.nca_bwd_mlp_reference(packed, x, cond, gx, 5, 17, 0.5, "float32", False,
                                             True)),
        "nca_bwd_adjoint_ms": (
            lambda: ft._launch_adjoint(gp, gx_acc, None, True),
            lambda: ft.nca_bwd_adjoint_reference(gp, gx, None, True)),
    }
    for name, (kern, plain) in runs.items():
        bound, by = ms_bound_ms(name.replace("_chain", ""), 16, 2, 128, hw)
        k_ms, p_ms = cuda_ms(kern, 20), cuda_ms(plain, 2)
        out[name] = (k_ms, p_ms, bound, by)
        print(f"  {name} {VM_SIZE}^2 b3 pos_emb f32: kernel {k_ms:.4f} ms/launch, plain "
              f"{p_ms:.4f} ms, bound {bound:.5f} ms ({by}); {k_ms / bound:.1f}x the bound")
    x1, d1, c1 = x[:1].contiguous(), dst[:1].contiguous(), cond[:1].contiguous()
    pb = fs.pack_weights(params, 16, 2, "bfloat16")
    k_ms = cuda_ms(lambda: fs.launch_step(x1, d1, c1, pb, "circular", "bfloat16", 5, 17, thr,
                                          True), 20)
    p_ms = cuda_ms(lambda: fs.reference_step(x1, c1, pb, "circular", "bfloat16", 5, 17, 0.5,
                                             True), 3)
    bound, by = ms_bound_ms("nca_step_ms", 16, 2, 128, VM_SIZE * VM_SIZE, "bfloat16")
    out["nca_step_ms_b1_bf16"] = (k_ms, p_ms, bound, by)
    print(f"  nca_step_ms {VM_SIZE}^2 b1 pos_emb bf16 (the stylizer's): kernel {k_ms:.4f} "
          f"ms/launch, plain {p_ms:.4f} ms, bound {bound:.5f} ms ({by}); {k_ms / bound:.1f}x "
          f"the bound")
    return out


def time_vm_losses(torch, vgg, msoe, loss_cfg, frames, style_feats, motion_feats,
                   appearance_loss, video_motion_loss):
    """The two loss forwards of a 144-step video_motion iteration (3 tapped
    frames of batch 3 at 256^2), alone on the same frames: the VGG16 OT
    appearance on the stacked frames, and MSOE MotionOT on their 2 pairs
    (CUDA events, median)."""
    gen = torch.Generator().manual_seed(0)
    stacked = torch.cat(frames, dim=0)
    app = cuda_ms(lambda: appearance_loss(vgg, stacked, frames[0][:1], "OT", style_feats, gen,
                                          loss_cfg.ot_subsample), 2, rounds=3)
    mot = cuda_ms(lambda: video_motion_loss(msoe, frames, None, "MotionOT", gen,
                                            loss_cfg.motion_img_size, loss_cfg.ot_subsample,
                                            target_features=motion_feats), 2, rounds=3)
    print(f"  of the loss forward, alone on 3 frames b3 at {VM_SIZE}^2: VGG16 + OT appearance "
          f"{app:.3f} ms, MSOE + MotionOT on 2 pairs {mot:.3f} ms")
    return app, mot


# ------------------------------------------- the TPU-layout forms (rows 1, 2, 5, 6)

FORMS = {"nca_step_mat": dict(algo="mat"),
         "nca_step_bf16_state": dict(algo="padded", state_dtype="bfloat16")}
# the bf16 state, relative to the largest element of the plain version's: both
# round the new state to bf16 on store, so one float32 ulp of difference in the
# MLP's sums can flip a stored value by one bf16 ulp (2^-8 relative)
BF16_STATE_TOL = 1e-2
SEG_STEPS = 128  # static_texture's longest rollout
VM_STEPS = 144  # video_motion's longest rollout


def form_bound_ms(form: str, c: int, cc: int, f: int, hw: int, compute_dtype: str):
    """Least time of one launch of a step form on an H100: the state read and
    written once and the conditioning read once (float32, or bf16 for the
    bf16-state form) plus the weights, over the memory rate, against the
    MLP's FLOPs over the peak for the operand type. The folded step's first
    layer is (9C + cc) x F: 2 ((9C + cc) F + F C) FLOP a pixel."""
    p = (9 * c if form.startswith("nca_step_mat") else 4 * c) + cc
    sb = 2 if form == "nca_step_bf16_state" else 4
    n_bytes = (2 * c + cc) * hw * sb + (p * f + f + f * c + c) * 4
    flops = 2 * hw * (p * f + f * c)
    peak = H100_BF16_FLOPS if compute_dtype == "bfloat16" else H100_F32_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mat_tc_rollout(fs, params, x, cond, cfg, n_steps, rate, cdt):
    """``n_steps`` launches of nca_step_mat's tensor-core form, whatever
    fused_step.chain_form picks for ``cdt`` (the steps of
    ``fused_rollout_chw(algo="mat")`` otherwise)."""
    import torch

    packed = fs.pack_weights(params, cfg.c_in, cond.shape[1] if cond is not None else 0, cdt,
                             True)
    src, thr = x, fs.uniform_threshold(rate)
    for i in range(n_steps):
        dst = torch.empty_like(x)
        fs.launch_step(src, dst, cond, packed, cfg.padding_mode, cdt, 7, i, thr, mat=True)
        src = dst
    return src


def phase_compare_forms(torch, fs, NCAConfig, dynca_init):
    """nca_step_mat (algo 'mat': its tensor-core form under f32 compute, its
    chain form under bf16, fused_step.chain_form) and the bf16-state nca_step
    (algo 'padded', state_dtype 'bfloat16') against their plain versions on
    the card, at 40x72 b2 x 4 steps and 256^2 b1 x 24 steps: three paddings,
    conditioning none / pos_emb / edges, rates 1 and 0.5, f32 and bf16
    compute. One line per form, shape and padding (the worst of its 12
    cases). Then the drift of nca_step_mat's tensor-core form under bf16
    compute, which no entry launches, on the 18 bf16 cases at 256^2 x 24
    steps: printed beside TOL['bfloat16'], not held to it. Returns the
    largest absolute difference of each form that ran (nca_step_mat_chain
    the chain form), and that drift's (worst, cases past TOL, cases)."""
    dev = "cuda"
    worst = {form: 0.0 for form in FORMS}
    drift = []
    for form, opts in FORMS.items():
        for shape, n_steps in (((2, 12, 40, 72), 4), ((1, 12, 256, 256), STEPS)):
            b, _, h, w = shape
            for pad in ("circular", "replicate", "zeros"):
                line_abs, line_rel, exact = 0.0, 0.0, 0
                for cond_kind in (None, "pos_emb", "edges"):
                    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode=pad,
                                    conditioning=cond_kind)
                    params = dynca_init(torch.Generator().manual_seed(0), cfg, device=dev)
                    g = torch.Generator().manual_seed(1)
                    x = (torch.rand(shape, generator=g) - 0.5).to(dev)
                    cond = None
                    if cond_kind:
                        cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(dev)
                    for rate in (1.0, 0.5):
                        for cdt in ("float32", "bfloat16"):
                            keys = [k for k in (form, form + "_chain") if k in fs.KERNEL_LAUNCHES]
                            before = sum(fs.KERNEL_LAUNCHES[k] for k in keys)
                            got = fs.fused_rollout_chw(params, x, 7, cfg, n_steps, cond, rate,
                                                       cdt, **opts)
                            launched = sum(fs.KERNEL_LAUNCHES[k] for k in keys) - before
                            want = fs.fused_rollout_chw_reference(params, x, 7, cfg, n_steps,
                                                                  cond, rate, cdt, **opts)
                            if form == "nca_step_mat" and cdt == "bfloat16" and h == 256:
                                tc = mat_tc_rollout(fs, params, x, cond, cfg, n_steps, rate,
                                                    cdt)
                                drift.append(float((tc - want).abs().max()))
                            torch.cuda.synchronize()
                            err = float((got.float() - want.float()).abs().max())
                            rel = scaled_err(got.float(), want.float())
                            moved = float((want.float() - x).abs().max())
                            tol_ok = (rel <= BF16_STATE_TOL if form == "nca_step_bf16_state"
                                      else err <= TOL[cdt])
                            ok = (tol_ok and launched == n_steps and moved > 0.0
                                  and got.dtype == want.dtype
                                  and bool(torch.isfinite(got.float()).all()))
                            if not ok:
                                raise SystemExit(
                                    f"{form} disagrees with its plain version: {shape} {pad} "
                                    f"{cond_kind} rate {rate} {cdt}: max abs {err:.3e}, "
                                    f"{rel:.2e} of max|plain|, {launched} launches")
                            line_abs, line_rel = max(line_abs, err), max(line_rel, rel)
                            exact += err == 0.0
                            form_cdt = form + ("_chain" if fs.chain_form(form, cdt) else "")
                            worst[form_cdt] = max(worst.get(form_cdt, 0.0), err)
                tol = (f"{BF16_STATE_TOL:.0e} of max|plain|" if form == "nca_step_bf16_state"
                       else f"{TOL['float32']:.0e} f32 / {TOL['bfloat16']:.0e} bf16")
                print(f"  {form} {h}x{w} b{b} x {n_steps} {pad}: 12 cases (cond none/pos_emb/"
                      f"edges, rates 1/0.5, f32/bf16), max|kernel-plain| {line_abs:.3e} "
                      f"({line_rel:.2e} of max|plain|; {exact} of 12 bit-identical), "
                      f"tol {tol} ok")
    past = sum(d > TOL["bfloat16"] for d in drift)
    print(f"  nca_step_mat's tensor-core form under bf16 compute, which no entry launches "
          f"(fused_step.chain_form): 256^2 b1 x {STEPS} steps, {len(drift)} cases, worst "
          f"max|kernel-plain| {max(drift):.3e}, {past} past TOL {TOL['bfloat16']:.0e} (the "
          f"chain form's 0)")
    return worst, (max(drift), past, len(drift))


def phase_compare_stream(torch, fs, cfg, params):
    """The streaming entry (circular, edges, bf16) at 1024^2 b1 x 4 steps
    against its plain version: nca_step's chain form (fused_step.chain_form),
    4 launches."""
    g = torch.Generator().manual_seed(5)
    x = (torch.rand((1, 12, 1024, 1024), generator=g) - 0.5).cuda()
    cond = (torch.rand((1, 3, 1024, 1024), generator=g) - 0.5).cuda()
    before = fs.KERNEL_LAUNCHES["nca_step_chain"]
    got = fs.fused_rollout_stream_chw(params, x, 7, cfg, 4, cond, compute_dtype="bfloat16")
    launched = fs.KERNEL_LAUNCHES["nca_step_chain"] - before
    want = fs.fused_rollout_chw_reference(params, x, 7, cfg, 4, cond, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = err <= TOL["bfloat16"] and launched == 4 and bool(torch.isfinite(got).all())
    print(f"  fused_rollout_stream_chw 1024^2 b1 x 4 circular edges bf16: max|kernel-plain| "
          f"{err:.3e} tol {TOL['bfloat16']:.0e}, nca_step launches {launched} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the streaming entry disagrees with its plain version")
    return err


def segment_inputs(torch, presets, dynca_init, make_conditioning):
    """The static_texture cell at full width: c12/fc96/pos_emb, 128^2, batch
    4, rate 0.5, random weights (seed 0), a random state and cotangent."""
    cfg = presets.static_texture()[0]
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    g = torch.Generator().manual_seed(4)
    x = (torch.rand((4, 12, 128, 128), generator=g) - 0.5).cuda()
    gy = torch.randn((4, 12, 128, 128), generator=g).cuda()
    cond = make_conditioning(cfg, (128, 128), batch=4, device="cuda")
    return cfg, params, x, gy, cond


def segment_run(ft, cfg, params, x, cond, gy, k, n_steps=SEG_STEPS):
    """The CHW pair forward and backward at segment ``k``: [state, dx0,
    dcond, dw1, db1, dw2, db2]."""
    p = {n: v.clone().requires_grad_() for n, v in params.items()}
    xr, cr = x.clone().requires_grad_(), cond.clone().requires_grad_()
    y = ft.fused_rollout_train_chw(p, xr, cr, 7, cfg, n_steps, k)
    (y * gy).sum().backward()
    return [y.detach(), xr.grad, cr.grad] + [p[n].grad for n in ("w1", "b1", "w2", "b2")]


def phase_compare_segment(torch, ft, presets, dynca_init, make_conditioning):
    """The segment-checkpointed CHW pair (rows 5, 6) at static_texture's full
    width, 128 steps, K = pick_segment = 16, against K = 1 (every state kept)
    and against its plain segment walk. Returns (K, largest difference from K
    = 1, largest absolute difference from the plain version)."""
    cfg, params, x, gy, cond = segment_inputs(torch, presets, dynca_init, make_conditioning)
    k = ft.pick_segment(cfg, 128, 128, SEG_STEPS)
    if k != 16:
        raise SystemExit(f"pick_segment gave {k} for {SEG_STEPS} steps, not 16")
    names = ["state", "dx0", "dcond", "dw1", "db1", "dw2", "db2"]
    one = segment_run(ft, cfg, params, x, cond, gy, 1)
    before = dict(ft.KERNEL_LAUNCHES)
    seg = segment_run(ft, cfg, params, x, cond, gy, k)
    torch.cuda.synchronize()
    launched = {n: ft.KERNEL_LAUNCHES[n] - before[n]
                for n in ("nca_step", "nca_bwd_mlp", "nca_bwd_adjoint")}
    want_launches = {"nca_step": 2 * SEG_STEPS - SEG_STEPS // k, "nca_bwd_mlp": SEG_STEPS,
                     "nca_bwd_adjoint": SEG_STEPS}
    diffs = {n: float((a - b).abs().max()) for n, a, b in zip(names, seg, one)}
    identical = all(d == 0.0 for d in diffs.values())
    rel = max(scaled_err(a, b) for a, b in zip(seg, one))
    y, grads, dx0, dcond = ft.fused_rollout_train_reference(
        params, x, 7, cfg, SEG_STEPS, cond, gy, need_dcond=True, segment=k)
    plain = [y, dx0, dcond] + [grads[n] for n in ("w1", "b1", "w2", "b2")]
    torch.cuda.synchronize()
    plain_rel = {n: scaled_err(a, b) for n, a, b in zip(names, seg, plain)}
    plain_abs = max(float((a - b).abs().max()) for a, b in zip(seg, plain))
    ok = (rel <= TRAIN_TOL["float32"] and launched == want_launches
          and max(plain_rel.values()) <= TRAIN_TOL["float32"]
          and all(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0 for a in seg))
    print(f"  CHW pair 128^2 b4 x {SEG_STEPS} pos_emb rate 0.5 f32, K = {k} vs K = 1: "
          + ("bit-identical (state, dx0, dcond, weight gradients)" if identical else
             "max|diff| " + ", ".join(f"{n} {d:.3e}" for n, d in diffs.items()))
          + f"; launches {launched} (want {want_launches}); K = {k} vs its plain segment "
          f"walk, of max|plain|: " + ", ".join(f"{n} {v:.2e}" for n, v in plain_rel.items())
          + f" (tol {TRAIN_TOL['float32']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the segment-checkpointed pair disagrees")
    return k, max(diffs.values()), plain_abs


def phase_tpu_layout_path(torch, fs, ft, presets, dynca_init, make_conditioning, cfg, params):
    """This slice's path, through the entries a user calls: bench.py's cell
    through ``ROLLOUT_KERNELS[select_rollout_kernel(...)]`` (96 steps, 256^2,
    bf16), the edge_conditioned cell at 256^2 x 24 steps through
    ``fused_rollout_chw`` with algo 'mat' (bf16 compute: its chain form; f32:
    its tensor-core form) and with algo 'padded' and a bf16 state, the
    streaming entries (``fused_rollout_stream_chw`` and
    ``ROLLOUT_KERNELS['stream_flat']``) at 1024^2 x 4 steps each, and the
    static_texture cell through the NHWC CHW pair (``fused_rollout_train_nhwc``, 128 steps,
    K = 16) with a backward. The counts are set to 0 just before and read
    just after. Returns the launches by kernel."""
    g = torch.Generator().manual_seed(6)
    bench_cfg = dataclasses.replace(cfg, conditioning=None)
    bench_params = dynca_init(torch.Generator().manual_seed(0), bench_cfg, device="cuda")
    xb = (torch.rand((1, 12, 256, 256), generator=g) - 0.5).cuda()
    x = (torch.rand((1, 12, 256, 256), generator=g) - 0.5).cuda()
    cond = (torch.rand((1, 3, 256, 256), generator=g) - 0.5).cuda()
    x4 = (torch.rand((1, 12, 1024, 1024), generator=g) - 0.5).cuda()
    c4 = (torch.rand((1, 3, 1024, 1024), generator=g) - 0.5).cuda()
    st_cfg, st_params, xs, _, st_cond = segment_inputs(torch, presets, dynca_init,
                                                       make_conditioning)
    p = {n: v.clone().requires_grad_() for n, v in st_params.items()}
    torch.cuda.synchronize()

    reset_counts(fs, ft)
    kernel = fs.select_rollout_kernel(bench_cfg, 256, 256)
    outs = {
        f"bench cell via ROLLOUT_KERNELS[{kernel!r}]": fs.ROLLOUT_KERNELS[kernel](
            bench_params, xb, 0, bench_cfg, 96, compute_dtype="bfloat16"),
        "algo mat": fs.fused_rollout_chw(params, x, 1, cfg, STEPS, cond,
                                         compute_dtype="bfloat16", algo="mat"),
        "algo mat, f32": fs.fused_rollout_chw(params, x, 1, cfg, STEPS, cond,
                                              compute_dtype="float32", algo="mat"),
        "algo padded, bf16 state": fs.fused_rollout_chw(
            params, x, 1, cfg, STEPS, cond, compute_dtype="bfloat16",
            state_dtype="bfloat16", algo="padded"),
        "stream 1024^2": fs.fused_rollout_stream_chw(params, x4, 1, cfg, 4, c4,
                                                     compute_dtype="bfloat16"),
        "ROLLOUT_KERNELS['stream_flat'] 1024^2": fs.ROLLOUT_KERNELS["stream_flat"](
            params, x4, 1, cfg, 4, c4, compute_dtype="bfloat16"),
    }
    state, rgb = ft.fused_rollout_train_nhwc(p, xs.permute(0, 2, 3, 1), 3, st_cfg, SEG_STEPS,
                                             st_cond.permute(0, 2, 3, 1))
    (rgb.square().mean() + 0.1 * state.square().mean()).backward()
    torch.cuda.synchronize()
    fs_counts, ft_counts = dict(fs.KERNEL_LAUNCHES), dict(ft.KERNEL_LAUNCHES)

    k = ft.pick_segment(st_cfg, 128, 128, SEG_STEPS)
    train_steps = 2 * SEG_STEPS - SEG_STEPS // k  # the forward and the recompute
    want_fs = {"nca_step": 0, "nca_step_ms": 0, "nca_step_mat": STEPS,
               "nca_step_bf16_state": STEPS, "nca_step_chain": 96 + 8 + train_steps,
               "nca_step_ms_chain": 0, "nca_step_mat_chain": STEPS}
    want_ft = {"nca_step": train_steps, "nca_bwd_mlp": SEG_STEPS,
               "nca_bwd_adjoint": SEG_STEPS}
    checks = {
        f"select_rollout_kernel(bench cell, 256, 256) == 'flat' ({kernel!r})": kernel == "flat",
        f"fused_step launches {fs_counts} == {want_fs}": fs_counts == want_fs,
        f"fused_train launches == {want_ft}":
            all(ft_counts[n] == v for n, v in want_ft.items()),
        "outputs finite, of their shapes": all(
            bool(torch.isfinite(o.float()).all()) for o in outs.values())
            and outs["stream 1024^2"].shape == (1, 12, 1024, 1024)
            and tuple(rgb.shape) == (4, 128, 128, 3),
        "bf16 state returned as bf16": outs["algo padded, bf16 state"].dtype == torch.bfloat16,
        "pair gradients finite and non-zero": all(
            bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().max()) > 0
            for v in p.values()),
    }
    for name, o in outs.items():
        print(f"  {name}: {tuple(o.shape)} {str(o.dtype)[6:]}, max|state| "
              f"{float(o.float().abs().max()):.3f}")
    print(f"  fused_rollout_train_nhwc static_texture 128^2 b4 x {SEG_STEPS}, K = {k}: "
          f"state {tuple(state.shape)}, rgb {tuple(rgb.shape)}; fused_train launches "
          f"{ft_counts}")
    for name, v in checks.items():
        print(f"  {name}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("the TPU-layout entries' path failed")
    return {**fs_counts, "nca_bwd_mlp": ft_counts["nca_bwd_mlp"],
            "nca_bwd_adjoint": ft_counts["nca_bwd_adjoint"]}


# the compute type each step form is timed at by time_forms: the tensor-core
# nca_step_mat runs float32 compute, its chain form bf16 (fused_step.chain_form)
SHORT = {"float32": "f32", "bfloat16": "bf16"}
FORM_CDT = {"nca_step": "bfloat16", "nca_step_mat": "float32",
            "nca_step_mat_chain": "bfloat16", "nca_step_bf16_state": "bfloat16"}


def time_forms(torch, fs, cfg, params):
    """nca_step_mat (its tensor-core form at f32 compute, its chain form at
    bf16) and the bf16-state nca_step per launch at 256^2 b1 (the
    edge_conditioned width, rate 0.5, FORM_CDT) beside nca_step in the same
    call, each beside its bound and its plain version; the streaming entry
    per step at 1024^2; every registry entry (and 'mat', 'padded') per step
    at 256^2 and 1024^2 (bf16 compute). nca_step_mat's bound is its
    tensor-core bound (split TF32 under f32, bf16 under bf16), whichever form
    runs: the card's peak for the folded product. Returns {name: (ms, plain
    ms, bound ms, bound by)} and {(entry, size): ms per step}."""
    g = torch.Generator().manual_seed(7)
    out, per_step = {}, {}
    thr = fs.uniform_threshold(0.5)
    for n in (256, 1024):
        x = (torch.rand((1, 12, n, n), generator=g) - 0.5).cuda()
        cond = (torch.rand((1, 3, n, n), generator=g) - 0.5).cuda()
        if n == 256:
            for name, cdt in FORM_CDT.items():
                mat = name.startswith("nca_step_mat")
                xi, ci = (x.bfloat16(), cond.bfloat16()) if name == "nca_step_bf16_state" else (
                    x, cond)
                packed = fs.pack_weights(params, 12, 3, cdt, mat)
                dst = torch.empty_like(xi)
                chain = name.endswith("_chain")
                k_ms = cuda_ms(lambda: fs.launch_step(xi, dst, ci, packed, "circular", cdt, 5,
                                                      17, thr, False, mat, chain), 20)
                p_ms = cuda_ms(lambda: fs.reference_step(xi, ci, packed, "circular", cdt, 5, 17,
                                                         0.5, False, mat), 3)
                bound, by = (step_bound_ms(12, 3, 96, n * n, cdt) if name == "nca_step"
                             else tc_bound_ms(name, 12, 3, 96, n * n, cdt) if mat
                             else form_bound_ms(name, 12, 3, 96, n * n, cdt))
                out[name] = (k_ms, p_ms, bound, by)
                print(f"  {name} 256^2 b1 edges {cdt}: kernel {k_ms:.4f} ms/launch, plain "
                      f"{p_ms:.4f} ms, bound {bound:.5f} ms ({by}); {k_ms / bound:.1f}x the "
                      f"bound")
        entries = {name: (fn, {}) for name, fn in fs.ROLLOUT_KERNELS.items()}
        entries["stream"] = (fs.fused_rollout_stream_chw, {})
        entries["roll, algo mat"] = (fs.fused_rollout_chw, dict(algo="mat"))
        entries["padded, bf16 state"] = (fs.fused_rollout_chw,
                                         dict(algo="padded", state_dtype="bfloat16"))
        for name, (fn, opts) in entries.items():
            ms = cuda_ms(lambda: fn(params, x, 1, cfg, 8, cond, compute_dtype="bfloat16",
                                    **opts), 2, rounds=3) / 8
            per_step[(name, n)] = ms
        print(f"  ms/step at {n}^2 b1 edges bf16, by entry (8-step calls): "
              + ", ".join(f"{k} {v:.4f}" for (k, m), v in per_step.items() if m == n))
        if n == 1024:
            plain = cuda_ms(lambda: fs.fused_rollout_chw_reference(
                params, x, 1, cfg, 4, cond, compute_dtype="bfloat16"), 1, rounds=3) / 4
            bound, by = step_bound_ms(12, 3, 96, n * n, "bfloat16")
            k_ms = per_step[("stream", n)]
            out["stream_1024"] = (k_ms, plain, bound, by)
            print(f"  fused_rollout_stream_chw 1024^2 edges bf16: {k_ms:.4f} ms/step, plain "
                  f"{plain:.4f}, bound {bound:.5f} ({by}); {k_ms / bound:.1f}x the bound")
    return out, per_step


def time_segments(torch, ft, presets, dynca_init, make_conditioning, vm_params):
    """The segment trade-off: the CHW pair's forward + backward and the peak
    device memory it adds (``max_memory_allocated`` over what was held before
    it) at K = 16 against K = 1, for static_texture (128^2 b4 x 128) and for
    the video_motion pair (scales (0, 1), 256^2 b3 x 144, through
    ``fused_rollout_train`` with ``segment``). Returns {(cell, K): (ms, GB)}."""
    out = {}
    cfg, params, x, gy, cond = segment_inputs(torch, presets, dynca_init, make_conditioning)
    vm_cfg = presets.video_motion()[0]
    g = torch.Generator().manual_seed(8)
    vx = (torch.rand((3, 16, VM_SIZE, VM_SIZE), generator=g) - 0.5).cuda()
    vgy = torch.randn((3, 16, VM_SIZE, VM_SIZE), generator=g).cuda()
    vcond = make_conditioning(vm_cfg, (VM_SIZE, VM_SIZE), batch=3, device="cuda")

    def vm_run(k):
        p = {n: v.detach().clone().requires_grad_() for n, v in vm_params.items()}
        y = ft.fused_rollout_train(p, vx, 7, vm_cfg, VM_STEPS, vcond, cond_no_grad=True,
                                   segment=k)
        (y * vgy).sum().backward()

    runs = {("static_texture 128^2 b4 x 128", k): (
        lambda k=k: segment_run(ft, cfg, params, x, cond, gy, k)) for k in (1, 16)}
    runs.update({("video_motion 256^2 b3 x 144", k): (lambda k=k: vm_run(k)) for k in (1, 16)})
    for key, fn in runs.items():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fn, 1, rounds=3)
        gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        out[key] = (ms, gb)
    for cell in ("static_texture 128^2 b4 x 128", "video_motion 256^2 b3 x 144"):
        (t1, m1), (t16, m16) = out[(cell, 1)], out[(cell, 16)]
        print(f"  segment trade-off, {cell} pair forward + backward, f32: K = 1 {t1:.3f} ms, "
              f"{m1:.3f} GB added at peak; K = 16 {t16:.3f} ms ({t16 - t1:+.3f}), {m16:.3f} GB "
              f"({m16 - m1:+.3f})")
    ckpt_gb = VM_STEPS * 3 * 16 * VM_SIZE * VM_SIZE * 4 / 1e9
    print(f"  the every-step checkpoint of video_motion 256^2 b3 x {VM_STEPS} (computed from "
          f"its shape): {ckpt_gb:.3f} GB")
    if not out[("static_texture 128^2 b4 x 128", 16)][1] < \
            out[("static_texture 128^2 b4 x 128", 1)][1]:
        raise SystemExit("K = 16 did not lower the pair's peak memory")
    return out


def phase_benchmark(torch, fs, ft, benchmark):
    """The benchmark harness (infer/benchmark.py) on the card, once each:
    ``benchmark_serving`` (8 streams at 256^2, edge_conditioned, 24 steps a
    frame) and ``benchmark_train_step('static_texture')``; each must launch
    the kernels."""
    reset_counts(fs, ft)
    serving = benchmark.benchmark_serving(size=256, n_streams=8)
    torch.cuda.synchronize()
    serve_launches = fs.LAUNCHES
    reset_counts(fs, ft)
    train = benchmark.benchmark_train_step("static_texture")
    torch.cuda.synchronize()
    train_launches = dict(ft.KERNEL_LAUNCHES)
    print(f"  benchmark_serving: {serving}; nca_step launches {serve_launches}")
    print(f"  benchmark_train_step: {train}; fused_train launches {train_launches}")
    ok = serve_launches == 13 * 24 and train_launches["nca_bwd_mlp"] > 0 and all(
        np.isfinite(v) for v in (serving["aggregate_fps"], train["train_iters_per_sec"]))
    if not ok:
        raise SystemExit("the benchmark harness did not run its kernels")
    return serving, train


# ------------------------------- the tensor-core backward kernels (section D)

H100_TF32_FLOPS = 495e12  # dense tensor-core peak


# FLOPs of the three perception stencils a pixel and channel
# (nca_common.cuh::stencils: Sobel x and y 4 products and 5 sums each, the
# Laplacian 5 and 8)
STENCIL_FLOP = 9 + 9 + 13


def tc_bound_ms(kernel: str, c: int, k2: int, f: int, hw: int, compute_dtype="float32"):
    """Least time of one launch of a tensor-core kernel on an H100 for the
    design's arithmetic: the FLOPs it keeps on the CUDA cores over the
    float32 peak plus its tensor-core FLOPs over the TF32 peak, three times
    over for split TF32 (float32 compute), or over the bf16 peak, against
    its bytes (counted as ``step_bound_ms``, ``form_bound_ms``,
    ``ms_bound_ms``, ``train_bound_ms`` and ``cnca_bound_ms`` count them) over
    the memory rate. nca_step, its bf16-state form and nca_step_ms (k2 = cc)
    keep the stencils (STENCIL_FLOP a pixel and channel) and the multiscale
    percept (MS_PERCEPT_FLOP) and put the MLP (2 (P*F + F*C)) on the tensor
    cores; nca_step_mat (k2 = cc) puts all of its MLP (2 ((9C + cc) F + F C))
    on them; nca_bwd_mlp(_ms) (k2 = cc) keeps the multiscale percept and puts
    z1 = W1^T p, W2 gdx, W1 gz1, dW1 and dW2 (2 (3 P*F + 2 F*C)) on them;
    cnca_bwd_mlp (k2 = D) keeps the recompute (the MLP and the percept) and
    the depthwise weight gradient (2 x 2*27*C) and puts the three transposed
    and three weight-gradient products (2 x the MLP) on them."""
    ms = kernel.startswith("nca_step_ms") or kernel == "nca_bwd_mlp_ms"
    if kernel.startswith("nca_step_mat"):  # the folded stencil: all on the tensor cores
        p = 9 * c + k2
        n_bytes = (2 * c + k2) * hw * 4 + (p * f + f + f * c + c) * 4
        cuda = 0
        tc = 2 * hw * (p * f + f * c)
    elif kernel.startswith("nca_step"):
        p = 4 * c + k2
        state_bytes = 2 if kernel == "nca_step_bf16_state" else 4
        n_bytes = (2 * c + k2) * hw * state_bytes + (p * f + f + f * c + c) * 4
        cuda = (STENCIL_FLOP + (MS_PERCEPT_FLOP if ms else 0)) * c * hw
        tc = 2 * hw * (p * f + f * c)
    elif kernel.startswith("nca_bwd_mlp"):
        p = 4 * c + k2
        n_bytes = (c + k2 + c + 4 * c) * hw * 4 + (p * f + f + f * c + c) * 4
        cuda = MS_PERCEPT_FLOP * c * hw if ms else 0
        tc = 2 * hw * (3 * p * f + 2 * f * c)
    else:
        d, p = k2, 3 * c
        mlp = 2 * (p * d + d * d + d * c)
        n_bytes = (8 * c * hw * 4 + hw
                   + 2 * (27 * c + p * d + d + d * d + d + d * c) * 4)
        cuda = hw * (mlp + 4 * 27 * c)
        tc = hw * 2 * mlp
    t_tc = tc / H100_BF16_FLOPS if compute_dtype == "bfloat16" else 3 * tc / H100_TF32_FLOPS
    t_ops = cuda / H100_F32_FLOPS + t_tc
    t_bytes = n_bytes / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_tc_kernels(torch, fs, ft, fc, cn, ConditionedNCAConfig, _build):
    """The tensor-core kernels at the shapes of PERF.md's table: the step
    nca_step at 128^2 b4 f32 (c12/fc96, pos_emb) and 256^2 b1 bf16 (the
    served c12/fc96/edges; also its bf16-state form), nca_step_ms at 256^2
    b3 f32 and b1 bf16 (c16/fc128, pos_emb), each with its blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the chain forms at
    the training shapes and the served one;
    nca_bwd_mlp at 128^2 b4 f32, nca_bwd_mlp_ms at 256^2 b3 f32 and b1 bf16,
    cnca_bwd_mlp at 64^2 b8 and b1 f32 (C 20 / D 64): ms per launch (CUDA
    events, and the step's and the DyNCA backward's device time) beside the
    float32 bound and the tensor-core bound, two launches on the same inputs
    checked for the same bits, and ptxas' registers and spills of each
    instantiation. Returns {(name, label): (ms, f32 bound, tensor-core
    bound or None, device ms or None, what bounds the tensor-core bound)}."""
    from vsnca_tpu_torch.models.dynca import dynca_init
    from vsnca_tpu_torch.config import NCAConfig

    out = {}
    want = False  # inside ptxas' report of a tensor-core kernel or the chain form
    for line in (_build.build_log("nca_step") + _build.build_log("nca_train")
                 + _build.build_log("nca_cnca")).splitlines():
        if "Function properties" in line:
            want = any(k in line for k in ("bwd_mlp", "nca_step_kernel", "nca_step_chain"))
            if want:
                print(f"    ptxas: {line.split('for', 1)[1].strip()}")
        elif want and ("registers" in line or "spill" in line):
            print(f"    ptxas:   {line.strip()}")
    thr = fs.uniform_threshold(0.5)
    for name, c, cc, f, b, n, cdt in (("nca_step", 12, 2, 96, 4, 128, "float32"),
                                      ("nca_step", 12, 3, 96, 1, 256, "bfloat16"),
                                      ("nca_step_bf16_state", 12, 3, 96, 1, 256, "bfloat16"),
                                      ("nca_step_ms", 16, 2, 128, 3, 256, "float32"),
                                      ("nca_step_ms", 16, 2, 128, 1, 256, "bfloat16"),
                                      ("nca_step_chain", 12, 2, 96, 4, 128, "float32"),
                                      ("nca_step_chain", 12, 3, 96, 1, 256, "bfloat16"),
                                      ("nca_step_ms_chain", 16, 2, 128, 3, 256, "float32")):
        ms, bstate = name.startswith("nca_step_ms"), name == "nca_step_bf16_state"
        chain = name.endswith("_chain")
        cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="circular",
                        conditioning="edges" if cc == 3 else "pos_emb",
                        perception_scales=(0, 1) if ms else (0,))
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        g = torch.Generator().manual_seed(3)
        sdt = torch.bfloat16 if bstate else torch.float32
        x = (torch.rand((b, c, n, n), generator=g) - 0.5).cuda().to(sdt)
        cond = (torch.rand((b, cc, n, n), generator=g) - 0.5).cuda().to(sdt)
        packed = fs.pack_weights(params, c, cc, cdt)
        outs = [torch.empty_like(x) for _ in range(2)]
        step = lambda o: fs.launch_step(x, o, cond, packed, "circular", cdt, 5, 17,  # noqa: E731
                                        thr, ms, chain=chain)
        for o in outs:
            step(o)
        torch.cuda.synchronize()
        same = torch.equal(outs[0], outs[1])
        k_ms = cuda_ms(lambda: step(outs[0]), 20)
        dev = device_ms(torch, lambda: step(outs[0]))
        hw = b * n * n
        base = name.replace("_chain", "")
        f32b = (ms_bound_ms(base, c, cc, f, hw)[0] if ms
                else form_bound_ms(base, c, cc, f, hw, "float32")[0])
        tcb, tcby = (None, None) if chain else tc_bound_ms(name, c, cc, f, hw, cdt)
        blocks, smem = fs.step_occupancy(
            c, cc, f, cdt, ms, "chain" if chain else "bf16_state" if bstate else "tc")
        label = f"{n}^2 b{b} {cdt}"
        out[(name, label)] = (k_ms, f32b, tcb, dev, tcby)
        tc_text = "" if chain else f", tensor-core bound {tcb:.5f} ms ({dev / tcb:.1f}x)"
        print(f"  {name} {label}: kernel {k_ms:.4f} ms/launch (CUDA events), {dev:.4f} device "
              f"(profiler); float32 bound {f32b:.5f} ms ({dev / f32b:.1f}x){tc_text}; {blocks} "
              f"blocks an SM ({smem / 1000:.1f} KB of shared memory); two launches "
              f"bit-identical: {same}")
        if not same:
            raise SystemExit(f"{name}: two launches on the same inputs differ")
    for name, c, f, ms, b, n, cdt in (("nca_bwd_mlp", 12, 96, False, 4, 128, "float32"),
                                      ("nca_bwd_mlp_ms", 16, 128, True, 3, 256, "float32"),
                                      ("nca_bwd_mlp_ms", 16, 128, True, 1, 256, "bfloat16")):
        cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="circular", conditioning="pos_emb",
                        perception_scales=(0, 1) if ms else (0,))
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        g = torch.Generator().manual_seed(3)
        x = (torch.rand((b, c, n, n), generator=g) - 0.5).cuda()
        gx = torch.randn((b, c, n, n), generator=g).cuda()
        cond = (torch.rand((b, 2, n, n), generator=g) - 0.5).cuda()
        packed = fs.pack_weights(params, c, 2, cdt)
        gp = torch.empty((b, 4 * c, n, n), device="cuda")
        runs = [ft._zero_slots(b, c, n, n, packed) for _ in range(2)]
        for slots in runs:
            ft._launch_mlp(x, cond, gx, gp, None, slots, packed, cdt, 5, 17, thr, ms)
        gp2 = gp.clone()
        ft._launch_mlp(x, cond, gx, gp2, None, torch.zeros_like(runs[0]), packed, cdt, 5,
                       17, thr, ms)
        torch.cuda.synchronize()
        same = torch.equal(runs[0], runs[1]) and torch.equal(gp, gp2)
        slots = runs[0]
        launch = lambda: ft._launch_mlp(x, cond, gx, gp, None, slots, packed, cdt,  # noqa: E731
                                        5, 17, thr, ms)
        k_ms, dev = cuda_ms(launch, 20), device_ms(torch, launch)
        hw = b * n * n
        f32b = (ms_bound_ms(name, c, 2, f, hw)[0] if ms
                else train_bound_ms(name, c, 2, f, hw)[0])
        tcb, tcby = tc_bound_ms(name, c, 2, f, hw, cdt)
        label = f"{n}^2 b{b} {cdt}"
        out[(name, label)] = (k_ms, f32b, tcb, dev, tcby)
        print(f"  {name} {label}: kernel {k_ms:.4f} ms/launch (CUDA events), {dev:.4f} device "
              f"(profiler); float32 bound {f32b:.5f} ms ({dev / f32b:.1f}x), tensor-core bound "
              f"{tcb:.5f} ms ({dev / tcb:.1f}x); two launches bit-identical: {same}")
        if not same:
            raise SystemExit(f"{name}: two launches on the same inputs differ")
    for b in (8, 1):
        cfg = ConditionedNCAConfig(image_size=64, cell_fire_rate=0.5)
        params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        g = torch.Generator().manual_seed(1)
        x = (0.3 * torch.randn((b, 20, 64, 64), generator=g)).cuda()
        goal = (0.3 * torch.randn((b, 20, 64, 64), generator=g)).cuda()
        gy = torch.randn((b, 20, 64, 64), generator=g).cuda()
        packed = fc.pack_weights(params, cfg, "float32")
        _, life = fc.cnca_step_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5)
        gp = torch.empty((b, 60, 64, 64), device="cuda")
        outs = []
        for _ in range(2):
            gg, slots = gy.clone(), fc._zero_slots(b, 64, 64, packed)
            fc._launch_bwd_mlp(x, goal, life, gg, gp, slots, packed, cfg, "float32", 3, 5,
                               thr)
            outs.append((gg, gp.clone(), slots))
        torch.cuda.synchronize()
        same = all(torch.equal(a, c_) for a, c_ in zip(*outs))
        gg = gy.clone()
        k_ms = cuda_ms(lambda: fc._launch_bwd_mlp(x, goal, life, gg, gp, slots, packed, cfg,
                                                  "float32", 3, 5, thr), 20)
        hw = b * 64 * 64
        f32b = cnca_bound_ms("cnca_bwd_mlp", 20, 64, hw)[0]
        tcb, tcby = tc_bound_ms("cnca_bwd_mlp", 20, 64, 64, hw)
        label = f"64^2 b{b} float32"
        out[("cnca_bwd_mlp", label)] = (k_ms, f32b, tcb, None, tcby)
        print(f"  cnca_bwd_mlp {label}: kernel {k_ms:.4f} ms/launch; float32 bound {f32b:.5f} "
              f"ms ({k_ms / f32b:.1f}x), tensor-core bound {tcb:.5f} ms ({k_ms / tcb:.1f}x); "
              f"two launches bit-identical: {same}")
        if not same:
            raise SystemExit("cnca_bwd_mlp: two launches on the same inputs differ")
    return out


# --------------------------- the redesigned CUDA-core kernels (PERF.md rows 10, 11)

# (shape, channels) of nca_bwd_adjoint_ms's footprint cases: 256^2 b3 the
# video_motion shape; 16^2 (the half-resolution footprint wraps more than
# once), 18^2 and 34x66 (rows of 18 and 66 floats: the 4-byte staging) and
# 40x72 (ragged against 16 x 16 blocks)
ADJ_SHAPES = ((3, 16, 256, 256), (2, 16, 16, 16), (2, 16, 18, 18), (2, 16, 40, 72),
              (2, 16, 34, 66))
# cnca_update's: 64^2 b8 and b1 the trainer's and the grower's shapes; 8^2 and
# 24x40 ragged against its 16 x 8 blocks
UPDATE_SHAPES = ((8, 64, 64), (1, 64, 64), (2, 8, 8), (2, 24, 40))


def phase_compare_redesigned(torch, ft, fc, cn, ConditionedNCAConfig):
    """nca_bwd_adjoint_ms and cnca_update, redesigned for the H100, alone
    against their plain versions on the same card tensors: the adjoint at
    ADJ_SHAPES with a tap and without, within MS_STATE_TOL of the largest
    element; the update at UPDATE_SHAPES, living channel on and off, f32 and
    bf16, rates 1 and 0.5, within CNCA_TOL. Returns the largest absolute
    difference of each."""
    worst = {"nca_bwd_adjoint_ms": 0.0, "cnca_update": 0.0}
    g = torch.Generator().manual_seed(11)
    rel_adj, n_adj = 0.0, 0
    for b, c, h, w in ADJ_SHAPES:
        gp = torch.randn((b, 4 * c, h, w), generator=g).cuda()
        gx = torch.randn((b, c, h, w), generator=g).cuda()
        gtap = torch.randn((b, c, h, w), generator=g).cuda()
        for tap in (None, gtap):
            got = ft.nca_bwd_adjoint(gp, gx, tap, True)
            want = ft.nca_bwd_adjoint_reference(gp, gx, tap, True)
            torch.cuda.synchronize()
            err, rel = float((got - want).abs().max()), scaled_err(got, want)
            worst["nca_bwd_adjoint_ms"] = max(worst["nca_bwd_adjoint_ms"], err)
            rel_adj, n_adj = max(rel_adj, rel), n_adj + 1
            if not (rel <= MS_STATE_TOL and bool(torch.isfinite(got).all())):
                raise SystemExit(f"nca_bwd_adjoint_ms disagrees with its plain version at "
                                 f"{h}x{w} b{b}, tap {tap is not None}: {rel:.2e} of max")
    print(f"  nca_bwd_adjoint_ms: {n_adj} cases (256^2 b3, 16^2, 18^2, 40x72, 34x66 b2, C 16, "
          f"tap on/off): max|kernel-plain|/max|plain| {rel_adj:.2e} (tol {MS_STATE_TOL:.0e}), "
          f"max|kernel-plain| {worst['nca_bwd_adjoint_ms']:.3e} ok")
    rel_up = {"float32": 0.0, "bfloat16": 0.0}
    n_up = 0
    for shape in UPDATE_SHAPES:
        for use_life in (True, False):
            for rate in (1.0, 0.5):
                cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, shape, rate,
                                                 use_life)
                thr = fc.fs.uniform_threshold(rate)
                for cdt in ("float32", "bfloat16"):
                    packed = fc.pack_weights(params, cfg, cdt)
                    got = torch.empty_like(x)
                    fc.launch_update(x, goal, got, packed, cfg, cdt, 3, 5, thr)
                    want = fc.cnca_update_reference(x, goal, packed, cfg, cdt, 3, 5, rate)
                    torch.cuda.synchronize()
                    err, rel = float((got - want).abs().max()), scaled_err(got, want)
                    worst["cnca_update"] = max(worst["cnca_update"], err)
                    rel_up[cdt] = max(rel_up[cdt], rel)
                    n_up += 1
                    if not (rel <= CNCA_TOL[cdt] and bool(torch.isfinite(got).all())):
                        raise SystemExit(f"cnca_update disagrees with its plain version at "
                                         f"{shape} living {use_life} rate {rate} {cdt}: "
                                         f"{rel:.2e} of max")
    print(f"  cnca_update: {n_up} cases (64^2 b8, b1, 8^2 b2, 24x40 b2 x living on/off x rate "
          f"1/0.5 x f32/bf16): max|kernel-plain|/max|plain| f32 {rel_up['float32']:.2e}, bf16 "
          f"{rel_up['bfloat16']:.2e} (tol {CNCA_TOL['float32']:.0e}, "
          f"{CNCA_TOL['bfloat16']:.0e}) ok")
    return worst


def phase_cnca_gate_stress(torch, fc, cn, ConditionedNCAConfig):
    """The ConditionedNCA training pair (cnca_update + cnca_gate forward,
    cnca_bwd_mlp recomputing h1, h2 and xn in the update's order) with b1
    and b2 shifted so that about a tenth of the first step's h1 and h2
    pre-activations lie within 1e-6 of zero: a 24 x 24 patch of constant
    state and goal shares one percept, and b1 (then b2, from the patch's h1)
    leaves each unit's pre-activation there between 1e-7 and 1e-6 from zero,
    either side. A forward and a recompute on different bits would flip
    those gates; the pair's state and gradients stay within CNCA_TOL of the
    plain pair's. 64^2 b8 x 24 steps, rate 0.5, f32. Returns the share of
    pre-activations within 1e-6 of zero (h1, h2) and the largest scaled
    error."""
    cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, (8, 64, 64))
    rng = np.random.RandomState(7)
    c = cfg.num_channels
    patch = (slice(None), slice(None), slice(20, 44), slice(20, 44))
    x[patch] = torch.from_numpy(rng.uniform(-0.5, 0.5, (c, 1, 1)).astype(np.float32)).cuda()
    x[:, cfg.alive_channel][:, 20:44, 20:44] = 0.5  # alive in the patch
    goal[patch] = torch.from_numpy(rng.uniform(-0.5, 0.5, (c, 1, 1)).astype(np.float32)).cuda()
    d = cfg.update_hidden_dim
    packed = fc.pack_weights(params, cfg, "float32")
    xg = x + goal * fc._alive(x, cfg)
    p = fc.depthwise_perceive(xg, packed[0].reshape(c, 3, 3, 3))
    pp = p[0, :, 32, 32]
    off1 = rng.uniform(1e-7, 1e-6, d) * rng.choice([-1.0, 1.0], d)
    b1 = torch.from_numpy(off1.astype(np.float32)).cuda() - pp @ params["update1.w"]
    h1p = torch.relu(pp @ params["update1.w"] + b1)
    off2 = rng.uniform(1e-7, 1e-6, d) * rng.choice([-1.0, 1.0], d)
    b2 = torch.from_numpy(off2.astype(np.float32)).cuda() - h1p @ params["update2.w"]
    params = dict(params, **{"update1.b": b1, "update2.b": b2})
    z1 = torch.einsum("bkhw,kf->bfhw", p, params["update1.w"]) + b1[:, None, None]
    z2 = torch.einsum("bfhw,fe->behw", torch.relu(z1), params["update2.w"]) + b2[:, None, None]
    near = (float((z1.abs() <= 1e-6).float().mean()), float((z2.abs() <= 1e-6).float().mean()))
    gy = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).cuda()
    pr = {k: v.clone().requires_grad_() for k, v in params.items()}
    xr, gr = x.clone().requires_grad_(), goal.clone().requires_grad_()
    y = fc.fused_cnca_train(pr, xr, gr, 9, cfg, 24, "float32")
    (y * gy).sum().backward()
    want_y, grads, dx0, dgoal = fc.fused_cnca_train_reference(params, x, goal, 9, cfg, 24, gy,
                                                              "float32")
    torch.cuda.synchronize()
    pairs = {"state": (y.detach(), want_y), "dx0": (xr.grad, dx0), "dgoal": (gr.grad, dgoal),
             **{f"d{k}": (pr[k].grad, grads[k]) for k in fc.WEIGHT_KEYS}}
    errs = {k: scaled_err(a, b) for k, (a, b) in pairs.items()}
    ok = (min(near) >= 0.09 and max(errs.values()) <= CNCA_TOL["float32"]
          and all(bool(torch.isfinite(a).all()) for a, _ in pairs.values()))
    print(f"  gate stress, cnca pair 64^2 b8 x 24 steps: h1 / h2 pre-activations within 1e-6 of "
          f"zero {near[0]:.3f} / {near[1]:.3f} of all; max|kernel-plain|/max|plain|: "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
          + f" (tol {CNCA_TOL['float32']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the cnca training pair under the gate stress disagrees with its "
                         "plain version")
    return near, max(errs.values())


def time_redesigned(torch, ft, fc, cn, ConditionedNCAConfig, _build):
    """nca_bwd_adjoint_ms at 256^2 b3 f32 (c16) and cnca_update at 64^2 b8
    and b1 f32 (C 20 / D 64): ms a launch by CUDA events and by the
    profiler's device time, beside the float32 bound; blocks an SM; ptxas'
    registers and spills (of every adjoint kernel too); two launches on the
    same inputs checked for the same bits. Returns {(name, label): (ms, device ms, f32
    bound, blocks an SM)}."""
    want = False
    for line in (_build.build_log("nca_train") + _build.build_log("nca_cnca")).splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            want = any(k in line for k in ("nca_bwd_adjoint", "cnca_update"))
            if want and "Compiling" in line:
                print(f"    ptxas: {line.split('function', 1)[1].strip()}")
        elif want and ("registers" in line or "spill" in line):
            print(f"    ptxas:   {line.strip()}")
    out = {}
    g = torch.Generator().manual_seed(3)
    gp = torch.randn((3, 64, VM_SIZE, VM_SIZE), generator=g).cuda()
    gx = torch.randn((3, 16, VM_SIZE, VM_SIZE), generator=g).cuda()
    runs = [gx.clone() for _ in range(2)]
    for r in runs:
        ft._launch_adjoint(gp, r, None, True)
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    launch = lambda: ft._launch_adjoint(gp, runs[0], None, True)  # noqa: E731
    k_ms, dev = cuda_ms(launch, 20), device_ms(torch, launch)
    bound = ms_bound_ms("nca_bwd_adjoint_ms", 16, 2, 128, 3 * VM_SIZE * VM_SIZE)[0]
    blocks, smem = ft.adjoint_ms_occupancy()
    out[("nca_bwd_adjoint_ms", "256^2 b3 float32")] = (k_ms, dev, bound, blocks)
    print(f"  nca_bwd_adjoint_ms 256^2 b3 f32: kernel {k_ms:.4f} ms/launch (CUDA events), "
          f"{dev:.4f} device (profiler); float32 bound {bound:.5f} ms (bytes, {dev / bound:.1f}x); "
          f"{blocks} blocks an SM ({smem / 1000:.1f} KB of shared memory); "
          f"two launches bit-identical: {same}")
    if not same:
        raise SystemExit("nca_bwd_adjoint_ms: two launches on the same inputs differ")
    for b in (8, 1):
        cfg, params, x, goal = cnca_case(torch, cn, ConditionedNCAConfig, (b, 64, 64))
        packed = fc.pack_weights(params, cfg, "float32")
        thr = fc.fs.uniform_threshold(0.5)
        outs = [torch.empty_like(x) for _ in range(2)]
        for o in outs:
            fc.launch_update(x, goal, o, packed, cfg, "float32", 3, 5, thr)
        torch.cuda.synchronize()
        same = torch.equal(outs[0], outs[1])
        launch = lambda: fc.launch_update(x, goal, outs[0], packed, cfg,  # noqa: E731
                                          "float32", 3, 5, thr)
        k_ms, dev = cuda_ms(launch, 20), device_ms(torch, launch)
        bound, by = cnca_bound_ms("cnca_update", 20, 64, b * 64 * 64)
        blocks, smem = fc.update_occupancy(20, 64)
        out[("cnca_update", f"64^2 b{b} float32")] = (k_ms, dev, bound, blocks)
        print(f"  cnca_update 64^2 b{b} f32: kernel {k_ms:.4f} ms/launch (CUDA events), "
              f"{dev:.4f} device (profiler); float32 bound {bound:.5f} ms ({by}, "
              f"{dev / bound:.1f}x); {blocks} "
              f"blocks an SM ({smem / 1000:.1f} KB of shared memory); two launches "
              f"bit-identical: {same}")
        if not same:
            raise SystemExit("cnca_update: two launches on the same inputs differ")
    return out


def time_mat_gate(torch, fs, fc, cn, ConditionedNCAConfig, _build, cfg, params):
    """The kernels redesigned last, at their main-path shapes: nca_step_mat
    at 256^2 b1 edges (c12/fc96) in the form each compute type takes (the
    tensor cores under f32, the chain under bf16; fused_step.chain_form) and
    cnca_gate at 64^2 b8 and b1 (C 20): ms a launch by CUDA events and by
    the profiler's device time, beside the bound (nca_step_mat: its
    tensor-core bound, the float32 CUDA-core bound beside it); blocks an SM; ptxas' registers
    and spills; two launches on the same inputs checked for the same bits.
    Returns {(name, label): (ms, device ms, float32 bound, blocks an SM)}
    and nca_step_mat's {form: (f32 bound, tc bound)}."""
    want = False
    for line in (_build.build_log("nca_step") + _build.build_log("nca_cnca")).splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            # nca_step_kernel's MAT instantiations end their template list in Lb1EE
            want = "cnca_gate" in line or ("nca_step_kernel" in line and "Lb1EEv" in line)
            if want and "Compiling" in line:
                print(f"    ptxas: {line.split('function', 1)[1].strip()}")
        elif want and ("registers" in line or "spill" in line):
            print(f"    ptxas:   {line.strip()}")
    out, bounds = {}, {}
    g = torch.Generator().manual_seed(8)
    x = (torch.rand((1, 12, 256, 256), generator=g) - 0.5).cuda()
    cond = (torch.rand((1, 3, 256, 256), generator=g) - 0.5).cuda()
    thr = fs.uniform_threshold(0.5)
    for cdt in ("float32", "bfloat16"):
        chain = fs.chain_form("nca_step_mat", cdt)
        name = "nca_step_mat" + ("_chain" if chain else "")
        packed = fs.pack_weights(params, 12, 3, cdt, True)
        outs = [torch.empty_like(x) for _ in range(2)]
        for o in outs:
            fs.launch_step(x, o, cond, packed, "circular", cdt, 5, 17, thr, mat=True, chain=chain)
        torch.cuda.synchronize()
        same = torch.equal(outs[0], outs[1])
        launch = lambda: fs.launch_step(x, outs[0], cond, packed, "circular", cdt, 5,  # noqa
                                        17, thr, mat=True, chain=chain)
        k_ms, dev = cuda_ms(launch, 20), device_ms(torch, launch)
        tcb, by = tc_bound_ms(name, 12, 3, 96, 256 * 256, cdt)
        f32b = form_bound_ms(name, 12, 3, 96, 256 * 256, "float32")[0]
        blocks, smem = fs.step_occupancy(12, 3, 96, cdt, False, "mat")
        out[(name, f"256^2 b1 edges {cdt}")] = (k_ms, dev, f32b, blocks)
        bounds[name] = (f32b, tcb)
        print(f"  {name} 256^2 b1 edges {cdt}: kernel {k_ms:.4f} ms/launch (CUDA events), "
              f"{dev:.4f} device (profiler); tensor-core bound {tcb:.5f} ms ({by}, "
              f"{dev / tcb:.1f}x), float32 CUDA-core bound {f32b:.5f} ({dev / f32b:.1f}x); "
              f"{blocks} blocks an SM ({smem / 1000:.1f} KB of shared memory); two launches "
              f"bit-identical: {same}")
        if not same:
            raise SystemExit(f"{name}: two launches on the same inputs differ")
    for b in (8, 1):
        gcfg, _, xg, _ = cnca_case(torch, cn, ConditionedNCAConfig, (b, 64, 64))
        xn = xg + 0.3 * torch.randn(xg.shape, generator=torch.Generator().manual_seed(b)).cuda()
        outs = [torch.empty_like(xg) for _ in range(2)]
        lives = [torch.empty((b, 64, 64), dtype=torch.uint8, device="cuda") for _ in range(2)]
        for o, li in zip(outs, lives):
            fc.launch_gate(xg, xn, o, li, gcfg)
        torch.cuda.synchronize()
        same = torch.equal(outs[0], outs[1]) and torch.equal(lives[0], lives[1])
        launch = lambda: fc.launch_gate(xg, xn, outs[0], lives[0], gcfg)  # noqa: E731
        k_ms, dev = cuda_ms(launch, 50), device_ms(torch, launch, 50)
        bound, by = cnca_bound_ms("cnca_gate", 20, 64, b * 64 * 64)
        n_blocks, blocks, smem = fc.gate_geometry(b, 20, 64, 64)
        out[("cnca_gate", f"64^2 b{b} float32")] = (k_ms, dev, bound, blocks)
        print(f"  cnca_gate 64^2 b{b} C20 f32: kernel {k_ms:.4f} ms/launch (CUDA events), "
              f"{dev:.4f} device (profiler); bound {bound:.5f} ms ({by}, {dev / bound:.1f}x); "
              f"{n_blocks} blocks, {blocks} an SM ({smem / 1000:.1f} KB of shared memory); two "
              f"launches bit-identical: {same}")
        if not same:
            raise SystemExit("cnca_gate: two launches on the same inputs differ")
    return out, bounds


def time_adjoints(torch, ft, fc, cn, ConditionedNCAConfig, F):
    """The redesigned single-scale adjoints, nca_bwd_adjoint at 128^2 b4
    C 12 and cnca_bwd_adjoint at 64^2 b8 C 20, f32: ms a launch by CUDA
    events and by the profiler's device time, beside the float32 bound; the
    launch's blocks and blocks an SM; two launches on the same inputs
    checked for the same bits. Then row 12's library yardstick, one PyTorch
    call that computes cnca_bwd_adjoint's g_xg (not its g and dgoal
    updates): F.conv_transpose2d(gp, wcol.view(3C, 1, 3, 3), padding=1,
    groups=C) on the same gp (cuDNN, TF32 off), by the same two clocks, its
    output held to the plain version's g_xg. Returns {name: (ms, device ms,
    f32 bound, blocks, blocks an SM)} and the call's (ms, device ms)."""
    out = {}
    g = torch.Generator().manual_seed(9)
    gp = torch.randn((4, 48, 128, 128), generator=g).cuda()
    gx = torch.randn((4, 12, 128, 128), generator=g).cuda()
    runs = [gx.clone() for _ in range(2)]
    for r in runs:
        ft._launch_adjoint(gp, r)
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    launch = lambda: ft._launch_adjoint(gp, runs[0])  # noqa: E731
    k_ms, dev = cuda_ms(launch, 50), device_ms(torch, launch, 50)
    bound, by = train_bound_ms("nca_bwd_adjoint", 12, 2, 96, 4 * 128 * 128)
    n_blocks, blocks, smem = ft.adjoint_geometry(4, 12, 128, 128)
    out["nca_bwd_adjoint"] = (k_ms, dev, bound, n_blocks, blocks)
    print(f"  nca_bwd_adjoint 128^2 b4 C12 f32: kernel {k_ms:.4f} ms/launch (CUDA events), "
          f"{dev:.4f} device (profiler); float32 bound {bound:.5f} ms ({by}, {dev / bound:.1f}x); "
          f"{n_blocks} blocks, {blocks} an SM ({smem / 1000:.1f} KB of shared memory); two "
          f"launches bit-identical: {same}")
    if not same:
        raise SystemExit("nca_bwd_adjoint: two launches on the same inputs differ")
    cfg, params, x, _ = cnca_case(torch, cn, ConditionedNCAConfig, (8, 64, 64))
    wcol = fc.pack_weights(params, cfg, "float32")[0]
    gp = torch.randn((8, 60, 64, 64), generator=g).cuda()
    g0 = torch.randn(x.shape, generator=g).cuda()
    runs = [(g0.clone(), torch.zeros_like(x)) for _ in range(2)]
    for gr, dr in runs:
        fc._launch_bwd_adjoint(x, gp, wcol, gr, dr, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    launch = lambda: fc._launch_bwd_adjoint(x, gp, wcol, *runs[0], cfg)  # noqa: E731
    k_ms, dev = cuda_ms(launch, 50), device_ms(torch, launch, 50)
    bound, by = cnca_bound_ms("cnca_bwd_adjoint", 20, 64, 8 * 64 * 64)
    n_blocks, blocks, smem = fc.bwd_adjoint_geometry(8, 20, 64, 64)
    out["cnca_bwd_adjoint"] = (k_ms, dev, bound, n_blocks, blocks)
    print(f"  cnca_bwd_adjoint 64^2 b8 C20 f32: kernel {k_ms:.4f} ms/launch (CUDA events), "
          f"{dev:.4f} device (profiler); float32 bound {bound:.5f} ms ({by}, {dev / bound:.1f}x); "
          f"{n_blocks} blocks, {blocks} an SM ({smem / 1000:.1f} KB of shared memory); two "
          f"launches bit-identical: {same}")
    if not same:
        raise SystemExit("cnca_bwd_adjoint: two launches on the same inputs differ")
    weight = wcol.view(60, 1, 3, 3)
    call = lambda: F.conv_transpose2d(gp, weight, padding=1, groups=20)  # noqa: E731
    want = fc.cnca_bwd_adjoint_reference(x, gp, torch.zeros_like(x), wcol, cfg)[0]
    err = scaled_err(call(), want)
    lib_ms, lib_dev = cuda_ms(call, 50), device_ms(torch, call, 50)
    print(f"  library yardstick for cnca_bwd_adjoint (g_xg alone): F.conv_transpose2d(gp, "
          f"wcol.view(60, 1, 3, 3), padding=1, groups=20) 64^2 b8 f32: {lib_ms:.4f} ms/call (CUDA "
          f"events), {lib_dev:.4f} device (profiler); its g_xg against the plain version's "
          f"{err:.2e} of max; the kernel {dev / lib_dev:.2f}x its device time")
    if err > 1e-5:
        raise SystemExit("F.conv_transpose2d does not compute cnca_bwd_adjoint's g_xg")
    return out, (lib_ms, lib_dev)


def time_vgg_pool(torch, vgg_mod, F):
    """VGG16's loss forward and backward (the five style taps and the
    content tap, the sum of squares of each, d/d image) with the
    equality-mask 2x2 pool (ops.conv.max_pool_2d) and, in turns, with
    F.max_pool2d (the pool before the repair), at static_texture's (128^2,
    batch 4) and video_motion's (256^2, 9 frames) shapes. Returns
    {label: (eq ms, F.max_pool2d ms)}."""
    params = vgg_mod.vgg16_random_init(torch.Generator().manual_seed(16), device="cuda")
    layers = vgg_mod.STYLE_LAYERS + (vgg_mod.CONTENT_LAYER,)
    pools = {"eq": vgg_mod.max_pool_2d, "torch": lambda x, w, s: F.max_pool2d(x, w, s)}
    out = {}
    for label, shape in (("128^2 b4", (4, 3, 128, 128)), ("256^2 b9", (9, 3, 256, 256))):
        img = torch.rand(shape, generator=torch.Generator().manual_seed(4)).cuda()

        def run():
            x = img.clone().requires_grad_()
            loss = sum(f.square().sum() for f in vgg_mod.vgg16_features(params, x, layers))
            loss.backward()

        times = {}
        for which in ("torch", "eq", "eq", "torch"):
            vgg_mod.max_pool_2d = pools[which]
            times.setdefault(which, []).append(cuda_ms(run, 3, rounds=3))
        vgg_mod.max_pool_2d = pools["eq"]
        out[label] = (statistics.median(times["eq"]), statistics.median(times["torch"]))
        print(f"  VGG16 loss forward + backward {label}: equality-mask pool "
              f"{out[label][0]:.3f} ms, F.max_pool2d {out[label][1]:.3f} ms "
              f"(turns torch, eq, eq, torch)")
    return out


# ------------------------------------ the conditioned and vector-field presets

COND_STEPS = 128  # the longest rollout of edge_conditioned, extra_channels and
# vector_field_motion (step_range (32, 128))


def phase_compare_conditioned(torch, ft, NCAConfig, dynca_init):
    """The training pair at the extra_channels cell (C 13, 12 seed channels,
    no conditioning: a percept of 52 rows, so nca_bwd_mlp's last depth block
    of 16 is ragged) at 40x72 b2 x 4 steps (rates 1 and 0.5, f32 and bf16)
    and 256^2 b2 x 16 steps f32, and at the edge_conditioned cell (edges,
    taken as the trainer takes it: without a cotangent) at 256^2 b2 x 32
    steps f32; then each backward kernel alone at both cells' 256^2 b2
    shape. Returns the largest absolute difference of each kernel's
    outputs."""
    worst = {"nca_step_chain": 0.0, "nca_bwd_mlp": 0.0, "nca_bwd_adjoint": 0.0}

    def pair(*args, **kw):
        y_err, _ = check_train_pair(torch, ft, NCAConfig, dynca_init, *args, **kw)
        worst["nca_step_chain"] = max(worst["nca_step_chain"], y_err)

    extra = dict(c_in=13, seed_channels=12, conditioning=None)
    for rate in (1.0, 0.5):
        for cdt in ("float32", "bfloat16"):
            pair(f"C13 40x72 b2 4 steps rate {rate} {cdt}", extra, (2, 13, 40, 72), 4, rate,
                 cdt)
    pair("C13 256^2 b2 16 steps rate 0.5 float32", extra, (2, 13, 256, 256), 16, 0.5,
         "float32")
    pair("edges 256^2 b2 32 steps rate 0.5 f32 no dcond", dict(c_in=12, conditioning="edges"),
         (2, 12, 256, 256), 32, 0.5, "float32", cond_no_grad=True)
    for c, cc, cell in ((13, 0, "extra_channels"), (12, 3, "edge_conditioned")):
        mlp_abs, adj_abs, mlp_rel, adj_rel = check_backward_kernels(
            torch, ft, NCAConfig, dynca_init, c, cc, (2, c, 256, 256))
        worst["nca_bwd_mlp"] = max(worst["nca_bwd_mlp"], mlp_abs)
        worst["nca_bwd_adjoint"] = max(worst["nca_bwd_adjoint"], adj_abs)
        ok = mlp_rel <= TRAIN_TOL["float32"] and adj_rel <= TRAIN_TOL["float32"]
        print(f"  one launch each at the {cell} cell (C {c}, cc {cc}) 256^2 b2 f32: nca_bwd_mlp "
              f"max|kernel-plain| {mlp_abs:.3e} ({mlp_rel:.2e} of max|plain|), "
              f"nca_bwd_adjoint {adj_abs:.3e} ({adj_rel:.2e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"a backward kernel disagrees with its plain version at the {cell} "
                             "cell")
    return worst


def flow_target_field(torch, cfg, loss_cfg, params, msoe, states, aux, step_n: int):
    """A target field along the MSOE flow of the first item's train-step
    frames (the 1-step pre-roll and the step_n-step rollout, on the CPU at
    update rate 1, where the masks play no part), each component scaled by
    1 + 0.2 x noise from RandomState(11): the cosine gate of the
    vector-field term then lets its strength part through, which it shuts
    against a synthetic field at random weights."""
    from vsnca_tpu_torch.models.dynca import dynca_rollout, make_conditioning, to_rgb
    from vsnca_tpu_torch.models.msoe import motion_pair_from_rgb, msoe_forward

    cond = make_conditioning(cfg, tuple(states.shape[-2:]), cond_img=aux.mean(dim=1,
                                                                              keepdim=True),
                             batch=states.shape[0], device="cpu")
    with torch.no_grad():
        pre, _ = dynca_rollout(params, states, 0, cfg, 1, cond, rollout_path="xla")
        _, after = dynca_rollout(params, states, 0, cfg, step_n, cond, rollout_path="xla")
        flow = msoe_forward(msoe, motion_pair_from_rgb(to_rgb(pre, cfg.c_out), after,
                                                       loss_cfg.motion_img_size))[:1]
    noise = np.random.RandomState(11).randn(*flow.shape).astype(np.float32)
    return flow * (1.0 + 0.2 * torch.from_numpy(noise))


def phase_edge_step_parity(torch, make_train_step, LossState, presets, dynca_init,
                           vgg16_random_init, msoe_random_init, make_optimizer):
    """One edge_conditioned train step on the card (the training pair, and
    the tensor-core step for the pre-roll) against the same step on the CPU
    (eager steps): the preset's cell and losses at 32^2 (OT, auxiliary VGG,
    vector-field motion, overflow; nothing subsampled), batch 2, 8 steps,
    update rate 1, float32, against a target field along the step's own
    flow (``flow_target_field``), so that the vector-field term's strength
    part and its gradient are held too."""
    nca, loss_cfg, _ = presets.edge_conditioned(32)
    cfg = dataclasses.replace(nca, update_rate=1.0)
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    vgg = vgg16_random_init(torch.Generator().manual_seed(16), device="cpu")
    msoe = msoe_random_init(torch.Generator().manual_seed(175), device="cpu")
    g = torch.Generator().manual_seed(1)
    states = torch.rand((2, 12, 32, 32), generator=g) - 0.5
    style = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    aux = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    field = flow_target_field(torch, cfg, loss_cfg, params, msoe, states, aux, 8)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().clone().to(dev).requires_grad_() for k, v in params.items()}
        state = LossState(cfg=loss_cfg, vgg_params=[{k: v.to(dev) for k, v in d.items()}
                                                    for d in vgg],
                          msoe_params={k: v.to(dev) for k, v in msoe.items()},
                          target_field=field.to(dev))
        step = make_train_step(cfg, state, "none", "auto")
        inputs = {"target_style": style.to(dev), "aux_imgs": aux.to(dev),
                  "aux_gs": aux.to(dev).mean(dim=1, keepdim=True)}
        _, _, new_states, loss, logs = step(p, make_optimizer(p, 1e-3), states.to(dev), 4,
                                            inputs, step_n=8)
        out[dev] = (float(loss), {k: float(v) for k, v in logs.items()},
                    {k: v.detach().cpu() for k, v in p.items()}, new_states.cpu())
    (lc, gc, pc, sc), (lg, gg, pg, sg) = out["cpu"], out["cuda"]
    p_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    s_err = float((sg - sc).abs().max())
    log_err = max(abs(gg[k] - gc[k]) / max(abs(gc[k]), 1e-6) for k in gc)
    strength = "vector_field_motion-strength"
    ok = (abs(lg - lc) <= 1e-4 * abs(lc) and log_err <= 1e-4 and p_err <= 5e-5
          and s_err <= 1e-4 and set(gg) == set(gc) and gc.get(strength, 0.0) > 0.0)
    print(f"  edge_conditioned train step card vs CPU, 32^2 b2 c12/fc96 edges, 8 steps, field "
          f"along the flow: loss {lg:.6f} vs {lc:.6f} (terms {sorted(gc)} within "
          f"{log_err:.1e}; strength {gg.get(strength, 0.0):.6f} vs {gc.get(strength, 0.0):.6f}, "
          f"open: {gc.get(strength, 0.0) > 0.0}), params max diff {p_err:.2e} (tol 5e-05), new "
          f"states {s_err:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the edge_conditioned train step on the card disagrees with the CPU")


def conditioned_trainer(torch, presets, DyNCATrainer, synthetic_style_image, synthetic_video,
                        precompute_target_style_features, preset, extractors, **train_kw):
    """DyNCATrainer with ``preset`` at full width and size (``train_kw``
    replaces TrainConfig fields), the VGG16 and MSOE ``extractors``, the
    synthetic style image with its features precomputed as the CLI does
    and, for the content-conditioned presets, the CLI's 8 synthetic content
    frames on the card. Returns (trainer, inputs, content frames or None)."""
    nca, loss, train = presets.PRESETS[preset]()
    train = dataclasses.replace(train, **train_kw)
    vgg, msoe = extractors
    trainer = DyNCATrainer(nca, loss, train, vgg_params=vgg, msoe_params=msoe, device="cuda")
    hw = train.img_size
    style = synthetic_style_image(hw, train.batch_size)
    style = torch.from_numpy(style * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().cuda()
    inputs = {"target_style": style,
              "target_style_features": precompute_target_style_features(
                  vgg, style, loss.appearance_loss_type, hw)}
    frames = None
    if preset in ("edge_conditioned", "extra_channels"):
        frames = torch.from_numpy(synthetic_video(hw, 8)).permute(0, 3, 1, 2).contiguous().cuda()
    return trainer, inputs, frames


def content_inputs(torch, inputs, frames, rng, batch: int):
    """One iteration's inputs with content frames drawn as the CLI draws
    them (``rng.choice`` with replacement) and their channel-mean
    grayscale; ``inputs`` as they are without frames."""
    if frames is None:
        return inputs
    idx = rng.choice(frames.shape[0], batch, replace=True)
    aux = frames[torch.as_tensor(idx, device=frames.device)]
    return {**inputs, "aux_imgs": aux, "aux_gs": aux.mean(dim=1, keepdim=True)}


def phase_conditioned_train(torch, ft, fs, trainer, inputs, frames, steps, label: str):
    """Iterations of a conditioned or vector-field preset at ``steps``, the
    content drawn as the CLI draws it: nca_step (the training forward, its
    chain form), nca_bwd_mlp and nca_bwd_adjoint sum(step_n) times each,
    nca_step's tensor-core form once an iteration (the vector-field
    pre-roll), no multiscale launch; the loss and every log term finite;
    the pool written back with ``n_seed_channels`` channels. Returns
    (launches by kernel: the pair's, and the tensor-core step's as
    'nca_step_tc'; the step counts)."""
    rng = np.random.RandomState(42)
    reset_counts(ft, fs)
    logs, written = [], []
    for n in steps:
        logs.append(trainer.train_iteration(
            content_inputs(torch, inputs, frames, rng, trainer.train_cfg.batch_size), step_n=n))
        idx = trainer.last_batch_idx
        written.append(bool(torch.isfinite(trainer.pool.states[idx]).all())
                       and float(trainer.pool.states[idx].abs().max()) > 0)
    torch.cuda.synchronize()
    launches = dict(ft.KERNEL_LAUNCHES)
    fs_launches = dict(fs.KERNEL_LAUNCHES)
    total = sum(steps)
    pair = ("nca_step", "nca_bwd_mlp", "nca_bwd_adjoint")
    checks = {
        "loss and every log term finite, with vector_field_motion": all(
            np.isfinite(l.loss) and "vector_field_motion" in l.logs
            and all(np.isfinite(v) for v in l.logs.values()) for l in logs),
        "nca_step == nca_bwd_mlp == nca_bwd_adjoint == sum(step_n)":
            all(launches[k] == total for k in pair),
        "no multiscale launches": all(launches[k] == 0 for k in launches if k not in pair),
        "fused_step: nca_step_chain == sum(step_n), tensor-core nca_step == iterations":
            fs_launches["nca_step_chain"] == total and fs_launches["nca_step"] == len(steps)
            and fs.LAUNCHES == total + len(steps),
        f"pool written back (finite, non-zero, {trainer.nca_cfg.n_seed_channels} channels)":
            all(written) and trainer.pool.states.shape[1] == trainer.nca_cfg.n_seed_channels,
    }
    for log, n in zip(logs, steps):
        terms = " ".join(f"{k}={v:.4f}" for k, v in log.logs.items())
        print(f"  {label} iter {log.iteration} step_n {n}: loss={log.loss:.4f} {terms}")
    print(f"  launches {launches}, fused_step {fs_launches} for sum(step_n) = {total}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit(f"{label} training phase failed")
    return {**launches, "nca_step_tc": fs_launches["nca_step"]}, steps


def phase_extra_channels(torch, ft, fs, dynca_mod, trainer, inputs, frames):
    """extra_channels for 2 iterations (32 and 128 steps): the training pair
    sees 13 channels (the content's grayscale appended) and the pool keeps
    12."""
    seen = []
    pair = dynca_mod.fused_rollout_train

    def recording(params, x, *args, **kw):
        seen.append(int(x.shape[1]))
        return pair(params, x, *args, **kw)

    dynca_mod.fused_rollout_train = recording
    try:
        launches, steps = phase_conditioned_train(torch, ft, fs, trainer, inputs, frames,
                                                  [32, 128], "extra_channels")
    finally:
        dynca_mod.fused_rollout_train = pair
    ok = seen == [13, 13] and trainer.pool.states.shape[1] == 12
    print(f"  the pair saw {seen} channels, the pool keeps {trainer.pool.states.shape[1]}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("extra_channels: the content channel is not appended or not stripped")
    return launches, steps


def phase_edge_cli(load_params_pickle):
    """``python -m vsnca_tpu_torch.train.cli --preset edge_conditioned`` in a
    subprocess, 2 iterations on the synthetic content frames; it prints the
    parameter count and its checkpoint must load. The run's directory (the
    checkpoint holds the 805 MB pool) is removed afterwards."""
    import shutil

    out = "out/chip_smoke_edge_cli"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vsnca_tpu_torch.train.cli", "--preset", "edge_conditioned",
         "--max-iterations", "2", "--log-every", "1", "--out", out],
        capture_output=True, text=True, timeout=600,
    )
    print("\n".join(f"    {line}" for line in r.stdout.strip().splitlines()))
    if r.returncode != 0:
        print(r.stderr[-4000:])
        raise SystemExit(f"the edge_conditioned CLI exited {r.returncode}")
    params = load_params_pickle(f"{out}/checkpoint", "cpu")
    shutil.rmtree(out)
    ok = (tuple(params["w1"].shape) == (51, 96) and tuple(params["w2"].shape) == (96, 12)
          and "DyNCA param count: 6156;" in r.stdout)
    print(f"  edge_conditioned CLI: 2 iterations in {time.perf_counter() - t0:.1f} s (process "
          f"start, kernel load and target features included); parameter count printed, "
          f"checkpoint loads: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the edge_conditioned CLI's checkpoint does not load")


def phase_vf_protocol(torch, ft, presets, VectorFieldProtocol, extractors,
                      synthetic_style_image):
    """VectorFieldProtocol at the vector_field_motion preset (c12/fc96,
    128^2, b4), 2 iterations with recalibrate_every 1: at iteration 1 the
    weight becomes median(appearance log) / 50, in place."""
    nca, loss, train = presets.vector_field_motion()
    style = synthetic_style_image(train.img_size, train.batch_size)
    style = torch.from_numpy(style * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().cuda()
    proto = VectorFieldProtocol(nca, loss, dataclasses.replace(train, max_iterations=2), style,
                                recalibrate_every=1, device="cuda")
    reset_counts(ft)
    t0 = time.perf_counter()
    trainer = proto.run(*extractors)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = float(np.median(np.asarray(proto._appearance_log[:2])) / 50.0)
    launches = dict(ft.KERNEL_LAUNCHES)
    checks = {
        "two iterations, losses finite": trainer.iteration == 2
        and all(np.isfinite(h.loss) for h in trainer.history),
        "one recalibration, at iteration 1, to median(appearance log) / 50":
            proto.recalibrations == [(1, want)],
        "the live loss takes the weight": trainer.loss_state.cfg.vector_field_motion_weight
        == want == proto.loss_cfg.vector_field_motion_weight,
        "the pair's kernels launched alike": launches["nca_step"] == launches["nca_bwd_mlp"]
        == launches["nca_bwd_adjoint"] > 0,
    }
    print(f"  appearance log {proto._appearance_log}; recalibrated vector_field_motion weight "
          f"{proto.loss_cfg.vector_field_motion_weight:.6f} (from 4.0); {secs:.2f} s")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("vector-field protocol phase failed")


def time_conditioned_losses(torch, trainer, inputs, frames, extractors, appearance_loss,
                            auxiliary_loss, vector_field_motion_loss, overflow_loss,
                            make_conditioning, dynca_rollout):
    """Each loss term of a 128-step edge_conditioned iteration alone, its
    forward without autograd, on the frame of a 128-step rollout from the
    pool (CUDA events, median): VGG16 + OT appearance, VGG16 content
    (auxiliary VGG, the target's features included), MSOE + the vector-field
    term, overflow."""
    vgg, msoe = extractors
    cfg, loss_cfg = trainer.nca_cfg, trainer.loss_state.cfg
    it = content_inputs(torch, inputs, frames, np.random.RandomState(0), 2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        params = {k: v.detach() for k, v in trainer.params.items()}
        x0 = trainer.pool.states[:2].contiguous()
        cond = make_conditioning(cfg, tuple(x0.shape[-2:]), cond_img=it["aux_gs"], batch=2)
        state, rgb = dynca_rollout(params, x0, 0, cfg, COND_STEPS, cond)
        before = dynca_rollout(params, x0, 1, cfg, 1, cond)[1]
        field = trainer.loss_state.target_field
        out = {
            "OT appearance (VGG16)": cuda_ms(lambda: appearance_loss(
                vgg, rgb, it["target_style"], "OT", it["target_style_features"], gen,
                loss_cfg.ot_subsample), 2, rounds=3),
            "auxiliary VGG (VGG16 content)": cuda_ms(lambda: auxiliary_loss(
                vgg, rgb, it["aux_imgs"], "VGG"), 2, rounds=3),
            "vector field (MSOE)": cuda_ms(lambda: vector_field_motion_loss(
                msoe, before, rgb, field, COND_STEPS, loss_cfg.nca_base_num_steps,
                loss_cfg.motion_img_size, loss_cfg.motion_strength_weight,
                loss_cfg.motion_direction_weight), 2, rounds=3),
            "overflow": cuda_ms(lambda: overflow_loss(state), 10, rounds=3),
        }
    print("  of the loss forward, each term alone without autograd, b2 at 256^2: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


# ------------------------------------- the product's lifecycle (PR 12's phase)

LIFE_SIZE = 128  # the CLI lifecycle's grid: its pool, 256 x 12 x 128^2 x 4 B = 201 MB a checkpoint
EXPORT_SIZE = 256  # validate_export's grid
EXPORT_STEPS = 24


def decode_mp4(path: str) -> np.ndarray:
    """Every frame of an mp4, [T, H, W, 3] uint8 (OpenCV's BGR)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0,), np.uint8)


def uint8_bound(path: str) -> float:
    """Half a uint8 step of the widest layer of an exported model, + 1e-6."""
    with open(path) as f:
        return max(layer["scale"] for layer in json.load(f)["layers"]) / 510.0 + 1e-6


def export_float_rollout(torch, cfg, params, device: str):
    """validate_export's float-model rollout alone, on ``device``: its seed
    state, conditioning and seed (0), EXPORT_SIZE^2 x EXPORT_STEPS. Returns
    (seed state, final state), both on the CPU."""
    from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning

    n = EXPORT_SIZE
    params = {k: torch.as_tensor(v).to(device, torch.float32) for k, v in params.items()}
    x = dynca_seed(cfg, 1, n, generator=torch.Generator().manual_seed(0), device=device)
    cond_img = (torch.zeros((1, 1, n, n), device=device)
                if cfg.conditioning == "edges" else None)
    cond = make_conditioning(cfg, (n, n), cond_img=cond_img, batch=1, device=device)
    with torch.no_grad():
        out, _ = dynca_rollout(params, x, 0, cfg, EXPORT_STEPS, cond)
    return x.cpu(), out.cpu()


def phase_lifecycle(torch, fs, ft, presets, dynca_init, VectorFieldProtocol, extractors,
                    synthetic_style_image, card: str):
    """The product's lifecycle on the card, at edge_conditioned's widths:
    (1) ``python -m vsnca_tpu_torch.train.cli --preset edge_conditioned
    --img-size 128 --max-iterations 2 --save-every 1 --make-videos
    --eval-videos DIR`` in a subprocess writes args.json, metrics.jsonl, the
    previews, the loss plot where matplotlib is installed, the checkpoint,
    both control videos and DIR's clip stylized; ``--video-only
    --checkpoint`` on that checkpoint writes the same control-video frames;
    (2) in this process, the checkpoint loads with ``load_checkpoint``,
    exports with ``save_webgl_model`` and ``validate_export`` runs at 256^2
    x 24 steps on the card (48 nca_step launches; a video_motion-cell
    export, scales (0, 1), 48 nca_step_ms launches) within half a uint8
    step and within 1e-4 of the same call on the CPU, and the float model's
    rollout on the card within TOL["float32"] of the CPU's; (3)
    ``VectorFieldProtocol`` (vector_field_motion, 128^2, 2 iterations,
    save_every 1) writes its 1x and 2x videos, flow images and, where
    matplotlib is installed, the field plots; (4) times: the CLI's wall
    time, a checkpoint's write time and bytes, the control videos' frames/s
    after a one-frame warm-up (frames made and mp4 encode apart),
    validate_export's device time. Returns
    (launches by kernel, metrics)."""
    import shutil

    from vsnca_tpu_torch.config import edge_conditioned
    from vsnca_tpu_torch.data.preprocess import synthetic_video
    from vsnca_tpu_torch.export.checkpoint import load_checkpoint, save_checkpoint
    from vsnca_tpu_torch.export.webgl import save_webgl_model
    from vsnca_tpu_torch.export.webgl_sim import validate_export
    from vsnca_tpu_torch.infer.stylize import generate_control_frames
    from vsnca_tpu_torch.utils.display import plotting_available
    from vsnca_tpu_torch.utils.video_writer import VideoWriter, generate_control_videos

    root = "out/chip_smoke_lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    plots = plotting_available()
    checks, metrics = {}, {}
    with VideoWriter(f"{root}/evals/clip.mp4", fps=30) as w:
        for f in synthetic_video((LIFE_SIZE, LIFE_SIZE), 8):
            w.add((f + 1.0) / 2.0)
    out, again = f"{root}/edges", f"{root}/again"
    base = [sys.executable, "-m", "vsnca_tpu_torch.train.cli", "--preset", "edge_conditioned",
            "--img-size", str(LIFE_SIZE)]
    runs = {}
    for label, args in (("train", ["--max-iterations", "2", "--save-every", "1", "--log-every",
                                   "1", "--make-videos", "--eval-videos", f"{root}/evals",
                                   "--out", out]),
                        ("video-only", ["--video-only", "--checkpoint", f"{out}/checkpoint",
                                        "--out", again])):
        t0 = time.perf_counter()
        r = subprocess.run(base + args, capture_output=True, text=True, timeout=600)
        runs[label] = time.perf_counter() - t0
        print("\n".join(f"    {line}" for line in r.stdout.strip().splitlines()))
        if r.returncode != 0:
            print(r.stderr[-4000:])
            raise SystemExit(f"the CLI ({label}) exited {r.returncode}")
        runs[label + " stdout"] = r.stdout
    for f in ("args.json", "metrics.jsonl", "artifacts/step_0.png", "artifacts/step_1.png",
              "checkpoint/state.pkl", "checkpoint/metadata.json", "videos/style_img.mp4",
              "videos/black_img.mp4", "videos/clip.mp4"):
        checks[f"CLI wrote {f}"] = os.path.isfile(f"{out}/{f}") and os.path.getsize(
            f"{out}/{f}") > 0
    checks[f"loss plot written iff matplotlib is installed ({plots})"] = (
        os.path.isfile(f"{out}/artifacts/loss_plot.png") == plots
        and (plots or "matplotlib is not installed" in runs["train stdout"]))
    with open(f"{out}/metrics.jsonl") as f:
        checks["metrics.jsonl holds iterations 0 and 1"] = [
            json.loads(line)["step"] for line in f] == [0, 1]
    videos = {}
    for name in ("style_img", "black_img"):
        first, second = decode_mp4(f"{out}/videos/{name}.mp4"), decode_mp4(
            f"{again}/videos/{name}.mp4")
        videos[name] = first.shape
        checks[f"--video-only's {name} frames equal the first run's"] = (
            first.shape == (64, LIFE_SIZE, LIFE_SIZE, 3) and np.array_equal(first, second))
    checks["the eval clip stylized, 8 frames"] = decode_mp4(f"{out}/videos/clip.mp4").shape == (
        8, LIFE_SIZE, LIFE_SIZE, 3)

    # the checkpoint, its WebGL export and validate_export on the card
    state = load_checkpoint(f"{out}/checkpoint")
    t0 = time.perf_counter()
    save_checkpoint(f"{root}/rewrite", state)
    write_s = time.perf_counter() - t0
    ck_bytes = os.path.getsize(f"{root}/rewrite/state.pkl")
    again_state = load_checkpoint(f"{root}/rewrite")
    checks["checkpoint: pool NHWC [256, 128, 128, 12], rewritten exactly"] = (
        state["pool"].shape == (256, LIFE_SIZE, LIFE_SIZE, 12)
        and np.array_equal(again_state["pool"], state["pool"])
        and all(np.array_equal(again_state["params"][k], v) for k, v in state["params"].items()))
    edge_cfg = edge_conditioned()
    vm_cfg = presets.video_motion()[0]
    vm_params = dynca_init(torch.Generator().manual_seed(0), vm_cfg, device="cpu")
    save_webgl_model(f"{root}/web/edges.json", [state["params"]], ["edges"],
                     edge_conditioning=True)
    save_webgl_model(f"{root}/web/video_motion.json", [vm_params], ["video_motion"],
                     pos_emb=True, n_perception_scales=2)
    launches = {}
    for label, cfg, params, kernel in (("edges", edge_cfg, state["params"], "nca_step"),
                                       ("video_motion", vm_cfg, vm_params, "nca_step_ms")):
        path = f"{root}/web/{label}.json"

        def run(device):
            return validate_export(path, params, cfg, size=EXPORT_SIZE, n_steps=EXPORT_STEPS,
                                   device=device)

        reset_counts(fs, ft)
        got = run("cuda")
        torch.cuda.synchronize()
        counts = {k: v for k, v in fs.KERNEL_LAUNCHES.items() if v}
        launches[kernel] = counts.get(kernel, 0)
        want = run("cpu")
        bound = uint8_bound(path)
        dev_ms = device_ms(torch, lambda: run("cuda"), reps=3)
        metrics[f"validate_export_{label}_device_ms"] = dev_ms
        metrics[f"validate_export_{label}_card"] = got
        metrics[f"validate_export_{label}_cpu"] = want
        print(f"  validate_export {label} at {EXPORT_SIZE}^2 x {EXPORT_STEPS} steps: card {got}; "
              f"cpu {want}; uint8 half step {bound:.6g}; launches {counts}")
        checks[f"{label}: {kernel} launched {2 * EXPORT_STEPS} times, nothing else"] = (
            counts == {kernel: 2 * EXPORT_STEPS})
        checks[f"{label}: weights within half a uint8 step on both devices"] = (
            got["weight_max_abs_diff"] <= bound and want["weight_max_abs_diff"] <= bound)
        checks[f"{label}: state and rgb differences within 1e-4 of the CPU's"] = all(
            abs(got[k] - want[k]) <= 1e-4 for k in ("state_max_abs_diff", "rgb_mean_abs_diff"))
        seed_state, card_state = export_float_rollout(torch, cfg, params, "cuda")
        _, cpu_state = export_float_rollout(torch, cfg, params, "cpu")
        err = float((card_state - cpu_state).abs().max())
        metrics[f"validate_export_{label}_float_rollout_card_vs_cpu"] = err
        print(f"  {label}: the float model's rollout, card against CPU: max|diff| {err:.3e} "
              f"(tol {TOL['float32']:.0e})")
        checks[f"{label}: the float model's rollout on the card within {TOL['float32']:.0e} of "
               f"the CPU's"] = (err <= TOL["float32"] and bool(torch.isfinite(card_state).all())
                                and float((cpu_state - seed_state).abs().max()) > 0)

    # the vector-field protocol's dumps
    nca, loss, train = presets.vector_field_motion()
    style = synthetic_style_image(train.img_size, train.batch_size)
    style = torch.from_numpy(style * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().cuda()
    proto = VectorFieldProtocol(nca, loss, dataclasses.replace(train, max_iterations=2), style,
                                recalibrate_every=0, save_every=1, out_dir=f"{root}/vf",
                                device="cuda")
    reset_counts(fs, ft)
    t0 = time.perf_counter()
    proto.run(*extractors)
    torch.cuda.synchronize()
    vf_s = time.perf_counter() - t0
    vf_tc = fs.KERNEL_LAUNCHES["nca_step"]
    launches["nca_step"] += vf_tc
    n_frames = proto.video_frames
    want_files = {"video_last.mp4", "video_large_last.mp4", "flow_gen0.jpg", "flow_gen1.jpg"}
    if plots:
        want_files |= {"vec_field_gen0.png", "vec_field_gen1.png", "vec_field_target.png"}
    checks[f"protocol dumps written ({sorted(want_files)})"] = set(
        os.listdir(f"{root}/vf")) == want_files
    checks["protocol videos: 1x at 128^2, 2x at 256^2"] = (
        decode_mp4(f"{root}/vf/video_last.mp4").shape == (n_frames, 128, 128, 3)
        and decode_mp4(f"{root}/vf/video_large_last.mp4").shape == (n_frames, 256, 256, 3))
    checks["protocol: tensor-core nca_step once a pre-roll and once a synthesis step"] = (
        vf_tc == 2 + 2 * 2 * n_frames * loss.nca_base_num_steps)

    # the control videos' frames/s, in this process, after one frame each at
    # this shape to warm the stylizer and the mp4 writer; the frames (launches
    # and readout) timed apart from the mp4 encode
    style01 = np.asarray(synthetic_style_image((LIFE_SIZE, LIFE_SIZE), 1)[0])
    generate_control_videos(f"{root}/warm", state["params"], edge_cfg, style01, n_frames=1,
                            step_n=STEPS, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = generate_control_frames(state["params"], edge_cfg, style01 * 2.0 - 1.0, 64, STEPS,
                                   device="cuda")
    t1 = time.perf_counter()
    for name, frames in zip(("style_img", "black_img"), seqs):
        with VideoWriter(f"{root}/ctl/{name}.mp4", fps=30) as w:
            for frame in frames:
                w.add(frame)
    t2 = time.perf_counter()
    video_fps, frames_ms, encode_ms = 128 / (t2 - t0), 1e3 * (t1 - t0) / 128, 1e3 * (t2 - t1) / 128
    shutil.rmtree(root)
    metrics.update({"cli_train_s": runs["train"], "cli_video_only_s": runs["video-only"],
                    "checkpoint_write_s": write_s, "checkpoint_bytes": ck_bytes,
                    "control_video_frames_per_s": video_fps, "control_frame_ms": frames_ms,
                    "control_encode_ms": encode_ms, "vf_protocol_s": vf_s,
                    "matplotlib": plots})
    print(f"  times ({card}): CLI train + previews + checkpoints + videos {runs['train']:.2f} s, "
          f"--video-only {runs['video-only']:.2f} s (process start and kernel load included); "
          f"checkpoint write {write_s:.3f} s for {ck_bytes} bytes "
          f"({ck_bytes / write_s / 1e6:.1f} MB/s); control videos {video_fps:.1f} frames/s "
          f"written (128^2, 24 bf16 steps a frame, mp4, after a warm-up: {frames_ms:.3f} ms a "
          f"frame made, {encode_ms:.3f} ms a frame encoded); validate_export device time "
          f"{metrics['validate_export_edges_device_ms']:.4f} ms (edges), "
          f"{metrics['validate_export_video_motion_device_ms']:.4f} ms (video_motion); "
          f"VectorFieldProtocol 2 iterations with 2 dumps {vf_s:.2f} s")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("lifecycle phase failed")
    return launches, metrics


def time_edge_kernels(torch, fs, ft, trainer):
    """The kernels of an edge_conditioned iteration alone at its shape
    (c12/fc96, edges, 256^2 b2, f32), beside their plain versions and
    bounds: the training forward (nca_step's chain form), nca_bwd_mlp,
    nca_bwd_adjoint, and the pre-roll's tensor-core nca_step (a whole
    ``fused_rollout_chw`` call of one step). CUDA events (median) and the
    profiler's device time, a launch each. Returns {name: (ms, device ms,
    plain ms, bound ms, bound by)}."""
    cfg = trainer.nca_cfg
    params = {k: v.detach() for k, v in trainer.params.items()}
    packed = fs.pack_weights(params, 12, 3, "float32")
    g = torch.Generator().manual_seed(5)
    shape = (2, 12, 256, 256)
    x = (torch.rand(shape, generator=g) - 0.5).cuda()
    gx = torch.randn(shape, generator=g).cuda()
    gx_acc = gx.clone()
    cond = (torch.rand((2, 3, 256, 256), generator=g) - 0.5).cuda()
    gp = torch.empty((2, 48, 256, 256), device="cuda")
    slots = ft._zero_slots(2, 12, 256, 256, packed)
    thr = fs.uniform_threshold(0.5)
    hw = 2 * 256 * 256
    spec = ft._Spec(3, 16, 0.5, "float32", True)
    cases = {  # name: (kernel call, launches a call, plain call, bound)
        "nca_step_chain (training forward)": (
            lambda: ft._forward_card(packed, x, cond, spec), 16,
            lambda: ft._forward_reference(packed, x, cond, spec),
            step_bound_ms(12, 3, 96, hw, "float32")),
        "nca_bwd_mlp": (
            lambda: ft._launch_mlp(x, cond, gx, gp, None, slots, packed, "float32", 5, 17, thr),
            1, lambda: ft.nca_bwd_mlp_reference(packed, x, cond, gx, 5, 17, 0.5),
            tc_bound_ms("nca_bwd_mlp", 12, 3, 96, hw)),
        "nca_bwd_adjoint": (
            lambda: ft._launch_adjoint(gp, gx_acc), 1,
            lambda: ft.nca_bwd_adjoint_reference(gp, gx),
            train_bound_ms("nca_bwd_adjoint", 12, 3, 96, hw)),
        "nca_step (pre-roll, tensor cores)": (
            lambda: fs.fused_rollout_chw(params, x, 1, cfg, 1, cond), 1,
            lambda: fs.fused_rollout_chw_reference(params, x, 1, cfg, 1, cond),
            tc_bound_ms("nca_step", 12, 3, 96, hw)),
    }
    out = {}
    for name, (fn, n, plain, (b, by)) in cases.items():
        k = cuda_ms(fn, max(20 // n, 1), rounds=3) / n
        dev = device_ms(torch, fn, reps=max(10 // n, 1)) / n
        p = cuda_ms(plain, 1, rounds=3) / n
        out[name] = (k, dev, p, b, by)
        print(f"  {name} at the edge_conditioned shape 256^2 b2 f32: kernel {k:.4f} ms/launch "
              f"({dev:.4f} device), plain {p:.4f} ms, bound {b:.5f} ms ({by}); {dev / b:.1f}x "
              f"the bound by device time")
    return out

# ---------------------------------------------------------------------------
# multi-device paths: data-parallel training, the spatial rollout, the fleet,
# the examples. Two ranks share the one card over gloo (NCCL takes one rank a
# card); the CLI's --dp 1 runs NCCL with one rank.

DP_STEPS = (32, 128, 128)  # the data-parallel cells' iterations
SPATIAL_STEPS = 24  # a served frame's steps


def launch_sum(counts: dict, *names) -> int:
    """The launches of ``names`` (``ranks._counts()``' keys) in one rank."""
    return sum(counts.get(n, 0) for n in names)


def host_ms(torch, fn) -> float:
    """One call of ``fn`` on the host clock, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_data_parallel(torch, presets, DyNCATrainer, load_vgg16, load_msoe,
                        synthetic_style_image, synthetic_video,
                        precompute_target_style_features):
    """``DyNCATrainer(mesh=...)`` in 2 gloo ranks on cuda:0 against the
    one-process trainer, at full width: static_texture (c12/fc96, pos_emb,
    128^2, batch 4 = 2 a rank, pool 256, Gram) and edge_conditioned
    (c12/fc96, edges, 256^2, batch 2 = 1 a rank, pool 256, OT + auxiliary
    VGG + vector field + overflow, one content draw as the CLI's first), 3
    iterations at step_n 32, 128, 128. Every rank launches nca_step (the
    chain forward), nca_bwd_mlp and nca_bwd_adjoint sum(step_n) times (and
    edge_conditioned the tensor-core nca_step once an iteration, its
    pre-roll); the first step matches the one-process step: its pool
    write-back (the same masks and parameters) within TOL, and for
    static_texture its loss and its averaged gradient within TRAIN_TOL (the
    slots sum in another order; edge_conditioned's OT subsamples each
    rank's rows, so its loss and gradient differ by design); both ranks
    hold the same parameters. Then the CLI's
    ``--dp 1`` over NCCL (2 iterations; its checkpoint loads) and ``--dp 2``
    refused on one card. Returns (launches by kernel over both ranks,
    timings)."""
    import shutil

    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.parallel.mesh import run_ranks
    from vsnca_tpu_torch.parallel.ranks import dp_train_rank

    jobs, refs = [], []
    rng = np.random.RandomState(0)
    for name in ("static_texture", "edge_conditioned"):
        nca, loss, train = presets.PRESETS[name]()
        hw = train.img_size
        style = synthetic_style_image(hw, train.batch_size) * 2.0 - 1.0
        inputs = {"target_style": np.ascontiguousarray(style.transpose(0, 3, 1, 2))}
        if name == "edge_conditioned":
            frames = synthetic_video(hw, 8)
            aux = frames[rng.choice(8, train.batch_size, replace=True)]
            inputs["aux_imgs"] = np.ascontiguousarray(aux.transpose(0, 3, 1, 2))
            inputs["aux_gs"] = inputs["aux_imgs"].mean(axis=1, keepdims=True)
        jobs.append(dict(nca=nca, loss=loss, train=train, seed=train.seed, inputs=inputs,
                         style_features=True, load_msoe=name == "edge_conditioned",
                         iterations=[{"step_n": n} for n in DP_STEPS]))
        refs.append(name)
    t0 = time.perf_counter()
    ranks = run_ranks(dp_train_rank, 2, "gloo", ["cuda:0", "cuda:0"], args=(jobs,),
                      timeout=900)
    spawn_s = time.perf_counter() - t0

    vgg, _ = load_vgg16(device="cuda")
    msoe, _ = load_msoe(device="cuda")
    launches = {"nca_step_chain": 0, "nca_bwd_mlp": 0, "nca_bwd_adjoint": 0, "nca_step": 0}
    checks, timing = {}, {"spawn_s": spawn_s}
    total = sum(DP_STEPS)
    for j, (job, name) in enumerate(zip(jobs, refs)):
        one = DyNCATrainer(job["nca"], job["loss"], job["train"], vgg_params=vgg,
                           msoe_params=msoe if job["load_msoe"] else None, device="cuda")
        inputs = {k: torch.from_numpy(v).cuda() for k, v in job["inputs"].items()}
        inputs["target_style_features"] = precompute_target_style_features(
            vgg, inputs["target_style"], job["loss"].appearance_loss_type,
            job["train"].img_size)
        losses, one_ms, first_pool, first_grads = [], [], None, None
        for n in DP_STEPS:
            one_ms.append(host_ms(torch, lambda: losses.append(
                one.train_iteration(inputs, step_n=n).loss)))
            if first_pool is None:
                first_pool = one.pool.gather(one.last_batch_idx).clone()
                first_grads = {k: v.grad.clone() for k, v in one.params.items()}
        r0, r1 = ranks[0][j], ranks[1][j]
        dp_losses = [log["loss"] for log in r0["logs"]]
        first_err = float((torch.from_numpy(r0["first_rows"]).cuda() - first_pool).abs().max())
        param_err = max(scaled_err(torch.from_numpy(r0["params"][k]).cuda(), v.detach())
                        for k, v in one.params.items())
        grad_err = max(scaled_err(torch.from_numpy(r0["first_grads"][k]).cuda(), v)
                       for k, v in first_grads.items())
        loss_err = abs(dp_losses[0] - losses[0]) / abs(losses[0])
        for r, rank in enumerate(ranks):
            c = rank[j]["launches"]
            checks[f"{name} rank {r}: nca_step == nca_bwd_mlp == nca_bwd_adjoint == "
                   f"sum(step_n)"] = (c["train:nca_step"] == c["train:nca_bwd_mlp"]
                                      == c["train:nca_bwd_adjoint"] == total)
            launches["nca_step_chain"] += c["train:nca_step"]
            launches["nca_bwd_mlp"] += c["train:nca_bwd_mlp"]
            launches["nca_bwd_adjoint"] += c["train:nca_bwd_adjoint"]
            launches["nca_step"] += c["step:nca_step"]
            if name == "edge_conditioned":
                checks[f"{name} rank {r}: the pre-roll's tensor-core nca_step once an "
                       "iteration"] = c["step:nca_step"] == len(DP_STEPS)
        checks[f"{name}: first write-back within TOL of one process"] = \
            first_err <= TOL["float32"]
        checks[f"{name}: losses finite"] = bool(np.all(np.isfinite(dp_losses)))
        checks[f"{name}: both ranks hold the same parameters"] = all(
            np.array_equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
        if name == "static_texture":
            checks[f"{name}: first loss within TRAIN_TOL"] = loss_err <= TRAIN_TOL["float32"]
            checks[f"{name}: first gradient within TRAIN_TOL"] = \
                grad_err <= TRAIN_TOL["float32"]
        ar = r0["allreduce_ms"]
        timing[name] = {"dp_ms": r0["ms"], "one_ms": one_ms, "allreduce_ms": ar,
                        "first_writeback_err": first_err, "first_grad_err": grad_err,
                        "first_loss_err": loss_err, "param_err_after": param_err}
        print(f"  {name}: 2 ranks on cuda:0, iterations {DP_STEPS}: "
              f"{', '.join(f'{t:.3f}' for t in r0['ms'])} ms (host clock, rank 0) against one "
              f"process {', '.join(f'{t:.3f}' for t in one_ms)} ms; gradient all-reduce "
              f"(gloo, through host memory) median {statistics.median(ar):.3f} ms of "
              f"{len(ar)}; losses {dp_losses} vs {losses} (first: relative {loss_err:.3g}); "
              f"first write-back max |diff| {first_err:.3g}; first gradient {grad_err:.3g} "
              f"of its largest; parameters after {len(DP_STEPS)} steps {param_err:.3g} of "
              f"their largest (not held: the normalized Adam step and cuDNN's VGG16 "
              f"backward order)")
        del one, inputs
    torch.cuda.empty_cache()

    out = "out/chip_smoke_dp1"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vsnca_tpu_torch.train.cli", "--preset", "static_texture",
         "--max-iterations", "2", "--log-every", "1", "--dp", "1", "--out", out],
        capture_output=True, text=True, timeout=600)
    timing["cli_dp1_s"] = time.perf_counter() - t0
    print("\n".join(f"    {line}" for line in r.stdout.strip().splitlines()))
    if r.returncode != 0:
        print(r.stderr[-4000:])
        raise SystemExit(f"the training CLI with --dp 1 exited {r.returncode}")
    checks["CLI --dp 1 (NCCL, one rank): checkpoint loads"] = \
        tuple(load_params_pickle(f"{out}/checkpoint", "cpu")["w1"].shape) == (50, 96)
    shutil.rmtree(out)
    n_cards = torch.cuda.device_count()
    r = subprocess.run(
        [sys.executable, "-m", "vsnca_tpu_torch.train.cli", "--preset", "static_texture",
         "--max-iterations", "1", "--dp", str(n_cards + 1), "--out", out],
        capture_output=True, text=True, timeout=600)
    refusal = f"--dp {n_cards + 1} needs {n_cards + 1} CUDA devices, {n_cards} visible"
    checks[f"CLI --dp {n_cards + 1} refused: '{refusal}'"] = (r.returncode != 0
                                                              and refusal in r.stderr)
    shutil.rmtree(out, ignore_errors=True)
    print(f"  CLI --dp 1 over NCCL: {timing['cli_dp1_s']:.1f} s (process start included); "
          f"the rank spawn and both cells: {spawn_s:.1f} s")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("data-parallel phase failed")
    return launches, timing


def phase_spatial(torch, presets, dynca_init, make_conditioning, dynca_rollout, fs):
    """``spatial_rollout`` in 2 gloo ranks on cuda:0, 128 rows each, against
    the dense rollout on the card, 24 steps at update_rate 0.5 (the served
    rate), b1: the video_motion cell (c16/fc128, pos_emb, scales (0, 1),
    circular, 256^2, a 6-row halo) and the served edges cell (c12/fc96,
    edges, circular, 256^2, a 1-row halo). Held within TOL["float32"] of
    the dense plain rollout (the same masks: keyed by the global pixel) and
    of the dense rollout kernels; plain ops only (no kernel launch in the
    ranks). Returns timings."""
    from vsnca_tpu_torch.parallel.mesh import run_ranks
    from vsnca_tpu_torch.parallel.ranks import spatial_rank

    cells = []
    g = torch.Generator().manual_seed(5)
    for name, cfg in (("video_motion", presets.video_motion()[0]),
                      ("edges", presets.edge_conditioned()[0])):
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        x = torch.rand((1, cfg.c_in, 256, 256), generator=g) - 0.5
        if cfg.conditioning == "edges":
            cond = make_conditioning(cfg, (256, 256), cond_img=torch.rand((1, 1, 256, 256),
                                                                          generator=g))
        else:
            cond = make_conditioning(cfg, (256, 256), batch=1, device="cpu")
        cells.append((name, cfg, params, x, cond))
    jobs = [dict(cfg=cfg, params={k: v.numpy() for k, v in p.items()}, x=x.numpy(),
                 cond=cond.numpy(), seed=9, n_steps=SPATIAL_STEPS, update_rate=0.5, reps=3)
            for _, cfg, p, x, cond in cells]
    ranks = run_ranks(spatial_rank, 2, "gloo", ["cuda:0", "cuda:0"], args=(jobs,), timeout=600)
    checks, timing = {}, {}
    for j, (name, cfg, p, x, cond) in enumerate(cells):
        pc = {k: v.cuda() for k, v in p.items()}
        xc, cc = x.cuda(), cond.cuda()
        got = torch.from_numpy(ranks[0][j]["state"]).cuda()
        with torch.no_grad():
            plain = dynca_rollout(pc, xc, 9, cfg, SPATIAL_STEPS, cc, update_rate=0.5,
                                  rollout_path="xla")[0]
            kern = dynca_rollout(pc, xc, 9, cfg, SPATIAL_STEPS, cc, update_rate=0.5)[0]
            plain_ms = host_ms(torch, lambda: dynca_rollout(
                pc, xc, 9, cfg, SPATIAL_STEPS, cc, update_rate=0.5, rollout_path="xla")) \
                / SPATIAL_STEPS
            kern_ms = cuda_ms(lambda: dynca_rollout(pc, xc, 9, cfg, SPATIAL_STEPS, cc,
                                                    update_rate=0.5), 2) / SPATIAL_STEPS
        err_plain = float((got - plain).abs().max())
        err_kern = float((got - kern).abs().max())
        ms = [rk[j]["ms_per_step"] for rk in ranks]
        hb = ranks[0][j]["halo_bytes"]
        checks[f"{name}: within TOL of the dense plain rollout"] = err_plain <= TOL["float32"]
        checks[f"{name}: within TOL of the dense rollout kernel"] = err_kern <= TOL["float32"]
        checks[f"{name}: finite"] = bool(torch.isfinite(got).all())
        timing[name] = {"ms_per_step": ms, "halo_bytes": hb, "dense_plain_ms": plain_ms,
                        "dense_kernel_ms": kern_ms, "err_plain": err_plain,
                        "err_kernel": err_kern}
        print(f"  {name} ({cfg.c_in} ch, scales {tuple(cfg.perception_scales)}, halo "
              f"{hb // (cfg.c_in * 256 * 4)} rows = {hb} B a side a step): sharded "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms a step (ranks 0 / 1, host clock) against the "
              f"dense plain rollout {plain_ms:.4f} and the dense kernel {kern_ms:.4f}; max "
              f"|diff| {err_plain:.3g} (plain), {err_kern:.3g} (kernel)")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("spatial phase failed")
    return timing


def phase_fleet(torch, ft, presets, DyNCATrainer, load_vgg16, synthetic_style_image,
                precompute_target_style_features):
    """``MultiStyleTrainer``: M = 4 static_texture models (seeds 0-3) at full
    width on the card, 2 iterations at step_n 32 and 128, each model
    through the kernel route (each pair kernel M x sum(step_n) times);
    model 0's first step against ``DyNCATrainer(seed=0)``'s: its loss
    and gradient within TRAIN_TOL, its pool write-back within TOL; then
    M = 2 over a ``model`` axis of 2 gloo ranks on cuda:0, one model each,
    each rank's losses against the one-process fleet's models 0 and 1
    within TRAIN_TOL. Returns (launches by kernel, timings)."""
    from vsnca_tpu_torch.parallel.mesh import run_ranks
    from vsnca_tpu_torch.parallel.ranks import fleet_rank
    from vsnca_tpu_torch.train.multi import MultiStyleTrainer

    nca, loss, train = presets.static_texture()
    vgg, _ = load_vgg16(device="cuda")
    seeds, steps = (0, 1, 2, 3), (32, 128)
    style = synthetic_style_image(train.img_size, train.batch_size) * 2.0 - 1.0
    style = torch.from_numpy(style).permute(0, 3, 1, 2).contiguous().cuda()
    styles = torch.stack([style] * len(seeds))
    feats = precompute_target_style_features(vgg, style, loss.appearance_loss_type,
                                             train.img_size)
    inputs = {"target_style": styles, "target_style_features": [torch.stack([f] * len(seeds))
                                                                for f in feats]}
    fleet = MultiStyleTrainer(nca, loss, train, seeds, vgg_params=vgg, device="cuda")
    alone = DyNCATrainer(nca, loss, train, vgg_params=vgg, seed=0, device="cuda")
    reset_counts(ft)
    logs, fleet_ms = [], []
    for n in steps:
        fleet_ms.append(host_ms(torch, lambda: logs.append(
            fleet.train_iteration(inputs, step_n=n))))
        if len(logs) == 1:  # the reference's launches are not the fleet's
            saved = dict(ft.KERNEL_LAUNCHES)
            first = ({k: v.grad.clone() for k, v in fleet.params[0].items()},
                     fleet.pools[0].states.clone())
            alone_loss = alone.train_iteration({"target_style": style,
                                                "target_style_features": feats},
                                               step_n=n).loss
            ft.KERNEL_LAUNCHES.update(saved)
    launches = {k: ft.KERNEL_LAUNCHES[k] for k in ("nca_step", "nca_bwd_mlp", "nca_bwd_adjoint")}
    loss_err = abs(float(logs[0].losses[0]) - alone_loss) / abs(alone_loss)
    grad_err = max(scaled_err(g, alone.params[k].grad) for k, g in first[0].items())
    pool_err = float((first[1] - alone.pool.states).abs().max())
    job = dict(nca=nca, loss=loss, train=train, seeds=seeds[:2],
               inputs={"target_style": styles[:2].cpu().numpy()},
               iterations=[{"step_n": n} for n in steps])
    ranks = run_ranks(fleet_rank, 2, "gloo", ["cuda:0", "cuda:0"], args=(job,), timeout=600)
    rank_err = max(abs(float(a[m]) - float(b.losses[m])) / abs(float(b.losses[m]))
                   for a, b in zip(ranks[0]["losses"], logs) for m in range(2))
    total = sum(steps)
    checks = {
        "M = 4: each pair kernel M x sum(step_n) times": all(
            v == len(seeds) * total for v in launches.values()),
        "M = 4: losses finite": all(np.isfinite(log.losses).all() for log in logs),
        "model 0's first step: loss and gradient within TRAIN_TOL of DyNCATrainer(seed=0)":
            loss_err <= TRAIN_TOL["float32"] and grad_err <= TRAIN_TOL["float32"],
        "model 0's first write-back within TOL": pool_err <= TOL["float32"],
        "model axis of 2 ranks: losses within TRAIN_TOL of the one-process fleet":
            rank_err <= TRAIN_TOL["float32"],
        "model axis: each rank's pair kernels sum(step_n) times": all(
            rk["launches"]["train:nca_step"] == rk["launches"]["train:nca_bwd_mlp"]
            == rk["launches"]["train:nca_bwd_adjoint"] == total for rk in ranks),
        "model axis: every rank sees the fleet's 2 losses": all(
            len(l) == 2 for rk in ranks for l in rk["losses"]),
    }
    for rk in ranks:
        launches["nca_step"] += rk["launches"]["train:nca_step"]
        launches["nca_bwd_mlp"] += rk["launches"]["train:nca_bwd_mlp"]
        launches["nca_bwd_adjoint"] += rk["launches"]["train:nca_bwd_adjoint"]
    timing = {"fleet_ms": fleet_ms, "rank_ms": [rk["ms"] for rk in ranks],
              "model0_first_loss_err": loss_err, "model0_first_grad_err": grad_err,
              "model0_first_writeback_err": pool_err, "rank_loss_err": rank_err}
    print(f"  M = 4 at 128^2 b4: iterations at step_n {steps} {fleet_ms[0]:.3f}, "
          f"{fleet_ms[1]:.3f} ms (host clock, the first with warm-up); model 0's first step "
          f"vs DyNCATrainer(seed=0): loss {loss_err:.3g} relative, gradient {grad_err:.3g} "
          f"of its largest, write-back max |diff| {pool_err:.3g}; M = 2 over 2 ranks: "
          f"{', '.join(f'{t:.3f}' for t in ranks[0]['ms'])} ms (rank 0), losses within "
          f"{rank_err:.3g}")
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("fleet phase failed")
    del fleet, alone
    torch.cuda.empty_cache()
    return launches, timing


def phase_examples(torch, fs, ft, fc, dynca_init):
    """Every example's ``main(argv)`` on the card at a small size and few
    iterations, synthetic data: export_webgl (a random edges checkpoint,
    validate_export at 64^2 x 24), interactive_growth (64^2), learning_proof
    (64^2, 4 iterations), train_encoder (64^2, 2 epochs), train_vector_field
    (64^2, 2 iterations), train_video_motion (64^2, warmup 1, 1 main
    iteration, the final evaluation). Each runs on the kernels (its launches
    counted; none 0 where the example rolls or trains) and returns finite
    results. Returns (launches by kernel over all examples, wall s by
    example)."""
    import shutil

    from vsnca_tpu_torch.config import NCAConfig
    from vsnca_tpu_torch.examples import (
        export_webgl,
        interactive_growth,
        learning_proof,
        train_encoder,
        train_vector_field,
        train_video_motion,
    )
    from vsnca_tpu_torch.export.checkpoint import save_checkpoint

    root = "out/chip_smoke_examples"
    shutil.rmtree(root, ignore_errors=True)
    cfg = NCAConfig(c_in=12, fc_dim=96, conditioning="edges")
    save_checkpoint(f"{root}/ck", {"params": dynca_init(torch.Generator().manual_seed(0), cfg,
                                                        device="cpu"), "iteration": 0})
    runs = [
        ("export_webgl", export_webgl.main,
         [f"{root}/ck", f"{root}/web/model.json", "--conditioning", "edges"],
         lambda r: r["weight_max_abs_diff"] < 1e-3 and np.isfinite(r["state_max_abs_diff"])),
        ("interactive_growth", interactive_growth.main, ["--out", f"{root}/growth"],
         lambda r: os.path.getsize(r) > 0),
        ("learning_proof", learning_proof.main,
         ["--size", "64", "--iters", "4", "--test-frames", "2", "--out", f"{root}/proof"],
         lambda r: np.isfinite(r["losses"]).all() and np.isfinite(r["errors"]).all()),
        ("train_encoder", train_encoder.main,
         ["--image-size", "64", "--epochs", "2", "--out", f"{root}/encoder"],
         lambda r: np.isfinite(r[1]).all()),
        ("train_vector_field", train_vector_field.main,
         ["--img-size", "64", "--iterations", "2", "--out", f"{root}/vf"],
         lambda r: np.isfinite(r.history[-1].loss)),
        ("train_video_motion", train_video_motion.main,
         ["--img-size", "64", "--iterations", "1", "--warmup", "1", "--out", f"{root}/vm"],
         lambda r: np.isfinite(r[1]["video_motion_loss_mean"])),
    ]
    launches, wall, checks = {}, {}, {}
    for name, main_fn, argv, ok in runs:
        reset_counts(fs, ft, fc)
        t0 = time.perf_counter()
        result = main_fn(argv)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        counts = {**{f"step:{k}": v for k, v in fs.KERNEL_LAUNCHES.items()},
                  **{f"train:{k}": v for k, v in ft.KERNEL_LAUNCHES.items()},
                  **{f"cnca:{k}": v for k, v in fc.KERNEL_LAUNCHES.items()}}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        used = {k: v for k, v in counts.items() if v}
        checks[f"{name}: finite results"] = bool(ok(result))
        checks[f"{name}: ran on the kernels"] = bool(used)
        print(f"  {name}: {wall[name]:.2f} s wall; launches {used}")
    shutil.rmtree(root, ignore_errors=True)
    for k, v in checks.items():
        print(f"  {k}: {'ok' if v else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("examples phase failed")
    return launches, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from vsnca_tpu_torch.config import (
        ConditionedNCAConfig,
        LossConfig,
        NCAConfig,
        edge_conditioned,
    )
    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.data.dataset import ConditioningDataset
    from vsnca_tpu_torch.data.preprocess import synthetic_style_image, synthetic_video
    from vsnca_tpu_torch.infer import benchmark
    from vsnca_tpu_torch.infer import server as server_mod
    from vsnca_tpu_torch.infer.grower import InteractiveGrower
    from vsnca_tpu_torch.infer.stylize import VideoStylizer
    from vsnca_tpu_torch.losses.appearance import (
        appearance_loss,
        precompute_target_style_features,
    )
    from vsnca_tpu_torch.losses.auxiliary import auxiliary_loss
    from vsnca_tpu_torch.losses.orchestrator import LossState
    from vsnca_tpu_torch.losses.overflow import overflow_loss
    from vsnca_tpu_torch.losses.vector_field import vector_field_motion_loss
    from vsnca_tpu_torch.losses.video_motion import (
        precompute_target_motion_features,
        video_motion_loss,
    )
    from vsnca_tpu_torch.models import conditioned_nca as cn
    from vsnca_tpu_torch.models import dynca as dynca_mod
    from vsnca_tpu_torch.models.dynca import (
        dynca_init,
        dynca_rollout,
        make_conditioning,
        rollout_taps,
        tap_schedule,
        to_rgb,
    )
    from vsnca_tpu_torch.models.msoe import load_msoe, msoe_random_init
    from vsnca_tpu_torch.models import vgg as vgg_mod
    from vsnca_tpu_torch.models.vgg import load_vgg16, vgg16_random_init
    from vsnca_tpu_torch.ops import _build
    from vsnca_tpu_torch.ops import fused_cnca as fc
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft
    from vsnca_tpu_torch.train import presets
    from vsnca_tpu_torch.train.encoder_trainer import ConditionedNCATrainer
    from vsnca_tpu_torch.train.optim import make_optimizer
    from vsnca_tpu_torch.train.trainer import DyNCATrainer, make_train_step
    from vsnca_tpu_torch.train.vector_field_protocol import VectorFieldProtocol
    from vsnca_tpu_torch.train.video_motion_protocol import VideoMotionProtocol

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = smi("name,power.limit")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}; card "
          "(nvidia-smi name, power.limit):")
    print(card)
    t0 = time.perf_counter()
    built = _build.build(_build.SOURCES)
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s: {built}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Function properties" in line:
                print(f"    ptxas {name}: {line.split('for', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"    ptxas {name}:   {line.strip()}")

    print("[2] kernel vs plain version on the card (TF32 off)")
    max_err = phase_compare(torch, fs, NCAConfig, dynca_init)
    tc_bf16_drift = report_tc_bf16_drift(torch, fs, NCAConfig, dynca_init)
    phase_stylizer_parity(torch, VideoStylizer, NCAConfig, dynca_init)
    print("[2] training pair vs its plain version on the card")
    train_err = phase_compare_train(torch, ft, NCAConfig, dynca_init)
    phase_train_step_parity(torch, make_train_step, LossState, LossConfig, NCAConfig,
                            dynca_init, vgg16_random_init, make_optimizer)
    print("[2] training pair at the extra_channels cell (C 13, no conditioning) and the "
          "edge_conditioned cell at 256^2 vs its plain version on the card")
    cond_err = phase_compare_conditioned(torch, ft, NCAConfig, dynca_init)
    print("[2] ConditionedNCA kernels vs their plain versions on the card (C 20, D 64)")
    cnca_err = phase_compare_cnca(torch, fc, cn, ConditionedNCAConfig)
    print("[2] multiscale kernels (the video_motion cell, c16/fc128, scales (0, 1)) vs their "
          "plain versions on the card")
    ms_err = phase_compare_ms(torch, fs, NCAConfig, dynca_init)
    chain_err = phase_compare_chain(torch, fs, NCAConfig, dynca_init)
    ms_train_err = phase_compare_ms_train(torch, ft, NCAConfig, dynca_init)
    print("[2] the redesigned nca_bwd_adjoint_ms and cnca_update vs their plain versions, at "
          "the main-path shapes and grids whose footprints wrap or are ragged; the cnca pair "
          "under a gate stress")
    redesigned_err = phase_compare_redesigned(torch, ft, fc, cn, ConditionedNCAConfig)
    stress_near, stress_err = phase_cnca_gate_stress(torch, fc, cn, ConditionedNCAConfig)
    phase_vm_step_parity(torch, make_train_step, LossState, presets, dynca_init,
                         vgg16_random_init, msoe_random_init, make_optimizer, tap_schedule,
                         precompute_target_motion_features)
    print("[2] TPU-layout forms (rows 1, 2, 5, 6) vs their plain versions on the card: "
          "nca_step_mat, the bf16-state nca_step, the streaming entry, the CHW pair")
    forms_err, mat_tc_drift = phase_compare_forms(torch, fs, NCAConfig, dynca_init)
    edge_cfg = edge_conditioned()
    edge_params = dynca_init(torch.Generator().manual_seed(0), edge_cfg, device="cuda")
    stream_err = phase_compare_stream(torch, fs, edge_cfg, edge_params)
    seg_k, seg_diff, seg_err = phase_compare_segment(torch, ft, presets, dynca_init,
                                                     make_conditioning)

    print("[3] serving path: edge_conditioned c12/fc96, 256^2, 24 steps/frame")
    cfg = edge_conditioned()
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    launches, serve = phase_serve(torch, fs, server_mod, cfg, params)
    print("[3] float32 stylizer: VideoStylizer, edge_conditioned, 256^2, compute_dtype float32 "
          "(the tensor-core scales-(0,) step)")
    f32_launches = phase_f32_stylizer(torch, fs, VideoStylizer, cfg, params)

    print("[3] training path: DyNCATrainer, static_texture c12/fc96/pos_emb, 128^2, "
          "batch 4, pool 256, full VGG16 (seed-16 fallback), Gram + overflow")
    trainer, inputs = static_texture_trainer(torch, presets, DyNCATrainer, load_vgg16,
                                             synthetic_style_image,
                                             precompute_target_style_features)
    train_launches, train_steps = phase_train(torch, ft, fs, trainer, inputs)
    phase_cli(load_params_pickle)

    print("[3] grower path: InteractiveGrower, ConditionedNCA C 20 / D 64, 64^2, random "
          "weights (seed 0)")
    grower_launches, grower = phase_grower(torch, fc, cn, InteractiveGrower,
                                           ConditionedNCAConfig)
    print("[3] encoder training path: ConditionedNCATrainer, C 20 / D 64, 64^2, batch 8, "
          "pool 1024, OT + content x 0.1 + overflow, full VGG16 (seed-16 fallback)")
    enc_trainer = encoder_trainer(torch, ConditionedNCATrainer, ConditioningDataset,
                                  ConditionedNCAConfig, load_vgg16, synthetic_style_image,
                                  synthetic_video)
    enc_launches, enc_steps = phase_encoder_train(torch, fc, enc_trainer)
    phase_encoder_cli(load_params_pickle)
    print("[3] video_motion training path: DyNCATrainer, video_motion c16/fc128/pos_emb, "
          "scales (0, 1), 256^2, batch 3, pool 256, OT + MotionOT x 5 + overflow, full VGG16 "
          "(seed-16 fallback) and MSOE (seed-175 fallback), synthetic 16-frame video")
    vm_trainer, vm_inputs, vm_feats, vm_extractors = video_motion_trainer(
        torch, presets, DyNCATrainer, load_vgg16, load_msoe, synthetic_style_image,
        synthetic_video, precompute_target_style_features, precompute_target_motion_features)
    vm_launches, vm_steps = phase_vm_train(torch, ft, fs, vm_trainer, vm_inputs, vm_feats)
    phase_vm_cli(load_params_pickle)
    print("[3] video_motion protocol: VideoMotionProtocol, warmup 2 -> calibrate -> reinit -> "
          "main 1, full width")
    phase_vm_protocol(torch, ft, presets, VideoMotionProtocol, vm_extractors)
    print("[3] edge_conditioned training path: DyNCATrainer, edge_conditioned c12/fc96/edges, "
          "256^2, batch 2, pool 256, OT + auxiliary VGG x 10 + vector field x 1 + overflow x "
          "1000, full VGG16 and MSOE (seeded fallbacks), 8 synthetic content frames drawn as the "
          "CLI draws them")
    phase_edge_step_parity(torch, make_train_step, LossState, presets, dynca_init,
                           vgg16_random_init, msoe_random_init, make_optimizer)
    cond_args = (torch, presets, DyNCATrainer, synthetic_style_image, synthetic_video,
                 precompute_target_style_features)
    extractors = vm_extractors[:2]
    edge_trainer, edge_inputs, edge_frames = conditioned_trainer(*cond_args, "edge_conditioned",
                                                                 extractors)
    edge_launches, edge_steps = phase_conditioned_train(
        torch, ft, fs, edge_trainer, edge_inputs, edge_frames,
        [32, COND_STEPS, edge_trainer.sample_step_n(), edge_trainer.sample_step_n()],
        "edge_conditioned")
    phase_edge_cli(load_params_pickle)
    print("[3] extra_channels: c13 (12 seed channels + the content's grayscale)/fc96, 256^2, "
          "batch 2, pool 256")
    xc_trainer, xc_inputs, xc_frames = conditioned_trainer(*cond_args, "extra_channels",
                                                           extractors)
    phase_extra_channels(torch, ft, fs, dynca_mod, xc_trainer, xc_inputs, xc_frames)
    del xc_trainer, xc_inputs, xc_frames
    print("[3] vector_field_motion: c12/fc96/pos_emb, 128^2, batch 4, pool 256, OT + vector "
          "field x 4 (strength 15, direction 10, circular) + overflow x 100")
    vf_trainer, vf_inputs, _ = conditioned_trainer(*cond_args, "vector_field_motion", extractors)
    phase_conditioned_train(torch, ft, fs, vf_trainer, vf_inputs, None,
                            [COND_STEPS, vf_trainer.sample_step_n()], "vector_field_motion")
    print("[3] vector-field protocol: VectorFieldProtocol, recalibrate_every 1, 2 iterations")
    phase_vf_protocol(torch, ft, presets, VectorFieldProtocol, extractors, synthetic_style_image)
    print("[3] the lifecycle at edge_conditioned's widths: the training CLI's artifacts, "
          "checkpoints and videos (128^2), --video-only, the WebGL export and validate_export "
          "(256^2 x 24 steps), the vector-field protocol's dumps")
    life_launches, life_metrics = phase_lifecycle(torch, fs, ft, presets, dynca_init,
                                                  VectorFieldProtocol, extractors,
                                                  synthetic_style_image, card)
    print("[3] multiscale stylizer: VideoStylizer, video_motion cell c16/fc128, 256^2, random "
          "weights (seed 0)")
    ms_styl_launches, ms_styl = phase_ms_stylizer(torch, fs, presets, VideoStylizer, dynca_init)
    print("[3] TPU-layout entries: bench.py's cell through the registry, the edge_conditioned "
          "cell with algo 'mat' and with a bf16 state, the streaming entry at 1024^2, the "
          "static_texture cell through the NHWC CHW pair (K = 16)")
    layout_launches = phase_tpu_layout_path(torch, fs, ft, presets, dynca_init,
                                            make_conditioning, edge_cfg, edge_params)
    print("[3] data-parallel training: DyNCATrainer(mesh=...) in 2 gloo ranks sharing cuda:0 "
          "(static_texture 128^2 b4, edge_conditioned 256^2 b2) against one process; the CLI's "
          "--dp 1 over NCCL and --dp 2 refused on one card")
    dp_launches, dp_timing = phase_data_parallel(
        torch, presets, DyNCATrainer, load_vgg16, load_msoe, synthetic_style_image,
        synthetic_video, precompute_target_style_features)
    print("[3] spatial rollout: spatial_rollout in 2 gloo ranks on cuda:0, 128 rows each, "
          "against the dense rollout (video_motion cell and served edges cell, 256^2)")
    spatial_timing = phase_spatial(torch, presets, dynca_init, make_conditioning,
                                   dynca_rollout, fs)
    print("[3] fleet: MultiStyleTrainer, 4 static_texture models at 128^2 b4 on the card, "
          "then 2 over a model axis of 2 gloo ranks")
    fleet_launches, fleet_timing = phase_fleet(torch, ft, presets, DyNCATrainer, load_vgg16,
                                               synthetic_style_image,
                                               precompute_target_style_features)
    print("[3] examples: each vsnca_tpu_torch.examples main on the card, small sizes")
    ex_launches, ex_wall = phase_examples(torch, fs, ft, fc, dynca_init)

    print("[4] times (CUDA events, median of 5 rounds after warm-up)")
    timing = {}
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((1, 12, 256, 256), generator=g) - 0.5).cuda()
    cond = (torch.rand((1, 3, 256, 256), generator=g) - 0.5).cuda()
    k = cuda_ms(lambda: fs.fused_rollout_chw(params, x, 1, cfg, STEPS, cond), 4) / STEPS
    p = cuda_ms(lambda: fs.fused_rollout_chw_reference(params, x, 1, cfg, STEPS, cond), 1) / STEPS
    bound, by = step_bound_ms(12, 3, 96, 256 * 256, "float32")
    tcb, tcby = tc_bound_ms("nca_step", 12, 3, 96, 256 * 256)
    timing["f32"] = {"kernel_ms_per_step": k, "plain_ms_per_step": p, "bound_ms_per_step": bound,
                     "bound_by": by, "tc_bound_ms": tcb, "tc_bound_by": tcby}
    print(f"  256^2 edges f32 (tensor cores): kernel {k:.4f} ms/step, plain {p:.4f} ms/step, "
          f"bound {bound:.5f} ms/step ({by}), tensor-core bound {tcb:.5f}; {k / bound:.1f}x "
          f"the bound, {k / tcb:.1f}x the tensor-core bound")
    for n in (256, 512):
        g = torch.Generator().manual_seed(1)
        x = (torch.rand((1, 12, n, n), generator=g) - 0.5).cuda()
        cond = (torch.rand((1, 3, n, n), generator=g) - 0.5).cuda()
        k = cuda_ms(lambda: fs.fused_rollout_chw(params, x, 1, cfg, STEPS, cond,
                                                 compute_dtype="bfloat16"), 4) / STEPS
        p = cuda_ms(lambda: fs.fused_rollout_chw_reference(
            params, x, 1, cfg, STEPS, cond, compute_dtype="bfloat16"), 1) / STEPS
        bound, by = step_bound_ms(12, 3, 96, n * n, "bfloat16")
        timing[n] = {"kernel_ms_per_step": k, "plain_ms_per_step": p,
                     "bound_ms_per_step": bound, "bound_by": by}
        print(f"  {n}^2 edges bf16 (chain form): kernel {k:.4f} ms/step, plain {p:.4f} ms/step, "
              f"bound {bound:.5f} ms/step ({by}); {k / bound:.1f}x the bound")

    styl = VideoStylizer(params, cfg, 256, step_n=STEPS, device="cuda")
    frame = (torch.rand((1, 256, 256, 3), generator=torch.Generator().manual_seed(2))
             * 2 - 1).cuda()

    def next_frame():  # reset every 24 frames: see phase_serve
        if styl._frame_idx % STEPS == 0:
            styl.reset()
        return styl.step_frame(frame)

    frame_ms = cuda_ms(next_frame, 10)
    stylizer_fps = 1e3 / frame_ms
    kernel_share = timing[256]["kernel_ms_per_step"] * STEPS / frame_ms
    print(f"  stylizer 256^2 edges bf16: {frame_ms:.4f} ms/frame = {stylizer_fps:.1f} "
          f"frames/s; rollout kernel {100 * kernel_share:.1f}% of the frame")

    bench_cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular")
    bench_params = dynca_init(torch.Generator().manual_seed(0), bench_cfg, device="cuda")
    xb = (torch.rand((1, 12, 256, 256), generator=torch.Generator().manual_seed(1))
          - 0.5).cuda()
    bench_kernel = fs.select_rollout_kernel(bench_cfg, 256, 256)
    call_ms = cuda_ms(lambda: fs.ROLLOUT_KERNELS[bench_kernel](
        bench_params, xb, 0, bench_cfg, 96, compute_dtype="bfloat16"), 2)
    cups = 256 * 256 * 96 / (call_ms / 1e3)
    print(f"  nca_cell_updates_per_sec_256px (c12/fc96 circular, 96 steps, bf16, through "
          f"ROLLOUT_KERNELS[{bench_kernel!r}]): {cups:.4e} ({call_ms:.4f} ms per 96-step call)")
    print(f"  server 256^2 edges, one client, JPEG round trip: {serve['fps']:.1f} frames/s; "
          f"latency p50 {serve['latency_ms_p50']:.3f} ms, p90 {serve['latency_ms_p90']:.3f} ms "
          f"({serve['requests']} requests); of a request (host clock, median of 10): "
          f"decode {serve['decode_ms']:.3f}, stylize + copy {serve['stylize_and_copy_ms']:.3f}, "
          f"encode {serve['encode_ms']:.3f}, HTTP and the rest {serve['http_and_rest_ms']:.3f} ms")
    profile_frames(torch, next_frame)
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # the training kernels at the static_texture shape, c12/fc96/pos_emb,
    # 128^2, batch 4, float32
    tcfg = trainer.nca_cfg
    tp = {k: v.detach() for k, v in trainer.params.items()}
    packed = fs.pack_weights(tp, 12, 2, "float32")
    g = torch.Generator().manual_seed(3)
    shape = (4, 12, 128, 128)
    xt = (torch.rand(shape, generator=g) - 0.5).cuda()
    gxt = torch.randn(shape, generator=g).cuda()
    gx_acc = gxt.clone()
    condt = (torch.rand((4, 2, 128, 128), generator=g) - 0.5).cuda()
    gpt = torch.empty((4, 48, 128, 128), device="cuda")
    slots = ft._zero_slots(4, 12, 128, 128, packed)
    thr = fs.uniform_threshold(0.5)
    hw4 = 4 * 128 * 128
    tk = {}
    tk["nca_bwd_mlp"] = (
        cuda_ms(lambda: ft._launch_mlp(xt, condt, gxt, gpt, None, slots, packed,
                                       "float32", 5, 17, thr), 20),
        cuda_ms(lambda: ft.nca_bwd_mlp_reference(packed, xt, condt, gxt, 5, 17, 0.5), 2),
        *train_bound_ms("nca_bwd_mlp", 12, 2, 96, hw4))
    tk["nca_bwd_adjoint"] = (
        cuda_ms(lambda: ft._launch_adjoint(gpt, gx_acc), 50),
        cuda_ms(lambda: ft.nca_bwd_adjoint_reference(gpt, gxt), 5),
        *train_bound_ms("nca_bwd_adjoint", 12, 2, 96, hw4))
    spec = ft._Spec(3, 32, 0.5, "float32", True)
    fwd_ms = cuda_ms(lambda: ft._forward_card(packed, xt, condt, spec), 1) / 32
    fwd_plain = cuda_ms(lambda: ft._forward_reference(packed, xt, condt, spec), 1) / 32
    fwd_bound, fwd_by = step_bound_ms(12, 2, 96, hw4, "float32")
    for name, (k, p, b, by) in tk.items():
        print(f"  {name} 128^2 b4 pos_emb f32: kernel {k:.4f} ms/launch, plain {p:.4f} ms, "
              f"bound {b:.5f} ms ({by}); {k / b:.1f}x the bound")
    print(f"  training forward (nca_step's chain form into the checkpoint buffer) 128^2 b4 f32: "
          f"{fwd_ms:.4f} ms/step, plain {fwd_plain:.4f}, bound {fwd_bound:.5f} ({fwd_by}); "
          f"{fwd_ms / fwd_bound:.1f}x the bound")
    split = {}
    for n in (32, 128):
        split[n] = time_train_iteration(torch, trainer, inputs, n)
        total = sum(split[n].values())
        print(f"  static_texture iteration, {n} steps: {total:.3f} ms = "
              + ", ".join(f"{k} {v:.3f}" for k, v in split[n].items()))
    torch.cuda.reset_peak_memory_stats()
    trainer.train_iteration(inputs, step_n=128)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    n_iters = 8
    for _ in range(n_iters):
        trainer.train_iteration(inputs)
    its = n_iters / (time.perf_counter() - t0)
    print(f"  DyNCATrainer.train_iteration at the preset's sampled step counts: "
          f"{its:.2f} iterations/s (host clock, {n_iters} iterations, loss read each); "
          f"peak device memory of a 128-step iteration {peak_gb:.3f} GB")
    profile_frames(torch, lambda: trainer.train_iteration(inputs, step_n=128), 2,
                   unit="128-step iteration")
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # the ConditionedNCA kernels, the grower and the encoder trainer
    cnca_times, grower_steps_per_s = time_cnca(torch, fc, cn, ConditionedNCAConfig, grower)
    enc_split = time_encoder_iteration(torch, enc_trainer, CNCA_STEPS)
    print(f"  encoder iteration (train twice), {CNCA_STEPS} steps each: "
          f"{sum(enc_split.values()):.3f} ms = "
          + ", ".join(f"{k} {v:.3f}" for k, v in enc_split.items()))
    torch.cuda.reset_peak_memory_stats()
    enc_trainer.train_iteration(batch_size=8, num_steps=CNCA_STEPS)
    enc_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    n_iters = 4
    for _ in range(n_iters):
        enc_trainer.train_iteration(batch_size=8)
    enc_its = n_iters / (time.perf_counter() - t0)
    print(f"  ConditionedNCATrainer.train_iteration at sampled step counts: {enc_its:.2f} "
          f"iterations/s (host clock, {n_iters} iterations, loss read each); peak device "
          f"memory of a {CNCA_STEPS}-step iteration {enc_peak_gb:.3f} GB")
    profile_frames(torch, lambda: enc_trainer.train_iteration(batch_size=8,
                                                              num_steps=CNCA_STEPS),
                   1, unit=f"{CNCA_STEPS}-step encoder iteration")
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # the multiscale kernels, the video_motion iteration and the multiscale
    # stylizer
    ms_times = time_ms_kernels(torch, fs, ft, {k: v.detach() for k, v in
                                               vm_trainer.params.items()})
    vm_rng = np.random.RandomState(1)
    it_inputs, it_kw = vm_iteration(vm_inputs, vm_feats, 144, vm_rng)
    it_kw.pop("step_n")
    vm_split = time_train_iteration(torch, vm_trainer, it_inputs, 144, reps=2, **it_kw)
    print(f"  video_motion iteration, 144 steps (frames after steps 1, 65, 129): "
          f"{sum(vm_split.values()):.3f} ms = "
          + ", ".join(f"{k} {v:.3f}" for k, v in vm_split.items()))
    with torch.no_grad():
        vm_params = {k: v.detach() for k, v in vm_trainer.params.items()}
        x0 = vm_trainer.pool.states[:3].contiguous()
        cond0 = make_conditioning(vm_trainer.nca_cfg, (VM_SIZE, VM_SIZE), batch=3,
                                  device="cuda")
        _, taps = rollout_taps(vm_params, x0, 0, vm_trainer.nca_cfg, it_kw["tap_chunks"],
                               it_kw["tail_steps"], cond0)
        frames = [to_rgb(t, 3) for t in taps]
        vm_app_ms, vm_mot_ms = time_vm_losses(
            torch, vm_extractors[0], vm_extractors[1], vm_trainer.loss_state.cfg, frames,
            vm_inputs["target_style_features"], it_inputs["target_motion_features"],
            appearance_loss, video_motion_loss)
    torch.cuda.synchronize()
    vm_held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    vm_trainer.train_iteration(it_inputs, step_n=144, **it_kw)
    vm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    n_iters = 4
    for _ in range(n_iters):
        n = max(vm_trainer.sample_step_n(), 65)
        a, kw = vm_iteration(vm_inputs, vm_feats, n, vm_rng)
        vm_trainer.train_iteration(a, **kw)
    vm_its = n_iters / (time.perf_counter() - t0)
    print(f"  video_motion DyNCATrainer.train_iteration at sampled step counts: {vm_its:.3f} "
          f"iterations/s (host clock, {n_iters} iterations, loss read each); peak device "
          f"memory of a 144-step iteration {vm_peak_gb:.3f} GB, of which {vm_held_gb:.3f} GB "
          f"held before it (every phase's pools, weights and buffers)")
    profile_frames(torch, lambda: vm_trainer.train_iteration(it_inputs, step_n=144, **it_kw),
                   1, unit="144-step video_motion iteration")
    ms_frame = (torch.rand((1, VM_SIZE, VM_SIZE, 3), generator=torch.Generator().manual_seed(2))
                * 2 - 1).cuda()

    def next_ms_frame():  # reset every 24 frames: see phase_serve
        if ms_styl._frame_idx % STEPS == 0:
            ms_styl.reset()
        return ms_styl.step_frame(ms_frame)

    ms_frame_ms = cuda_ms(next_ms_frame, 10)
    print(f"  multiscale stylizer {VM_SIZE}^2 c16/fc128 bf16: {ms_frame_ms:.4f} ms/frame = "
          f"{1e3 / ms_frame_ms:.1f} frames/s; nca_step_ms "
          f"{100 * ms_times['nca_step_ms_b1_bf16'][0] * STEPS / ms_frame_ms:.1f}% of the frame")
    profile_frames(torch, next_ms_frame, unit="multiscale frame")
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # the edge_conditioned iteration, its loss terms alone, and the
    # vector_field_motion iteration
    edge_rng = np.random.RandomState(1)
    it_edge = content_inputs(torch, edge_inputs, edge_frames, edge_rng, 2)
    edge_split = time_train_iteration(torch, edge_trainer, it_edge, COND_STEPS, reps=2)
    print(f"  edge_conditioned iteration, {COND_STEPS} steps, 256^2 b2: "
          f"{sum(edge_split.values()):.3f} ms = "
          + ", ".join(f"{k} {v:.3f}" for k, v in edge_split.items()))
    edge_loss_ms = time_conditioned_losses(
        torch, edge_trainer, edge_inputs, edge_frames, extractors, appearance_loss,
        auxiliary_loss, vector_field_motion_loss, overflow_loss, make_conditioning,
        dynca_rollout)
    torch.cuda.synchronize()
    edge_held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    edge_trainer.train_iteration(it_edge, step_n=COND_STEPS)
    edge_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    n_iters = 4
    for _ in range(n_iters):
        edge_trainer.train_iteration(content_inputs(torch, edge_inputs, edge_frames, edge_rng, 2))
    edge_its = n_iters / (time.perf_counter() - t0)
    print(f"  edge_conditioned DyNCATrainer.train_iteration at sampled step counts: "
          f"{edge_its:.3f} iterations/s (host clock, {n_iters} iterations, loss read each); "
          f"peak device memory of a {COND_STEPS}-step iteration {edge_peak_gb:.3f} GB, of which "
          f"{edge_held_gb:.3f} GB held before it")
    edge_busy = profile_frames(
        torch, lambda: edge_trainer.train_iteration(it_edge, step_n=COND_STEPS), 1,
        unit=f"{COND_STEPS}-step edge_conditioned iteration")
    edge_kernels = time_edge_kernels(torch, fs, ft, edge_trainer)
    vf_split = time_train_iteration(torch, vf_trainer, vf_inputs, COND_STEPS, reps=1)
    print(f"  vector_field_motion iteration, {COND_STEPS} steps, 128^2 b4: "
          f"{sum(vf_split.values()):.3f} ms = "
          + ", ".join(f"{k} {v:.3f}" for k, v in vf_split.items()))
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # the TPU-layout forms, the registry's entries, the segment trade-off and
    # the benchmark harness
    form_times, entry_ms = time_forms(torch, fs, edge_cfg, edge_params)
    seg_times = time_segments(torch, ft, presets, dynca_init, make_conditioning,
                              vm_trainer.params)
    bench_serving, bench_train = phase_benchmark(torch, fs, ft, benchmark)
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # the tensor-core backward kernels at the table's shapes, and the VGG
    # loss with the equality-mask pool against F.max_pool2d
    tc_times = time_tc_kernels(torch, fs, ft, fc, cn, ConditionedNCAConfig, _build)
    print("  the redesigned CUDA-core kernels (PERF.md rows 10 and 11):")
    redesigned = time_redesigned(torch, ft, fc, cn, ConditionedNCAConfig, _build)
    print("  the redesigned nca_step_mat and cnca_gate (PERF.md rows 1, 11 and 12):")
    mat_gate, mat_bounds = time_mat_gate(torch, fs, fc, cn, ConditionedNCAConfig, _build,
                                         edge_cfg, edge_params)
    redesigned.update(mat_gate)
    print("  the redesigned single-scale adjoints (PERF.md rows 6, 9 and 12):")
    adj_times, conv_t_ms = time_adjoints(torch, ft, fc, cn, ConditionedNCAConfig,
                                         torch.nn.functional)
    vgg_pool_ms = time_vgg_pool(torch, vgg_mod, torch.nn.functional)
    print(f"  card during timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    metrics = {
        "card": card,
        "kernel_ms_per_step_256": timing[256]["kernel_ms_per_step"],
        "kernel_ms_per_step_256_f32": timing["f32"]["kernel_ms_per_step"],
        "tc_bf16_served_drift_24": tc_bf16_drift,
        "mat_tc_bf16_drift_24_worst_past_cases": list(mat_tc_drift),
        "f32_stylizer_launches": f32_launches,
        "kernel_ms_per_step_512": timing[512]["kernel_ms_per_step"],
        "plain_ms_per_step_256": timing[256]["plain_ms_per_step"],
        "plain_ms_per_step_512": timing[512]["plain_ms_per_step"],
        "bound_ms_per_step_256": timing[256]["bound_ms_per_step"],
        "bound_ms_per_step_512": timing[512]["bound_ms_per_step"],
        "stylizer_ms_per_frame_256": frame_ms,
        "stylizer_fps_256": stylizer_fps,
        "nca_cell_updates_per_sec_256px": cups,
        **{f"server_256_{k}": v for k, v in serve.items()},
        "train_fwd_ms_per_step_128_b4": fwd_ms,
        **{f"train_{k.replace(' ', '_').replace('+', 'and')}_ms_{n}": v
           for n, parts in split.items() for k, v in parts.items()},
        "train_iterations_per_s": its,
        "train_peak_gb_128": peak_gb,
        "train_launches": train_launches,
        "train_step_n": train_steps,
        "grower_launches": grower_launches,
        "grower_steps_per_s_64": grower_steps_per_s,
        "encoder_launches": enc_launches,
        "encoder_step_n": enc_steps,
        **{f"encoder_{k.replace(' ', '_')}_ms_{CNCA_STEPS}": v for k, v in enc_split.items()},
        "encoder_iterations_per_s": enc_its,
        "encoder_peak_gb_96": enc_peak_gb,
        **{f"{name}_ms_b{b}": t[0] for (name, b), t in cnca_times.items()},
        **{f"{name}_ms_256_b3": t[0] for name, t in ms_times.items() if not name.endswith("bf16")},
        "nca_step_ms_ms_256_b1_bf16": ms_times["nca_step_ms_b1_bf16"][0],
        "vm_launches": vm_launches,
        "vm_step_n": vm_steps,
        **{f"vm_{k.replace(' ', '_')}_ms_144": v for k, v in vm_split.items()},
        "vm_appearance_loss_fwd_ms": vm_app_ms,
        "vm_motion_loss_fwd_ms": vm_mot_ms,
        "vm_iterations_per_s": vm_its,
        "vm_peak_gb_144": vm_peak_gb,
        "vm_held_gb_before_144": vm_held_gb,
        "cond_pair_max_abs_err": cond_err,
        "edge_launches": edge_launches,
        "edge_step_n": edge_steps,
        **{f"edge_{k.replace(' ', '_')}_ms_{COND_STEPS}": v for k, v in edge_split.items()},
        **{f"edge_loss_fwd_{k.split(' (')[0].replace(' ', '_')}_ms": v
           for k, v in edge_loss_ms.items()},
        "edge_iterations_per_s": edge_its,
        "edge_peak_gb_128": edge_peak_gb,
        "edge_held_gb_before_128": edge_held_gb,
        "edge_profiler_busy_ms_and_window_ms": edge_busy,
        **{f"edge_kernel_{k.split(' (')[0]}_{what}": v for k, t in edge_kernels.items()
           for what, v in zip(("ms", "device_ms", "plain_ms", "bound_ms"), t)},
        **{f"vf_{k.replace(' ', '_')}_ms_{COND_STEPS}": v for k, v in vf_split.items()},
        "ms_stylizer_ms_per_frame_256": ms_frame_ms,
        "ms_stylizer_fps_256": 1e3 / ms_frame_ms,
        "ms_stylizer_launches": ms_styl_launches,
        **{f"{name}_ms_256_b1_{SHORT[FORM_CDT[name]]}": t[0]
           for name, t in form_times.items() if name != "stream_1024"},
        "stream_ms_per_step_1024": form_times["stream_1024"][0],
        **{f"entry_{k.replace(', ', '_').replace(' ', '_')}_ms_per_step_{n}": v
           for (k, n), v in entry_ms.items()},
        **{f"segment_{cell.split()[0]}_k{k}_{what}": v
           for (cell, k), t in seg_times.items() for what, v in zip(("ms", "gb"), t)},
        "benchmark_serving_aggregate_fps_8x256": bench_serving["aggregate_fps"],
        "benchmark_train_static_texture_iters_per_s": bench_train["train_iters_per_sec"],
        "layout_path_launches": layout_launches,
        "forms_max_abs_err": forms_err,
        "stream_max_abs_err_1024": stream_err,
        "segment_k": seg_k,
        "segment_max_abs_diff_k_vs_1": seg_diff,
        "segment_max_abs_err_vs_plain": seg_err,
        **{f"tc_{name}_{label.replace('^', '').replace(' ', '_')}_{what}": v
           for (name, label), t in tc_times.items()
           for what, v in zip(("ms", "f32_bound_ms", "tc_bound_ms", "device_ms"), t[:4])
           if v is not None},
        **{f"redesigned_{name}_{label.replace('^', '').replace(' ', '_')}_{what}": v
           for (name, label), t in redesigned.items()
           for what, v in zip(("ms", "device_ms", "f32_bound_ms", "blocks_per_sm"), t)},
        **{f"adjoint_{name}_{what}": v for name, t in adj_times.items()
           for what, v in zip(("ms", "device_ms", "f32_bound_ms", "blocks", "blocks_per_sm"), t)},
        "cnca_bwd_adjoint_library_conv_transpose2d_ms": conv_t_ms[0],
        "cnca_bwd_adjoint_library_conv_transpose2d_device_ms": conv_t_ms[1],
        "cnca_gate_stress_near_zero_h1_h2": list(stress_near),
        "cnca_gate_stress_max_scaled_err": stress_err,
        **{f"vgg_loss_fwd_bwd_{label.replace('^', '').replace(' ', '_')}_{which}_ms": v
           for label, t in vgg_pool_ms.items() for which, v in zip(("eq_pool", "torch_pool"), t)},
        "lifecycle_launches": life_launches,
        **{f"lifecycle_{k}": v for k, v in life_metrics.items()},
        "data_parallel": dp_timing,
        "spatial": spatial_timing,
        "fleet": fleet_timing,
        "examples_s": ex_wall,
    }
    print("metrics " + json.dumps(metrics))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    bwd_rows = ("vsnca_tpu/ops/pallas_train.py:2235 (_make_bwd_kernel_flat :1139, "
                "_make_bwd_kernel_flat_scatter :1657); vsnca_tpu/ops/pallas_train.py:2358 "
                "(_make_bwd_kernel_flat_tiled :1301, scales (0,) without taps); "
                "vsnca_tpu/ops/pallas_train.py:843 (_bwd_call, _make_bwd_kernel :485, under "
                "the segment walk of ops/fused_train.py)")
    fwd_rows = ("vsnca_tpu/ops/pallas_cnca.py:250 (_make_cnca_kernel :47); "
                "vsnca_tpu/ops/pallas_cnca.py:610 (_make_cnca_fwd_train_kernel :350)")
    bwd_cnca = "vsnca_tpu/ops/pallas_cnca.py:675 (_make_cnca_bwd_train_kernel :434)"
    ms_bwd_rows = ("vsnca_tpu/ops/pallas_train.py:2358 (_make_bwd_kernel_flat_tiled :1301 with "
                   "_flat_percept_ms_adj :185 and the tap injection :1361-1373, :1542)")
    cnca_rows = {"cnca_update": fwd_rows, "cnca_gate": fwd_rows, "cnca_bwd_mlp": bwd_cnca,
                 "cnca_bwd_adjoint": bwd_cnca}
    rollout_rows = ("vsnca_tpu/ops/pallas_step.py:1600 (_make_kernel_flat :1411); "
                    "vsnca_tpu/ops/pallas_step.py:1885 (_make_kernel_stream_flat :1621); "
                    "vsnca_tpu/ops/pallas_step.py:731 (fused_rollout_chw algo 'roll', "
                    "_make_kernel_roll :175); vsnca_tpu/ops/pallas_step.py:1066 "
                    "(fused_rollout_stream_chw, _make_kernel_stream :845)")
    kernels = [{
        "name": "nca_step",
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_step.cu",
        "replaces": rollout_rows,
        "launches": f32_launches + edge_launches["nca_step_tc"] + life_launches["nca_step"],
        "max_abs_err": max_err,
        "ms": timing["f32"]["kernel_ms_per_step"],
        "plain_ms": timing["f32"]["plain_ms_per_step"],
        "bound_ms": timing["f32"]["bound_ms_per_step"],
        "bound_by": timing["f32"]["bound_by"],
        "library_ms": None,
        "f32_bound_ms": timing["f32"]["bound_ms_per_step"],
        "tc_bound_ms": timing["f32"]["tc_bound_ms"],
        "tc_bound_by": timing["f32"]["tc_bound_by"],
    }, {
        "name": "nca_step_chain",
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_step.cu",
        "replaces": rollout_rows + "; vsnca_tpu/ops/pallas_train.py:2079 (_fwd_call_flat, "
                    "_make_fwd_kernel_flat :942); vsnca_tpu/ops/pallas_train.py:759 "
                    "(_fwd_call, _make_fwd_kernel :390) and the recompute of "
                    "vsnca_tpu/ops/pallas_train.py:843 (_make_bwd_kernel :485)",
        "launches": launches + train_launches["nca_step"] + edge_launches["nca_step"],
        "max_abs_err": max(max_err, stream_err, chain_err["nca_step_chain"],
                           cond_err["nca_step_chain"]),
        "ms": timing[256]["kernel_ms_per_step"],
        "plain_ms": timing[256]["plain_ms_per_step"],
        "bound_ms": timing[256]["bound_ms_per_step"],
        "bound_by": timing[256]["bound_by"],
        "library_ms": None,
        "f32_bound_ms": step_bound_ms(12, 3, 96, 256 * 256, "float32")[0],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_train.cu",
        "replaces": bwd_rows,
        "launches": train_launches[name] + edge_launches[name],
        "max_abs_err": max(train_err[name], cond_err[name]),
        "ms": k,
        "plain_ms": p,
        "bound_ms": b,
        "bound_by": by,
        "library_ms": None,
        **({"tc_bound_ms": tc_times[(name, "128^2 b4 float32")][2],
            "tc_bound_by": tc_times[(name, "128^2 b4 float32")][4]}
           if name == "nca_bwd_mlp" else {}),
        **({"device_ms": adj_times[name][1], "blocks": adj_times[name][3],
            "blocks_per_sm": adj_times[name][4]} if name in adj_times else {}),
    } for name, (k, p, b, by) in tk.items()] + [{
        "name": name,
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_cnca.cu",
        "replaces": cnca_rows[name],
        "launches": enc_launches[name],
        "max_abs_err": max(cnca_err[name], redesigned_err.get(name, 0.0)),
        "ms": cnca_times[(name, 8)][0],
        "plain_ms": cnca_times[(name, 8)][1],
        "bound_ms": cnca_times[(name, 8)][2],
        "bound_by": cnca_times[(name, 8)][3],
        "library_ms": conv_t_ms[0] if name == "cnca_bwd_adjoint" else None,
        **({"tc_bound_ms": tc_times[(name, "64^2 b8 float32")][2],
            "tc_bound_by": tc_times[(name, "64^2 b8 float32")][4]}
           if name == "cnca_bwd_mlp" else {}),
        **({"device_ms": adj_times[name][1], "blocks": adj_times[name][3],
            "blocks_per_sm": adj_times[name][4], "library_device_ms": conv_t_ms[1]}
           if name == "cnca_bwd_adjoint" else {}),
        **({"device_ms": redesigned[(name, "64^2 b8 float32")][1],
            "blocks_per_sm": redesigned[(name, "64^2 b8 float32")][3]}
           if name in ("cnca_update", "cnca_gate") else {}),
        **({"blocks": fc.gate_geometry(8, 20, 64, 64)[0]} if name == "cnca_gate" else {}),
    } for name in fc.KERNEL_LAUNCHES] + [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": rows,
        "launches": vm_launches[name.replace("_chain", "")],
        "max_abs_err": err,
        "ms": ms_times[name][0],
        "plain_ms": ms_times[name][1],
        "bound_ms": ms_times[name][2],
        "bound_by": ms_times[name][3],
        "library_ms": None,
        **({"tc_bound_ms": tc_times[(name, "256^2 b3 float32")][2],
            "tc_bound_by": tc_times[(name, "256^2 b3 float32")][4]}
           if name == "nca_bwd_mlp_ms" else {}),
        **({"device_ms": redesigned[(name, "256^2 b3 float32")][1],
            "blocks_per_sm": redesigned[(name, "256^2 b3 float32")][3]}
           if name == "nca_bwd_adjoint_ms" else {}),
    } for name, src, rows, err in (
        ("nca_step_ms_chain", "vsnca_tpu_torch/csrc/nca_step.cu",
         "vsnca_tpu/ops/pallas_train.py:2144 (_fwd_call_flat_tiled_ms, "
         "_make_fwd_kernel_flat_tiled_ms :1031)", chain_err["nca_step_ms_chain"]),
        ("nca_bwd_mlp_ms", "vsnca_tpu_torch/csrc/nca_train.cu", ms_bwd_rows,
         ms_train_err["nca_bwd_mlp_ms"]),
        ("nca_bwd_adjoint_ms", "vsnca_tpu_torch/csrc/nca_train.cu", ms_bwd_rows,
         max(ms_train_err["nca_bwd_adjoint_ms"], redesigned_err["nca_bwd_adjoint_ms"])),
    )] + [{
        "name": "nca_step_ms",
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_step.cu",
        "replaces": "vsnca_tpu/ops/pallas_step.py:731 (fused_rollout_chw, "
                    "_make_kernel_roll_ms :308)",
        "launches": ms_styl_launches + life_launches["nca_step_ms"],
        "max_abs_err": ms_err,
        "ms": ms_times["nca_step_ms_b1_bf16"][0],
        "plain_ms": ms_times["nca_step_ms_b1_bf16"][1],
        "bound_ms": ms_times["nca_step_ms_b1_bf16"][2],
        "bound_by": ms_times["nca_step_ms_b1_bf16"][3],
        "library_ms": None,
        "f32_bound_ms": ms_bound_ms("nca_step_ms", 16, 2, 128, VM_SIZE * VM_SIZE)[0],
        "tc_bound_ms": tc_times[("nca_step_ms", "256^2 b1 bfloat16")][2],
        "tc_bound_by": tc_times[("nca_step_ms", "256^2 b1 bfloat16")][4],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_step.cu",
        "replaces": rows,
        "launches": layout_launches[name],
        "max_abs_err": forms_err[name],
        "ms": form_times[name][0],
        "plain_ms": form_times[name][1],
        "bound_ms": form_times[name][2],
        "bound_by": form_times[name][3],
        "library_ms": None,
        **({"f32_bound_ms": mat_bounds[name][0], "tc_bound_ms": mat_bounds[name][1],
            "tc_bound_by": form_times[name][3],
            "device_ms": redesigned[(name, f"256^2 b1 edges {FORM_CDT[name]}")][1],
            "blocks_per_sm": redesigned[(name, f"256^2 b1 edges {FORM_CDT[name]}")][3]}
           if name in mat_bounds else {}),
    } for name, rows in (
        ("nca_step_mat", "vsnca_tpu/ops/pallas_step.py:731 (fused_rollout_chw algo 'mat', "
         "_make_kernel_roll(mat_stencil=True) :175 with stencil_folded_w1 :148)"),
        ("nca_step_mat_chain", "vsnca_tpu/ops/pallas_step.py:731 (fused_rollout_chw algo "
         "'mat' under bf16 compute, _make_kernel_roll(mat_stencil=True) :175 with "
         "stencil_folded_w1 :148)"),
        ("nca_step_bf16_state", "vsnca_tpu/ops/pallas_step.py:731 (fused_rollout_chw algo "
         "'padded' and state_dtype 'bfloat16', _make_kernel :498)"),
    )]
    # this slice's launches: the data-parallel ranks, the fleet and the examples
    ex = lambda *names: sum(ex_launches.get(n, 0) for n in names)  # noqa: E731
    slice_launches = {
        "nca_step": dp_launches["nca_step"] + ex("step:nca_step"),
        "nca_step_chain": dp_launches["nca_step_chain"] + fleet_launches["nca_step"]
        + ex("train:nca_step", "step:nca_step_chain"),
        "nca_bwd_mlp": dp_launches["nca_bwd_mlp"] + fleet_launches["nca_bwd_mlp"]
        + ex("train:nca_bwd_mlp"),
        "nca_bwd_adjoint": dp_launches["nca_bwd_adjoint"] + fleet_launches["nca_bwd_adjoint"]
        + ex("train:nca_bwd_adjoint"),
        "nca_step_ms_chain": ex("train:nca_step_ms"),
        "nca_bwd_mlp_ms": ex("train:nca_bwd_mlp_ms"),
        "nca_bwd_adjoint_ms": ex("train:nca_bwd_adjoint_ms"),
        "nca_step_ms": ex("step:nca_step_ms", "step:nca_step_ms_chain"),
        "nca_step_mat": ex("step:nca_step_mat"),
        "nca_step_mat_chain": ex("step:nca_step_mat_chain"),
        "nca_step_bf16_state": ex("step:nca_step_bf16_state"),
        **{k: ex(f"cnca:{k}") for k in fc.KERNEL_LAUNCHES},
    }
    for entry in kernels:
        entry["launches"] += slice_launches.get(entry["name"], 0)
    print(f"  this slice's launches (data-parallel ranks, fleet, examples): {slice_launches}")
    for entry in kernels:
        # the kernels whose products run on the tensor cores, and nca_step_mat
        # in either form, are held to the bound at the tensor cores' peak; the
        # float32 CUDA-core bound stays beside it
        if "tc_bound_by" in entry:
            entry.setdefault("f32_bound_ms", entry["bound_ms"])
            entry["bound_ms"], entry["bound_by"] = entry["tc_bound_ms"], entry.pop("tc_bound_by")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
