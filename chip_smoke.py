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
   a ragged size, at the served shape (256^2) and past the TPU's resident
   cap (512^2); the stylizer on the card against the CPU; the training pair
   (forward through nca_step, backward through nca_bwd_mlp and
   nca_bwd_adjoint) across conditioning, rates and compute types at 40x72,
   and at the static_texture shape (128^2, batch 4, 32 steps), with each
   backward kernel alone there; one train step on the card against the CPU;
3. the serving path: ``StylizeServer`` with the edge-conditioned model at
   full width (c12/fc96, random weights from a seed) answers session, frame,
   damage, reset, stream and stats requests at 256^2 with 24 steps a frame;
   the kernel launch counts must equal frames x 24. The training path:
   ``DyNCATrainer`` with the static_texture preset at full width (c12/fc96,
   128^2, batch 4, pool 256, full VGG16 from its seeded fallback) trains four
   iterations (32, 128 and two sampled step counts); each training kernel's
   launches must equal the sum of the step counts; then the training CLI
   runs 3 iterations in a subprocess and its checkpoint must load;
4. times with CUDA events (median of repeats after warm-up): kernel and plain
   ms/step at 256^2 and 512^2, stylizer frames/s, the cell-update rate of
   ``bench.py``'s primary metric; on the host clock the server's frames/s and
   latency (p50, p90) including the JPEG round trip, split into its parts;
   a ``torch.profiler`` window over stylizer frames (device busy share, time
   by kernel); each training kernel's ms per launch at 128^2 / batch 4
   beside its bound and its plain version, one static_texture iteration at
   32 and 128 steps split into its parts, training iterations/s, peak device
   memory, and a profiler window over two 128-step iterations.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs one card; exits non-zero without
one. Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
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
    return worst


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
        fs.LAUNCHES = 0
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


def phase_compare_train(torch, ft, NCAConfig, dynca_init):
    """The training pair (forward through nca_step, backward through
    nca_bwd_mlp and nca_bwd_adjoint) against its plain version on the same
    card tensors; then each backward kernel alone at the static_texture
    shape. Returns the largest absolute difference of each kernel's
    outputs."""
    dev = "cuda"
    worst = {"nca_bwd_mlp": 0.0, "nca_bwd_adjoint": 0.0}

    def case(name, cond_kind, shape, n_steps, rate, cdt):
        cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning=cond_kind)
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device=dev)
        g = torch.Generator().manual_seed(1)
        x = (torch.rand(shape, generator=g) - 0.5).to(dev)
        gy = torch.randn(shape, generator=g).to(dev)
        cond = None
        if cond_kind:
            b, _, h, w = shape
            cond = (torch.rand((b, cfg.c_cond, h, w), generator=g) - 0.5).to(dev)
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr = x.clone().requires_grad_()
        cr = None if cond is None else cond.clone().requires_grad_()
        y = ft.fused_rollout_train(p, xr, 7, cfg, n_steps, cr, rate, cdt)
        (y * gy).sum().backward()
        want_y, grads, dx0, dcond = ft.fused_rollout_train_reference(
            params, x, 7, cfg, n_steps, cond, gy, rate, cdt, need_dcond=cond is not None)
        torch.cuda.synchronize()
        pairs = {"dx0": (xr.grad, dx0), **{f"d{k}": (p[k].grad, grads[k]) for k in grads}}
        if cond is not None:
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
        return absd

    for cond_kind in (None, "pos_emb", "edges"):
        for rate in (1.0, 0.5):
            for cdt in ("float32", "bfloat16"):
                case(f"40x72 b2 4 steps {cond_kind} rate {rate} {cdt}", cond_kind,
                     (2, 12, 40, 72), 4, rate, cdt)
    case("128^2 b4 32 steps pos_emb rate 0.5 float32", "pos_emb", (4, 12, 128, 128),
         32, 0.5, "float32")

    # each backward kernel alone at the static_texture shape, against its
    # plain version on the same inputs
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="pos_emb")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device=dev)
    g = torch.Generator().manual_seed(2)
    x = (torch.rand((4, 12, 128, 128), generator=g) - 0.5).to(dev)
    gx = torch.randn((4, 12, 128, 128), generator=g).to(dev)
    cond = (torch.rand((4, 2, 128, 128), generator=g) - 0.5).to(dev)
    packed = ft.fs.pack_weights(params, 12, 2, "float32")
    args = (packed, x, cond, gx, 5, 17, 0.5, "float32", True)
    got, want = ft.nca_bwd_mlp(*args), ft.nca_bwd_mlp_reference(*args)
    adj, adj_want = ft.nca_bwd_adjoint(want[0], gx), ft.nca_bwd_adjoint_reference(want[0], gx)
    torch.cuda.synchronize()
    mlp_err = max(scaled_err(a, b) for a, b in zip(got, want))
    adj_err = scaled_err(adj, adj_want)
    worst["nca_bwd_mlp"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    worst["nca_bwd_adjoint"] = float((adj - adj_want).abs().max())
    ok = mlp_err <= TRAIN_TOL["float32"] and adj_err <= TRAIN_TOL["float32"]
    print(f"  one launch each at 128^2 b4 pos_emb f32: nca_bwd_mlp max|kernel-plain| "
          f"{worst['nca_bwd_mlp']:.3e} ({mlp_err:.2e} of max|plain|), nca_bwd_adjoint "
          f"{worst['nca_bwd_adjoint']:.3e} ({adj_err:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("a backward kernel disagrees with its plain version")
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
    ft.LAUNCHES = 0
    ft.KERNEL_LAUNCHES.update({k: 0 for k in ft.KERNEL_LAUNCHES})
    fs.LAUNCHES = 0
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
        "fused_step.LAUNCHES == sum(step_n)": fs.LAUNCHES == total,
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


def time_train_iteration(torch, trainer, inputs, step_n: int, reps: int = 3):
    """One static_texture iteration (``DyNCATrainer.train_iteration``)
    split with CUDA events, recorded by the train step's ``mark`` hook, into
    rollout forward, loss forward (VGG16, Gram, overflow), loss backward,
    rollout backward and optimizer (median of ``reps`` after one warm-up).
    Returns ms by part."""
    runs = []
    for _ in range(reps + 1):
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        trainer.train_iteration(inputs, step_n=step_n, mark=mark)
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
    so the busy share is a lower bound)."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from vsnca_tpu_torch.config import LossConfig, NCAConfig, edge_conditioned
    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.data.preprocess import synthetic_style_image
    from vsnca_tpu_torch.infer import server as server_mod
    from vsnca_tpu_torch.infer.stylize import VideoStylizer
    from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
    from vsnca_tpu_torch.losses.orchestrator import LossState
    from vsnca_tpu_torch.models.dynca import dynca_init
    from vsnca_tpu_torch.models.vgg import load_vgg16, vgg16_random_init
    from vsnca_tpu_torch.ops import _build
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft
    from vsnca_tpu_torch.train import presets
    from vsnca_tpu_torch.train.optim import make_optimizer
    from vsnca_tpu_torch.train.trainer import DyNCATrainer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    phase_stylizer_parity(torch, VideoStylizer, NCAConfig, dynca_init)
    print("[2] training pair vs its plain version on the card")
    train_err = phase_compare_train(torch, ft, NCAConfig, dynca_init)
    phase_train_step_parity(torch, make_train_step, LossState, LossConfig, NCAConfig,
                            dynca_init, vgg16_random_init, make_optimizer)

    print("[3] serving path: edge_conditioned c12/fc96, 256^2, 24 steps/frame")
    cfg = edge_conditioned()
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    launches, serve = phase_serve(torch, fs, server_mod, cfg, params)

    print("[3] training path: DyNCATrainer, static_texture c12/fc96/pos_emb, 128^2, "
          "batch 4, pool 256, full VGG16 (seed-16 fallback), Gram + overflow")
    trainer, inputs = static_texture_trainer(torch, presets, DyNCATrainer, load_vgg16,
                                             synthetic_style_image,
                                             precompute_target_style_features)
    train_launches, train_steps = phase_train(torch, ft, fs, trainer, inputs)
    phase_cli(load_params_pickle)

    print("[4] times (CUDA events, median of 5 rounds after warm-up)")
    timing = {}
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
        print(f"  {n}^2 edges bf16: kernel {k:.4f} ms/step, plain {p:.4f} ms/step, "
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
    call_ms = cuda_ms(lambda: fs.fused_rollout_chw(bench_params, xb, 0, bench_cfg, 96,
                                                   compute_dtype="bfloat16"), 2)
    cups = 256 * 256 * 96 / (call_ms / 1e3)
    print(f"  nca_cell_updates_per_sec_256px (c12/fc96 circular, 96 steps, bf16): "
          f"{cups:.4e} ({call_ms:.4f} ms per 96-step call)")
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
    print(f"  training forward (nca_step into the checkpoint buffer) 128^2 b4 f32: "
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

    metrics = {
        "card": card,
        "kernel_ms_per_step_256": timing[256]["kernel_ms_per_step"],
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
    }
    print("metrics " + json.dumps(metrics))
    bwd_rows = ("vsnca_tpu/ops/pallas_train.py:2235 (_make_bwd_kernel_flat :1139, "
                "_make_bwd_kernel_flat_scatter :1657); vsnca_tpu/ops/pallas_train.py:2358 "
                "(_make_bwd_kernel_flat_tiled :1301, scales (0,) without taps)")
    print(json.dumps({"kernels": [{
        "name": "nca_step",
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_step.cu",
        "replaces": "vsnca_tpu/ops/pallas_step.py:1600 (_make_kernel_flat :1411); "
                    "vsnca_tpu/ops/pallas_step.py:1885 (_make_kernel_stream_flat :1621); "
                    "vsnca_tpu/ops/pallas_train.py:2079 (_make_fwd_kernel_flat :942)",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[256]["kernel_ms_per_step"],
        "plain_ms": timing[256]["plain_ms_per_step"],
        "bound_ms": timing[256]["bound_ms_per_step"],
        "bound_by": timing[256]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "vsnca_tpu_torch/csrc/nca_train.cu",
        "replaces": bwd_rows,
        "launches": train_launches[name],
        "max_abs_err": train_err[name],
        "ms": k,
        "plain_ms": p,
        "bound_ms": b,
        "bound_by": by,
        "library_ms": None,
    } for name, (k, p, b, by) in tk.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
