"""The redesigned kernels against another build of the same C interfaces,
bit for bit and in time, on the card.

``python3 -m vsnca_tpu_torch.ops.kernel_diff --ref-csrc DIR`` (a CUDA card
and ``nvcc`` needed): DIR holds ``nca_step.cu``, ``nca_train.cu``,
``nca_cnca.cu`` and the ``*.cuh`` headers of another commit, for example
written by
``git show <commit>:vsnca_tpu_torch/csrc/<file> > DIR/<file>`` into a
git-ignored directory. Both are built into ``build/kernels/ref/`` with the
flags of ``ops/_build.py``. Each case launches the kernel of this checkout
and the one of DIR on the same card tensors and prints whether their outputs
are the same bits, then each against its plain version (within the card
tests' tolerances, defined here: ``TOL``, ``TRAIN_TOL``, ``MS_STATE_TOL``,
``CNCA_TOL``); then both kernels' times
a launch at the main-path shapes by CUDA events, in turns (ref, this, this,
ref, twice), and for the single-scale adjoints, ``nca_step_mat`` and
``cnca_gate`` by the profiler's device time too, in the same turns (CUDA events over back-to-back launches read the
host's pace when a launch's host work outlasts its kernel). Exits 1 if any
case differs.

Cases: ``nca_bwd_adjoint_ms`` at 256^2 b3 (the video_motion shape) and at
16^2, 18^2, 40x72 and 34x66 b2 (footprints that wrap, more than once at
16^2; 18^2 and 34x66 take the 4-byte staging), C 16 and 5, with a tap and
without; the scales-(0,) ``nca_bwd_adjoint`` at 128^2 b4 (the
static_texture shape) and at 8^2, 18^2, 34x66 and 40x72 b2, C 12 and 5, with
a tap and without; ``cnca_bwd_adjoint`` at 64^2 b8 (the encoder trainer's
shape) and at 8^2, 24x40 and 34x66 b2, C 20 and 7, living channel on (a
sparse alpha plane) and off; ``cnca_update`` at 64^2 b8 and b1, 8^2 and
24x40 b2, living channel on and off, f32 and bf16, rates 1 and 0.5; and
``cnca_bwd_mlp``, whose
recompute shares ``cnca_update``'s device functions, at 64^2 b8 and 40x72
b2, f32 and bf16; ``cnca_gate`` at 64^2 b8 and b1 and 8^2, 24x40, 34x66 b2,
C 20 and 7, living channel on and off, alpha on and one ulp around the
threshold (``out`` and ``life``); ``nca_step`` in every form but the folded
stencil's — the tensor-core form at 256^2 b1 (edges) under float32 and
bf16 compute, the chain form at 256^2 b1 (edges, bf16) and 128^2 b4
(pos_emb, f32), the multiscale tensor-core form at 256^2 b3 f32 and b1 bf16
and its chain form at 256^2 b3 f32, the bf16-state form at 256^2 b1 — and
``nca_bwd_mlp`` / ``nca_bwd_mlp_ms``, which share ``nca_mma.cuh``'s z1, at
128^2 b4 and 256^2 b3, each one launch on the same inputs as the
reference build's; ``nca_step_mat`` at 256^2 b1 (edges) and 40x72, 8^2,
18^2 and 34x66 b2 under the three paddings — the tensor-core form under
float32 and bf16 compute, the chain form under bf16 — against the
reference build, against its plain version and against the plain version
over 2^16 pixels (the batch repeated, the first copy's result: a 256^2
step's row count in its matrix products), the differences printed. The
chain form must be the reference's bits and the bits of the plain version
over 2^16 pixels, and within ``TOL`` of the plain version at the grid (whose
bits are printed beside); the tensor-core form within ``TOL`` of both. A
reference ``nca_step.cu`` whose ``nca_step_mat_launch`` has no ``tc``
argument (one form, the chain's order) is called without it.

Last, the kernels line, one JSON line ``{"kernels": [...]}``: each kernel
the benchmark's cells launch (the served step at 256^2 b1 and 8 x 512^2;
the training pair's three kernels at edge_train_256's and vm_train_256's
shapes; the four ConditionedNCA kernels at enc_train_64_b8's), its ms a
launch beside the reference build's, its plain version's, a library call's
where one computes part of it, and the bound of its step's work from
``portbench/counts`` (see ``kernel_rows``). Pass this checkout's own
``csrc`` as DIR to time the kernels without another commit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from vsnca_tpu_torch.ops import _build

OUT = _build.BUILD_DIR / "ref"
# the C functions whose argument types the wrappers set, by source
FUNCS = {
    "nca_step": ("nca_step_launch", "nca_step_bf16_state_launch", "nca_step_mat_launch",
                 "nca_step_limits"),
    "nca_train": ("nca_bwd_mlp_launch", "nca_bwd_adjoint_launch", "nca_train_limits"),
    "nca_cnca": ("cnca_update_launch", "cnca_gate_launch", "cnca_bwd_mlp_launch",
                 "cnca_bwd_adjoint_launch", "cnca_limits"),
}
# The tolerances every kernel is held to against its plain version, here and
# in tests/test_torch_cuda.py. TOL, for a step: float32 rtol 1e-4 / atol
# 1e-5 (the MLP's summation order); bfloat16 rtol 1e-3 / atol 1e-3 (the same
# rounding places; one float32 ulp can flip a bf16 rounding). The rest are
# of the largest element: TRAIN_TOL for the backward kernels and the pair
# (float32 1e-5, summation order: the kernel sums the weight gradients per
# 256-pixel block, then over blocks; bfloat16 5e-3, one float32 ulp before a
# bf16 rounding moves the value by 2^-8); MS_STATE_TOL for the multiscale
# adjoint; CNCA_TOL for the ConditionedNCA kernels.
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
TRAIN_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
MS_STATE_TOL = 1e-6
CNCA_TOL = {"float32": 1e-6, "bfloat16": 5e-3}


def build_ref(csrc: Path, current: dict) -> dict:
    """Build DIR's sources (one nvcc each, together) and give each library
    the argument types of the current one (``nca_step_mat_launch`` without
    ``tc`` where DIR's has none: ``mat_takes_tc``)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in FUNCS:
        so = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
               str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the reference {name}.cu:\n{out.decode()}")
        lib = ctypes.CDLL(str(so))
        for fn in FUNCS[name]:
            getattr(lib, fn).argtypes = getattr(current[name], fn).argtypes
            getattr(lib, fn).restype = getattr(current[name], fn).restype
        libs[name] = lib
    if not mat_takes_tc(csrc):
        types = list(libs["nca_step"].nca_step_mat_launch.argtypes)
        libs["nca_step"].nca_step_mat_launch.argtypes = types[:15] + types[16:]
    return libs


def mat_takes_tc(csrc: Path) -> bool:
    """Whether DIR's ``nca_step_mat_launch`` takes the ``tc`` argument
    (after ``bf16``)."""
    text = (csrc / "nca_step.cu").read_text()
    head = text[text.index("int nca_step_mat_launch("):]
    return "int tc" in head[:head.index(")")]


def _with(name: str, lib, fn):
    """fn() with ``lib`` standing in for the built library ``name``."""
    cur = _build._LIBS[name]
    _build._LIBS[name] = lib
    try:
        return fn()
    finally:
        _build._LIBS[name] = cur


def _scaled(a, b) -> float:
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _turns(cur_fn, ref_fn, reps: int = 50):
    """Median ms a launch of each, timed in turns ref, this, this, ref, twice."""
    times = {"this": [], "ref": []}
    for which, fn in (("ref", ref_fn), ("this", cur_fn), ("this", cur_fn), ("ref", ref_fn)) * 2:
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times[which].append(e0.elapsed_time(e1) / reps)
    return statistics.median(times["this"]), statistics.median(times["ref"])


def _device_turns(cur_fn, ref_fn, reps: int = 50):
    """Median device ms a launch of each (the profiler's CUDA time of
    ``reps`` launches), in turns ref, this, this, ref, twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = {"this": [], "ref": []}
    for which, fn in (("ref", ref_fn), ("this", cur_fn), ("this", cur_fn), ("ref", ref_fn)) * 2:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
        times[which].append(us / 1e3 / reps)
    return statistics.median(times["this"]), statistics.median(times["ref"])


def _print_times(name: str, cur_fn, ref_fn) -> None:
    this_ms, ref_ms = _turns(cur_fn, ref_fn)
    this_dev, ref_dev = _device_turns(cur_fn, ref_fn)
    print(f"  {name}: this {this_ms:.4f} ms a launch, the reference build {ref_ms:.4f} (CUDA "
          f"events); device this {this_dev:.4f}, the reference build {ref_dev:.4f} (profiler; "
          f"turns ref, this, this, ref, twice)")


def adjoint0_cases(ft, ref_lib):
    """The scales-(0,) nca_bwd_adjoint: the same bits as the reference build
    at every shape, within TRAIN_TOL of its plain version; times at 128^2
    b4 C 12."""
    ok = True
    g = torch.Generator().manual_seed(12)
    for (b, c, h, w) in ((4, 12, 128, 128), (2, 12, 8, 8), (2, 12, 18, 18), (2, 12, 34, 66),
                         (2, 12, 40, 72), (2, 5, 8, 8), (2, 5, 18, 18), (2, 5, 34, 66),
                         (2, 5, 40, 72)):
        gp = torch.randn((b, 4 * c, h, w), generator=g).cuda()
        gx = torch.randn((b, c, h, w), generator=g).cuda()
        gtap = torch.randn((b, c, h, w), generator=g).cuda()
        for tap in (None, gtap):
            got = ft.nca_bwd_adjoint(gp, gx, tap)
            ref = _with("nca_train", ref_lib, lambda: ft.nca_bwd_adjoint(gp, gx, tap))
            want = ft.nca_bwd_adjoint_reference(gp, gx, tap)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            err = _scaled(got, want)
            good = same and err <= TRAIN_TOL["float32"]
            ok = ok and good
            print(f"  nca_bwd_adjoint {h}x{w} b{b} C{c} tap {tap is not None}: same bits as "
                  f"the reference build {same}; against the plain version {err:.2e} of max "
                  f"(tol {TRAIN_TOL['float32']:.0e}) {'ok' if good else 'FAIL'}")
    gp = torch.randn((4, 48, 128, 128), generator=g).cuda()
    gx = torch.randn((4, 12, 128, 128), generator=g).cuda()
    run = lambda: ft._launch_adjoint(gp, gx)  # noqa: E731
    _print_times("nca_bwd_adjoint 128^2 b4 C12 f32", run,
                 lambda: _with("nca_train", ref_lib, run))
    return ok


def cnca_adjoint_cases(fc, cn, ConditionedNCAConfig, ref_lib):
    """cnca_bwd_adjoint: the same bits as the reference build (g and dgoal)
    at every shape, within CNCA_TOL of its plain version; times at 64^2 b8
    C 20."""
    ok = True
    for (b, h, w) in ((8, 64, 64), (2, 8, 8), (2, 24, 40), (2, 34, 66)):
        for hidden in (16, 3):
            for use_life in (True, False):
                cfg = ConditionedNCAConfig(image_size=w, num_hidden_channels=hidden,
                                           use_living_channel=use_life)
                c = cfg.num_channels
                params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg,
                                                 device="cuda")
                gen = torch.Generator().manual_seed(1)
                x = torch.zeros((b, c, h, w))
                x[:, cfg.alive_channel:, h // 2, w // 2] = 1.0
                x = x + 0.3 * torch.randn((b, c, h, w), generator=gen)
                x[:, cfg.alive_channel] *= 0.15  # a sparse living channel: the mask has holes
                x = x.cuda()
                gp = torch.randn((b, 3 * c, h, w), generator=gen).cuda()
                g_xn = torch.randn((b, c, h, w), generator=gen).cuda()
                wcol = fc.pack_weights(params, cfg, "float32")[0]
                got = fc.cnca_bwd_adjoint(x, gp, g_xn, wcol, cfg)
                ref = _with("nca_cnca", ref_lib,
                            lambda: fc.cnca_bwd_adjoint(x, gp, g_xn, wcol, cfg))
                want = fc.cnca_bwd_adjoint_reference(x, gp, g_xn, wcol, cfg)
                torch.cuda.synchronize()
                same = all(torch.equal(a, r) for a, r in zip(got, ref))
                err = max(_scaled(a, r) for a, r in zip(got, want))
                good = same and err <= CNCA_TOL["float32"]
                ok = ok and good
                print(f"  cnca_bwd_adjoint {h}x{w} b{b} C{c} living {use_life}: same bits as "
                      f"the reference build {same}; against the plain version {err:.2e} of "
                      f"max (tol {CNCA_TOL['float32']:.0e}) {'ok' if good else 'FAIL'}")
    cfg = ConditionedNCAConfig(image_size=64)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    gen = torch.Generator().manual_seed(2)
    x = (0.3 * torch.randn((8, 20, 64, 64), generator=gen)).cuda()
    gp = torch.randn((8, 60, 64, 64), generator=gen).cuda()
    g, dgoal = torch.randn((8, 20, 64, 64), generator=gen).cuda(), torch.zeros_like(x)
    wcol = fc.pack_weights(params, cfg, "float32")[0]
    run = lambda: fc._launch_bwd_adjoint(x, gp, wcol, g, dgoal, cfg)  # noqa: E731
    _print_times("cnca_bwd_adjoint 64^2 b8 C20 f32", run,
                 lambda: _with("nca_cnca", ref_lib, run))
    return ok


def adjoint_cases(ft, ref_lib):
    ok = True
    g = torch.Generator().manual_seed(11)
    for (b, c, h, w) in ((3, 16, 256, 256), (2, 16, 16, 16), (2, 16, 18, 18), (2, 16, 40, 72),
                         (2, 16, 34, 66), (2, 5, 16, 16), (2, 5, 34, 66)):
        gp = torch.randn((b, 4 * c, h, w), generator=g).cuda()
        gx = torch.randn((b, c, h, w), generator=g).cuda()
        gtap = torch.randn((b, c, h, w), generator=g).cuda()
        for tap in (None, gtap):
            got = ft.nca_bwd_adjoint(gp, gx, tap, True)
            ref = _with("nca_train", ref_lib, lambda: ft.nca_bwd_adjoint(gp, gx, tap, True))
            want = ft.nca_bwd_adjoint_reference(gp, gx, tap, True)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            err = _scaled(got, want)
            good = same and err <= MS_STATE_TOL
            ok = ok and good
            print(f"  nca_bwd_adjoint_ms {h}x{w} b{b} C{c} tap {tap is not None}: same bits as "
                  f"the reference build {same}; against the plain version {err:.2e} of max "
                  f"(tol {MS_STATE_TOL:.0e}) {'ok' if good else 'FAIL'}")
    return ok


def update_cases(fc, cn, ConditionedNCAConfig, ref_lib):
    ok = True
    for shape in ((8, 64, 64), (1, 64, 64), (2, 8, 8), (2, 24, 40)):
        for use_life in (True, False):
            for rate in (1.0, 0.5):
                b, h, w = shape
                cfg = ConditionedNCAConfig(image_size=w, cell_fire_rate=rate,
                                           use_living_channel=use_life)
                params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg,
                                                 device="cuda")
                gen = torch.Generator().manual_seed(1)
                c = cfg.num_channels
                x = torch.zeros((b, c, h, w))
                x[:, cfg.alive_channel:, h // 2, w // 2] = 1.0
                x = (x + 0.3 * torch.randn((b, c, h, w), generator=gen)).cuda()
                goal = (0.3 * torch.randn((b, c, h, w), generator=gen)).cuda()
                thr = fc.fs.uniform_threshold(rate)
                for cdt in ("float32", "bfloat16"):
                    packed = fc.pack_weights(params, cfg, cdt)
                    got, ref = torch.empty_like(x), torch.empty_like(x)
                    fc.launch_update(x, goal, got, packed, cfg, cdt, 3, 5, thr)
                    _with("nca_cnca", ref_lib,
                          lambda: fc.launch_update(x, goal, ref, packed, cfg, cdt, 3, 5, thr))
                    want = fc.cnca_update_reference(x, goal, packed, cfg, cdt, 3, 5, rate)
                    torch.cuda.synchronize()
                    same = torch.equal(got, ref)
                    err = _scaled(got, want)
                    good = same and err <= CNCA_TOL[cdt]
                    ok = ok and good
                    print(f"  cnca_update {h}x{w} b{b} living {use_life} rate {rate} {cdt}: same "
                          f"bits as the reference build {same}; against the plain version "
                          f"{err:.2e} of max (tol {CNCA_TOL[cdt]:.0e}) {'ok' if good else 'FAIL'}")
    # the grower's b1; b8 is the kernels line's
    cfg = ConditionedNCAConfig(image_size=64)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    gen = torch.Generator().manual_seed(1)
    x = (0.3 * torch.randn((1, 20, 64, 64), generator=gen)).cuda()
    goal = (0.3 * torch.randn((1, 20, 64, 64), generator=gen)).cuda()
    packed = fc.pack_weights(params, cfg, "float32")
    xn = torch.empty_like(x)
    thr = fc.fs.uniform_threshold(0.5)
    run = lambda: fc.launch_update(x, goal, xn, packed, cfg, "float32", 3, 5, thr)  # noqa
    this_ms, ref_ms = _turns(run, lambda: _with("nca_cnca", ref_lib, run))
    print(f"  cnca_update 64^2 b1 f32: this {this_ms:.4f} ms a launch, the reference "
          f"build {ref_ms:.4f} (CUDA events, turns ref, this, this, ref, twice)")
    return ok


def bwd_mlp_cases(fc, cn, ConditionedNCAConfig, ref_lib):
    """cnca_bwd_mlp, whose recompute now runs on cnca_update's device
    functions: the same bits as the reference build (g_xn, gp and the
    weight-gradient sums); its time is the kernels line's."""
    ok = True
    for shape in ((8, 64, 64), (2, 40, 72)):
        b, h, w = shape
        cfg = ConditionedNCAConfig(image_size=w, cell_fire_rate=0.5)
        params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        gen = torch.Generator().manual_seed(1)
        x = (0.3 * torch.randn((b, 20, h, w), generator=gen)).cuda()
        goal = (0.3 * torch.randn((b, 20, h, w), generator=gen)).cuda()
        gy = torch.randn((b, 20, h, w), generator=gen).cuda()
        for cdt in ("float32", "bfloat16"):
            packed = fc.pack_weights(params, cfg, cdt)
            _, life = fc.cnca_step_reference(x, goal, packed, cfg, cdt, 3, 5, 0.5)
            args = (packed, x, goal, life, gy, cfg, cdt, 3, 5, 0.5)
            got = fc.cnca_bwd_mlp(*args)
            ref = _with("nca_cnca", ref_lib, lambda: fc.cnca_bwd_mlp(*args))
            torch.cuda.synchronize()
            flat = lambda r: [r[0], r[1], *r[2]]  # noqa: E731
            same = all(torch.equal(a, c) for a, c in zip(flat(got), flat(ref)))
            ok = ok and same
            print(f"  cnca_bwd_mlp {h}x{w} b{b} {cdt}: same bits as the reference build {same} "
                  f"{'ok' if same else 'FAIL'}")
    return ok


def gate_cases(fc, ConditionedNCAConfig, ref_lib):
    """cnca_gate: the same bits as the reference build (out and life) at
    every shape, and its plain version's; times at 64^2 b8 and b1 C 20."""
    ok = True
    for (b, h, w) in ((8, 64, 64), (1, 64, 64), (2, 8, 8), (2, 24, 40), (2, 34, 66)):
        for hidden in (16, 3):
            for use_life in (True, False):
                cfg = ConditionedNCAConfig(image_size=w, num_hidden_channels=hidden,
                                           use_living_channel=use_life)
                c, a = cfg.num_channels, cfg.alive_channel
                thr = cfg.alpha_living_threshold
                gen = torch.Generator().manual_seed(h * w + c)
                x = torch.randn((b, c, h, w), generator=gen)
                xn = 12 * torch.randn((b, c, h, w), generator=gen)  # past the clamp too
                near = torch.tensor([thr, 0.7], dtype=torch.float32)
                near = torch.cat([near, torch.nextafter(near[:1], torch.tensor([-1.0])),
                                  torch.nextafter(near[:1], torch.tensor([1.0]))])
                for arr in (x, xn):
                    pick = near[torch.randint(0, 4, (b, h, w), generator=gen)]
                    arr[:, a] = torch.where(torch.rand((b, h, w), generator=gen) < 0.7,
                                            torch.tensor(-0.2), pick)
                x, xn = x.cuda(), xn.cuda()
                outs = [torch.empty_like(x) for _ in range(2)]
                lives = [torch.zeros((b, h, w), dtype=torch.uint8, device="cuda")
                         for _ in range(2)]
                fc.launch_gate(x, xn, outs[0], lives[0], cfg)
                _with("nca_cnca", ref_lib,
                      lambda: fc.launch_gate(x, xn, outs[1], lives[1], cfg))
                want, want_life = fc.cnca_gate_reference(x, xn, cfg)
                torch.cuda.synchronize()
                same = torch.equal(outs[0], outs[1]) and torch.equal(lives[0], lives[1])
                plain = torch.equal(outs[0], want) and (
                    want_life is None or torch.equal(lives[0], want_life))
                ok = ok and same and plain
                print(f"  cnca_gate {h}x{w} b{b} C{c} living {use_life}: same bits as the "
                      f"reference build {same}; the plain version's bits {plain} "
                      f"{'ok' if same and plain else 'FAIL'}")
    for b in (8, 1):
        cfg = ConditionedNCAConfig(image_size=64)
        gen = torch.Generator().manual_seed(b)
        x = (0.3 * torch.randn((b, 20, 64, 64), generator=gen)).cuda()
        xn = (0.3 * torch.randn((b, 20, 64, 64), generator=gen)).cuda()
        out = torch.empty_like(x)
        life = torch.empty((b, 64, 64), dtype=torch.uint8, device="cuda")
        run = lambda: fc.launch_gate(x, xn, out, life, cfg)  # noqa: E731
        _print_times(f"cnca_gate 64^2 b{b} C20 f32", run, lambda: _with("nca_cnca", ref_lib, run))
    return ok


def _step_inputs(c, cc, f, shape, seed, ms=False):
    from vsnca_tpu_torch.config import NCAConfig
    from vsnca_tpu_torch.models.dynca import dynca_init

    cond_kind = {0: None, 2: "pos_emb", 3: "edges"}[cc]
    cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="circular", conditioning=cond_kind,
                    perception_scales=(0, 1) if ms else (0,))
    params = dynca_init(torch.Generator().manual_seed(seed), cfg, device="cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    b, h, w = shape
    x = (torch.rand((b, c, h, w), generator=gen) - 0.5).cuda()
    cond = (torch.rand((b, cc, h, w), generator=gen) - 0.5).cuda() if cc else None
    return params, x, cond


def step_cases(fs, ft, ref_step, ref_train):
    """nca_step in every form but the folded stencil's, and nca_bwd_mlp(_ms),
    whose z1 shares nca_mma.cuh with the step: one launch of each on the
    same inputs as the reference build's, the same bits."""
    ok = True
    thr = fs.uniform_threshold(0.5)
    # (label, C, cc, F, shape, compute, multiscale, chain, bf16 state)
    forms = [
        ("tensor-core 256^2 b1 edges f32", 12, 3, 96, (1, 256, 256), "float32", False, False,
         False),
        ("tensor-core 256^2 b1 edges bf16", 12, 3, 96, (1, 256, 256), "bfloat16", False, False,
         False),
        ("chain 256^2 b1 edges bf16 (served)", 12, 3, 96, (1, 256, 256), "bfloat16", False,
         True, False),
        ("chain 128^2 b4 pos_emb f32 (training)", 12, 2, 96, (4, 128, 128), "float32", False,
         True, False),
        ("multiscale tensor-core 256^2 b3 f32", 16, 2, 128, (3, 256, 256), "float32", True,
         False, False),
        ("multiscale tensor-core 256^2 b1 bf16", 16, 2, 128, (1, 256, 256), "bfloat16", True,
         False, False),
        ("multiscale chain 256^2 b3 f32", 16, 2, 128, (3, 256, 256), "float32", True, True,
         False),
        ("bf16-state 256^2 b1 edges f32", 12, 3, 96, (1, 256, 256), "float32", False, False,
         True),
    ]
    for label, c, cc, f, shape, cdt, ms, chain, bstate in forms:
        params, x, cond = _step_inputs(c, cc, f, shape, 0, ms)
        if bstate:
            x, cond = x.bfloat16(), cond.bfloat16()
        packed = fs.pack_weights(params, c, cc, cdt)
        got, ref = torch.empty_like(x), torch.empty_like(x)
        run = lambda o: fs.launch_step(x, o, cond, packed, "circular", cdt, 5, 17,  # noqa
                                       thr, ms, chain=chain)
        run(got)
        _with("nca_step", ref_step, lambda: run(ref))
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        ok = ok and same
        print(f"  nca_step {label}: same bits as the reference build {same} "
              f"{'ok' if same else 'FAIL'}")
    for c, cc, f, shape, ms in ((12, 2, 96, (4, 128, 128), False),
                                (16, 2, 128, (3, 256, 256), True)):
        params, x, cond = _step_inputs(c, cc, f, shape, 1, ms)
        gx = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).cuda()
        for cdt in ("float32", "bfloat16"):
            packed = fs.pack_weights(params, c, cc, cdt)
            args = (packed, x, cond, gx, 5, 17, 0.5, cdt, True, ms)
            got = ft.nca_bwd_mlp(*args)
            ref = _with("nca_train", ref_train, lambda: ft.nca_bwd_mlp(*args))
            torch.cuda.synchronize()
            same = all(torch.equal(a, r) for a, r in zip(got, ref))
            ok = ok and same
            name = "nca_bwd_mlp_ms" if ms else "nca_bwd_mlp"
            print(f"  {name} {shape[1]}^2 b{shape[0]} {cdt}: same bits as the reference build "
                  f"{same} {'ok' if same else 'FAIL'}")
    return ok


def _mat_launch(fs, lib, with_tc, src, dst, cond, packed, pad, cdt, step, thr, tc):
    """One nca_step_mat launch of ``lib`` (the reference build's takes no
    ``tc`` where ``with_tc`` is False)."""
    w1, b1, w2, b2 = packed
    b, c, h, w = src.shape
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    head = [p(src), p(dst), p(cond), p(w1), p(b1), p(w2), p(b2), b, c, h, w,
            cond.shape[1] if cond is not None else 0, w1.shape[1], fs.PAD_CODES[pad],
            int(cdt == "bfloat16")] + ([int(tc)] if with_tc else [])
    err = lib.nca_step_mat_launch(*head, 5, step, thr,
                                  ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"nca_step_mat launch failed: CUDA error {err}")


def plain_over_rows(fs, x, cond, packed, pad, cdt, seed, step, rate, rows=1 << 16):
    """``reference_step(mat=True)`` on x's batch repeated until it holds at
    least ``rows`` pixels, the first copy's result: the same function, with
    matrix products of a 256^2 step's row count."""
    b, _, h, w = x.shape
    r = -(-rows // (b * h * w))
    rep = lambda t: None if t is None else t.repeat(r, 1, 1, 1)  # noqa: E731
    return fs.reference_step(rep(x), rep(cond), packed, pad, cdt, seed, step, rate,
                             mat=True)[:b]


def mat_cases(fs, this_lib, ref_lib, ref_tc):
    """nca_step_mat against the reference build and the plain version, one
    step at rate 0.5: the chain form (bf16) must be the reference's bits and
    those of the plain version over 2^16 pixels, and within TOL of the plain
    version at the grid; the tensor-core form (f32, and bf16 by ``tc``)
    within TOL of all three; the differences printed, and whether the plain
    version's bits at the grid are its bits over 2^16 pixels. Times at 256^2
    b1 edges: this build's form of each compute type against the
    reference's."""
    ok = True
    thr = fs.uniform_threshold(0.5)
    for shape in ((1, 256, 256), (2, 40, 72), (2, 8, 8), (2, 18, 18), (2, 34, 66)):
        for pad in ("circular", "replicate", "zeros"):
            params, x, cond = _step_inputs(12, 3, 96, shape, 3)
            for cdt in ("float32", "bfloat16"):
                packed = fs.pack_weights(params, 12, 3, cdt, True)
                ref = torch.empty_like(x)
                _mat_launch(fs, ref_lib, ref_tc, x, ref, cond, packed, pad, cdt, 17, thr, 0)
                want = fs.reference_step(x, cond, packed, pad, cdt, 5, 17, 0.5, mat=True)
                want_rows = plain_over_rows(fs, x, cond, packed, pad, cdt, 5, 17, 0.5)
                plain_same = torch.equal(want, want_rows)
                for tc in ((True,) if cdt == "float32" else (False, True)):
                    got = torch.empty_like(x)
                    _mat_launch(fs, this_lib, True, x, got, cond, packed, pad, cdt, 17, thr,
                                tc)
                    torch.cuda.synchronize()
                    d_ref = float((got - ref).abs().max())
                    d_plain = float((got - want).abs().max())
                    d_rows = float((got - want_rows).abs().max())
                    tol = TOL[cdt]["rtol"]
                    good = (d_ref == 0.0 and d_rows == 0.0 and d_plain <= tol) if not tc \
                        else max(d_ref, d_plain, d_rows) <= tol
                    ok = ok and good
                    print(f"  nca_step_mat {'tensor-core' if tc else 'chain'} "
                          f"{shape[1]}x{shape[2]} b{shape[0]} {pad} {cdt}: max|this - reference "
                          f"build| {d_ref:.3e}, max|this - plain| {d_plain:.3e}, max|this - "
                          f"plain over 2^16 px| {d_rows:.3e} (the plain version's bits there "
                          f"{'the same' if plain_same else 'differ'}) "
                          f"{'ok' if good else 'FAIL'}")
    params, x, cond = _step_inputs(12, 3, 96, (1, 256, 256), 3)
    dst = torch.empty_like(x)
    for cdt in ("float32", "bfloat16"):
        packed = fs.pack_weights(params, 12, 3, cdt, True)
        chain = fs.chain_form("nca_step_mat", cdt)
        _print_times(
            f"nca_step_mat 256^2 b1 edges {cdt} ({'chain' if chain else 'tensor-core'} form; "
            f"the reference build's one form)",
            lambda: _mat_launch(fs, this_lib, True, x, dst, cond, packed, "circular", cdt, 17,
                                thr, not chain),
            lambda: _mat_launch(fs, ref_lib, ref_tc, x, dst, cond, packed, "circular", cdt,
                                17, thr, 0))
    return ok


def _events_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """Median ms a call of ``fn`` by CUDA events, over ``rounds`` runs of
    ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def _bound(flops: float, n_bytes: float, peak_flops: float):
    """(ms, 'operations' or 'bytes'): ``portbench/counts``' least time of
    the work against the card's peaks."""
    from portbench.counts import nca, peaks

    by = "bytes" if n_bytes / peaks.HBM_BYTES_PER_S >= flops / peak_flops else "operations"
    return 1e3 * nca.bound_seconds(flops, n_bytes, peak_flops, peaks.HBM_BYTES_PER_S), by


def _cell_model(name: str) -> dict:
    """The ``nca`` group of the benchmark's configuration ``name``."""
    import json

    root = Path(__file__).resolve().parents[2]
    return json.loads((root / "portbench" / "configs" / f"{name}.json").read_text())["nca"]


def kernel_rows(fs, ft, fc, cn, ConditionedNCAConfig, ref: dict) -> list:
    """The kernels line: each kernel the benchmark's cells launch, at its
    cell's shape, random inputs and weights. ``ms`` a launch of this build
    and ``ref_ms`` of the reference build (CUDA events, in turns), the plain
    version's ``plain_ms`` on the same inputs, ``library_ms`` of the one
    PyTorch call that computes part of a kernel (``F.conv_transpose2d``,
    ``cnca_bwd_adjoint``'s g_xg alone), and ``bound_ms``, the least time of
    the step's work as ``portbench/counts`` counts it (against the bf16
    peak for the served step, the float32-accurate peak for training, as
    the cells' rooflines): for a step that is two kernels, the pair's bound
    on each row, named by ``bound_of``."""
    import torch.nn.functional as F
    from portbench.counts import cnca as cnca_count
    from portbench.counts import nca as nca_count
    from portbench.counts import peaks

    rows = []

    def row(name, cell, lib, run, plain, bound, bound_of=None, library=None):
        this_ms, ref_ms = _turns(run, lambda: _with(lib, ref[lib], run))
        r = {"name": name, "cell": cell, "ms": this_ms, "ref_ms": ref_ms,
             "plain_ms": _events_ms(plain),
             "library_ms": _events_ms(library) if library else None,
             "bound_ms": bound[0], "bound_by": bound[1], "bound_of": bound_of or name}
        rows.append(r)
        print(f"  {name} {cell}: this {this_ms:.4f} ms a launch, the reference build "
              f"{ref_ms:.4f}; plain {r['plain_ms']:.4f}; bound of {r['bound_of']} "
              f"{bound[0]:.5f} ({bound[1]})"
              + (f"; library {r['library_ms']:.4f}" if library else ""))

    thr = fs.uniform_threshold(0.5)
    edge, vm = _cell_model("edge_conditioned"), _cell_model("video_motion")
    for b, n, cell in ((1, 256, "edge_stream_256"), (8, 512, "edge_streams8_512")):
        params, x, cond = _step_inputs(12, 3, 96, (b, n, n), 4)
        packed, dst = fs.pack_weights(params, 12, 3, "bfloat16"), torch.empty_like(x)
        px = b * n * n
        row("nca_step_chain", f"{cell} {n}^2 b{b} bf16 (served)", "nca_step",
            lambda: fs.launch_step(x, dst, cond, packed, "circular", "bfloat16", 5, 17, thr,
                                   chain=True),
            lambda: fs.reference_step(x, cond, packed, "circular", "bfloat16", 5, 17, 0.5),
            _bound(nca_count.step_flops(edge, px), nca_count.rollout_bytes(edge, px),
                   peaks.BF16_FLOPS))
    for model, c, cc, f, (b, n), ms, cell in (
            (edge, 12, 3, 96, (2, 256), False, "edge_train_256"),
            (vm, 16, 2, 128, (3, 256), True, "vm_train_256")):
        sfx, px = "_ms" if ms else "", b * n * n
        params, x, cond = _step_inputs(c, cc, f, (b, n, n), 5, ms)
        packed, dst = fs.pack_weights(params, c, cc, "float32"), torch.empty_like(x)
        gen = torch.Generator().manual_seed(6)
        gx = torch.randn(x.shape, generator=gen).cuda()
        gp = torch.randn((b, 4 * c, n, n), generator=gen).cuda()
        slots = ft._zero_slots(b, c, n, n, packed)
        row(f"nca_step{sfx}_chain", f"{cell} {n}^2 b{b} f32", "nca_step",
            lambda: fs.launch_step(x, dst, cond, packed, "circular", "float32", 5, 17, thr, ms,
                                   chain=True),
            lambda: fs.reference_step(x, cond, packed, "circular", "float32", 5, 17, 0.5, ms),
            _bound(nca_count.step_flops(model, px), nca_count.rollout_bytes(model, px),
                   peaks.F32_ACCURATE_FLOPS))
        bwd = _bound(nca_count.step_backward_flops(model, px),
                     nca_count.step_backward_bytes(model, px), peaks.F32_ACCURATE_FLOPS)
        pair = f"nca_bwd_mlp{sfx} + nca_bwd_adjoint{sfx}"
        row(f"nca_bwd_mlp{sfx}", f"{cell} {n}^2 b{b} f32", "nca_train",
            lambda: ft._launch_mlp(x, cond, gx, gp, None, slots, packed, "float32", 5, 17, thr,
                                   ms),
            lambda: ft.nca_bwd_mlp_reference(packed, x, cond, gx, 5, 17, 0.5, "float32",
                                             False, ms),
            bwd, pair)
        row(f"nca_bwd_adjoint{sfx}", f"{cell} {n}^2 b{b} f32", "nca_train",
            lambda: ft._launch_adjoint(gp, gx, None, ms),
            lambda: ft.nca_bwd_adjoint_reference(gp, gx, None, ms), bwd, pair)
    enc = _cell_model("encoder_conditioned")
    cfg = ConditionedNCAConfig(image_size=64)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    gen = torch.Generator().manual_seed(7)
    x = (0.3 * torch.randn((8, 20, 64, 64), generator=gen)).cuda()
    goal = (0.3 * torch.randn((8, 20, 64, 64), generator=gen)).cuda()
    g = torch.randn((8, 20, 64, 64), generator=gen).cuda()
    gp = torch.randn((8, 60, 64, 64), generator=gen).cuda()
    packed = fc.pack_weights(params, cfg, "float32")
    xn, out = torch.empty_like(x), torch.empty_like(x)
    _, life = fc.cnca_step_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5)
    life_out = torch.empty_like(life)
    slots, dgoal = fc._zero_slots(8, 64, 64, packed), torch.zeros_like(x)
    cthr, px, cell = fc.fs.uniform_threshold(0.5), 8 * 64 * 64, "enc_train_64_b8 64^2 b8 f32"
    fwd = _bound(cnca_count.step_flops(enc, px), cnca_count.step_bytes(enc, px),
                 peaks.F32_ACCURATE_FLOPS)
    bwd = _bound(cnca_count.step_backward_flops(enc, px), cnca_count.step_backward_bytes(enc, px),
                 peaks.F32_ACCURATE_FLOPS)
    row("cnca_update", cell, "nca_cnca",
        lambda: fc.launch_update(x, goal, xn, packed, cfg, "float32", 3, 5, cthr),
        lambda: fc.cnca_update_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5), fwd,
        "cnca_update + cnca_gate")
    row("cnca_gate", cell, "nca_cnca", lambda: fc.launch_gate(x, xn, out, life_out, cfg),
        lambda: fc.cnca_gate_reference(x, xn, cfg), fwd, "cnca_update + cnca_gate")
    row("cnca_bwd_mlp", cell, "nca_cnca",
        lambda: fc._launch_bwd_mlp(x, goal, life, g, gp, slots, packed, cfg, "float32", 3, 5,
                                   cthr),
        lambda: fc.cnca_bwd_mlp_reference(packed, x, goal, life, g, cfg, "float32", 3, 5, 0.5),
        bwd, "cnca_bwd_mlp + cnca_bwd_adjoint")
    wcol = packed[0]
    row("cnca_bwd_adjoint", cell, "nca_cnca",
        lambda: fc._launch_bwd_adjoint(x, gp, wcol, g, dgoal, cfg),
        lambda: fc.cnca_bwd_adjoint_reference(x, gp, g, wcol, cfg), bwd,
        "cnca_bwd_mlp + cnca_bwd_adjoint",
        library=lambda: F.conv_transpose2d(gp, wcol.view(60, 1, 3, 3), padding=1, groups=20))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-csrc", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_diff needs a CUDA device", file=sys.stderr)
        return 1
    from vsnca_tpu_torch.config import ConditionedNCAConfig
    from vsnca_tpu_torch.models import conditioned_nca as cn
    from vsnca_tpu_torch.ops import fused_cnca as fc
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(list(FUNCS))
    current = {"nca_step": fs._launcher(), "nca_train": ft._lib(), "nca_cnca": fc._lib()}
    csrc = args.ref_csrc.resolve()
    ref = build_ref(csrc, current)
    print(torch.cuda.get_device_name(0))
    ok = gate_cases(fc, ConditionedNCAConfig, ref["nca_cnca"])
    ok = mat_cases(fs, current["nca_step"], ref["nca_step"], mat_takes_tc(csrc)) and ok
    ok = step_cases(fs, ft, ref["nca_step"], ref["nca_train"]) and ok
    ok = adjoint_cases(ft, ref["nca_train"]) and ok
    ok = adjoint0_cases(ft, ref["nca_train"]) and ok
    ok = cnca_adjoint_cases(fc, cn, ConditionedNCAConfig, ref["nca_cnca"]) and ok
    ok = update_cases(fc, cn, ConditionedNCAConfig, ref["nca_cnca"]) and ok
    ok = bwd_mlp_cases(fc, cn, ConditionedNCAConfig, ref["nca_cnca"]) and ok
    print(json.dumps({"kernels": kernel_rows(fs, ft, fc, cn, ConditionedNCAConfig, ref)}))
    print(f"kernel_diff: {'every case ok' if ok else 'a case FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
