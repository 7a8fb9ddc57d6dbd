"""Where the time goes inside the redesigned kernels: a per-phase clock
profile of the served step (``nca_step_kernel_served``, ``served``), of the
rollout step ``nca_step_ms`` (its tensor-core and chain forms) and
``nca_step_mat`` (the folded stencil, both forms), of the training
backward's ``nca_bwd_mlp(_ms)``, ``nca_bwd_adjoint`` and
``nca_bwd_adjoint_ms``, and of ``cnca_update``, ``cnca_gate``,
``cnca_bwd_mlp`` and ``cnca_bwd_adjoint`` on the card.

``python3 -m vsnca_tpu_torch.ops.phase_profile`` (a CUDA card and ``nvcc``
needed) writes instrumented copies of ``csrc/nca_step.cu``,
``csrc/nca_train.cu`` and ``csrc/nca_cnca.cu`` into
``build/kernels/profile/``: after every ``__syncthreads()`` in the body of
each kernel of ``KERNELS``, and after every ``// phase:`` comment there,
thread 0 of each block adds the ``clock64()`` cycles since the previous
sample into a device counter for that phase. It builds them, launches each
kernel at the shapes of PERF.md's kernel table through the port's own
wrappers (the instrumented library stands in for the built one), and prints
each phase's mean cycles a block and its share. A phase that ends at a
barrier includes the wait for the block's slowest warp; one that ends at a
``// phase:`` mark (the step's z1 and second layer, a chunk of units at a
time, and its store; the staging and the last phase of ``cnca_update``; the
issue of the next pass's copies and the combine of ``nca_bwd_adjoint_ms``)
counts thread 0's warp alone (the served step's, summed over a block's
tiles, too); so do the staging, adjoint and store marks of the
single-scale adjoints, whose
waiting phase ends at the barrier after a channel's copies, and
``cnca_gate``'s staging, life-mask and store marks. A phase in a
loop (the adjoints' passes or channels) sums over its iterations. The
kernels' results are not checked here: ``tests/test_torch_cuda.py`` holds
the uninstrumented kernels to their plain versions.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from typing import Dict, List, Tuple

import torch

from vsnca_tpu_torch.ops import _build

OUT = _build.BUILD_DIR / "profile"
KERNELS = {"nca_step": ("nca_step_kernel(", "nca_step_kernel_served("),
           "nca_train": ("nca_bwd_mlp_kernel(", "nca_bwd_adjoint_kernel(",
                         "nca_bwd_adjoint_ms_kernel("),
           "nca_cnca": ("cnca_update_kernel(", "cnca_gate_kernel(", "cnca_bwd_mlp_kernel(",
                        "cnca_bwd_adjoint_kernel(")}
MAX_PHASES = 32

_COUNTERS = f"""
__device__ unsigned long long phase_clk[{MAX_PHASES}];
#define PHASE(i) do {{ if (threadIdx.x == 0) {{ const long long now = clock64(); \\
  atomicAdd(&phase_clk[i], (unsigned long long)(now - t_phase)); t_phase = now; }} }} while (0)
"""
_READER = f"""
extern "C" int read_phase_clocks(unsigned long long* out) {{
  cudaMemcpyFromSymbol(out, phase_clk, sizeof(phase_clk));
  unsigned long long zero[{MAX_PHASES}] = {{0}};
  return (int)cudaMemcpyToSymbol(phase_clk, zero, sizeof(zero));
}}
"""


def instrument(name: str) -> Dict[str, Tuple[int, List[str]]]:
    """Write the instrumented copy of ``csrc/<name>.cu`` (and the headers)
    into OUT; returns, for each kernel of KERNELS[name], the counter index of
    its first phase and each phase's label (the comment on its barrier or
    mark)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    src = (_build.CSRC / f"{name}.cu").read_text()
    out, n, phases = src, 0, {}
    for kernel in KERNELS[name]:
        start = out.index(kernel)
        start = out.index(") {\n", start) + len(") {\n")  # the body's first line
        end = out.index("\n}\n", start)
        labels, lines = [], []
        for line in out[start:end].split("\n"):
            lines.append(line)
            if "__syncthreads();" in line:
                lines.append(f"  PHASE({n + len(labels)});")
                labels.append(line.split("//", 1)[1].strip() if "//" in line else "")
            elif "// phase:" in line:
                lines.append(f"  PHASE({n + len(labels)});")
                labels.append(line.split("// phase:", 1)[1].strip())
        body = "  long long t_phase = clock64();\n" + "\n".join(lines)
        out = out[:start] + body + out[end:]
        phases[kernel.rstrip("(")] = (n, labels)
        n += len(labels)
    if n > MAX_PHASES:
        raise RuntimeError(f"{name}.cu has {n} phases, more than MAX_PHASES = {MAX_PHASES}")
    out = re.sub(r'(#include "nca_mma.cuh"\n)', lambda m: m.group(1) + _COUNTERS, out, count=1)
    (OUT / f"{name}.cu").write_text(out + _READER)
    return phases


def build() -> Dict[str, Dict[str, Tuple[int, List[str]]]]:
    """Instrument and compile the sources (one nvcc each, together) and put
    the libraries in place of the built ones for this process."""
    labels, procs = {}, {}
    for name in KERNELS:
        labels[name] = instrument(name)
        so = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(OUT / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs[name] = (proc, so)
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the instrumented {name}.cu:\n{out.decode()}")
        with _build._LOCK:
            _build._LIBS[name] = ctypes.CDLL(str(so))
    return labels


def _report(lib, phases: Tuple[int, List[str]], n_blocks: int, reps: int, title: str,
            per: str = "a block") -> None:
    first, labels = phases
    buf = (ctypes.c_ulonglong * MAX_PHASES)()
    lib.read_phase_clocks(buf)
    clocks = [buf[first + i] for i in range(len(labels))]
    total = sum(clocks) or 1
    print(f"{title}: mean clocks {per} by phase (the barrier that ends it)")
    for i, label in enumerate(labels):
        print(f"  {i}: {clocks[i] / (n_blocks * reps):9.0f} ({100 * clocks[i] / total:4.1f}%)  "
              f"{label or '__syncthreads()'}")


def served(labels: Dict[str, Dict[str, Tuple[int, List[str]]]], reps: int = 10) -> None:
    """The served step, ``nca_step``'s chain form under bf16 compute at the
    edge_conditioned widths (c12/fc96/edges), at the serving cells' shapes
    [1, 12, 256, 256] and [8, 12, 512, 512]: clocks by phase of a 16 x 16
    tile (a block walks several where the grid holds fewer blocks than
    tiles)."""
    from vsnca_tpu_torch.config import NCAConfig
    from vsnca_tpu_torch.models.dynca import dynca_init
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft

    lib = _build._LIBS["nca_step"]
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    packed = fs.pack_weights(params, 12, 3, "bfloat16")
    thr = fs.uniform_threshold(0.5)
    for b, h, w in ((1, 256, 256), (8, 512, 512)):
        g = torch.Generator().manual_seed(3)
        x = (torch.rand((b, 12, h, w), generator=g) - 0.5).cuda()
        cond = (torch.rand((b, 3, h, w), generator=g) - 0.5).cuda()
        dst = torch.empty_like(x)
        run = lambda: fs.launch_step(x, dst, cond, packed, "circular", "bfloat16", 5, 17,  # noqa
                                     thr, chain=True)
        run()  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        _report(lib, labels["nca_step"]["nca_step_kernel_served"], ft.n_blocks(b, h, w), reps,
                f"nca_step_kernel_served c12/fc96/edges {h}x{w} b{b} bfloat16",
                "a 16 x 16 tile")


def main(reps: int = 10) -> None:
    from vsnca_tpu_torch.config import ConditionedNCAConfig, NCAConfig
    from vsnca_tpu_torch.models import conditioned_nca as cn
    from vsnca_tpu_torch.models.dynca import dynca_init
    from vsnca_tpu_torch.ops import fused_cnca as fc
    from vsnca_tpu_torch.ops import fused_step as fs
    from vsnca_tpu_torch.ops import fused_train as ft

    if not torch.cuda.is_available():
        raise SystemExit("phase_profile needs a CUDA device")
    labels = build()
    print(torch.cuda.get_device_name(0))
    served(labels, reps)
    thr = fs.uniform_threshold(0.5)
    lib = _build._LIBS["nca_step"]
    for b, cdt, chain in ((3, "float32", False), (1, "bfloat16", False), (3, "float32", True)):
        cfg = NCAConfig(c_in=16, fc_dim=128, padding_mode="circular", conditioning="pos_emb",
                        perception_scales=(0, 1))
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        g = torch.Generator().manual_seed(3)
        x = (torch.rand((b, 16, 256, 256), generator=g) - 0.5).cuda()
        cond = (torch.rand((b, 2, 256, 256), generator=g) - 0.5).cuda()
        dst = torch.empty_like(x)
        packed = fs.pack_weights(params, 16, 2, cdt)
        fs.launch_step(x, dst, cond, packed, "circular", cdt, 5, 17, thr, True,
                       chain=chain)  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            fs.launch_step(x, dst, cond, packed, "circular", cdt, 5, 17, thr, True, chain=chain)
        torch.cuda.synchronize()
        _report(lib, labels["nca_step"]["nca_step_kernel"], ft.n_blocks(b, 256, 256), reps,
                f"nca_step_ms{'_chain' if chain else ''} c16/fc128 256^2 b{b} {cdt} (the "
                f"other form's phases read 0)")
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    g = torch.Generator().manual_seed(3)
    x = (torch.rand((1, 12, 256, 256), generator=g) - 0.5).cuda()
    cond = (torch.rand((1, 3, 256, 256), generator=g) - 0.5).cuda()
    dst = torch.empty_like(x)
    for cdt in ("float32", "bfloat16"):
        chain = fs.chain_form("nca_step_mat", cdt)
        packed = fs.pack_weights(params, 12, 3, cdt, True)
        fs.launch_step(x, dst, cond, packed, "circular", cdt, 5, 17, thr, mat=True,
                       chain=chain)  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            fs.launch_step(x, dst, cond, packed, "circular", cdt, 5, 17, thr, mat=True,
                           chain=chain)
        torch.cuda.synchronize()
        _report(lib, labels["nca_step"]["nca_step_kernel"], ft.n_blocks(1, 256, 256), reps,
                f"nca_step_mat{'_chain' if chain else ''} c12/fc96/edges 256^2 b1 {cdt} (the "
                f"other forms' phases read 0)")
    lib = _build._LIBS["nca_train"]
    for c, f, ms, b, n, cdt in ((12, 96, False, 4, 128, "float32"),
                                (16, 128, True, 3, 256, "float32"),
                                (16, 128, True, 1, 256, "bfloat16")):
        cfg = NCAConfig(c_in=c, fc_dim=f, padding_mode="circular", conditioning="pos_emb",
                        perception_scales=(0, 1) if ms else (0,))
        params = dynca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        g = torch.Generator().manual_seed(3)
        x = (torch.rand((b, c, n, n), generator=g) - 0.5).cuda()
        gx = torch.randn((b, c, n, n), generator=g).cuda()
        cond = (torch.rand((b, 2, n, n), generator=g) - 0.5).cuda()
        packed = fs.pack_weights(params, c, 2, cdt)
        gp = torch.empty((b, 4 * c, n, n), device="cuda")
        slots = ft._zero_slots(b, c, n, n, packed)
        ft._launch_mlp(x, cond, gx, gp, None, slots, packed, cdt, 5, 17, thr, ms)  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            ft._launch_mlp(x, cond, gx, gp, None, slots, packed, cdt, 5, 17, thr, ms)
        torch.cuda.synchronize()
        _report(lib, labels["nca_train"]["nca_bwd_mlp_kernel"], ft.n_blocks(b, n, n), reps,
                f"{'nca_bwd_mlp_ms' if ms else 'nca_bwd_mlp'} c{c}/fc{f} {n}^2 b{b} {cdt}")
    g = torch.Generator().manual_seed(4)
    gp = torch.randn((3, 64, 256, 256), generator=g).cuda()
    gx = torch.randn((3, 16, 256, 256), generator=g).cuda()
    ft._launch_adjoint(gp, gx, None, True)  # warm-up
    torch.cuda.synchronize()
    lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
    for _ in range(reps):
        ft._launch_adjoint(gp, gx, None, True)
    torch.cuda.synchronize()
    _report(lib, labels["nca_train"]["nca_bwd_adjoint_ms_kernel"], ft.n_blocks(3, 256, 256), reps,
            "nca_bwd_adjoint_ms C16 256^2 b3 float32 (8 passes of 2 channels)")
    gp = torch.randn((4, 48, 128, 128), generator=g).cuda()
    gx = torch.randn((4, 12, 128, 128), generator=g).cuda()
    ft._launch_adjoint(gp, gx)  # warm-up
    torch.cuda.synchronize()
    lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
    for _ in range(reps):
        ft._launch_adjoint(gp, gx)
    torch.cuda.synchronize()
    _report(lib, labels["nca_train"]["nca_bwd_adjoint_kernel"],
            ft.adjoint_geometry(4, 12, 128, 128)[0], reps,
            "nca_bwd_adjoint C12 128^2 b4 float32 (2 channels a block)")
    lib = _build._LIBS["nca_cnca"]
    for b in (8, 1):
        cfg = ConditionedNCAConfig(image_size=64, cell_fire_rate=0.5)
        params = cn.conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device="cuda")
        g = torch.Generator().manual_seed(1)
        x = (0.3 * torch.randn((b, 20, 64, 64), generator=g)).cuda()
        goal = (0.3 * torch.randn((b, 20, 64, 64), generator=g)).cuda()
        gy = torch.randn((b, 20, 64, 64), generator=g).cuda()
        packed = fc.pack_weights(params, cfg, "float32")
        _, life = fc.cnca_step_reference(x, goal, packed, cfg, "float32", 3, 5, 0.5)
        xn = torch.empty_like(x)
        fc.launch_update(x, goal, xn, packed, cfg, "float32", 3, 5, thr)  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            fc.launch_update(x, goal, xn, packed, cfg, "float32", 3, 5, thr)
        torch.cuda.synchronize()
        _report(lib, labels["nca_cnca"]["cnca_update_kernel"], fc.n_mlp_blocks(b, 64, 64), reps,
                f"cnca_update C20/D64 64^2 b{b} float32")
        out = torch.empty_like(x)
        life_out = torch.empty((b, 64, 64), dtype=torch.uint8, device="cuda")
        fc.launch_gate(x, xn, out, life_out, cfg)  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            fc.launch_gate(x, xn, out, life_out, cfg)
        torch.cuda.synchronize()
        _report(lib, labels["nca_cnca"]["cnca_gate_kernel"], fc.gate_geometry(b, 20, 64, 64)[0],
                reps, f"cnca_gate C20 64^2 b{b} float32 (4 channels a block)")
        gp = torch.empty((b, 60, 64, 64), device="cuda")
        slots = fc._zero_slots(b, 64, 64, packed)
        fc._launch_bwd_mlp(x, goal, life, gy.clone(), gp, slots, packed, cfg, "float32", 3, 5,
                           thr)
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            fc._launch_bwd_mlp(x, goal, life, gy.clone(), gp, slots, packed, cfg, "float32", 3,
                               5, thr)
        torch.cuda.synchronize()
        _report(lib, labels["nca_cnca"]["cnca_bwd_mlp_kernel"], fc.n_mlp_blocks(b, 64, 64), reps,
                f"cnca_bwd_mlp C20/D64 64^2 b{b} float32")
        dgoal = torch.zeros_like(x)
        fc._launch_bwd_adjoint(x, gp, packed[0], gy, dgoal, cfg)  # warm-up
        torch.cuda.synchronize()
        lib.read_phase_clocks((ctypes.c_ulonglong * MAX_PHASES)())
        for _ in range(reps):
            fc._launch_bwd_adjoint(x, gp, packed[0], gy, dgoal, cfg)
        torch.cuda.synchronize()
        _report(lib, labels["nca_cnca"]["cnca_bwd_adjoint_kernel"],
                fc.bwd_adjoint_geometry(b, 20, 64, 64)[0], reps,
                f"cnca_bwd_adjoint C20 64^2 b{b} float32 (2 channels a block)")


if __name__ == "__main__":
    main()
