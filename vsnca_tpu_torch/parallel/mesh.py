"""Process groups for the port's multi-device paths — the counterpart of
``vsnca_tpu/parallel/mesh.py`` (``make_mesh`` :25, ``replicate`` :39,
``shard_along`` :43).

JAX's named mesh axes become ``torch.distributed`` process groups: one rank
a device, ranks laid out row-major over the axes (``data``, ``space``,
``model``), as ``make_mesh`` reshapes its device list. Nothing here guesses
a cluster: ``init_process`` takes the backend, world size, rank and address
explicitly (``nccl`` with one rank a card, ``gloo`` on the CPU or for ranks
that share one card). ``run_ranks`` starts the ranks as spawned processes
that import only torch and this package, and returns each rank's result.

Under gloo a CUDA tensor crosses through host memory (an explicit copy in
``_staged``); under NCCL every collective takes the device tensor as it is.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "space", "model")


def init_process(backend: str, world_size: int, rank: int, port: int,
                 device=None) -> None:
    """Join the process group of ``world_size`` ranks at
    ``tcp://localhost:port`` as ``rank``, over ``backend`` ('nccl' or
    'gloo'); ``device`` is this rank's device (an NCCL rank needs its
    card)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dev = torch.device(device) if device is not None else None
    if backend == "nccl" and (dev is None or dev.type != "cuda"):
        raise ValueError("an NCCL rank needs a CUDA device")
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)


@dataclasses.dataclass
class Mesh:
    """This rank's place on a mesh of named axes: ``shape`` (axis → size),
    ``coords`` (axis → this rank's index along it) and ``groups`` (axis →
    the process group of the ranks that differ from this one only along
    that axis)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]

    @property
    def axis_names(self):
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh over every rank of the initialized world; by default one
    ``data`` axis. Every rank must call it with the same ``axes`` (each
    axis' groups are made collectively)."""
    world = dist.get_world_size()
    axes = dict(axes or {"data": world})
    for name in axes:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; the axes are {AXES}")
    if int(np.prod(list(axes.values()))) != world:
        raise ValueError(f"mesh {axes} needs {int(np.prod(list(axes.values())))} ranks, "
                         f"have {world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(tuple(axes.values()))
    coords = dict(zip(axes, (int(i) for i in np.unravel_index(rank, grid.shape))))
    groups = {}
    for a, name in enumerate(axes):
        if len(axes) == 1:
            groups[name] = dist.group.WORLD
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(axes, coords, groups)


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _staged(t: torch.Tensor, group, op: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """Run the in-place collective ``op`` on ``t``: through a host copy when
    the group is gloo and ``t`` lies on a card, on ``t`` itself otherwise."""
    if t.is_cuda and _is_gloo(group):
        host = t.detach().cpu()
        op(host)
        t.copy_(host)
    else:
        op(t)
    return t


def replicate(x, mesh: Mesh, axis: Optional[str] = None):
    """Broadcast a tensor, or a dict of tensors, from the first rank of
    ``axis``'s group (the whole mesh's first axis when None) to the others,
    in place; returns ``x``."""
    group = mesh.group(axis or mesh.axis_names[0])
    src = dist.get_global_rank(group, 0)
    tensors = x.values() if isinstance(x, dict) else [x]
    with torch.no_grad():
        for t in tensors:
            _staged(t, group, lambda u: dist.broadcast(u, src, group=group))
    return x


def shard_along(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, split evenly over ``axis``."""
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} must divide the {n}-rank "
                         f"'{axis}' axis")
    m = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * m, m)


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group``, in place."""
    n = dist.get_world_size(group)
    _staged(t, group, lambda u: dist.all_reduce(u, group=group))
    return t.div_(n)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if src.is_cuda and _is_gloo(group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


# ----------------------------------------------------------------- spawning


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, backend, port, device, threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process(backend, world_size, rank, port, device)
        out = fn(device, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent re-raises it by name
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, backend: str, devices: Sequence[str],
              args: Sequence = (), threads: Optional[int] = None,
              timeout: Optional[float] = 900.0) -> List[Any]:
    """Start ``world_size`` spawned processes, rank r calling
    ``fn(devices[r], *args)`` inside the process group of ``backend``;
    returns the ranks' results in rank order. ``fn`` must be a module-level
    function of this package (a child imports its module, and nothing of a
    test file), and its result picklable (numpy, not tensors). ``threads``
    sets each rank's torch threads. A rank that raises, dies or outlasts
    ``timeout`` seconds (None: no limit) ends every rank, and the error is
    raised here."""
    if len(devices) != world_size:
        raise ValueError(f"{world_size} ranks need {world_size} devices, got {devices}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, port, devices[r], threads,
                               tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with code(s) "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {world_size} ranks outlasted {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [got[r] for r in range(world_size)]


def rank_devices(world_size: int, device: str) -> List[str]:
    """Each rank's device: ``cuda:r`` for 'cuda' (one rank a card), else
    ``device`` for every rank ('cpu', or one named card that the ranks
    share)."""
    if device == "cuda":
        n = torch.cuda.device_count()
        if n < world_size:
            raise RuntimeError(f"{world_size} ranks need {world_size} CUDA devices, "
                               f"{n} visible")
        return [f"cuda:{r}" for r in range(world_size)]
    return [device] * world_size
