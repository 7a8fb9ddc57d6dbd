"""Persistent-state video stylization — the product inference path.

Counterpart of ``vsnca_tpu/infer/stylize.py``: the NCA state persists across
frames while each frame's grayscale / edge content steers it; per frame the
cell runs ``step_n`` (default 24) steps through the rollout kernel that
``ops.fused_step.select_rollout_kernel`` picks from ``ROLLOUT_KERNELS``, as
the JAX stylizer does (stylize.py:60-63): 'flat' (``nca_step``) for a
perception_scales (0,) model, 'roll' (``nca_step_ms``) for (0, 1) at even
sizes, and eager steps where no kernel applies. The RGB readout is clipped
to [-1, 1] → [0, 1]. The state is NCHW ``[1, C, H, W]``, as on the TPU fused
path; ``state_nhwc`` gives the JAX stylizer's layout.

Where every step is a launch of the served kernel (``takes_graph``), a
frame's whole device work (the edge map, the steps and the readout) is
captured once as CUDA graphs, after one eager frame at the state and frame
shape, and replayed each frame: the same kernels in the same order, so the
same bits, without the host between them. A batched frame is served as
chunks of whole streams (``chunk_plan``), a graph each, and each chunk's
host frame is copied to the card while the chunks before it run there. A
stylizer keeps the graphs of the last shape only. ``FRAMES``,
``GRAPH_CAPTURES`` and ``GRAPH_REPLAYS`` count ``step_frame`` calls,
captures and replays (a frame each) in the process; ``UPLOAD_BYTES`` the
host frame bytes ``step_frame`` copies to a card, and
``HIDDEN_UPLOAD_BYTES`` those whose copy was issued while an earlier chunk
of the same frame was queued on the card.

Spans (``utils.spans``): ``stylize.frame`` is a whole ``step_frame``;
inside it ``stylize.upload`` the frame to the device (one call a frame, its
chunks' copies summed), ``stylize.replay`` a chunk's seed fill and replay,
``stylize.clone`` the copies of the state and RGB a replay returns,
``stylize.eager`` an eager frame and ``stylize.capture`` a shape's capture.
Nothing in ``_frame`` is a span: a capture records device work only, and
host code is not replayed.
"""

from __future__ import annotations

import math
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning
from vsnca_tpu_torch.ops import fused_step as fs
from vsnca_tpu_torch.ops.fused_step import ROLLOUT_KERNELS, select_rollout_kernel
from vsnca_tpu_torch.ops.resize import resize_bilinear
from vsnca_tpu_torch.utils import spans

FRAMES = 0  # step_frame calls
GRAPH_CAPTURES = 0  # shapes whose frame graphs were captured
GRAPH_REPLAYS = 0  # frames served by graph replays
UPLOAD_BYTES = 0  # host frame bytes step_frame copied to a card
HIDDEN_UPLOAD_BYTES = 0  # of those, copied while an earlier chunk of the frame was queued

SERVED_TILE = 16  # NCA_TILE of csrc/nca_common.cuh: the served kernel's tiles are 16 x 16


def chunk_plan(batch: int, h: int, w: int, resident: int) -> Tuple[Tuple[int, int], ...]:
    """The chunks ``_FrameGraph`` serves a [batch, C, h, w] frame in: runs
    [b0, b1) of whole streams, contiguous and covering the batch, as many
    as there can be while each holds at least one full wave of the served
    kernel's 16 x 16 tiles on its ``resident`` blocks (blocks an SM times
    SMs), their sizes differing by one at most. One chunk where the batch
    is one stream or under a wave. More chunks hide more of the upload: at
    8 x 512^2 on an H100 (132 SMs x 3 blocks, 2.6 waves a stream) a tick
    took 24.0-25.8 ms as one chunk, 21.9-22.2 as 2, 20.9-21.1 as 4 and
    20.5-20.6 as 8 (PERF.md §6), so a chunk needs no more than one wave."""
    tiles = math.ceil(h / SERVED_TILE) * math.ceil(w / SERVED_TILE)
    per = max(1, math.ceil(resident / tiles))  # streams a chunk needs
    k = max(1, batch // per)
    return tuple((i * batch // k, (i + 1) * batch // k) for i in range(k))


def takes_graph(device_type: str, compute_dtype: str, route: Optional[str], c: int,
                cc: int) -> bool:
    """Whether ``VideoStylizer.step_frame`` serves frames by replaying a
    CUDA graph: on a card, where every step launches
    ``nca_step_kernel_served``, that is the scales-(0,) route 'flat'
    (``fused_rollout_chw``'s ``nca_step``) in its chain form (``chain_form``:
    bf16 compute) at a (C, c_cond) the built library's ``served_widths``
    gives, as ``launch_step`` decides. Every other frame runs eagerly."""
    return (device_type == "cuda" and route == "flat"
            and fs.chain_form("nca_step", compute_dtype) and (c, cc) in fs.served_widths())


class VideoStylizer:
    """Streaming stylizer with persistent NCA state.

    For the ExtraChannels variant (``seed_channels < c_in``) the grayscale
    frame is appended as the last state channel and stripped after the
    rollout; for edge conditioning it feeds the edge map. The per-frame mask
    seed is the frame counter, as on the TPU fused path. ``compute_dtype``
    is the rollout kernel's matmul operand type ("bfloat16", the served
    setting, or "float32"). The stylizer holds its own copy of ``params``,
    taken at construction. Where ``takes_graph`` holds, those weights are
    packed once and each frame after the first at a (state, frame) shape
    replays the ``_FrameGraph`` of that shape; the state and RGB a frame
    returns are new tensors either way, never written by a later frame.
    """

    def __init__(
        self,
        params: dict,
        nca_cfg: NCAConfig,
        size,
        step_n: int = 24,
        generator: Optional[torch.Generator] = None,
        device=None,
        compute_dtype: str = "bfloat16",
    ):
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v).to(self.device, torch.float32, copy=True)
                       for k, v in params.items()}
        self.cfg = nca_cfg
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.step_n = step_n
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.compute_dtype = compute_dtype
        self._extra_channel = nca_cfg.n_seed_channels < nca_cfg.c_in
        self._frame_idx = 0
        self._kernel = select_rollout_kernel(nca_cfg, *self.size)
        cc = 0 if self._extra_channel or nca_cfg.conditioning is None else nca_cfg.c_cond
        self._cc = cc  # the conditioning channels the rollout kernel reads
        self._graphed = takes_graph(self.device.type, compute_dtype, self._kernel,
                                    nca_cfg.c_in, cc)
        self._packed = (fs.pack_weights(self.params, nca_cfg.c_in, cc, compute_dtype)
                        if self._graphed else None)
        self._shape: Optional[tuple] = None  # (state shape, frame shape) of the last frame
        self._graph: Optional[_FrameGraph] = None  # its graph, from its second frame on
        self.reset()

    def reset(self):
        """(Re)seed the persistent state."""
        self.state = dynca_seed(self.cfg, 1, self.size, generator=self.generator,
                                device=self.device)

    @property
    def state_nhwc(self) -> torch.Tensor:
        return self.state.permute(0, 2, 3, 1)

    def damage(self, x: int, y: int, radius: int):
        """Zero a circular patch of the persistent state (the brush tool of
        the browser runtime); the NCA regenerates it over later frames."""
        yy, xx = np.ogrid[: self.size[0], : self.size[1]]
        keep = ((xx - x) ** 2 + (yy - y) ** 2 > radius**2).astype(np.float32)
        self.state = self.state * torch.from_numpy(keep).to(self.device)

    @torch.no_grad()
    @spans.span("stylize.frame")
    def step_frame(self, frame) -> torch.Tensor:
        """Advance one content frame [1, H, W, 3] in [-1, 1] (array or
        tensor) → stylized RGB [1, H, W, 3] in [0, 1] on ``self.device``."""
        global FRAMES
        FRAMES += 1
        f = torch.as_tensor(frame, dtype=torch.float32)
        self._frame_idx += 1
        if self._graphed:
            shape = (tuple(self.state.shape), tuple(f.shape))
            if shape == self._shape:
                if self._graph is None:
                    with spans.span("stylize.capture"):
                        self._graph = _FrameGraph(self, *shape)
                return self._graph.serve(self, f)
            # a new shape: the last one's graph goes, and this frame runs
            # eagerly, which warms the launcher for the capture
            self._shape, self._graph = shape, None
        with spans.span("stylize.upload"):
            _count_upload(f, self.device)
            f = f.to(self.device)
        with spans.span("stylize.eager"):
            self.state, rgb = self._frame(f, self.state, self._rollout)
        return rgb

    def _rollout(self, h: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
        """The frame's ``step_n`` steps, eagerly, keyed by the frame counter."""
        if self._kernel is None:
            out, _ = dynca_rollout(self.params, h, self._frame_idx, self.cfg, self.step_n,
                                   cond, rollout_path="xla")
            return out
        return ROLLOUT_KERNELS[self._kernel](
            self.params, h, self._frame_idx, self.cfg, self.step_n, cond,
            compute_dtype=self.compute_dtype,
        )

    def _frame(self, f: torch.Tensor, state: torch.Tensor, rollout):
        """One frame's device work from the float32 frame ``f`` [B, H, W, 3]
        on the device: gray, the conditioning, ``rollout(h, cond)`` and the
        readout. Returns (the new state, the RGB)."""
        gray = f.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2).contiguous()
        cond = None
        if not self._extra_channel and self.cfg.conditioning is not None:
            cond = make_conditioning(self.cfg, self.size, cond_img=gray,
                                     batch=f.shape[0])
        h = state
        if self._extra_channel:
            h = torch.cat([h, gray], dim=1)
        out = rollout(h, cond)
        if self._extra_channel:
            out = out[:, : self.cfg.n_seed_channels].contiguous()
        rgb = out[:, : self.cfg.c_out].permute(0, 2, 3, 1) * 2.0
        return out, (rgb.clamp(-1.0, 1.0) + 1.0) / 2.0


def _count_upload(f: torch.Tensor, device: torch.device, hidden: bool = False) -> None:
    """Counts a copy of ``f`` to ``device`` in ``UPLOAD_BYTES`` where it is a
    host frame going to a card, and in ``HIDDEN_UPLOAD_BYTES`` too with
    ``hidden``."""
    global UPLOAD_BYTES, HIDDEN_UPLOAD_BYTES
    if f.device.type == "cpu" and device.type != "cpu":
        UPLOAD_BYTES += f.numel() * f.element_size()
        HIDDEN_UPLOAD_BYTES += hidden * f.numel() * f.element_size()


class _FrameGraph:
    """A stylizer's ``_frame`` for one (state shape, frame shape), captured
    as CUDA graphs on a stream of the stylizer's device, one for each chunk
    of ``chunk_plan``: chunk [b0, b1) reads ``frame[b0:b1]``,
    ``state[b0:b1]`` and ``seeds[k]`` (its mask seed, a word the served
    kernel reads: the frame's seed plus b0, so its masks are the whole
    batch's) and writes ``outs[k]`` and ``rgbs[k]``. The steps are
    ``launch_step``'s served launches, ping-ponging between two buffers of
    the chunk graph's own pool, with the weights the stylizer packed. The
    first chunk replays on the caller's stream, each other on a stream of
    its own (``side``), so a chunk's upload runs under the earlier chunks'
    rollouts and its rollout can fill their last wave of tiles."""

    def __init__(self, styl: VideoStylizer, state_shape: tuple, frame_shape: tuple):
        global GRAPH_CAPTURES
        dev = styl.device
        cfg = styl.cfg
        thr = fs.uniform_threshold(cfg.update_rate)
        # the served kernel's resident blocks: blocks an SM at the rollout's
        # widths (the state and, for extra_channels, the gray) times SMs
        blocks, _ = fs.step_occupancy(cfg.c_in, styl._cc, cfg.fc_dim, styl.compute_dtype,
                                      False, "chain")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.chunks = chunk_plan(state_shape[0], *state_shape[2:], blocks * sms)
        recorded = 0

        def rollout(seed):
            def run(x, cond):
                nonlocal recorded
                bufs = [torch.empty_like(x) for _ in range(min(styl.step_n, 2))]
                src = x
                for i in range(styl.step_n):
                    # launch_step launches on the device's current stream
                    recorded += (torch.cuda.current_stream(x.device) == self.stream
                                 and torch.cuda.is_current_stream_capturing())
                    fs.launch_step(src, bufs[i % 2], cond, styl._packed, cfg.padding_mode,
                                   styl.compute_dtype, 0, i, thr, chain=True, seed_ptr=seed)
                    src = bufs[i % 2]
                return src
            return run

        counted = dict(fs.KERNEL_LAUNCHES), fs.LAUNCHES, fs.LAUNCH_HOST_NS
        with torch.cuda.device(dev):
            self.frame = torch.empty(frame_shape, device=dev)
            self.state = torch.empty(state_shape, device=dev)
            self.seeds = torch.zeros(len(self.chunks), dtype=torch.int32, device=dev)
            self.stream = torch.cuda.Stream(dev)
            self.side = [torch.cuda.Stream(dev) for _ in self.chunks[1:]]
            self.graphs, self.outs, self.rgbs = [], [], []
            for k, (b0, b1) in enumerate(self.chunks):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(self.stream):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out, rgb = styl._frame(self.frame[b0:b1], self.state[b0:b1],
                                               rollout(self.seeds[k:k + 1]))
                    finally:
                        graph.capture_end()
                self.graphs.append(graph)
                self.outs.append(out)
                self.rgbs.append(rgb)
        # the capture ran nothing: its launches are counted at each replay,
        # which makes no launch call on the host
        self.kernel_launches = {k: n - counted[0][k] for k, n in fs.KERNEL_LAUNCHES.items()}
        self.launches = fs.LAUNCHES - counted[1]
        fs.KERNEL_LAUNCHES.update(counted[0])
        fs.LAUNCHES, fs.LAUNCH_HOST_NS = counted[1:]
        if recorded != self.launches:
            raise RuntimeError(f"the frame graphs recorded {recorded} of their "
                               f"{self.launches} launches")
        GRAPH_CAPTURES += 1

    def serve(self, styl: VideoStylizer, f: torch.Tensor) -> torch.Tensor:
        """Replay for the host or device frame ``f`` from ``styl.state`` with
        the mask seed of ``styl``'s frame counter; sets ``styl.state`` and
        returns the RGB, both new tensors. Chunk k copies its part of ``f``
        once chunks 0..k-1 are queued, so its host copy runs while they
        compute; the caller's stream waits for every chunk before the
        outputs are gathered."""
        global GRAPH_REPLAYS
        with torch.cuda.device(styl.device):
            main = torch.cuda.current_stream()
            for s in self.side:
                s.wait_stream(main)
            upload_ns = 0
            for k, (b0, b1) in enumerate(self.chunks):
                with torch.cuda.stream(self.side[k - 1] if k else main):
                    t0 = time.perf_counter_ns()
                    self.frame[b0:b1].copy_(f[b0:b1])
                    upload_ns += time.perf_counter_ns() - t0
                    _count_upload(f[b0:b1], styl.device, hidden=k > 0)
                    self.state[b0:b1].copy_(styl.state[b0:b1])
                    with spans.span("stylize.replay"):
                        seed = (styl._frame_idx + b0) & 0xFFFFFFFF  # the uint32 the kernel reads
                        self.seeds[k].fill_(seed - (1 << 32) if seed >= 1 << 31 else seed)
                        self.graphs[k].replay()
            spans.add("stylize.upload", upload_ns)
            for s in self.side:
                main.wait_stream(s)
            with spans.span("stylize.clone"):
                styl.state = torch.cat(self.outs)
                rgb = torch.cat(self.rgbs)
        fs.LAUNCHES += self.launches
        for k, n in self.kernel_launches.items():
            fs.KERNEL_LAUNCHES[k] += n
        GRAPH_REPLAYS += 1
        return rgb


def stylize_frames(
    params: dict,
    nca_cfg: NCAConfig,
    frames: Sequence[np.ndarray],
    step_n: int = 24,
    steps_per_frame: int = 1,
    size_factor: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
    compute_dtype: str = "bfloat16",
) -> Iterator[np.ndarray]:
    """Stylize a frame sequence [T, H, W, 3] in [-1, 1]; yields [H, W, 3]
    arrays in [0, 1]. ``steps_per_frame=k`` emits k output frames per input
    frame; ``size_factor`` rescales the frames bilinearly first."""
    h, w = frames[0].shape[0], frames[0].shape[1]
    size = (int(h * size_factor), int(w * size_factor))
    styl = VideoStylizer(params, nca_cfg, size, step_n, generator, device,
                         compute_dtype)
    for frame in frames:
        f = torch.as_tensor(frame, dtype=torch.float32).to(styl.device)[None]
        if size != (h, w):
            f = resize_bilinear(f.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
        for _ in range(steps_per_frame):
            yield styl.step_frame(f)[0].cpu().numpy()


def generate_control_frames(
    params: dict,
    nca_cfg: NCAConfig,
    style_image: np.ndarray,
    n_frames: int = 32,
    step_n: int = 24,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Control generations: stylize the style image itself and a black image
    as qualitative sanity checks. Returns (style_frames, black_frames)."""
    style_seq = np.repeat(style_image[None], n_frames, axis=0)
    black_seq = np.zeros_like(style_seq) - 1.0
    kw = dict(generator=generator, device=device)
    style_frames = list(stylize_frames(params, nca_cfg, style_seq, step_n, **kw))
    black_frames = list(stylize_frames(params, nca_cfg, black_seq, step_n, **kw))
    return style_frames, black_frames
