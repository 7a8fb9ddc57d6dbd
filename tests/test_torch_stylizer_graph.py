"""``VideoStylizer.step_frame``'s CUDA graph path: where it engages
(``takes_graph``), that the CPU never takes it, and, on the card, that a
replayed frame gives the eager frame's bits, keeps the value semantics of
the states and RGBs a caller holds, captures once a shape and counts its
launches.

The card tests (marked ``cuda``) skip without a card. This file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs on its own:

    python -m pytest --noconftest -q tests/test_torch_stylizer_graph.py
"""

import itertools

import numpy as np
import pytest
import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.infer import stylize
from vsnca_tpu_torch.infer.stylize import VideoStylizer, takes_graph
from vsnca_tpu_torch.models import dynca
from vsnca_tpu_torch.ops import fused_step as fs

WIDTHS = [(12, 3), (12, 2), (13, 0), (12, 0), (13, 3), (16, 2), (6, 3), (5, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the served kernel has no CPU mode")
    return torch.device("cuda")


def _frames(n, b, size, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("device,compute_dtype,route", list(itertools.product(
    ["cpu", "cuda"], ["float32", "bfloat16"], ["flat", "stream_flat", "roll", None])))
def test_takes_graph_truth_table(monkeypatch, device, compute_dtype, route):
    """A graph exactly where every step is the served kernel: a card, the
    scales-(0,) route's chain form (bf16 compute) and a width the library
    serves ('stream_flat' launches the same kernel, but no config reaches
    it: ``select_rollout_kernel`` takes 'flat' first). The widths are the
    library's, whatever they are: a table stands in for it here."""
    SERVED = {(12, 3), (5, 1)}
    monkeypatch.setattr(fs, "served_widths", lambda: tuple(SERVED))
    for c, cc in WIDTHS:
        want = (device == "cuda" and compute_dtype == "bfloat16" and route == "flat"
                and (c, cc) in SERVED)
        assert takes_graph(device, compute_dtype, route, c, cc) == want, (c, cc)
        if route == "flat":  # the form the route launches is nca_step
            chain = fs.chain_form(fs.rollout_form(NCAConfig(c_in=c)), compute_dtype)
            assert want == (device == "cuda" and chain and (c, cc) in SERVED)


def _eager_frame(params, cfg, state, frame, idx, step_n, compute_dtype, extra):
    """The parent's ``step_frame`` body on the CPU: gray, the edge map, the
    plain rollout and the readout."""
    f = torch.as_tensor(frame, dtype=torch.float32)
    gray = f.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2).contiguous()
    cond = None
    if not extra and cfg.conditioning is not None:
        cond = dynca.make_conditioning(cfg, state.shape[-2:], cond_img=gray, batch=f.shape[0])
    h = torch.cat([state, gray], dim=1) if extra else state
    out = fs.fused_rollout_chw_reference(params, h, idx, cfg, step_n, cond,
                                         compute_dtype=compute_dtype)
    if extra:
        out = out[:, : cfg.n_seed_channels].contiguous()
    rgb = out[:, : cfg.c_out].permute(0, 2, 3, 1) * 2.0
    return out, (rgb.clamp(-1.0, 1.0) + 1.0) / 2.0


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kw", [
    dict(c_in=12, fc_dim=24, conditioning="edges", padding_mode="circular"),
    dict(c_in=13, seed_channels=12, fc_dim=24, padding_mode="zeros"),
    dict(c_in=8, fc_dim=16, conditioning="pos_emb", perception_scales=(0, 1)),
], ids=["edges", "extra_channel", "multiscale"])
def test_cpu_frames_count_and_take_no_graph(kw, compute_dtype):
    """On the CPU ``step_frame`` counts every frame, captures and replays
    nothing, and gives the eager body's bits."""
    cfg = NCAConfig(**kw)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = VideoStylizer(params, cfg, 16, step_n=3, device="cpu", compute_dtype=compute_dtype)
    state = st.state.clone()
    counts = stylize.FRAMES, stylize.GRAPH_CAPTURES, stylize.GRAPH_REPLAYS
    for i, frame in enumerate(_frames(3, 1, 16)):
        rgb = st.step_frame(frame)
        state, want = _eager_frame(params, cfg, state, frame, i + 1, 3, compute_dtype,
                                   cfg.n_seed_channels < cfg.c_in)
        assert torch.equal(rgb, want) and torch.equal(st.state, state)
    assert (stylize.FRAMES, stylize.GRAPH_CAPTURES, stylize.GRAPH_REPLAYS) == (
        counts[0] + 3, counts[1], counts[2])
    assert not st._graphed and st._graph is None


def test_the_stylizer_holds_its_own_weights():
    """The weights are taken at construction: a later in-place change to
    the caller's tensors reaches neither path."""
    cfg = NCAConfig(c_in=12, fc_dim=24, conditioning="edges")
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = VideoStylizer(params, cfg, 16, step_n=2, device="cpu")
    want = {k: v.clone() for k, v in params.items()}
    params["w1"].add_(1.0)
    for k, v in st.params.items():
        assert torch.equal(v, want[k]) and v.data_ptr() != params[k].data_ptr(), k


@pytest.mark.parametrize("batch,h,w,resident,want", [
    (1, 512, 512, 396, 1),  # one stream: always one chunk
    (1, 4096, 4096, 396, 1),
    (4, 64, 64, 396, 1),  # 16 tiles a stream: the batch is under a wave
    (8, 512, 512, 132 * 3, 8),  # the served cell on an H100: a stream a chunk
    (3, 512, 512, 396, None), (8, 256, 256, 396, None), (7, 300, 200, 264, None),
    (16, 128, 96, 396, None), (5, 17, 33, 1, None),
], ids=lambda v: str(v))
def test_chunk_plan_is_whole_contiguous_streams(batch, h, w, resident, want):
    """The plan is whole streams, in order, covering the batch, each chunk
    at least a wave of 16 x 16 tiles unless the batch is one chunk, as many
    chunks as that allows, sizes within one of each other."""
    plan = stylize.chunk_plan(batch, h, w, resident)
    assert plan[0][0] == 0 and plan[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    sizes = [b1 - b0 for b0, b1 in plan]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    tiles = -(-h // 16) * -(-w // 16)
    need = resident
    if len(plan) > 1:
        assert min(sizes) * tiles >= need
    # one more chunk would leave one under the waves
    assert (batch // (len(plan) + 1)) * tiles < need or batch // (len(plan) + 1) == 0
    if want is not None:
        assert len(plan) == want


@pytest.mark.parametrize("seed,b0", [(0, 3), (7, 1), (2**31 - 2, 5), (2**32 - 3, 6),
                                     (2**32 - 1, 1), (123456789, 4)])
def test_a_chunk_seed_draws_the_batch_masks(seed, b0):
    """Batch b0 + b under ``seed`` draws the masks of batch b under the
    chunk's seed word ``seed + b0`` (mod 2^32, as the kernel's uint32 sum
    wraps), at every step: what a chunk's seed word relies on."""
    word = (seed + b0) & 0xFFFFFFFF
    for b in range(3):
        for step in (0, 1, 23):
            assert torch.equal(fs.mask_bits(seed, b0 + b, step, 6, 10),
                               fs.mask_bits(word, b, step, 6, 10)), (b, step)
            assert torch.equal(fs.update_mask(seed, b0 + b, step, 6, 10, 0.5),
                               fs.update_mask(word, b, step, 6, 10, 0.5)), (b, step)


# ---------------------------------------------------------------- on the card


def _pair(cfg, size, device, batch):
    """Two stylizers of the same weights and seed: one on the graph path,
    one held to the eager path."""
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params["w2"] = params["w2"] * 0.2  # random weights: states stay within ±5 over 30 frames
    graph = VideoStylizer(params, cfg, size, device=device)
    eager = VideoStylizer(params, cfg, size, device=device)
    assert graph._graphed
    eager._graphed = False
    for st in (graph, eager):
        st.state = st.state.repeat(batch, 1, 1, 1)
        st._frame_idx = 2**31 - 12  # the mask seed crosses 2^31 (an int32's sign) at frame 12
    return graph, eager


@pytest.mark.cuda
@pytest.mark.parametrize("batch,size", [pytest.param(1, 64, id="1"), pytest.param(4, 64, id="4"),
                                        pytest.param(8, 512, id="8-512")])
@pytest.mark.parametrize("pad_mode", ["zeros", "circular"])
def test_graph_frames_are_the_eager_frames_bits(cuda, pad_mode, batch, size):
    """Replayed frames give the eager frames' bits over 30 frames (the mask
    seed crossing 2^31, a reset, damage, a scaled state). At 64^2 a frame
    is one graph of 24 launches; at 8 x 512^2 the frame is served in
    chunks, each chunk's upload issued while the chunks before it are
    queued, and the bits stay the whole batch's."""
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode=pad_mode, conditioning="edges")
    graph, eager = _pair(cfg, size, cuda, batch)
    counts = stylize.GRAPH_CAPTURES, stylize.GRAPH_REPLAYS
    held = []
    for k, frame in enumerate(_frames(30, batch, size, seed=batch)):
        if k == 10:
            for st in (graph, eager):
                st.reset()
                st.state = st.state.repeat(batch, 1, 1, 1)
        if k == 15:
            for st in (graph, eager):
                st.damage(20, 30, 9)
        if k == 20:
            for st in (graph, eager):
                st.state = st.state * 0.5
        launches, chain = fs.LAUNCHES, fs.KERNEL_LAUNCHES["nca_step_chain"]
        uploaded, hidden = stylize.UPLOAD_BYTES, stylize.HIDDEN_UPLOAD_BYTES
        rgb = graph.step_frame(frame)
        assert stylize.UPLOAD_BYTES - uploaded == frame.nbytes
        if k > 0:  # replayed
            chunks = graph._graph.chunks
            assert (len(chunks) == 1) == (size == 64), chunks
            assert fs.LAUNCHES - launches == 24 * len(chunks)
            assert fs.KERNEL_LAUNCHES["nca_step_chain"] - chain == 24 * len(chunks)
            first = chunks[0][1] - chunks[0][0]
            assert stylize.HIDDEN_UPLOAD_BYTES - hidden == frame.nbytes * (batch - first) // batch
        else:
            assert stylize.HIDDEN_UPLOAD_BYTES == hidden
        want = eager.step_frame(frame)
        assert torch.equal(rgb, want), k
        assert torch.equal(graph.state, eager.state), k
        held.append((graph.state, rgb, graph.state.clone(), rgb.clone()))
    assert torch.isfinite(graph.state).all()
    for state, rgb, state0, rgb0 in held:  # never written by a later frame
        assert torch.equal(state, state0) and torch.equal(rgb, rgb0)
    assert stylize.GRAPH_CAPTURES - counts[0] == 1
    assert stylize.GRAPH_REPLAYS - counts[1] == 29
    assert graph._graph is not None and eager._graph is None
    assert _index(graph._graph.stream.device) == _index(graph.device)
    assert all(_index(s.device) == _index(graph.device) for s in graph._graph.side)


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


@pytest.mark.cuda
def test_graph_per_shape_and_extra_channel(cuda):
    """The extra_channels width (c13, no conditioning) replays too; a new
    state shape captures anew, and the stylizer keeps the last shape's graph
    only: back at the first shape, one eager frame, then a new capture."""
    cfg = NCAConfig(c_in=13, seed_channels=12, fc_dim=96, padding_mode="circular")
    graph, eager = _pair(cfg, 48, cuda, 1)
    captures, replays = stylize.GRAPH_CAPTURES, stylize.GRAPH_REPLAYS
    for k, frame in enumerate(_frames(18, 1, 48, seed=7)):
        if k in (6, 12):
            for st in (graph, eager):
                st.state = st.state.repeat(2, 1, 1, 1) if k == 6 else st.state[:1].clone()
        f = np.repeat(frame, graph.state.shape[0], axis=0)
        assert torch.equal(graph.step_frame(f), eager.step_frame(f)), k
        assert torch.equal(graph.state, eager.state), k
        assert graph._graph is None if k % 6 == 0 else graph._graph.frame.shape == f.shape
    assert stylize.GRAPH_CAPTURES - captures == 3
    assert stylize.GRAPH_REPLAYS - replays == 15


@pytest.mark.cuda
def test_graph_on_the_last_card_while_the_first_is_current(cuda):
    """A stylizer on the last card (another card than the current one where
    there are two or more) captures on a stream of its own card, and its
    replays give the eager frames' bits."""
    dev = torch.device(f"cuda:{torch.cuda.device_count() - 1}")
    cfg = NCAConfig(c_in=12, fc_dim=96, padding_mode="circular", conditioning="edges")
    with torch.cuda.device(0):
        graph, eager = _pair(cfg, 64, dev, 2)
        for k, frame in enumerate(_frames(6, 2, 64, seed=3)):
            rgb = graph.step_frame(frame)
            assert torch.equal(rgb, eager.step_frame(frame)), k
            assert torch.equal(graph.state, eager.state), k
            assert rgb.device == dev and torch.cuda.current_device() == 0
    assert _index(graph._graph.stream.device) == dev.index
    assert all(out.device == dev for out in graph._graph.outs)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,compute_dtype", [
    (dict(c_in=12, fc_dim=96, conditioning="edges", padding_mode="circular"), "float32"),
    (dict(c_in=16, fc_dim=128, conditioning="pos_emb", padding_mode="circular",
          perception_scales=(0, 1)), "bfloat16"),
], ids=["float32_compute", "video_motion_roll"])
def test_no_graph_off_the_served_kernel(cuda, kw, compute_dtype):
    cfg = NCAConfig(**kw)
    params = dynca.dynca_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = VideoStylizer(params, cfg, 32, device=cuda, compute_dtype=compute_dtype)
    counts = stylize.GRAPH_CAPTURES, stylize.GRAPH_REPLAYS
    launches = fs.LAUNCHES
    for frame in _frames(3, 1, 32):
        st.step_frame(frame)
    assert fs.LAUNCHES - launches == 3 * 24
    assert (stylize.GRAPH_CAPTURES, stylize.GRAPH_REPLAYS) == counts
    assert not st._graphed and st._graph is None


@pytest.mark.cuda
def test_served_launch_after_a_smaller_fc_dim(cuda):
    """The served kernel's shared-memory attribute is the kernel's, not a
    launch's: fc_dim 96 still launches after fc_dim 32 at the same widths,
    and every launch gives the plain step's bits."""
    g = torch.Generator().manual_seed(2)
    x = (torch.rand((1, 12, 40, 40), generator=g) - 0.5).to(cuda)
    cond = (torch.rand((1, 3, 40, 40), generator=g) - 0.5).to(cuda)
    thr = fs.uniform_threshold(0.5)
    for fc in (96, 32, 96):
        cfg = NCAConfig(c_in=12, fc_dim=fc, padding_mode="circular", conditioning="edges")
        params = dynca.dynca_init(torch.Generator().manual_seed(fc), cfg, device=cuda)
        packed = fs.pack_weights(params, 12, 3, "bfloat16")
        out = torch.full_like(x, float("nan"))
        fs.launch_step(x, out, cond, packed, "circular", "bfloat16", 7, 3, thr, chain=True)
        want = fs.reference_step(x, cond, packed, "circular", "bfloat16", 7, 3, 0.5)
        assert torch.equal(out, want), fc


@pytest.mark.cuda
def test_served_widths_and_device_seed_match_the_library(cuda):
    """A seed in device memory launches at exactly the widths
    ``served_widths`` reads from the library (the presets' among them), and
    draws the seed argument's masks (past 2^31 too)."""
    SERVED = set(fs.served_widths())
    assert {(12, 3), (12, 2), (13, 0)} <= SERVED
    g = torch.Generator().manual_seed(0)
    word = torch.zeros(1, dtype=torch.int32, device=cuda)
    thr = fs.uniform_threshold(0.5)
    for c, cc in itertools.product(range(1, 17), range(0, 5)):
        x = torch.rand((2, c, 19, 21), generator=g).to(cuda) - 0.5
        cond = torch.rand((2, cc, 19, 21), generator=g).to(cuda) if cc else None
        packed = tuple(t.to(cuda) for t in (torch.randn(4 * c + cc, 32, generator=g) * 0.2,
                                            torch.randn(32, generator=g) * 0.1,
                                            torch.randn(32, c, generator=g) * 0.2,
                                            torch.randn(c, generator=g) * 0.1))
        by_value, by_word = torch.empty_like(x), torch.empty_like(x)
        if (c, cc) not in SERVED:
            with pytest.raises(RuntimeError, match="CUDA error"):
                fs.launch_step(x, by_word, cond, packed, "circular", "bfloat16", 0, 3, thr,
                               chain=True, seed_ptr=word)
            continue
        for seed in (5, 2**31 + 77):
            word.fill_(seed - 2**32 if seed >= 2**31 else seed)
            fs.launch_step(x, by_value, cond, packed, "circular", "bfloat16", seed, 3, thr,
                           chain=True)
            fs.launch_step(x, by_word, cond, packed, "circular", "bfloat16", 0, 3, thr,
                           chain=True, seed_ptr=word)
            assert torch.equal(by_value, by_word), (c, cc, seed)
    with pytest.raises(ValueError, match="served bf16 step only"):
        fs.launch_step(x, by_word, cond, packed, "circular", "float32", 0, 3, thr,
                       chain=True, seed_ptr=word)
