"""The port's encoder-conditioned NCA against the benchmark's plain PyTorch
reference (``portbench/reference/cnca.py``, ``cnca_trainer.py``) on the CPU
at tiny sizes, on seeded random weights: a step and a 6-step grow at fire
rate 0.5 with the hash masks (the eager route and the kernels' plain
versions), the ImageEncoder, the loss, one ``train_iteration``'s loss,
gradients and pool rows; the ``encode`` part of the trainer's ``mark``
hook; the reference's imports; and ``portbench/counts/cnca.py`` against
``torch.utils.flop_counter`` on the reference.

Tolerances: the reference is an independent float32 program (a grouped
convolution where the port sums 9 taps, einsum products in another order),
so values agree to a few float32 ulps of the largest element: 1e-5
relative for the step, grow, encoder and loss, 1e-4 for gradients (sums
over every pixel and step) and the parameters after two normalized Adam
updates (each element moves by about lr = 2e-3, set by sqrt(v) of a
normalized gradient).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import cnca as counts
from portbench.harness import inputs
from portbench.reference import cnca as ref
from portbench.reference.cnca_trainer import ReferenceEncTrainer
from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.data.dataset import ConditioningDataset
from vsnca_tpu_torch.models import conditioned_nca as cn
from vsnca_tpu_torch.ops.fused_step import batch_mask
from vsnca_tpu_torch.train import encoder_trainer as et

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)
MODEL = {"num_target_channels": 3, "num_hidden_channels": 16, "use_living_channel": True,
         "alpha_living_threshold": 0.1, "cell_fire_rate": 0.5, "update_hidden_dim": 64,
         "clamp_value": 10.0}
LOSS = {"overflow_weight": 1.0, "appearance_weight": 1.0, "appearance_loss_type": "OT",
        "content_weight": 0.1, "ot_subsample": 1000}


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _case(size=16, batch=2, seed=0):
    """Port parameters, a state grown around the seed pixel plus noise and
    goal images in [0, 1]."""
    cfg = ConditionedNCAConfig(image_size=size)
    params = cn.conditioned_nca_init(torch.Generator().manual_seed(seed), cfg, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    x = cn.conditioned_nca_seed(cfg, batch, device="cpu")
    x = x + 0.3 * torch.randn(x.shape, generator=g)
    goal_img = torch.rand((batch, 3, size, size), generator=g)
    return cfg, params, x, goal_img


def test_encoder_is_the_ports():
    cfg, params, _, img = _case(size=18, batch=3)
    want = cn.encode_goal(params, cfg, img)
    got = ref.encode(params, img, MODEL)
    assert got.shape == want.shape == (3, 20, 18, 18)
    assert torch.equal(got[:, :4], torch.zeros_like(got[:, :4]))
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_step_and_grow_are_the_ports(route):
    cfg, params, x, img = _case(size=16, batch=2)
    goal = cn.encode_goal(params, cfg, img)
    mask = batch_mask(7, 3, x.shape, cfg.cell_fire_rate, "cpu")
    want = cn.conditioned_nca_step(params, x, goal, mask, cfg)
    got = ref.step(params, x, goal, MODEL, 7, 3)
    assert _rel(got, want) <= 1e-5
    with torch.no_grad():
        want = cn.grow_from_encoding(params, x, goal, 11, cfg, 6, rollout_path=route)
    got = ref.grow(params, x, goal, MODEL, 11, 6)
    assert _rel(got, want) <= 1e-5
    # the fire mask drew both values, and some pixel died or was clamped
    assert 0.0 < float(mask.mean()) < 1.0


def test_loss_is_the_ports():
    g = torch.Generator().manual_seed(3)
    vgg = inputs.vgg16_weights(g, "cpu")
    style = torch.rand((1, 3, 64, 64), generator=g)
    state = 1.5 * torch.randn((2, 20, 64, 64), generator=g)
    goals = torch.rand((2, 3, 64, 64), generator=g)
    loss_fn = et.make_encoder_loss_fn(vgg, style, "OT", 1.0, 0.1, 1.0)
    want, _ = loss_fn(state, state[:, :3], goals, torch.Generator().manual_seed(5))
    got = ref.total_loss(LOSS, vgg, state, goals, ref.style_features(vgg, style),
                         torch.Generator().manual_seed(5))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def _trainers(size=32, batch=4, pool=6, seed=9):
    cfg = ConditionedNCAConfig(image_size=size)
    g = torch.Generator().manual_seed(seed)
    goals = torch.rand((5, 3, size, size), generator=g)
    style = torch.rand((1, 3, size, size), generator=g)
    vgg = inputs.vgg16_weights(g, "cpu")
    dataset = ConditioningDataset(goals.permute(0, 2, 3, 1).numpy(), "cpu")
    prog = et.ConditionedNCATrainer(cfg, dataset, style, vgg, lr=2e-3, pool_size=pool,
                                    content_weight=0.1, seed=seed, device="cpu")
    train = {"img_size": [size, size], "batch_size": batch, "pool_size": pool, "lr": 2e-3,
             "lr_decay_steps": [5000], "lr_decay_gamma": 0.3, "grad_norm_eps": 1e-10,
             "fresh_seeds": 2, "steps_per_batch": 2}
    params = {k: v.detach().clone() for k, v in prog.params.items()}
    reference = ReferenceEncTrainer(MODEL, LOSS, train, params, vgg, seed, style, goals, "cpu")
    return prog, reference


def test_train_iteration_is_the_references():
    prog, reference = _trainers()
    grads = {}

    def grab(into, params):
        def mark(name):
            if name == "optimizer" and not into:
                into.update({k: p.grad.clone() for k, p in params.items()})
        return mark

    ref_grads = {}
    for it, step_n in enumerate((6, 8)):
        loss, _ = prog.train_iteration(4, num_steps=step_n,
                                       mark=grab(grads, prog.params) if it == 0 else None)
        value = reference.iteration(step_n, grab(ref_grads, reference.params) if it == 0 else None)
        assert loss == pytest.approx(value, rel=1e-5)
        rows = reference.written_rows()
        assert _rel(prog.pool_states[torch.as_tensor(reference.last_idx)], rows) <= 1e-5
    assert set(grads) == set(ref_grads) and len(grads) == 9
    for k in grads:
        assert _rel(grads[k], ref_grads[k]) <= 1e-4, k
        assert float(ref_grads[k].abs().max()) > 0, k
    for k, p in prog.params.items():
        assert _rel(p.detach(), reference.params[k].detach()) <= 1e-4, k


def test_train_step_marks_encode_before_the_rollout():
    prog, _ = _trainers(size=32, batch=2, pool=3)
    names = []
    prog.train_iteration(2, num_steps=2, mark=names.append)
    one = ["encode", "rollout forward", "loss forward", "loss backward", "rollout backward",
           "optimizer", "end"]
    assert names == one + one


def test_reference_imports_no_jax_and_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import portbench.reference.cnca, portbench.reference.cnca_trainer\n"
            "import portbench.reference.cnca_train_check, portbench.reference.cnca_control\n"
            "import portbench.counts.cnca\n"
            "print(__import__('json').dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "vsnca_tpu", "vsnca_tpu_torch"}


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_counts_are_the_flop_counters():
    cfg, params, x, img = _case(size=8, batch=2)
    px = 2 * 8 * 8
    c, e, _ = counts.widths(MODEL)
    goal = cn.encode_goal(params, cfg, img)
    fwd = _flops(lambda: ref.step(params, x, goal, MODEL, 1, 0))
    # the counter sees the percept and the MLP; the gate (2 a channel) by hand
    assert counts.step_flops(MODEL, px) == fwd + px * 2 * c
    # the backward recomputes the step's products, then takes their VJPs: the
    # MLP's by the counter; the depthwise percept's three passes (recompute,
    # input and weight gradients) each cost its forward, which the counter
    # counts (it counts a grouped convolution's backward as if ungrouped)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    p = ref.perceive(x, params["perception_w"]).requires_grad_()
    mlp = _flops(lambda: ref.update(leaves, p).sum().backward())
    percept = _flops(lambda: ref.perceive(x, params["perception_w"]))
    assert counts.step_backward_flops(MODEL, px) == mlp + 3 * percept
    assert mlp == 3 * px * counts.mlp_flops(MODEL) and percept == px * 54 * c
    enc = _flops(lambda: ref.encode(params, img, MODEL))
    # the counter sees the blur and both convolutions; the gray and stencils by hand
    assert counts.encoder_flops(MODEL, px) == enc + px * (3 + 31)

    def enc_bwd():
        ref.encode(leaves, img, MODEL).sum().backward()
    assert counts.encoder_backward_flops(MODEL, px) == _flops(enc_bwd) - enc
    assert e == 16
