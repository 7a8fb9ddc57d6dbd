"""The reference against the port's plain path on the CPU at tiny sizes: the
same function, written independently (the reference imports nothing of the
port; these tests import both)."""

import numpy as np
import pytest
import torch

from portbench_tiny import SERVE_CELLS, TRAIN_CELLS, correct, run_tiny, tiny_cell


def _cfg(model):
    from vsnca_tpu_torch.config import NCAConfig

    return NCAConfig(**{**model, "perception_scales": tuple(model["perception_scales"])})


def test_masks_are_the_ports():
    from portbench.reference import nca
    from vsnca_tpu_torch.ops.fused_step import batch_mask

    for seed, step in ((0, 0), (2 ** 31 + 3, 17), (123456789, 143)):
        want = batch_mask(seed, step, (3, 1, 9, 13), 0.5, "cpu")
        assert torch.equal(nca.update_mask(seed, step, 3, 9, 13, 0.5, "cpu"), want)


@pytest.mark.parametrize("operand", [None, torch.bfloat16])
def test_served_rollout_is_the_ports(operand):
    from portbench.harness import inputs
    from portbench.reference import nca
    from vsnca_tpu_torch.models.dynca import make_conditioning
    from vsnca_tpu_torch.ops.fused_step import fused_rollout_chw

    cell = tiny_cell("edge_stream_256")
    model = cell.config["nca"]
    g = torch.Generator().manual_seed(3)
    params = inputs.served_weights(g, model, cell.config["serve_weights"], "cpu")
    x = torch.rand((2, 12, 18, 20), generator=g) - 0.5
    gray = torch.rand((2, 1, 18, 20), generator=g)
    cond_port = make_conditioning(_cfg(model), (18, 20), cond_img=gray, batch=2)
    cond_ref = nca.edge_map(gray)
    assert torch.equal(cond_port, cond_ref)
    dtype = "bfloat16" if operand is not None else "float32"
    want = fused_rollout_chw(params, x, 7, _cfg(model), 24, cond_port, compute_dtype=dtype)
    got = nca.rollout(params, x, cond_ref, model, 7, 24, operand=operand)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_multiscale_step_and_grid_are_the_ports():
    from portbench.harness import inputs
    from portbench.reference import nca
    from vsnca_tpu_torch.models.dynca import dynca_step, make_conditioning
    from vsnca_tpu_torch.ops.fused_step import batch_mask

    model = tiny_cell("vm_train_256").config["nca"]
    g = torch.Generator().manual_seed(4)
    params = inputs.dynca_weights(g, model, "cpu")
    x = torch.rand((2, 16, 16, 16), generator=g) - 0.5
    cond = make_conditioning(_cfg(model), (16, 16), batch=2, device="cpu")
    assert torch.equal(cond, nca.positional_grid(2, 16, 16, "cpu"))
    want = dynca_step(params, x, batch_mask(5, 3, x.shape, 0.5, "cpu"), _cfg(model), cond)
    got = nca.step(params, x, cond, model, 5, 3)
    assert float((got - want).abs().max()) <= 1e-5


def test_loss_networks_are_the_ports():
    from portbench.harness import inputs
    from portbench.reference import losses
    from vsnca_tpu_torch.losses.appearance import ot_style_loss
    from vsnca_tpu_torch.losses.vector_field import get_motion_vector_field_by_name
    from vsnca_tpu_torch.models.msoe import msoe_forward
    from vsnca_tpu_torch.models.vgg import vgg16_features

    g = torch.Generator().manual_seed(5)
    vgg = inputs.vgg16_weights(g, "cpu")
    msoe = inputs.msoe_weights(g, "cpu")
    img = torch.rand((2, 3, 64, 64), generator=g)
    mine = losses.vgg16_features(vgg, img, losses.STYLE_LAYERS)
    port = vgg16_features(vgg, img, losses.STYLE_LAYERS)
    for a, b in zip(mine, port):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    other = losses.vgg16_features(vgg, torch.rand((2, 3, 64, 64), generator=g),
                                  losses.STYLE_LAYERS)
    a = losses.ot_loss(mine, other, torch.Generator().manual_seed(9), 100)
    b = ot_style_loss(port, other, torch.Generator().manual_seed(9), 100)
    assert float(a) == pytest.approx(float(b), rel=1e-5)
    pair = torch.rand((2, 2, 32, 32), generator=g)
    flow, z = losses.msoe_forward(msoe, pair)
    pflow, pz = msoe_forward(msoe, pair, return_features=True)
    assert torch.allclose(flow, pflow, rtol=1e-4, atol=1e-5)
    assert torch.allclose(z, pz[0], rtol=1e-4, atol=1e-5)
    assert torch.equal(losses.circular_field(32, 32),
                       get_motion_vector_field_by_name("circular", (32, 32)))


@pytest.mark.parametrize("name", SERVE_CELLS + TRAIN_CELLS)
def test_sound_run_is_correct(name):
    _, e2e, checks, attempted, failed = run_tiny(tiny_cell(name))
    assert attempted > 0 and failed == 0
    assert correct(checks), checks
    assert all(np.isfinite(v) for v in e2e.values())
