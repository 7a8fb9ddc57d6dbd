"""The operation counts against a count made another way at a tiny shape:
``torch.utils.flop_counter`` over the reference's convolutions and
products, plus the stencils and the update counted by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench_tiny import ROOT  # noqa: F401  (puts the repo on the path)


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("scales,cond", [((0,), "edges"), ((0,), None), ((0, 1), "pos_emb")])
def test_step_flops(scales, cond):
    from portbench.counts import nca as counts
    from portbench.reference import nca

    model = {"c_in": 4, "fc_dim": 8, "padding_mode": "circular", "conditioning": cond,
             "perception_scales": list(scales), "update_rate": 0.5}
    c, cc, p, f = counts.widths(model)
    params = {"w1": torch.randn(p, f), "b1": torch.randn(f), "w2": torch.randn(f, c),
              "b2": torch.randn(c)}
    x = torch.randn(2, c, 8, 8)
    cnd = torch.randn(2, cc, 8, 8) if cc else None
    products = _flops(lambda: nca.step(params, x, cnd, model, 1, 0))
    assert products == 2 * 2 * 64 * (p * f + f * c)
    extra = counts.STENCIL_FLOP + (counts.MS_PERCEPT_FLOP if scales == (0, 1) else 0)
    assert counts.step_flops(model, 128) == products + 128 * (extra * c + 2 * c)


@pytest.mark.parametrize("size,last", [(32, 1), (32, 19), (64, 25)])
def test_vgg16_flops(size, last):
    from portbench.counts.losses import vgg16_flops
    from portbench.harness.inputs import vgg16_weights
    from portbench.reference.losses import vgg16_features

    vgg = vgg16_weights(torch.Generator().manual_seed(0), "cpu")
    got = _flops(lambda: vgg16_features(vgg, torch.rand(1, 3, size, size), (last,)))
    assert vgg16_flops(size, size, last) == got


def test_msoe_flops():
    from portbench.counts.losses import msoe_flops
    from portbench.harness.inputs import msoe_weights
    from portbench.reference.losses import msoe_forward

    msoe = msoe_weights(torch.Generator().manual_seed(0), "cpu")
    got = _flops(lambda: msoe_forward(msoe, torch.rand(1, 2, 32, 32)))
    assert msoe_flops(32) == got


def test_peaks():
    from portbench.counts import peaks

    assert peaks.F32_ACCURATE_FLOPS == pytest.approx(165e12)
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
