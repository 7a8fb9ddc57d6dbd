"""Operations and bytes of the DyNCA cell's algorithm at a cell's shapes.

These count the work the model's equations need, whatever kernel runs them,
so a later fused or re-tiled kernel is held to the same work. They restate
the arithmetic of the port's bring-up smoke (its ``step_bound_ms``,
``train_bound_ms``, ``ms_bound_ms`` and ``STENCIL_FLOP``):

- the three 3x3 stencils cost ``STENCIL_FLOP`` = 31 operations a pixel and
  channel (Sobel x and y 4 products and 5 sums each, the Laplacian 5 and 8);
- perception scale 1 adds ``MS_PERCEPT_FLOP`` a pixel and channel (the 2x2
  mean, the half-resolution stencils, the two-tap upsample of the four
  percept blocks and the average of the scales);
- the MLP is 2 (P F + F C) a pixel (a multiply and an add a weight);
- the masked residual update is 2 C a pixel;
- the backward of a step (the vector-Jacobian product through the MLP, with
  respect to its input and its weights: 4 (P F + F C), and the stencil
  adjoint: 2 x 25 = 50 a pixel and channel at scale 0, ``MS_ADJ_FLOP`` with
  scale 1).

Bytes count each input read once and each output written once, as float32,
over the whole call: a served frame's 24 steps read the state, the
conditioning and the weights once and write the state once; a step of the
training backward reads its saved state, its conditioning and the incoming
cotangent and writes the outgoing one.
"""

from __future__ import annotations

STENCIL_FLOP = 9 + 9 + 13
MS_PERCEPT_FLOP = (4 + 42) / 4 + 4 * 11
MS_ADJ_FLOP = (56 + 50) / 4 + 50 + 3
ADJ_FLOP = 2 * 25


def c_cond(model: dict) -> int:
    return {"edges": 3, "pos_emb": 2}.get(model.get("conditioning"), 0)


def widths(model: dict):
    """(C, cc, P, F) of a model configuration."""
    c, cc = model["c_in"], c_cond(model)
    return c, cc, 4 * c + cc, model["fc_dim"]


def multiscale(model: dict) -> bool:
    return tuple(model["perception_scales"]) == (0, 1)


def weight_count(model: dict) -> int:
    c, _, p, f = widths(model)
    return p * f + f + f * c + c


def step_flops(model: dict, pixels: int) -> float:
    """One forward step over ``pixels`` pixels (batch x H x W)."""
    c, _, p, f = widths(model)
    percept = (STENCIL_FLOP + (MS_PERCEPT_FLOP if multiscale(model) else 0)) * c
    return float(pixels) * (percept + 2 * (p * f + f * c) + 2 * c)


def step_backward_flops(model: dict, pixels: int) -> float:
    """The backward of one step over ``pixels`` pixels."""
    c, _, p, f = widths(model)
    adj = MS_ADJ_FLOP if multiscale(model) else ADJ_FLOP
    return float(pixels) * (4 * (p * f + f * c) + adj * c)


def rollout_bytes(model: dict, pixels: int) -> float:
    """A rollout call: state in and out, conditioning and weights once."""
    c, cc, _, _ = widths(model)
    return float((2 * c + cc) * pixels * 4 + weight_count(model) * 4)


def step_backward_bytes(model: dict, pixels: int) -> float:
    """One step of the backward: saved state, conditioning and the incoming
    cotangent read, the outgoing cotangent written."""
    c, cc, _, _ = widths(model)
    return float((3 * c + cc) * pixels * 4)


def edge_map_flops(pixels: int) -> float:
    """The content's grayscale (3 a pixel) and its three stencils."""
    return float(pixels) * (3 + STENCIL_FLOP)


def bound_seconds(flops: float, n_bytes: float, peak_flops: float,
                  bytes_per_s: float) -> float:
    """The least time: the larger of the operations over the peak and the
    bytes over the memory rate."""
    return max(flops / peak_flops, n_bytes / bytes_per_s)
