"""Operations and bytes of the encoder-conditioned NCA's algorithm at a
cell's shapes (``reference.cnca``), whatever kernel runs them, restating the
port's bring-up smoke (its ``cnca_bound_ms``). Per pixel, with P = 3C
perception rows and an MLP of D hidden units:

- a forward step: the learnable depthwise percept, 27 taps a channel at 2
  operations each (``PERCEPT_FLOP`` = 54 a channel), the MLP's three
  products, 2 (P D + D D + D C), and the life gate and clamp, 2 a channel;
- its backward: the MLP recomputed, its three transposed products and its
  three weight-gradient products (3 x the MLP), the percept recomputed and
  its weight gradient (2 x 54 a channel), and the depthwise adjoint into the
  state and goal cotangents (54 a channel);
- the ImageEncoder's forward: the grayscale (3), its three stencils
  (``nca.STENCIL_FLOP``), a 5 x 5 blur of 3 channels, the 3 x 3
  convolutions 6 -> E and E -> E; its backward: the second convolution's
  input and weight gradients and the first's weight gradient.

Bytes count each input read once and each output written once, as float32
(the life mask a byte): a forward step's update reads the state and the goal
encoding and writes the updated state, its gate reads the updated alpha and
both states and writes the state and the life mask; a backward step reads
the saved state, the goal encoding, the life mask and the incoming
cotangent, writes the percept cotangent, then reads it back with the alpha
and writes the state and goal cotangents; the weights once a launch (twice
in the backward's MLP launch: read, and their gradients written).
"""

from __future__ import annotations

from portbench.counts import losses, nca

PERCEPT_FLOP = 2 * 27


def widths(model: dict):
    """(C, E, D) of a configuration's ``nca`` group."""
    e = model["num_hidden_channels"]
    return model["num_target_channels"] + e + 1, e, model["update_hidden_dim"]


def mlp_flops(model: dict) -> int:
    c, _, d = widths(model)
    return 2 * (3 * c * d + d * d + d * c)


def weight_bytes(model: dict) -> int:
    c, _, d = widths(model)
    return 4 * (27 * c + 3 * c * d + d + d * d + d + d * c)


def step_flops(model: dict, pixels: int) -> float:
    """One forward step (update and gate) over ``pixels`` (batch x H x W)."""
    c, _, _ = widths(model)
    return float(pixels) * (mlp_flops(model) + PERCEPT_FLOP * c + 2 * c)


def step_backward_flops(model: dict, pixels: int) -> float:
    c, _, _ = widths(model)
    return float(pixels) * (3 * mlp_flops(model) + 3 * PERCEPT_FLOP * c)


def step_bytes(model: dict, pixels: int) -> float:
    c, _, _ = widths(model)
    update = 3 * c * pixels * 4 + weight_bytes(model)
    gate = (1 + 2 * c) * pixels * 4 + pixels
    return float(update + gate)


def step_backward_bytes(model: dict, pixels: int) -> float:
    c, _, _ = widths(model)
    mlp = 8 * c * pixels * 4 + pixels + 2 * weight_bytes(model)
    adjoint = (7 * c + 1) * pixels * 4
    return float(mlp + adjoint)


def encoder_flops(model: dict, pixels: int) -> float:
    _, e, _ = widths(model)
    return float(pixels) * (3 + nca.STENCIL_FLOP + 2 * 25 * 3 + 2 * 9 * 6 * e + 2 * 9 * e * e)


def encoder_backward_flops(model: dict, pixels: int) -> float:
    _, e, _ = widths(model)
    return float(pixels) * (2 * 2 * 9 * e * e + 2 * 9 * 6 * e)


def train_step_flops(model: dict, loss: dict, batch: int, h: int, w: int,
                     step_n: int) -> float:
    """One train step: encode, grow ``step_n`` steps and back, the losses
    (VGG16 on the grown RGB with a gradient, to relu5_1 for the appearance
    and to conv4_2 for the content, and the goals' content features
    without)."""
    px = batch * h * w
    flops = step_n * (step_flops(model, px) + step_backward_flops(model, px))
    flops += encoder_flops(model, px) + encoder_backward_flops(model, px)
    if loss.get("appearance_weight"):
        flops += 2 * batch * losses.vgg16_flops(h, w, losses.STYLE_LAST)
    if loss.get("content_weight"):
        flops += 3 * batch * losses.vgg16_flops(h, w, losses.CONTENT_LAST)
    return float(flops)


def iteration_flops(model: dict, loss: dict, train: dict, step_n: int) -> float:
    """One iteration: ``steps_per_batch`` train steps of ``step_n`` steps."""
    h, w = train["img_size"]
    return train["steps_per_batch"] * train_step_flops(model, loss, train["batch_size"], h, w,
                                                       step_n)
