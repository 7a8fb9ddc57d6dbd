"""The encoder-conditioned NCA in plain PyTorch: the benchmark's reference
for the goal-guided model (Sudhakaran, Najarro and Risi, 2022, "Goal-Guided
Neural Cellular Automata"), as smehra34/Video-Stylization-with-NCA's
``EncoderConditioning/`` runs it (``nca.py:29-209``, ``encoder.py:5-64``,
``loss/``). Written from that description, not from the port.

The state x [B, C, H, W] holds C = 3 RGB + 1 alive + E hidden channels (the
alive channel right after the RGB). One step:

- ``pre = maxpool3x3(x[alive]) > threshold``;
- ``p = depthwise3x3(x + g * pre)``: a learnable perception, 3 filters a
  channel (``perception_w`` [C, 3, 3, 3], rows c*3 + s), zero padding;
- ``dx = W3^T relu(W2^T relu(W1^T p + b1) + b2)``: 1x1 layers 3C -> D -> D
  -> C, no bias on the last (``update1.w`` [3C, D] input-major, ...);
- ``x' = x + m * dx``, m the fire mask;
- ``x'' = clamp(x' * (pre & maxpool3x3(x'[alive]) > threshold), +-clamp)``.

The goal encoding g is the ImageEncoder of the goal image [B, 3, H, W] in
[0, 1]: the Sobel x, Sobel y and Laplacian of its channel mean and a 5x5
sigma-1 Gaussian blur of each channel (fixed, zero padding), then a 3x3
convolution 6 -> E with a ReLU and a 3x3 convolution E -> E without bias
(``encoder.embed1.w`` [E, 6, 3, 3] OIHW, ``encoder.embed1.b``,
``encoder.embed2.w``), in the last E channels with zeros before them.

The loss of a grown state: overflow (mean |x - clamp(x, -1, 1)|), the OT
appearance loss of the raw RGB channels' VGG16 features against the style
image's, and the MSE of the content layer's features against the goal
image's, each times its weight.

Departures from the reference repository, all of them the system's own
definition:

- the fire mask is the murmur3 hash of (seed, batch index, step, pixel)
  (``reference.nca.update_mask``) in place of ``torch.rand``;
- the Laplacian is the edge map's (``reference.nca.edge_map``: 1 2 1 /
  2 -12 2 / 1 2 1), the front end the edge-conditioned model shares;
- the OT subsample is drawn from the trainer's generator
  (``reference.losses.ot_loss``).

Products run in float32: the callers set TF32 off (``cnca_trainer``), or on
for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import losses, nca


def widths(model: dict):
    """(C, alive channel, E, D) of a configuration's ``nca`` group."""
    t, e = model["num_target_channels"], model["num_hidden_channels"]
    return t + e + 1, t, e, model["update_hidden_dim"]


def alive(x: torch.Tensor, model: dict) -> torch.Tensor:
    """maxpool3x3 of the alive channel above the threshold: bool [B, 1, H, W]."""
    _, a, _, _ = widths(model)
    pooled = F.max_pool2d(x[:, a:a + 1].detach(), 3, 1, 1)
    return pooled > model["alpha_living_threshold"]


def perceive(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    return F.conv2d(x, w.reshape(3 * c, 1, 3, 3), padding=1, groups=c)


def update(params: dict, p: torch.Tensor) -> torch.Tensor:
    h = torch.relu(torch.einsum("bkhw,kd->bdhw", p, params["update1.w"])
                   + params["update1.b"][:, None, None])
    h = torch.relu(torch.einsum("bdhw,de->behw", h, params["update2.w"])
                   + params["update2.b"][:, None, None])
    return torch.einsum("behw,ec->bchw", h, params["update3.w"])


def step(params: dict, x: torch.Tensor, goal: torch.Tensor, model: dict, seed: int,
         step_index: int) -> torch.Tensor:
    """One step of index ``step_index`` of a grow keyed by ``seed``."""
    pre = alive(x, model)
    dx = update(params, perceive(x + goal * pre.to(x.dtype), params["perception_w"]))
    b, _, h, w = x.shape
    m = nca.update_mask(seed, step_index, b, h, w, model["cell_fire_rate"], x.device)
    x = x + m * dx
    life = (pre & alive(x, model)).to(x.dtype)
    return torch.clamp(x * life, -model["clamp_value"], model["clamp_value"])


def grow(params: dict, x: torch.Tensor, goal: torch.Tensor, model: dict, seed: int,
         n_steps: int) -> torch.Tensor:
    for i in range(n_steps):
        x = step(params, x, goal, model, seed, i)
    return x


def seed_states(model: dict, n: int, h: int, w: int, device) -> torch.Tensor:
    """Zero states with the alive and hidden channels 1 at the centre pixel."""
    c, a, _, _ = widths(model)
    x = torch.zeros((n, c, h, w), device=device)
    x[:, a:, h // 2, w // 2] = 1.0
    return x


def gaussian_5x5(sigma: float = 1.0) -> torch.Tensor:
    k = torch.tensor([[math.exp(-(i * i + j * j) / (2.0 * sigma * sigma))
                       for j in range(-2, 3)] for i in range(-2, 3)])
    return k / k.sum()


def encode(params: dict, img01: torch.Tensor, model: dict) -> torch.Tensor:
    """The goal encoding [B, C, H, W] of goal images [B, 3, H, W] in [0, 1]."""
    c, _, e, _ = widths(model)
    edges = nca.edge_map(img01.mean(dim=1, keepdim=True))
    k = gaussian_5x5().to(img01.device)[None, None].repeat(3, 1, 1, 1)
    blurred = F.conv2d(img01, k, padding=2, groups=3)
    feats = torch.cat([edges, blurred], dim=1)
    h = torch.relu(F.conv2d(feats, params["encoder.embed1.w"], params["encoder.embed1.b"],
                            padding=1))
    emb = F.conv2d(h, params["encoder.embed2.w"], padding=1)
    return torch.cat([torch.zeros_like(emb[:, :1]).expand(-1, c - e, -1, -1), emb], dim=1)


def style_features(vgg, style01: torch.Tensor) -> list:
    with torch.no_grad():
        return losses.vgg16_features(vgg, style01, losses.STYLE_LAYERS)


def total_loss(loss_cfg: dict, vgg, state: torch.Tensor, goal01: torch.Tensor,
               style_feats: list, gen: torch.Generator) -> torch.Tensor:
    """Overflow + appearance + content of a grown state, in that order (the
    OT subsample drawn from ``gen``); the RGB is the state's first three
    channels as they are, the goal images the content targets."""
    rgb = state[:, :3]
    total = loss_cfg["overflow_weight"] * losses.overflow_loss(state)
    if loss_cfg["appearance_weight"]:
        feats = losses.vgg16_features(vgg, rgb, losses.STYLE_LAYERS)
        tiled = [f.repeat((rgb.shape[0], 1, 1, 1)) for f in style_feats]
        total = total + loss_cfg["appearance_weight"] * losses.ot_loss(
            feats, tiled, gen, loss_cfg["ot_subsample"])
    if loss_cfg["content_weight"]:
        total = total + loss_cfg["content_weight"] * losses.content_loss(vgg, rgb, goal01)
    return total
