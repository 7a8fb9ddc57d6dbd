"""Inputs and weights, made from the run's seed on the device in a few large
calls. The same seed gives the same inputs; both the program and the
reference are handed what is made here.

Content is synthetic video: a sum of moving oriented gratings, colour-mixed,
and moving discs with hard edges, through ``tanh`` into [-1, 1]. Every
stream, frame and image of a run is drawn from the same sizes and speeds,
so seeds differ only in which textures they draw, not in the work they ask.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seeds(seed: int, n: int):
    """``n`` independent 32-bit seeds derived from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def videos(g: torch.Generator, n_videos: int, n_frames: int, size: int, spec: dict,
           device) -> torch.Tensor:
    """[n_frames, n_videos, size, size, 3] float32 frames in [-1, 1]."""
    k, d = spec["gratings"], spec["discs"]
    nv = n_videos
    amp = _uniform(g, (nv, k), 0.4, 1.0, device)
    lam = _uniform(g, (nv, k), *spec["wavelength_px"], device)
    ang = _uniform(g, (nv, k), 0.0, math.pi, device)
    spd = _uniform(g, (nv, k), *spec["speed_px"], device)
    spd = spd * torch.where(torch.rand((nv, k), generator=g, device=device) < 0.5, -1.0, 1.0)
    phase = _uniform(g, (nv, k), 0.0, 2 * math.pi, device)
    colour = _uniform(g, (nv, k, 3), -1.0, 1.0, device)
    rad = _uniform(g, (nv, d), *spec["radius_px"], device)
    pos = _uniform(g, (nv, d, 2), 0.0, float(size), device)
    vang = _uniform(g, (nv, d), 0.0, 2 * math.pi, device)
    vmag = _uniform(g, (nv, d), *spec["disc_speed_px"], device)
    dcol = _uniform(g, (nv, d, 3), -1.5, 1.5, device)

    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    out = torch.empty((n_frames, nv, size, size, 3), device=device)
    for t in range(n_frames):
        # [nv, k, H, W] phases of every grating
        proj = (xx[None, None] * torch.cos(ang)[..., None, None]
                + yy[None, None] * torch.sin(ang)[..., None, None])
        arg = 2 * math.pi * (proj - spd[..., None, None] * t) / lam[..., None, None]
        wave = amp[..., None, None] * torch.sin(arg + phase[..., None, None])
        img = torch.einsum("vkhw,vkc->vhwc", wave, colour)
        centre = pos + t * torch.stack([torch.cos(vang), torch.sin(vang)], -1) * vmag[..., None]
        centre = torch.remainder(centre, float(size))
        dy = yy[None, None] - centre[..., 1, None, None]
        dx = xx[None, None] - centre[..., 0, None, None]
        # wrap-around distance, so discs leave one edge and enter the other
        dy = torch.remainder(dy + size / 2, float(size)) - size / 2
        dx = torch.remainder(dx + size / 2, float(size)) - size / 2
        inside = ((dy * dy + dx * dx) < (rad * rad)[..., None, None]).float()
        img = img + torch.einsum("vdhw,vdc->vhwc", inside, dcol)
        out[t] = torch.tanh(img)
    return out


def dynca_weights(g: torch.Generator, model: dict, device) -> dict:
    """The published DyNCA initialisation: w1 Xavier normal gain 0.2, b1
    uniform +-1/sqrt(P), w2 Xavier normal gain 0.1, b2 zero."""
    c = model["c_in"]
    cc = {"edges": 3, "pos_emb": 2}.get(model.get("conditioning"), 0)
    p, f = 4 * c + cc, model["fc_dim"]
    std1 = 0.2 * math.sqrt(2.0 / (p + f))
    std2 = 0.1 * math.sqrt(2.0 / (f + c))
    return {
        "w1": std1 * torch.randn((p, f), generator=g, device=device),
        "b1": (torch.rand(f, generator=g, device=device) * 2 - 1) / math.sqrt(p),
        "w2": std2 * torch.randn((f, c), generator=g, device=device),
        "b2": torch.zeros(c, device=device),
    }


def served_weights(g: torch.Generator, model: dict, spec: dict, device) -> dict:
    """The stand-in for a trained served model (see the configuration's
    ``assumed``): the published initialisation, then 2C hidden units turned
    into a leak x -> x - leak * x on each channel (a relu pair), the other
    units' state rows scaled by ``state_gain``, conditioning rows by
    ``cond_gain`` and second layer by ``w2_gain``. It keeps the state
    bounded over thousands of frames, as training keeps a trained one."""
    w = dynca_weights(g, model, device)
    c = model["c_in"]
    w1, b1, w2 = w["w1"], w["b1"], w["w2"] * spec["w2_gain"]
    w1[: 4 * c] *= spec["state_gain"]
    w1[4 * c:] *= spec["cond_gain"]
    w1[:, : 2 * c] = 0.0
    b1[: 2 * c] = 0.0
    w2[: 2 * c] = 0.0
    idx = torch.arange(c, device=device)
    w1[idx, 2 * idx] = 1.0
    w1[idx, 2 * idx + 1] = -1.0
    w2[2 * idx, idx] = -spec["leak"]
    w2[2 * idx + 1, idx] = spec["leak"]
    return {"w1": w1.contiguous(), "b1": b1.contiguous(), "w2": w2.contiguous(),
            "b2": w["b2"]}


VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


def vgg16_weights(g: torch.Generator, device) -> list:
    """He-normal OIHW convolutions and zero biases, torchvision's "D"."""
    out, c_in = [], 3
    for c_out in VGG16_CHANNELS:
        std = math.sqrt(2.0 / (c_in * 9))
        out.append({"w": std * torch.randn((c_out, c_in, 3, 3), generator=g, device=device),
                    "b": torch.zeros(c_out, device=device)})
        c_in = c_out
    return out


MSOE_SHAPES = {
    "conv1_w": ((32, 2, 11, 11), 242), "conv1_b": ((32,), 242),
    "conv2_w": ((64, 32, 1, 1), 32), "conv2_b": ((64,), 32),
    "decode1_w": ((64, 320, 3, 3), 2880), "decode1_b": ((64,), 2880),
    "decode2_w": ((2, 64, 1, 1), 64), "decode2_b": ((2,), 64),
}


def msoe_weights(g: torch.Generator, device) -> dict:
    """Uniform in +-1/sqrt(fan_in), torch's default bounds."""
    return {name: (torch.rand(shape, generator=g, device=device) * 2 - 1) / math.sqrt(fan)
            for name, (shape, fan) in MSOE_SHAPES.items()}
