"""The training losses in plain PyTorch: frozen plain versions of the loss
stack the DyNCA trainers use (VGG16 style and content features, the relaxed
optimal-transport style loss, the MSOE two-stream motion network, the
MotionOT video-motion loss, the vector-field motion loss on the 'circular'
field, the overflow regulariser), written as ordinary torch operations on
NCHW tensors. Nothing here imports the program; the benchmark hands these
functions the same weights and images it hands the program.

Randomness (the OT pixel subsample) is drawn from a CPU ``torch.Generator``
in the order the terms are evaluated: overflow, auxiliary, vector field,
appearance, video motion.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ----------------------------------------------------------------- VGG16

VGG16_POOL_AFTER = (False, True, False, True, False, False, True, False, False, True,
                    False, False, True)
STYLE_LAYERS = (1, 6, 11, 18, 25)
CONTENT_LAYER = 19
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg16_features(vgg, imgs01: torch.Tensor, layers) -> list:
    """Taps of torchvision's vgg16().features Sequential (conv k at index
    2k plus the pools, each followed by its ReLU), images in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, device=imgs01.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=imgs01.device)[:, None, None]
    x = (imgs01 - mean) / std
    feats, idx, last = [], 0, max(layers)
    for layer, pool in zip(vgg, VGG16_POOL_AFTER):
        stages = [lambda t, layer=layer: F.conv2d(t, layer["w"], layer["b"], padding=1),
                  torch.relu]
        if pool:
            stages.append(lambda t: F.max_pool2d(t, 2, 2))
        for stage in stages:
            x = stage(x)
            if idx in layers:
                feats.append(x)
            if idx >= last:
                return feats
            idx += 1
    return feats


# ----------------------------------------------------------- OT style loss

def _pixels(f: torch.Tensor) -> torch.Tensor:
    b, c, h, w = f.shape
    return f.reshape(b, c, h * w).transpose(1, 2)


def _remd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xn = torch.sqrt(torch.sum(x ** 2, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y ** 2, dim=-1, keepdim=True))
    d = 1.0 - (x @ y.transpose(-1, -2)) / (xn + 1e-10) / (yn.transpose(-1, -2) + 1e-10)
    return torch.maximum(d.min(dim=-1).values.mean(dim=-1),
                         d.min(dim=-2).values.mean(dim=-1))


def _moments(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    mx, my = x.mean(dim=-2, keepdim=True), y.mean(dim=-2, keepdim=True)
    xc, yc = x - mx, y - my
    cx = (xc.transpose(-1, -2) @ xc) / (x.shape[-2] - 1)
    cy = (yc.transpose(-1, -2) @ yc) / (y.shape[-2] - 1)
    return (mx - my).abs().mean(dim=(-2, -1)) + (cx - cy).abs().mean(dim=(-2, -1))


def ot_loss(gen_feats, tgt_feats, gen: torch.Generator, subsample: int = 1000) -> torch.Tensor:
    """Relaxed EMD plus moment matching, summed over layers, averaged over
    the batch; a layer taller than 32 with more than ``subsample`` pixels
    keeps ``subsample`` pixels drawn without replacement (the same for both)."""
    loss = 0.0
    for g, t in zip(gen_feats, tgt_feats):
        h, w = g.shape[-2:]
        gp, tp = _pixels(g), _pixels(t)
        if h > 32 and h * w > subsample:
            idx = torch.randperm(h * w, generator=gen)[:subsample].to(gp.device)
            gp, tp = gp[:, idx], tp[:, idx]
        if tp.shape[0] != gp.shape[0]:
            tp = tp.expand((gp.shape[0],) + tuple(tp.shape[1:]))
        loss = loss + (_remd(tp, gp) + _moments(tp, gp)).mean()
    return loss


# ------------------------------------------------------------------- MSOE

MSOE_LEVELS = 5


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    lo, span = -0.5, float(n)
    mod = np.fmod(idx - lo, 2 * span)
    mod = np.where(mod < 0, mod + 2 * span, mod)
    return (np.where(mod >= span, 2 * span - mod, mod) + lo).astype(np.int64)


def symmetric_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Half-sample symmetric padding (edge samples repeated) of H and W."""
    h, w = x.shape[-2:]
    yi = torch.from_numpy(_reflect_index(np.arange(-pad, h + pad), h)).to(x.device)
    xi = torch.from_numpy(_reflect_index(np.arange(-pad, w + pad), w)).to(x.device)
    return x.index_select(-2, yi).index_select(-1, xi)


def _gaussian_5x5(sigma: float = 2.0) -> np.ndarray:
    y, x = np.ogrid[-2:3, -2:3]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    k[k < np.finfo(k.dtype).eps * k.max()] = 0.0
    return (k / k.sum()).astype(np.float32)


def _upsample_matrix(h: int, scale: int) -> np.ndarray:
    """The TF-style bilinear upsample's sampling matrix: an (N - p)-point
    grid in [-1 + 1/h, 1 - 1/h], the last point repeated p = scale - 1
    times, taps outside the image dropped."""
    n = h * scale
    p = scale - 1
    xs = np.linspace(-1.0 + 1.0 / h, 1.0 - 1.0 / h, n - p)
    if p:
        xs = np.concatenate([xs, np.full(p, xs[-1])])
    g = (xs + 1.0) * h / 2.0 - 0.5
    lo = np.floor(g).astype(np.int64)
    fr = g - lo
    m = np.zeros((n, h), np.float32)
    for i in range(n):
        for tap, wt in ((lo[i], 1.0 - fr[i]), (lo[i] + 1, fr[i])):
            if 0 <= tap < h:
                m[i, tap] += wt
    return m


def _energy(msoe, pair: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(symmetric_pad(pair, 5), msoe["conv1_w"], msoe["conv1_b"])
    y = F.max_pool2d(y.square(), 5, 1, 2)
    y = F.conv2d(y, msoe["conv2_w"], msoe["conv2_b"])
    return y / torch.clamp(y.abs().sum(dim=1, keepdim=True), min=1e-12)


def msoe_forward(msoe, pair: torch.Tensor):
    """Frame pairs [B, 2, H, W] (grayscale in [0, 1]) -> (flow [B, 2, H, W],
    the 320-channel motion feature)."""
    dims = (1, 2, 3)
    n = pair[0].numel()
    mean = pair.mean(dim=dims, keepdim=True)
    var = ((pair - mean) ** 2).sum(dim=dims, keepdim=True) / (n - 1)
    level = (pair - mean) / torch.sqrt(var + 1e-12)
    k = torch.from_numpy(_gaussian_5x5()).to(pair.device)[None, None].repeat(2, 1, 1, 1)
    zs = []
    for lv in range(MSOE_LEVELS):
        if lv:
            level = F.conv2d(symmetric_pad(level, 2), k, stride=2, groups=2)
        e = _energy(msoe, level)
        if lv:
            a = torch.from_numpy(_upsample_matrix(e.shape[-1], 2 ** lv)).to(pair.device)
            e = torch.einsum("iu,bcuv,jv->bcij", a, e, a)
        zs.append(e)
    z = torch.cat(zs, dim=1)
    d = F.conv2d(symmetric_pad(z, 1), msoe["decode1_w"], msoe["decode1_b"])
    flow = F.conv2d(torch.relu(d), msoe["decode2_w"], msoe["decode2_b"])
    flow = flow * torch.tensor([1.0, -1.0], device=flow.device)[:, None, None]
    return flow, z


def resize(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def gray01(rgb_m11: torch.Tensor) -> torch.Tensor:
    x = (rgb_m11 + 1.0) / 2.0
    w = torch.tensor([0.2989, 0.587, 0.114], device=x.device)
    return (x * w[:, None, None]).sum(dim=1, keepdim=True)


def motion_pairs(frames, size) -> torch.Tensor:
    """Consecutive pairs of a list of RGB batches in [-1, 1], stacked on the
    batch: [(T - 1) * B, 2, h, w]."""
    g = [gray01(resize(f, size)) for f in frames]
    return torch.cat([torch.cat([a, b], dim=1) for a, b in zip(g, g[1:])], dim=0)


def motion_ot_loss(msoe, frames, target_feats, gen: torch.Generator, size,
                   subsample: int = 1000) -> torch.Tensor:
    """MotionOT summed over consecutive generated pairs, each against its
    target pair's motion feature ([320, h, w] a pair)."""
    b = frames[0].shape[0]
    _, z = msoe_forward(msoe, motion_pairs(frames, size))
    loss = 0.0
    for i in range(len(frames) - 1):
        fg = z[i * b:(i + 1) * b]
        h, w = fg.shape[-2:]
        gp, tp = _pixels(fg), _pixels(target_feats[i][None])
        if h > 32 and h * w > subsample:
            idx = torch.randperm(h * w, generator=gen)[:subsample].to(gp.device)
            gp, tp = gp[:, idx], tp[:, idx]
        tp = tp.expand((b,) + tuple(tp.shape[1:]))
        loss = loss + (_remd(tp, gp) + _moments(tp, gp)).mean()
    return loss


def target_motion_features(msoe, video: torch.Tensor, size) -> torch.Tensor:
    """The motion feature of every consecutive pair of a video [T, 3, H, W]
    in [-1, 1]: [T - 1, 320, h, w]."""
    with torch.no_grad():
        out = [msoe_forward(msoe, motion_pairs([video[t:t + 1], video[t + 1:t + 2]], size))[1][0]
               for t in range(video.shape[0] - 1)]
    return torch.stack(out)


def circular_field(h: int, w: int) -> torch.Tensor:
    """The 'circular' target field [1, 2, H, W] of the vector-field loss:
    (4 i / r_max, -4 j / r_max) at offsets (i, j) from the centre, zero at
    the centre and outside the half-open ranges, scaled to mean strength 1."""
    cx, cy = h // 2, w // 2
    i = np.broadcast_to((np.arange(h) - cx)[:, None], (h, w)).astype(np.float64)
    j = np.broadcast_to((np.arange(w) - cy)[None, :], (h, w)).astype(np.float64)
    keep = ((np.arange(h) - cx)[:, None] < cx) & ((np.arange(w) - cy)[None, :] < cy)
    keep = keep & (np.sqrt(i ** 2 + j ** 2) != 0)
    rmax = (cx ** 2 + cy ** 2) ** 0.5
    vec = np.zeros((h, w, 2))
    vec[..., 0] = np.where(keep, 4.0 * i / rmax, 0.0)
    vec[..., 1] = np.where(keep, -4.0 * j / rmax, 0.0)
    vec = vec / np.mean(np.sqrt(vec[..., 0] ** 2 + vec[..., 1] ** 2))
    return torch.from_numpy(np.ascontiguousarray(vec.transpose(2, 0, 1)[None]).astype(np.float32))


def vector_field_loss(msoe, before, after, field, step_n, base_steps, size,
                      strength_w, direction_w) -> torch.Tensor:
    flow, _ = msoe_forward(msoe, motion_pairs([before, after], size))
    field = field.to(flow.device)
    num = torch.sum(flow * field, dim=1)
    den = torch.linalg.vector_norm(flow, dim=1) * torch.linalg.vector_norm(field, dim=1)
    cos = num / torch.clamp_min(den, 1e-8)
    loss = 0.0
    if strength_w > 0:
        strength = torch.linalg.vector_norm(flow, dim=1) * (base_steps / step_n)
        sl = torch.abs(strength - torch.linalg.vector_norm(field, dim=1))
        gate = (1.0 - torch.clamp(1.0 - cos.mean(dim=(1, 2), keepdim=True), 0.0, 1.0)).detach()
        loss = loss + strength_w * torch.mean(sl * gate)
    if direction_w > 0:
        loss = loss + direction_w * (1.0 - torch.mean(cos))
    return loss


def overflow_loss(state: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(state - torch.clamp(state, -1.0, 1.0)))


def content_loss(vgg, gen01: torch.Tensor, tgt01: torch.Tensor) -> torch.Tensor:
    g = vgg16_features(vgg, gen01, (CONTENT_LAYER,))[0]
    with torch.no_grad():
        t = vgg16_features(vgg, tgt01, (CONTENT_LAYER,))[0]
    return torch.mean((g - t) ** 2)


def style_features(vgg, style_m11: torch.Tensor, size) -> list:
    with torch.no_grad():
        return vgg16_features(vgg, resize((style_m11 + 1.0) / 2.0, size), STYLE_LAYERS)


def total_loss(loss_cfg: dict, vgg, msoe, terms: dict, gen: torch.Generator,
               field=None) -> torch.Tensor:
    """The weighted objective of a configuration's loss group, in the
    program's order of terms. ``terms``: ``state`` (final), ``frames`` (the
    RGB frames in [-1, 1], one or the taps), ``style_feats``, ``aux``
    (content in [-1, 1]), ``before``/``after`` RGB, ``step_n``,
    ``motion_feats`` ([T - 1, 320, h, w] of the target window)."""
    c = loss_cfg
    total = 0.0
    if c.get("overflow_weight", 0):
        total = total + c["overflow_weight"] * overflow_loss(terms["state"])
    if c.get("auxiliary_weight", 0):
        gen01 = (terms["frames"][0] + 1.0) / 2.0
        aux01 = resize((terms["aux"] + 1.0) / 2.0, gen01.shape[-2:])
        total = total + c["auxiliary_weight"] * content_loss(vgg, gen01, aux01)
    if c.get("vector_field_motion_weight", 0):
        total = total + c["vector_field_motion_weight"] * vector_field_loss(
            msoe, terms["before"], terms["after"], field, terms["step_n"],
            c["nca_base_num_steps"], c["motion_img_size"], c["motion_strength_weight"],
            c["motion_direction_weight"])
    if c.get("appearance_weight", 0):
        frames = terms["frames"]
        gen_f = vgg16_features(vgg, (torch.cat(frames, dim=0) + 1.0) / 2.0, STYLE_LAYERS)
        rep = gen_f[0].shape[0] // terms["style_feats"][0].shape[0]
        tgt_f = [t.repeat((rep, 1, 1, 1)) for t in terms["style_feats"]]
        total = total + c["appearance_weight"] * ot_loss(gen_f, tgt_f, gen,
                                                         c.get("ot_subsample", 1000))
    if c.get("video_motion_weight", 0):
        total = total + c["video_motion_weight"] * motion_ot_loss(
            msoe, terms["frames"], terms["motion_feats"], gen, c["motion_img_size"],
            c.get("ot_subsample", 1000))
    return total

