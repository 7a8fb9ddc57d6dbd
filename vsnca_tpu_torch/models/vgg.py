"""VGG16 feature extractor on NCHW tensors — the port's copy of
``vsnca_tpu/models/vgg.py``.

Layer indexing follows torchvision's ``vgg16().features`` Sequential, so the
reference's tap constants carry over: style taps [1, 6, 11, 18, 25]
(post-ReLU of convN_1), content tap 19 (conv4_2 before its ReLU). The
convolutions are ``torch.nn.functional.conv2d`` (the JAX package's are plain
``lax.conv``, not Pallas kernels) with weights OIHW.

Weights: ``vgg16_from_npz`` reads the converted ``weights/vgg16.npz`` the
JAX package reads (HWIO ``w{i}``, ``b{i}``). Without it ``load_vgg16`` falls
back to a He-normal init drawn from ``torch.Generator().manual_seed(16)``:
the distribution of the JAX fallback (``vgg16_random_init``, PRNGKey(16)),
not its numbers. ``convert.vgg_from_jax`` carries the JAX arrays across
where the two packages must see the same weights.

Max-pool ties: the 2x2/2 pools go through ``ops.conv.max_pool_2d``, whose
equality-mask VJP splits a tie's gradient evenly over the tied maxima, as
the JAX package's custom VJP does (``ops/conv.py:193-234``). Ties are real
here: a flat image region, or the dead cells of a ConditionedNCA, gives
equal activations in a window.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.ops.conv import max_pool_2d

# (out_channels, pool_after) per conv, torchvision vgg16 "D" configuration.
VGG16_CONVS: Tuple[Tuple[int, bool], ...] = (
    (64, False), (64, True),
    (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, True),
)

# torchvision Sequential index of each conv (for layer-tap bookkeeping).
VGG16_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

STYLE_LAYERS = (1, 6, 11, 18, 25)  # relu1_1, relu2_1, relu3_1, relu4_1, relu5_1
CONTENT_LAYER = 19  # conv4_2 pre-ReLU

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

DEFAULT_VGG_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "weights",
                                "vgg16.npz")


def vgg16_random_init(generator: torch.Generator, device=None) -> List[dict]:
    """He-normal (std = sqrt(2 / fan_in)) weights and zero biases, drawn on
    the CPU from ``generator`` — variance-preserving through conv + ReLU, so
    every tap stays O(1) without pretrained weights."""
    dev = resolve_device(device)
    params = []
    c_in = 3
    for c_out, _ in VGG16_CONVS:
        std = math.sqrt(2.0 / (c_in * 9))
        w = std * torch.randn((c_out, c_in, 3, 3), generator=generator)
        params.append({"w": w.to(dev), "b": torch.zeros(c_out, device=dev)})
        c_in = c_out
    return params


def vgg16_from_npz(path: str, device=None) -> List[dict]:
    """Weights from a converted npz: ``w{i}`` HWIO → OIHW, ``b{i}``."""
    from vsnca_tpu_torch.convert import vgg_from_jax

    data = np.load(path)
    return vgg_from_jax(
        [{"w": data[f"w{i}"], "b": data[f"b{i}"]} for i in range(len(VGG16_CONVS))],
        device,
    )


def load_vgg16(path: Optional[str] = None, device=None) -> Tuple[List[dict], bool]:
    """(params, pretrained): the npz at ``path`` (or ``weights/vgg16.npz``
    of the checkout) when it exists, else the seed-16 He-normal fallback."""
    p = path or DEFAULT_VGG_PATH
    if os.path.exists(p):
        return vgg16_from_npz(p, device), True
    return vgg16_random_init(torch.Generator().manual_seed(16), device), False


def vgg16_features(
    params: List[dict],
    imgs: torch.Tensor,
    layers: Sequence[int] = STYLE_LAYERS,
    include_image_as_feat: bool = False,
) -> List[torch.Tensor]:
    """Run VGG16 up to max(layers) and collect the taps.

    imgs: [B, 3, H, W] in [0, 1], ImageNet-normalized here. Tap index 2k is
    conv k's output, 2k+1 its ReLU, pools take their own indices. Returns
    NCHW feature maps.
    """
    n_pools_needed = sum(
        1
        for conv_i, (_, pool) in enumerate(VGG16_CONVS)
        if pool and VGG16_CONV_INDICES[conv_i] < max(layers)
    )
    if min(imgs.shape[-2:]) >> n_pools_needed == 0:
        raise ValueError(
            f"input {tuple(imgs.shape[-2:])} too small for VGG tap {max(layers)} "
            f"({n_pools_needed} pools)"
        )
    mean = torch.as_tensor(IMAGENET_MEAN, device=imgs.device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=imgs.device)[:, None, None]
    x = (imgs - mean) / std

    feats: List[torch.Tensor] = []
    if include_image_as_feat:
        feats.append(x)
    max_layer = max(layers)
    idx = 0  # torchvision Sequential index
    for conv_i, (_, pool_after) in enumerate(VGG16_CONVS):
        stages = [lambda x: F.conv2d(x, params[conv_i]["w"], params[conv_i]["b"],
                                     padding=1), torch.relu]
        if pool_after:
            stages.append(lambda x: max_pool_2d(x, 2, 2))
        for stage in stages:
            x = stage(x)
            if idx in layers:
                feats.append(x)
            if idx >= max_layer:
                return feats
            idx += 1
    return feats


def vgg16_style_features(params: List[dict], imgs: torch.Tensor,
                         include_image_as_feat: bool = False) -> List[torch.Tensor]:
    return vgg16_features(params, imgs, STYLE_LAYERS, include_image_as_feat)


def vgg16_content_features(params: List[dict], imgs: torch.Tensor) -> torch.Tensor:
    return vgg16_features(params, imgs, (CONTENT_LAYER,))[0]
