"""ImageEncoder: the per-pixel goal embedding of the encoder-conditioned NCA
— the port's copy of ``vsnca_tpu/models/encoder.py`` on NCHW tensors.

A fixed front end (Sobel-x, Sobel-y and Laplacian of the grayscale image
through the port's ``edge_extract``, and a 5x5 sigma-1 Gaussian blur of each
input channel) feeds two learnable 3x3 convolutions, the first with a ReLU.
The convolutions are ``F.conv2d`` (the JAX package's are XLA convolutions,
not Pallas kernels), with weights OIHW and TF32 off, so a float32 encoder on
the card rounds as float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsnca_tpu_torch.ops.conv import torch_conv_init
from vsnca_tpu_torch.ops.filters import gaussian_kernel_2d
from vsnca_tpu_torch.ops.perception import edge_extract


def image_encoder_init(generator: torch.Generator, embedding_dim: int = 16,
                       channels: int = 3) -> dict:
    """{"embed1.w": [E, channels + 3, 3, 3], "embed1.b": [E], "embed2.w":
    [E, E, 3, 3]} from torch's default conv init, drawn from ``generator``
    on the CPU (the JAX package's nested {"embed1": {"w", "b"}, ...}, flat)."""
    e1 = torch_conv_init(generator, 3, 3, channels + 3, embedding_dim)
    e2 = torch_conv_init(generator, 3, 3, embedding_dim, embedding_dim, bias=False)
    return {"embed1.w": e1["w"], "embed1.b": e1["b"], "embed2.w": e2["w"]}


def image_encoder_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, channels, H, W] → [B, E, H, W] with ``params`` as
    ``image_encoder_init`` makes them. The features are concatenated
    as (sobel_x, sobel_y, laplacian, blurred channels), all fixed filters
    with zero padding, as encoder.py:51 of the reference."""
    torch.backends.cudnn.allow_tf32 = False
    channels = x.shape[1]
    gray = x.mean(dim=1, keepdim=True)
    edges = edge_extract(gray, "none")
    gk = torch.from_numpy(gaussian_kernel_2d(5, 1.0)).to(x.device, x.dtype)
    blurred = F.conv2d(x, gk[None, None].repeat(channels, 1, 1, 1), padding=2,
                       groups=channels)
    feats = torch.cat([edges, blurred], dim=1)
    h = torch.relu(F.conv2d(feats, params["embed1.w"], params["embed1.b"], padding=1))
    return F.conv2d(h, params["embed2.w"], padding=1)
