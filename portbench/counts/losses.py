"""Operations of the loss networks at a cell's shapes: VGG16's convolutions
(torchvision's configuration "D") and the MSOE motion network's
convolutions and pyramid upsamples. Each is counted as 2 operations a
multiply-add; pooling, activations and normalisations are not counted.

Both networks are frozen, so their backward computes the input's gradient
only, which costs what the forward costs: a pass with a gradient counts
twice its forward.
"""

from __future__ import annotations

# (out channels, pool after) of each conv; the torchvision Sequential index
# of each conv's output
VGG16_CONVS = ((64, False), (64, True), (128, False), (128, True), (256, False),
               (256, False), (256, True), (512, False), (512, False), (512, True),
               (512, False), (512, False), (512, True))
VGG16_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
STYLE_LAST = 25  # relu5_1
CONTENT_LAST = 19  # conv4_2


def vgg16_flops(h: int, w: int, last_layer: int) -> float:
    """One image's forward up to torchvision index ``last_layer``."""
    flops, c_in = 0.0, 3
    for (c_out, pool), idx in zip(VGG16_CONVS, VGG16_CONV_INDEX):
        if idx > last_layer:
            break
        flops += 2.0 * 9 * c_in * c_out * h * w
        c_in = c_out
        if pool:
            h, w = h // 2, w // 2
    return flops


MSOE_LEVELS = 5


def msoe_flops(size: int) -> float:
    """One frame pair's forward at ``size`` x ``size``: per pyramid level
    the 11 x 11 x 2 -> 32 energy conv, the 1 x 1 32 -> 64 conv and (below
    the top) the 5 x 5 depthwise blur of both frames at stride 2 and the
    separable upsample of the 64 channels back to full size; then the
    3 x 3 320 -> 64 and 1 x 1 64 -> 2 decoder."""
    flops, s = 0.0, size
    for level in range(MSOE_LEVELS):
        flops += 2.0 * s * s * (121 * 2 * 32 + 32 * 64)
        if level:
            flops += 2.0 * 64 * (size * s * s + size * size * s)
        if level < MSOE_LEVELS - 1:
            flops += 2.0 * 25 * 2 * (s // 2) ** 2
        s //= 2
    flops += 2.0 * size * size * (9 * 320 * 64 + 64 * 2)
    return flops
