"""The model operations of the window's iterations (``harness/train.py``'s
count: the NCA forward and backward at the steps drawn, VGG16 and MSOE on
the images the losses feed them, a pass with a gradient twice its forward)
over the window's seconds times the float32-accurate peak, in %. Layer: the
whole iteration."""

from portbench.counts import peaks


def read(run):
    if run.kind != "train" or run.window_s <= 0 or not run.iteration_flops:
        return None
    return 100.0 * sum(run.iteration_flops) / (run.window_s * peaks.F32_ACCURATE_FLOPS)
