"""Frames the stylizer served by replaying a CUDA graph, over its
``step_frame`` calls, in %: ``infer/stylize.py``'s ``GRAPH_REPLAYS`` over
``FRAMES``, counted over the whole process (warm-up, traced stretch and
window; a stylizer's first frame at each shape runs eagerly). None where the
program has no such counters. Layer: the stylizer."""

import sys


def read(run):
    stylize = sys.modules.get("vsnca_tpu_torch.infer.stylize")
    frames = getattr(stylize, "FRAMES", None)
    replays = getattr(stylize, "GRAPH_REPLAYS", None)
    if run.kind != "serve" or not frames or replays is None:
        return None
    return 100.0 * replays / frames
