"""Host milliseconds a graph-served frame spends on its replay: the
program's span ``stylize.replay`` (``utils/spans.py``: the mask seed's fill
and ``CUDAGraph.replay``), its host nanoseconds over its calls, over the
whole process. None where the program has no such span or served no frame
by a replay. Layer: the stylizer."""

import sys


def read(run):
    spans = sys.modules.get("vsnca_tpu_torch.utils.spans")
    calls = getattr(spans, "CALLS", {}).get("stylize.replay")
    if run.kind != "serve" or not calls:
        return None
    return spans.HOST_NS["stylize.replay"] / calls / 1e6
