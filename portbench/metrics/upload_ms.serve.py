"""Host milliseconds a stylized frame spends handing its content frame to
the device: the program's span ``stylize.upload`` (``utils/spans.py``), its
host nanoseconds over its calls, over the whole process (warm-up, traced
stretch and window). None where the program has no such span. Layer: the
stylizer."""

import sys


def read(run):
    spans = sys.modules.get("vsnca_tpu_torch.utils.spans")
    calls = getattr(spans, "CALLS", {}).get("stylize.upload")
    if run.kind != "serve" or not calls:
        return None
    return spans.HOST_NS["stylize.upload"] / calls / 1e6
