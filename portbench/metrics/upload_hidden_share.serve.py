"""The host frame bytes the stylizer copied to the card while an earlier
chunk of the same frame was already queued there, over all the host frame
bytes it copied, in %: ``infer/stylize.py``'s ``HIDDEN_UPLOAD_BYTES`` over
``UPLOAD_BYTES``, counted over the whole process (warm-up, traced stretch
and window). 0 where every frame is one chunk; None where the program has
no such counters or copied no host frame. Layer: the stylizer."""

import sys


def read(run):
    stylize = sys.modules.get("vsnca_tpu_torch.infer.stylize")
    uploaded = getattr(stylize, "UPLOAD_BYTES", None)
    hidden = getattr(stylize, "HIDDEN_UPLOAD_BYTES", None)
    if run.kind != "serve" or not uploaded or hidden is None:
        return None
    return 100.0 * hidden / uploaded
