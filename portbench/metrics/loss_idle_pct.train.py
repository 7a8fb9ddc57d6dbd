"""The share of the traced stretch in which the device idled while the
host's innermost range was a loss term's or a feature net's span
(``vsnca.loss.*``, ``vsnca.vgg16``, ``vsnca.msoe``; ``utils/spans.py``), in
%: those labels' ``idle_by_host`` seconds over the stretch's ``window_s``.
The spans close with the loss's forward, so this is the forward's idle;
the loss stack's backward runs under ``vsnca.train.backward``, which no
per-layer metric reads. None where the trace holds no ``vsnca.`` label (a
program without the spans). Layer: the losses."""


def _names(label):
    return label.startswith("vsnca.loss.") or label in ("vsnca.vgg16", "vsnca.msoe")


def read(run):
    if run.kind != "train" or run.trace is None or run.trace["window_s"] <= 0:
        return None
    idle = run.trace["idle_by_host"]
    if not any(label.startswith("vsnca.") for label in idle):
        return None
    return 100.0 * sum(s for label, s in idle.items() if _names(label)) / run.trace["window_s"]
