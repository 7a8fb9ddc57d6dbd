"""The share of the traced stretch in which the device idled while the
host's innermost range was one of the trainers' own spans
(``vsnca.train.*``; ``utils/spans.py``: the iteration, the pool, the
pre-roll, the encoder, the rollout, the loss's set-up, the optimizer, the
loss's read), in %: those labels' ``idle_by_host`` seconds over the
stretch's ``window_s``. ``vsnca.train.backward`` is left out: the autograd
backward under it is every layer's (the loss stack's, the kernel pair's,
the encoder's), and no span names its parts by layer. None where the trace
holds no ``vsnca.`` label (a program without the spans). Layer: the
trainer."""

BACKWARD = "vsnca.train.backward"


def read(run):
    if run.kind != "train" or run.trace is None or run.trace["window_s"] <= 0:
        return None
    idle = run.trace["idle_by_host"]
    if not any(label.startswith("vsnca.") for label in idle):
        return None
    train = sum(s for label, s in idle.items()
                if label.startswith("vsnca.train.") and label != BACKWARD)
    return 100.0 * train / run.trace["window_s"]
