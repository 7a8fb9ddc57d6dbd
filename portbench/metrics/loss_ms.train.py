"""Milliseconds of the losses a training iteration: the trainer's ``mark``
hook's "loss forward" and "loss backward" parts, by CUDA events, summed over
the window's iterations and divided by them. Layer: the losses (VGG16,
MSOE and the loss terms)."""


def read(run):
    parts = run.part_ms
    if run.kind != "train" or not parts.get("loss forward"):
        return None
    n = len(parts["loss forward"])
    return (sum(parts["loss forward"]) + sum(parts["loss backward"])) / n
