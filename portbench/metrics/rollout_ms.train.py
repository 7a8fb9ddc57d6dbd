"""Milliseconds of the rollout a training iteration: the trainer's ``mark``
hook's "rollout forward" and "rollout backward" parts, by CUDA events,
summed over the window's iterations and divided by them. Layer: the
trainer."""


def read(run):
    parts = run.part_ms
    if run.kind != "train" or not parts.get("rollout forward"):
        return None
    n = len(parts["rollout forward"])
    return (sum(parts["rollout forward"]) + sum(parts["rollout backward"])) / n
