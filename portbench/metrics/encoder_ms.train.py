"""Milliseconds of the goal encoder's forward a training iteration: the
encoder trainer's ``mark`` hook's "encode" part (from "encode" to "rollout
forward"), by CUDA events, summed over the iteration's train steps, then
over the window's iterations and divided by them. None where the program
has no "encode" part. Layer: the encoder."""


def read(run):
    parts = run.part_ms
    if run.kind != "train" or not parts.get("encode"):
        return None
    return sum(parts["encode"]) / len(parts["encode"])
