"""Rollout kernel launches a delivered frame: the wrappers' ``LAUNCHES``
counter over the window, divided by the frames delivered (summed over
streams). Layer: the wrappers and registry."""


def read(run):
    if run.kind != "serve" or run.launches is None or run.frames == 0:
        return None
    return run.launches / run.frames
