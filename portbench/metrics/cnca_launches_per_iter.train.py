"""ConditionedNCA kernel launches a training iteration: the wrappers'
``fused_cnca.LAUNCHES`` counter over the window, divided by the window's
completed iterations (the profiled stretch left out of both). Layer: the
ConditionedNCA wrappers."""


def read(run):
    if run.kind != "train" or not run.launches or not run.iteration_flops:
        return None
    return run.launches / len(run.iteration_flops)
