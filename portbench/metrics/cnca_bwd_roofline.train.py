"""The ConditionedNCA backward kernels' share of their roofline, in %: the
least time of the traced iterations' backward steps (``counts.cnca``: the
MLP and percept recomputed, their vector-Jacobian and weight-gradient
products and the depthwise adjoint at the float32-accurate peak, against
the bytes the two launches a step must move over the HBM rate) over the
device time of ``cnca_bwd_mlp_kernel`` and ``cnca_bwd_adjoint_kernel`` in the
traced stretch. Layer: the ConditionedNCA kernels."""

from portbench.counts import cnca, nca, peaks


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace_step_counts:
        return None
    from portbench.harness.trace import device_seconds

    dev = device_seconds(run.trace, ("cnca_bwd_mlp_kernel", "cnca_bwd_adjoint_kernel"))
    if dev <= 0:
        return None
    tc = run.config["train"]
    px = tc["batch_size"] * tc["img_size"][0] * tc["img_size"][1]
    steps = tc["steps_per_batch"] * sum(run.trace_step_counts)
    bound = nca.bound_seconds(steps * cnca.step_backward_flops(run.model, px),
                              steps * cnca.step_backward_bytes(run.model, px),
                              peaks.F32_ACCURATE_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / dev
