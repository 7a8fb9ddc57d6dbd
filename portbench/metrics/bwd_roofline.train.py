"""The rollout backward's share of its roofline, in %: the least time of the
traced iterations' backward (``counts.nca``: every step's MLP vector-Jacobian
product and stencil adjoint at the float32-accurate peak, against each
step's saved state, conditioning and cotangents over the HBM rate) over the
device time of the backward kernels (``nca_bwd_*``) in the traced stretch.
Layer: the kernels."""

from portbench.counts import nca, peaks


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace_step_counts:
        return None
    from portbench.harness.trace import device_seconds

    dev = device_seconds(run.trace, ("nca_bwd_",))
    if dev <= 0:
        return None
    tc = run.config["train"]
    px = tc["batch_size"] * tc["img_size"][0] * tc["img_size"][1]
    steps = sum(run.trace_step_counts)
    bound = nca.bound_seconds(steps * nca.step_backward_flops(run.model, px),
                              steps * nca.step_backward_bytes(run.model, px),
                              peaks.F32_ACCURATE_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / dev
