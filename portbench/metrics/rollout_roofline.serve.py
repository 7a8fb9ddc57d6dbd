"""The rollout kernels' share of their roofline, in %: the least time of one
tick's rollout (``counts.nca``: the larger of its steps' operations over the
peak of the served operand type and the state, conditioning and weights read
once and the state written once over the HBM rate) over the device time of
the kernels the rollout launches (``nca_step_kernel``, every form), from the
traced stretch. Layer: the kernels."""

from portbench.counts import nca, peaks


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace_units == 0:
        return None
    from portbench.harness.trace import device_seconds

    dev = device_seconds(run.trace, ("nca_step_kernel",)) / run.trace_units
    if dev <= 0:
        return None
    serve = run.config["serve"]
    peak = peaks.BF16_FLOPS if serve["compute_dtype"] == "bfloat16" else peaks.F32_ACCURATE_FLOPS
    px = run.pixels_per_tick
    bound = nca.bound_seconds(serve["step_n"] * nca.step_flops(run.model, px),
                              nca.rollout_bytes(run.model, px), peak, peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / dev
