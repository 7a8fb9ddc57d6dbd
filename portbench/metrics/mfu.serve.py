"""The served model's operations over the window (every tick's edge map and
its steps, counted from shapes by ``counts.nca``) over the window's seconds
times the peak of the served operand type, in %. Layer: the whole frame."""

from portbench.counts import nca, peaks


def read(run):
    if run.kind != "serve" or run.window_s <= 0 or run.ticks == 0:
        return None
    serve = run.config["serve"]
    peak = peaks.BF16_FLOPS if serve["compute_dtype"] == "bfloat16" else peaks.F32_ACCURATE_FLOPS
    px = run.pixels_per_tick
    per_tick = serve["step_n"] * nca.step_flops(run.model, px) + nca.edge_map_flops(px)
    return 100.0 * run.ticks * per_tick / (run.window_s * peak)
