"""Host milliseconds inside ``VideoStylizer.step_frame`` a tick, before the
readout copy: the benchmark's own span around the call, summed over the
window's ticks and divided by them (each span is one tick of about a
millisecond; the sum spans the window). Layer: the stylizer."""


def read(run):
    if run.kind != "serve" or not run.host_spans:
        return None
    return 1e3 * sum(run.host_spans) / len(run.host_spans)
