"""kernels_per_decode_step: device kernels and copies that start inside the
traced window's decode steps, over those steps."""

from portbench.tracing import kernels_within, spans_named


def read(records):
    trace = records["trace"]
    steps = spans_named(trace, "decode")
    launched = kernels_within(trace, steps)
    if not steps or not launched:
        return None
    return len(launched) / len(steps)
