"""decode_ms_per_step: the window's decode wall time (each step's
``decode_step``, argmax and token copy to the host) over its decode steps,
in ms."""


def read(records):
    steps = [t1 - t0 for n, t0, t1, _ in records["spans"] if n == "decode"]
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
