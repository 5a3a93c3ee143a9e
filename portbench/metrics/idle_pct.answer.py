"""idle_pct.answer: the share of the traced window (prefill, decode and
dashboard, host hand-offs included) in which no kernel or copy ran on the
card, in %."""


def read(records):
    trace = records["trace"]
    if not trace["window_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
