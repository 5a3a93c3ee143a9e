"""mfu_pct: the published model's operations for the window's prefills
(``yardstick.prefill_flops``) over their summed synchronised host time and
the card's f32-accurate peak (3xTF32, 165 TFLOP/s), in %."""

from portbench.yardstick import F32_PEAK_OPS, prefill_flops


def read(records):
    pre = [(t1 - t0, a) for n, t0, t1, a in records["spans"]
           if n == "prefill"]
    seconds = sum(t for t, _ in pre)
    if not seconds:
        return None
    ops = sum(prefill_flops(records["config"], a["batch"], a["prompt"])
              for _, a in pre)
    return 100.0 * ops / (seconds * F32_PEAK_OPS)
