"""flash_roofline_pct: the traced prefills' flash launches' summed bound
(one launch a layer; ``yardstick.flash_bound_s``, 3xTF32 peak and HBM
bandwidth) over the device time of the ``flash_*`` kernels, in %."""

from portbench.tracing import spans_named
from portbench.yardstick import flash_bound_s


def read(records):
    trace = records["trace"]
    dev_ns = sum(e - s for n, s, e in trace["kernels"] if "flash_" in n)
    if not dev_ns:
        return None
    bound = sum(flash_bound_s(records["config"], a["batch"], a["prompt"])
                for _, _, a in spans_named(trace, "prefill"))
    return 100.0 * bound / (dev_ns / 1e9)
