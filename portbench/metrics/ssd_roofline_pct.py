"""ssd_roofline_pct: the traced prefills' SSD launches' summed bound (the
configuration's family's ``ssd_launches`` and ``ssd_cost``: operations at
the published chunk, 3xTF32 peak and HBM bandwidth) over the device time
of the SSD kernels (names holding ``ssd_``: the prologue and the scan),
in %; none where no SSD kernel ran or the family counts none."""

from portbench import families
from portbench.tracing import spans_named
from portbench.yardstick import roofline_s


def read(records):
    trace, c = records["trace"], records["config"]
    dev_ns = sum(e - s for n, s, e in trace["kernels"] if "ssd_" in n)
    fam = families.of(c)
    if not dev_ns or not hasattr(fam, "ssd_launches"):
        return None
    bound = sum(roofline_s(*fam.ssd_cost(c, *launch))
                for _, _, a in spans_named(trace, "prefill")
                for launch in fam.ssd_launches(c, a["batch"], a["prompt"]))
    return 100.0 * bound / (dev_ns / 1e9)
