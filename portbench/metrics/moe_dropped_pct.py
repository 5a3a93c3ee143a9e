"""moe_dropped_pct: routed (token, expert) slots that an expert's capacity
dropped (``Routing.dropped``, recorded through
``models.layers.recording(RoutingLog())``) over all routed slots of the
traced requests, in %."""


def read(records):
    c = records["counters"]
    if not c.get("moe_routed"):
        return None
    return 100.0 * c["moe_dropped"] / c["moe_routed"]
