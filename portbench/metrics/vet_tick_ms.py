"""vet_tick_ms: host ms of each dashboard call of the window (one unit fed
to ``fleet.ShardedVetMux.feed``, then ``tick``), averaged."""


def read(records):
    ticks = [t1 - t0 for n, t0, t1, _ in records["spans"]
             if n == "dashboard"]
    if not ticks:
        return None
    return 1e3 * sum(ticks) / len(ticks)
