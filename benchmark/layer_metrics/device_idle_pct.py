"""device_idle_pct: the share of a round in which the card runs nothing:
1 - the device's busy time a round over the untraced window's time a
round. The busy time is the union of the device activity (kernels,
copies, fills) in the traced window, from the profiler's trace, over the
rounds it holds. The traced window's own wall is not the divisor: the
profiler slows the host's launches (the transformer's traced rounds take
about twice their untraced time), not the card's work."""


def read(ctx):
    if ctx.trace.rounds <= 0 or ctx.round_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.rounds / ctx.round_s)
