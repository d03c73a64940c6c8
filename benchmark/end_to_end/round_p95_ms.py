"""round_p95_ms: the 95th percentile of every round's latency in the
window, from its dispatch to its loss on the host (nearest rank)."""
import math


def read(win) -> float:
    ordered = sorted(win.latencies)
    return 1e3 * ordered[math.ceil(0.95 * len(ordered)) - 1]
