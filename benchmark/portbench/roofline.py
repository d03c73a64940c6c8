"""A kernel's share of its roofline, read from a traced window."""
from __future__ import annotations


def least_seconds(work: dict, peak: dict) -> tuple[float, str]:
    """(the least time ``work`` {"flops", "bytes", "dtype"} needs on a card
    of ``peak``, which bound sets it: "flops" or "bytes")."""
    t_flops = work["flops"] / peak[work["dtype"]]
    t_bytes = work["bytes"] / peak["hbm_bytes_per_s"]
    return (t_flops, "flops") if t_flops >= t_bytes else (t_bytes, "bytes")


def share(ctx, range_name: str, work_name: str):
    """100 x the least time of the calls under ``range_name`` over the
    device time of their kernels; None where the configuration counts no
    such work, the card has no peak in the table, or the window holds no
    such range."""
    work_fn = getattr(ctx.flops, work_name, None)
    if work_fn is None or ctx.peak is None:
        return None
    calls, device_s = ctx.trace.under_range(range_name)
    if calls == 0 or device_s <= 0:
        return None
    least, _ = least_seconds(work_fn(ctx.config, ctx.traffic), ctx.peak)
    return 100.0 * calls * least / device_s
