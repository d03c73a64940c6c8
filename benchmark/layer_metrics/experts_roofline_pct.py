"""experts_roofline_pct: the least time of the held experts' work over the
device time of the kernels launched inside the program's ``moe.experts``
and ``moe.experts_bwd`` ranges, from any thread. The work
(``flops/<config>.py``'s ``held_experts``) is 18 d moe_inter FLOPs a
token-slot, for the slots the program routed to its held experts in the
traced rounds, and each held expert's weights read once a pass. The slots
come from the program's counter ``moe.expert_slots``
(``runtime.tracing.COUNTERS``), kept on the card while the profiler runs
and read here after the window, so the share holds under any routing. The
passes are the ranges' count. None where the program keeps no such
counter or opens no such range, or the card has no peak in the table."""

COUNTER = "moe.expert_slots"
_NOT_READ = object()


def _slots(ctx):
    """The traced rounds' token-slots routed to held experts, drained once
    a traced run and kept on ``ctx``; None where the program keeps no
    such counter."""
    got = getattr(ctx, "_expert_slots", _NOT_READ)
    if got is _NOT_READ:
        got = None
        try:
            from vantage6_tpu_torch.runtime import tracing
        except ImportError:
            tracing = None
        counters = getattr(tracing, "COUNTERS", None)
        if counters is not None:
            total = counters.drain().get(COUNTER)
            if total is not None:
                got = float(total.sum())
        ctx._expert_slots = got
    return got


def read(ctx):
    from portbench import roofline, spans

    work_fn = getattr(ctx.flops, "held_experts", None)
    slots = _slots(ctx)
    if work_fn is None or ctx.peak is None or not slots:
        return None
    device_s = 0.0
    for name in ("moe.experts", "moe.experts_bwd"):
        device_s += spans.device_seconds(ctx.trace, name) or 0.0
    passes = len(spans.ranges(ctx.trace, "moe.experts"))
    if device_s <= 0 or passes == 0:
        return None
    least, _ = roofline.least_seconds(
        work_fn(ctx.config, ctx.traffic, slots, passes), ctx.peak)
    return 100.0 * least / device_s
