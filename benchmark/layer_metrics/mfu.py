"""mfu: the model FLOPs of one round (``flops/<config>.py``'s
``round_flops``) over the untraced window's time a round and the card's
published dense peak in the round's compute type."""


def read(ctx):
    peak = (ctx.peak or {}).get(ctx.flops.ROUND_DTYPE)
    if not peak or ctx.round_s <= 0:
        return None
    flops = ctx.flops.round_flops(ctx.config, ctx.traffic)
    return 100.0 * flops / (ctx.round_s * peak)
