"""moe_experts_ms: milliseconds a round of the device time of the kernels
launched inside the program's ``moe.experts`` ranges (the held experts'
forward products and SwiGLU) and ``moe.experts_bwd`` ranges (their
backward, opened in the backward of the autograd function around them, on
autograd's thread), over the traced rounds; None where the program opens
neither."""


def read(ctx):
    from portbench import spans

    parts = [spans.per_round_ms(ctx, name)
             for name in ("moe.experts", "moe.experts_bwd")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
