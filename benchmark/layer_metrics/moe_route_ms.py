"""moe_route_ms: milliseconds a round of the device time of the kernels
launched inside the program's ``moe.route`` ranges (``models/mla_moe.py``:
the router's f32 product, the sigmoid, the biased top-k, the weights and
the sort of the token-slots to the held experts, one range a MoE layer a
station), from any thread, over the traced rounds."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "moe.route")
