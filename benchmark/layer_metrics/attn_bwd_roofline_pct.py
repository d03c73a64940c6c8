"""attn_bwd_roofline_pct: the same under the ``attention_bwd`` ranges,
against the work the backward needs for these inputs whatever implements
it: the causal Q K^T recompute and the dV, dP, dQ and dK products; q, k,
v, o and dO read once, dq, dk and dv written once; the bf16 peak, the
inputs being bf16."""


def read(ctx):
    from portbench.roofline import share

    return share(ctx, "attention_bwd", "attention_bwd")
