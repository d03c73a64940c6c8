"""mla_attn_bwd_roofline_pct: the same under the ``attention_bwd`` ranges,
against the backward's work at MLA's widths whatever implements it
(``flops/<config>.py``'s ``attention_bwd``): the Q K^T recompute and the
dP, dV, dQ and dK products, q, k, v, o and dO read and dq, dk and dv
written once at their true widths, bf16."""


def read(ctx):
    from portbench.roofline import share

    return share(ctx, "attention_bwd", "attention_bwd")
