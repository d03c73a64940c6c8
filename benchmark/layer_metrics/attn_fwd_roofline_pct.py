"""attn_fwd_roofline_pct: the least time the attention forward's work
needs (the larger of its causal FLOPs over the bf16 peak and its bytes,
q, k, v read once and o written once, over the memory rate), over the
device time of the kernels launched under the program's ``attention_fwd``
ranges. ``flops/<config>.py``'s ``attention_fwd`` gives the work of one
call."""


def read(ctx):
    from portbench.roofline import share

    return share(ctx, "attention_fwd", "attention_fwd")
