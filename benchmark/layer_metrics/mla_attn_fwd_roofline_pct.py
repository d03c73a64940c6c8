"""mla_attn_fwd_roofline_pct: the least time of latent attention's forward
work over the device time of the kernels launched under the program's
``attention_fwd`` ranges, one a layer a station. The work is what MLA
needs, not what the kernel computes at its padded width:
``flops/<config>.py``'s ``attention_fwd``, Q K^T at the q/k width and P V
at v's over the causal pairs, q, k, v read and o written once at their
true widths, bf16."""


def read(ctx):
    from portbench.roofline import share

    return share(ctx, "attention_fwd", "attention_fwd")
