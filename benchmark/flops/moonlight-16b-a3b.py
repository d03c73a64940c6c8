"""Operations and bytes of the moonlight-16b-a3b cells' work, from shapes
and, for the held experts, from the token-slots the program counted.

``round_flops``: the model FLOPs of one federated round, 3x the forward
(the backward ~2x), model FLOPs only. A token's forward costs, in each
layer, latent attention's projections 2 d H (dn + dr) (q), 2 d (r + dr)
(the latent and k_pe), 2 r H (dn + dv) (k_nope and v) and 2 H dv d (the
output), and causal attention H (dn + dr + dv) (T + 1) (Q K^T at the q/k
width and P V at v's, at the (T + 1) / 2 keys a query sees on average);
then the dense layer's SwiGLU 6 d dense_inter, or a MoE layer's router
2 d E, shared MLP 6 d n_shared moe_inter and routed experts 6 d moe_inter
for each slot routed to a held expert. That share is taken as expected
here, top_k x held / E slots a token (0.75 at 6 of 64 with 8 held): the
window's own routing is not read, and the clipped edge tokens of the
traffic make it uneven. Then the head, 2 d V. Every station's S x B x T
tokens count; the loss predicts T - 1 of them, the forward computes all T.

``attention_fwd`` and ``attention_bwd``: the work of one MLA attention
call, the heads of one station's batch, causal: the pairs (q, k) with
k <= q, T (T + 1) / 2 a head. At q/k width Dqk = dn + dr and v width Dv
the forward needs Q K^T and P V, 2 (Dqk + Dv) FLOPs a pair, and reads q,
k, v and writes o once at their true widths; the backward needs the
Q K^T recompute, dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q,
2 (3 Dqk + 2 Dv) FLOPs a pair, and reads q, k, v, o and dO and writes dq,
dk and dv once. All bf16, 2 bytes a value. The kernel's padding of v to
the q/k width (and of both to its instantiated 256) is not work.

``held_experts``: the least work of the held experts' products for
``slots`` token-slots: the three SwiGLU products forward and six backward,
18 d moe_inter FLOPs a slot, and each held expert's three weight matrices
read once a pass (forward and backward), bf16.
"""
ROUND_DTYPE = "bf16"
BYTES = 2  # bf16


def _model(config: dict) -> dict:
    return config["model"]


def round_flops(config: dict, traffic: dict) -> float:
    m = _model(config)
    d, t, nh = m["d_model"], traffic["seq_len"], m["n_heads"]
    dn, dr, dv, r = (m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"],
                     m["kv_lora_rank"])
    attn = (2.0 * d * nh * (dn + dr) + 2.0 * d * (r + dr)
            + 2.0 * r * nh * (dn + dv) + 2.0 * nh * dv * d
            + nh * (dn + dr + dv) * (t + 1.0))
    slots = m["top_k"] * len(m["held_experts"]) / m["n_experts"]
    moe = (2.0 * d * m["n_experts"] + 6.0 * d * m["n_shared"] * m["moe_inter"]
           + 6.0 * d * m["moe_inter"] * slots)
    dense = 6.0 * d * m["dense_inter"]
    n_moe = m["n_layers"] - m["first_k_dense"]
    per_token = (m["n_layers"] * attn + m["first_k_dense"] * dense
                 + n_moe * moe + 2.0 * d * m["vocab"])
    tokens = config["federation"]["stations"] * traffic["batch"] * t
    return 3.0 * per_token * tokens


def _heads(config: dict, traffic: dict) -> tuple[float, float, int, int]:
    """(pairs over the call's heads, one head-token row count, Dqk, Dv)."""
    m = _model(config)
    t = traffic["seq_len"]
    heads = traffic["batch"] * m["n_heads"]
    return (heads * t * (t + 1) / 2.0, heads * t,
            m["qk_nope_dim"] + m["qk_rope_dim"], m["v_head_dim"])


def attention_fwd(config: dict, traffic: dict) -> dict:
    pairs, rows, dqk, dv = _heads(config, traffic)
    return {"flops": 2.0 * (dqk + dv) * pairs,
            "bytes": rows * (2 * dqk + 2 * dv) * BYTES, "dtype": "bf16"}


def attention_bwd(config: dict, traffic: dict) -> dict:
    pairs, rows, dqk, dv = _heads(config, traffic)
    return {"flops": 2.0 * (3 * dqk + 2 * dv) * pairs,
            "bytes": rows * (4 * dqk + 4 * dv) * BYTES,
            "dtype": "bf16"}


def held_experts(config: dict, traffic: dict, slots: float,
                 passes: float) -> dict:
    """The work of ``slots`` token-slots through the held experts over
    ``passes`` forward passes (each with its backward): ``passes`` is the
    MoE layers' calls, a station's layer each."""
    m = _model(config)
    d, ff = m["d_model"], m["moe_inter"]
    weights = 3.0 * d * ff * len(m["held_experts"]) * BYTES
    return {"flops": 18.0 * d * ff * slots,
            "bytes": 2.0 * passes * weights, "dtype": "bf16"}
