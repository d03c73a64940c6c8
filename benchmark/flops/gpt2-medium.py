"""Operations and bytes of the gpt2-medium cells' work, from shapes.

``round_flops``: the model FLOPs of one federated round, 3x the forward
(the backward ~2x), model FLOPs only. A token's forward costs, a layer,
the q/k/v projection 6 d^2, the output projection 2 d^2, the MLP
4 d n_inner (16 d^2 at GPT-2's n_inner = 4d) and causal attention
2 d (T + 1) (Q K^T and P V at the (T + 1) / 2 keys a query sees on
average), and then the logits 2 d vocab. Every station's S x B x T tokens
count; the loss predicts T - 1 of them, the forward computes all T.

``attention_fwd`` and ``attention_bwd``: the work of one attention call,
the heads of one station's batch ``[B, H, T, d / H]``, causal: the pairs
(q, k) with k <= q, T (T + 1) / 2 a head. The forward needs Q K^T and P V,
4 D FLOPs a pair, and reads q, k, v and writes o once; the backward
needs the Q K^T recompute and the dV, dP, dQ and dK products, 10 D FLOPs a
pair, and reads q, k, v, o and dO and writes dq, dk and dv once. All in
bf16, the compute type, 2 bytes a value.
"""
ROUND_DTYPE = "bf16"
BYTES = 2  # bf16


def round_flops(config: dict, traffic: dict) -> float:
    m = config["model"]
    d, n_inner, vocab = m["n_embd"], m["n_inner"], m["vocab_size"]
    t = traffic["seq_len"]
    per_layer = 8.0 * d * d + 4.0 * d * n_inner + 2.0 * d * (t + 1)
    per_token = m["n_layer"] * per_layer + 2.0 * d * vocab
    tokens = config["federation"]["stations"] * traffic["batch"] * t
    return 3.0 * per_token * tokens


def _heads(config: dict, traffic: dict) -> tuple[float, float, int]:
    """(pairs over the call's heads, values of one [B, H, T, D] tensor,
    D)."""
    m = config["model"]
    h, t = m["n_head"], traffic["seq_len"]
    d_head = m["n_embd"] // h
    heads = traffic["batch"] * h
    return heads * t * (t + 1) / 2.0, heads * t * d_head, d_head


def attention_fwd(config: dict, traffic: dict) -> dict:
    pairs, values, d_head = _heads(config, traffic)
    return {"flops": 4.0 * d_head * pairs, "bytes": 4.0 * values * BYTES,
            "dtype": "bf16"}


def attention_bwd(config: dict, traffic: dict) -> dict:
    pairs, values, d_head = _heads(config, traffic)
    return {"flops": 10.0 * d_head * pairs, "bytes": 8.0 * values * BYTES,
            "dtype": "bf16"}
