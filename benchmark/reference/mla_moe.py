"""Plain reference of the federated MLA-MoE round (the moonlight-16b-a3b
configuration), in float32 with TF32 off or in the float8 control
(``reference/precision.py``).

The model is DeepSeek-V3's block as the configuration states it, with the
configuration's departures:

- latent attention without a query latent: ``h W_q`` gives the heads' q
  (``qk_nope_dim + qk_rope_dim``); ``h W_kv_a`` gives the latent ``c_kv``
  (RMS-normed, then ``W_kv_b`` gives each head's k_nope and v) and one
  ``k_pe`` shared by the heads; RoPE turns q_pe and k_pe, each interleaved
  pair read as a complex number times ``e^(i p theta^(-2j / dim))``; the
  textbook ``[T, T]`` scores, masked causally, scaled by the q/k width's
  ``-0.5`` power;
- the router: f32 sigmoid scores over every expert (the router's weights
  a fixed buffer, as the configuration states), the top-k of score + the
  fixed correction bias, weights the unbiased scores over their sum times
  the routed scale; the layer holds ``held_experts`` only, and each
  held expert runs on the tokens that chose it (found by comparison, one
  expert at a time), weighted, plus the shared MLP on every token;
- RMSNorm with gains, SwiGLU MLPs, an untied head, no biases; the loss is
  the mean next-token cross-entropy over the vocabulary slice.

A round: each station's gradient of its own loss, their plain mean, one
Adam step with optax's arithmetic. A station's sequences are taken
``chunk_tokens`` at a time and their gradients summed, so the reference
fits on one card once the program's state is freed.

The reference routes on its own hidden states. It keeps the first round's
choices (``[N, top_k]`` a station and MoE layer) so that a driver can read
how many token-slots the program chose otherwise: near-ties flip on
rounding.

Parameters are the program's tree, used as ``h @ W``; ``leaves`` walks it
in sorted-key order, as the program does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.precision import Precision, exact_float32


def param_shapes(m: dict) -> dict:
    """The parameter tree's shapes for the configuration's ``model``."""
    d, h = m["d_model"], m["n_heads"]
    r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_dim"], m["qk_rope_dim"],
                     m["v_head_dim"])
    layers = []
    for i in range(m["n_layers"]):
        layer = {"attn_norm": (d,), "wq": (d, h * (dn + dr)),
                 "wkv_a": (d, r + dr), "kv_norm": (r,),
                 "wkv_b": (r, h * (dn + dv)), "wo": (h * dv, d),
                 "ffn_norm": (d,)}
        if i >= m["first_k_dense"]:
            ff, sh = m["moe_inter"], m["n_shared"] * m["moe_inter"]
            layer.update(shared_gate=(d, sh),
                         shared_up=(d, sh), shared_down=(sh, d),
                         experts=[{"gate": (d, ff), "up": (d, ff),
                                   "down": (ff, d)}
                                  for _ in m["held_experts"]])
        else:
            ff = m["dense_inter"]
            layer.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
        layers.append(layer)
    return {"embed": (m["vocab"], d), "head": (d, m["vocab"]),
            "final_norm": (d,), "layers": layers}


def leaves(tree) -> list:
    """The leaves in sorted-key order (lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(like, flat: list):
    """A tree shaped like ``like`` holding ``flat`` in ``leaves`` order."""
    it = iter(flat)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return next(it)

    return walk(like)


def rms_norm(x, gain, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain


def rope(x, theta):
    """``x`` [B, T, H, dim], each pair (x[2j], x[2j+1]) times e^(i p w_j)."""
    t, dim = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=x.device) / dim)
    angle = torch.outer(torch.arange(t, dtype=torch.float32,
                                     device=x.device), freqs)
    turn = torch.polar(torch.ones_like(angle), angle)[None, :, None]
    xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(xc * turn).flatten(-2)


def swiglu(x, gate, up, down, rnd):
    a = rnd(F.silu(rnd(x @ rnd(gate))) * rnd(x @ rnd(up)))
    return rnd(a @ rnd(down))


def attention(x, layer, m, rnd):
    """MLA of the normed ``x`` [B, T, d]."""
    b, t, _ = x.shape
    nh, dn, dr, dv = (m["n_heads"], m["qk_nope_dim"], m["qk_rope_dim"],
                      m["v_head_dim"])
    r, theta = m["kv_lora_rank"], m["rope_theta"]
    q = rnd(x @ rnd(layer["wq"])).view(b, t, nh, dn + dr)
    kv_a = rnd(x @ rnd(layer["wkv_a"]))
    c_kv = rnd(rms_norm(kv_a[..., :r], layer["kv_norm"], m["rms_eps"]))
    k_pe = rnd(rope(kv_a[..., r:][:, :, None], theta))
    kv = rnd(c_kv @ rnd(layer["wkv_b"])).view(b, t, nh, dn + dv)
    q = torch.cat([q[..., :dn], rnd(rope(q[..., dn:], theta))], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, t, nh, dr)], -1)
    v = kv[..., dn:]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dn + dr)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = rnd(torch.einsum("bhqk,bkhd->bqhd", rnd(p), v))
    return rnd(o.reshape(b, t, nh * dv) @ rnd(layer["wo"]))


def moe(x, layer, router, bias, m, rnd, chose: list | None):
    """The held experts' share of the MoE layer on tokens ``x`` [N, d],
    plus the shared MLP; appends the choice [N, k] to ``chose``."""
    scores = torch.sigmoid(x @ router)
    choice = torch.topk(scores + bias, m["top_k"], dim=-1).indices
    if chose is not None:
        chose.append(choice.detach().cpu())
    weights = scores.gather(-1, choice)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * m["routed_scale"]
    routed = torch.zeros_like(x)
    for expert, w in zip(m["held_experts"], layer["experts"], strict=True):
        tok, slot = torch.nonzero(choice == expert, as_tuple=True)
        if tok.numel() == 0:  # no token chose it: no term, no gradient
            continue
        y = swiglu(x[tok], w["gate"], w["up"], w["down"], rnd)
        routed = routed.index_add(0, tok, weights[tok, slot][:, None] * y)
    shared = swiglu(x, layer["shared_gate"], layer["shared_up"],
                    layer["shared_down"], rnd)
    return rnd(rnd(routed) + shared)


def nll_sum(params, buffers, tokens, m, rnd, chose=None):
    """Sum of the next-token negative log-likelihoods of ``tokens`` [B, T];
    ``chose``: a list per MoE layer to append each layer's choice to."""
    b, t = tokens.shape
    eps = m["rms_eps"]
    x = rnd(params["embed"][tokens])
    n_moe = 0
    for i, layer in enumerate(params["layers"]):
        x = rnd(x + attention(rnd(rms_norm(x, layer["attn_norm"], eps)),
                              layer, m, rnd))
        h = rnd(rms_norm(x, layer["ffn_norm"], eps))
        if i >= m["first_k_dense"]:
            out = moe(h.reshape(b * t, -1), layer, buffers["router"][n_moe],
                      buffers["score_bias"][n_moe], m, rnd,
                      None if chose is None else chose[n_moe])
            x = rnd(x + out.view(b, t, -1))
            n_moe += 1
        else:
            x = rnd(x + swiglu(h, layer["w_gate"], layer["w_up"],
                               layer["w_down"], rnd))
    logits = rnd(rnd(rms_norm(x, params["final_norm"], eps))
                 @ rnd(params["head"]))
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None]).sum()


def station_grad(params, buffers, tokens, m, rnd, chunk_tokens, chose=None):
    """(mean loss, gradient per leaf) of one station's ``[B, T]`` tokens,
    ``chunk_tokens`` at a time."""
    b, t = tokens.shape
    rows = max(1, chunk_tokens // t)
    count = b * (t - 1)
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tree = rebuild(params, flat)
    grads = [torch.zeros_like(p) for p in flat]
    total = 0.0
    for r0 in range(0, b, rows):
        part = nll_sum(tree, buffers, tokens[r0:r0 + rows], m, rnd,
                       chose) / count
        # an expert no token chose has no gradient: zeros
        for acc, g in zip(grads, torch.autograd.grad(
                part, flat, allow_unused=True, materialize_grads=True),
                strict=True):
            acc += g
        total += float(part.detach())
    return total, grads


def run(params0, buffers, steps, m, adam, precision="float32",
        chunk_tokens=4096) -> dict:
    """The rounds of ``steps`` (each ``[S, B, T]`` tokens) from
    ``params0``: each round's loss, the first round's mean gradient and the
    norm of each of its leaves, the norm of each leaf's change over the
    rounds, and the first round's choices (``choices[s][layer]``)."""
    rnd = Precision(precision)
    b1, b2, eps, lr = adam["b1"], adam["b2"], adam["eps"], adam["lr"]
    with exact_float32(), torch.no_grad():
        start = [p.detach().clone() for p in leaves(params0)]
        p = [x.clone() for x in start]
        mu = [torch.zeros_like(x) for x in p]
        nu = [torch.zeros_like(x) for x in p]
        losses, grad_norms, first, choices = [], None, None, []
        n_moe = m["n_layers"] - m["first_k_dense"]
        for n, tokens in enumerate(steps, start=1):
            tree = rebuild(params0, p)
            g_mean = [torch.zeros_like(x) for x in p]
            loss = 0.0
            for s in range(tokens.shape[0]):
                chose = [[] for _ in range(n_moe)] if n == 1 else None
                with torch.enable_grad():
                    l_s, g_s = station_grad(tree, buffers, tokens[s], m, rnd,
                                            chunk_tokens, chose)
                if chose is not None:
                    choices.append([torch.cat(c) for c in chose])
                loss += l_s / tokens.shape[0]
                for acc, g in zip(g_mean, g_s, strict=True):
                    acc += g / tokens.shape[0]
                del g_s
            losses.append(loss)
            if grad_norms is None:
                grad_norms = [float(torch.linalg.vector_norm(g))
                              for g in g_mean]
                first = [g.clone() for g in g_mean]
            c1 = 1 - b1 ** n
            c2 = 1 - b2 ** n
            for i, g in enumerate(g_mean):
                mu[i] = b1 * mu[i] + (1 - b1) * g
                nu[i] = b2 * nu[i] + (1 - b2) * g * g
                p[i] = p[i] - lr * (mu[i] / c1) / (torch.sqrt(nu[i] / c2)
                                                   + eps)
            del g_mean
        change = [float(torch.linalg.vector_norm(a - b))
                  for a, b in zip(p, start, strict=True)]
    return {"losses": losses, "grad_norms": grad_norms, "grads": first,
            "change_norms": change, "choices": choices}


def flip_share(prog: list, ref: list) -> float | None:
    """The share of token-slots whose expert the program chose and the
    reference did not, over every station and MoE layer (``[N, k]``
    choices each, in the same order); None where the program routed other
    tokens (a program that left some out)."""
    shapes = [[c.shape for c in station] for station in prog]
    if shapes != [[c.shape for c in station] for station in ref]:
        return None
    flipped = total = 0
    for p_station, r_station in zip(prog, ref, strict=True):
        for p, r in zip(p_station, r_station, strict=True):
            kept = (p[:, :, None] == r[:, None, :]).any(-1)
            flipped += int((~kept).sum())
            total += kept.numel()
    return flipped / total
