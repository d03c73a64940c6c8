"""Plain reference of ``models/mla_moe.py``'s model: DeepSeek-V3's block in
float32 with TF32 off, textbook operations only.

It imports no kernel and no model module of the port (only the tree
helpers of ``_tree``). The configuration is read by attribute
(``MLAMoEConfig``'s fields), and the parameters and buffers are the trees
``mla_moe.init_params`` and ``init_buffers`` make.

- Attention is the textbook one: the ``[T, T]`` scores of q and k at
  ``qk_nope_dim + qk_rope_dim``, masked causally, scaled by that width's
  ``-0.5`` power, softmax, times v at ``v_head_dim``. RoPE multiplies
  each interleaved pair, read as a complex number, by ``e^(i p theta^(-2j
  / dim))``, as DeepSeek-V3's own inference code does.
- The mixture of experts is dense: each held expert runs on every token
  and is weighted by the token's routing weight for it (zero where the
  token did not choose it), then the shared MLP is added. The router is
  the published one: f32 sigmoid scores, top-k of score + bias, weights
  the unbiased scores over their sum, times the routed scale.
- A round is FedSGD: each station's gradient of its own mean loss, their
  plain mean, one Adam step with optax's arithmetic.

Departures from the published model, the same as the program's: the
layer holds only ``held_experts`` (one chip's share; the absent experts'
part is left out), no sequence-wise auxiliary loss, the router and the
correction bias fixed (buffers, not trained), a sliced vocabulary. RMSNorm multiplies its gain in f32 before any
cast (the published code casts first; in f32 the two agree).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from vantage6_tpu_torch._tree import tree_leaves, tree_unflatten


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


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
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2)
                               .contiguous())
    return torch.view_as_real(xc * turn).flatten(-2)


def attention(x, layer, cfg):
    """MLA of the normed ``x`` [B, T, d], textbook."""
    b, t, _ = x.shape
    nh, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                      cfg.v_head_dim)
    q = (x @ layer["wq"]).view(b, t, nh, dn + dr)
    kv_a = x @ layer["wkv_a"]
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], layer["kv_norm"],
                    cfg.rms_eps)
    k_pe = rope(kv_a[..., cfg.kv_lora_rank:][:, :, None], cfg.rope_theta)
    kv = (c_kv @ layer["wkv_b"]).view(b, t, nh, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg.rope_theta)], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, t, nh, dr)], -1)
    v = kv[..., dn:]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dn + dr)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, nh * dv)
    return o @ layer["wo"]


def router(x, w, bias, cfg):
    """(chosen experts [N, k], their weights [N, k]) of tokens ``x``."""
    scores = torch.sigmoid(x @ w)
    choice = torch.topk(scores + bias, cfg.top_k, dim=-1).indices
    weights = scores.gather(-1, choice)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return choice, weights * cfg.routed_scale


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(x, layer, w_router, bias, cfg, held=None):
    """The MoE layer on tokens ``x`` [N, d]: the experts ``held`` (default
    ``cfg.held_experts``, whose weights ``layer["experts"]`` holds in that
    order) run densely on every token, weighted by each token's weight
    for them, plus the shared MLP."""
    held = cfg.held_experts if held is None else held
    choice, weights = router(x, w_router, bias, cfg)
    out = swiglu(x, layer["shared_gate"], layer["shared_up"],
                 layer["shared_down"])
    for expert, w in zip(held, layer["experts"], strict=True):
        token_w = (weights * (choice == expert)).sum(-1, keepdim=True)
        out = out + token_w * swiglu(x, w["gate"], w["up"], w["down"])
    return out


def forward(params, tokens, cfg, buffers):
    """Logits [B, T, V] of ``tokens`` [B, T]."""
    x = params["embed"][tokens]
    moe_buffers = zip(buffers["router"], buffers["score_bias"], strict=True)
    for i, layer in enumerate(params["layers"]):
        x = x + attention(rms_norm(x, layer["attn_norm"], cfg.rms_eps),
                          layer, cfg)
        h = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        if i >= cfg.first_k_dense:
            b, t, d = h.shape
            x = x + moe(h.reshape(b * t, d), layer, *next(moe_buffers),
                        cfg).view(b, t, d)
        else:
            x = x + swiglu(h, layer["w_gate"], layer["w_up"],
                           layer["w_down"])
    return rms_norm(x, params["final_norm"], cfg.rms_eps) @ params["head"]


def loss(params, tokens, cfg, buffers):
    """Mean next-token cross-entropy (T - 1 predictions a sequence)."""
    logits = forward(params, tokens, cfg, buffers)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def fed_round(params, mu, nu, count, tokens, cfg, buffers, lr,
              b1=0.9, b2=0.999, eps=1e-8):
    """One FedSGD round over ``tokens`` [S, B, T] with every station
    weighted 1: (new params, mu, nu, the stations' mean loss, the mean
    gradient), trees like ``params``; ``count`` is the steps taken
    before."""
    flat = [p.detach() for p in tree_leaves(params)]
    g_mean = [torch.zeros_like(p) for p in flat]
    total = 0.0
    n = tokens.shape[0]
    for s in range(n):
        leaves = [p.clone().requires_grad_() for p in flat]
        value = loss(tree_unflatten(params, leaves), tokens[s], cfg,
                     buffers)
        for acc, g in zip(g_mean, torch.autograd.grad(value, leaves),
                          strict=True):
            acc += g / n
        total += float(value.detach()) / n
    c1, c2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
    m_flat, v_flat, p_flat = [], [], []
    for p, g, m, v in zip(flat, g_mean, tree_leaves(mu), tree_leaves(nu),
                          strict=True):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p_flat.append(p - lr * (m / c1) / (torch.sqrt(v / c2) + eps))
        m_flat.append(m)
        v_flat.append(v)
    return (tree_unflatten(params, p_flat), tree_unflatten(params, m_flat),
            tree_unflatten(params, v_flat), total,
            tree_unflatten(params, g_mean))
