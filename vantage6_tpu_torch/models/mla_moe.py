"""DeepSeek-V3's decoder block: latent attention (MLA) and a sigmoid-routed
mixture of experts, as one chip's share of an expert-parallel layer.

The model family of Moonlight-16B-A3B, DeepSeek-V3, Kimi-K2 and the GLM-4.x
flash models (``model_type: deepseek_v3``). A layer is

    h = x + MLA(RMSNorm(x)),    out = h + FFN(RMSNorm(h)),

with the FFN a SwiGLU MLP in the first ``first_k_dense`` layers and a
mixture of experts after them; then a final RMSNorm and an untied head.

- **MLA**, without a query latent (``q_lora_rank: null``): the queries are
  ``h W_q``, ``n_heads`` of ``qk_nope_dim + qk_rope_dim``; ``h W_kv_a``
  gives a ``kv_lora_rank``-wide latent ``c_kv``, which is RMS-normed and
  expanded by ``W_kv_b`` into per-head ``k_nope`` and ``v``, and a single
  ``qk_rope_dim``-wide ``k_pe`` that every head shares. RoPE turns the
  ``q_pe`` and ``k_pe`` parts only, each interleaved pair (x[2i],
  x[2i+1]) by its angle. DeepSeek's code first permutes each to halves
  (evens then odds) and rotates those; q and k are permuted alike, so the
  scores are the same. Scores take the q/k width and the scale
  ``(qk_nope_dim + qk_rope_dim) ** -0.5``; the values are ``v_head_dim``
  wide. Attention runs on ``ops.flash_attention`` (``"flash"``) or its
  kernel-free twin (``"recompute"``), which take q, k and v at one width:
  the narrower of q/k and v is zero-padded to the wider (the scores and
  the output's true columns are unchanged; padded output columns are
  exactly zero) and the output sliced back. ``"ring"`` passes q, k and v
  at one width and is not offered.
- **The router** is ``sigmoid(h W_g)`` in f32 over all ``n_experts``; the
  ``top_k`` experts are chosen by ``scores + score_bias`` (``noaux_tc``
  with one group), and weighted by their unbiased scores, divided by their
  sum (``norm_topk_prob``) and multiplied by ``routed_scale``. The router
  ``W_g`` and the bias are fixed buffers outside the trained tree
  (``init_buffers``): on one chip's share the router's gradient lacks the
  absent experts' outputs, and Adam's per-element steps then move the
  tokens onto the experts this chip holds within a few rounds, which the
  deployment, whose router sees every expert's output, would not do.
- **The held experts**: this layer holds the experts ``held_experts`` of
  the ``n_experts`` (one chip's share under expert parallelism). It routes
  every token over all of them and computes, for every token-slot routed
  to a held expert, that expert's weighted SwiGLU output, dropping none;
  what the absent experts would add is left out, and that partial sum goes
  on to the next layer. A shared SwiGLU MLP ``n_shared * moe_inter`` wide
  runs on every token, once. Under ``torch.profiler`` the parts are named
  by ``runtime.tracing.phase``: ``moe.route`` (router, choice, weights and
  the sort of the token-slots to the held experts), ``moe.experts`` and
  ``moe.experts_bwd`` (the held experts' products and SwiGLU, forward and
  backward) and ``moe.combine`` (the weighted sum back onto the tokens);
  ``tracing.COUNTERS`` keeps the token-slots routed to each held expert on
  the card (``moe.expert_slots``).

Products run in ``dtype`` (bf16 on the card) over float32 master weights;
RMSNorm statistics, RoPE, the router, softmax and the loss run in f32.
The token lookup reads the f32 table and casts, so a token's repeated
rows sum their gradients in f32.

The held experts' dispatch sorts the token-slots by expert and loops over
the held experts with one product a part. Their sizes reach the host once
a MoE layer's forward (one read of ``n_held`` counts); the backward
reuses them, and recomputes each expert's first two products rather than
keep anything the size of the routed slots (``_HeldExperts``).

Parameters (``h @ W`` layout, float32)::

    embed [V, d]   head [d, V]   final_norm [d]
    layers[i]: attn_norm [d], wq [d, H (dn + dr)], wkv_a [d, r + dr],
               kv_norm [r], wkv_b [r, H (dn + dv)], wo [H dv, d], ffn_norm [d]
      dense:   w_gate, w_up [d, dense_inter], w_down [dense_inter, d]
      MoE:     shared_gate, shared_up [d, n_shared moe_inter],
               shared_down [n_shared moe_inter, d],
               experts: one {gate [d, moe_inter], up [d, moe_inter],
               down [moe_inter, d]} a held expert, in ``held_experts`` order
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from vantage6_tpu_torch.core.mesh import resolve_device
from vantage6_tpu_torch.ops.flash_attention import (
    flash_attention,
    recompute_attention,
)
from vantage6_tpu_torch.runtime import tracing
from vantage6_tpu_torch.runtime.tracing import phase

INIT_STD = 0.02
# the correction bias is drawn as this times N(0, 1): about a quarter of
# the spread of the initial router scores, so that it moves some choices
BIAS_STD = 0.05
# counter of the token-slots routed to each held expert (tracing.COUNTERS)
SLOTS_COUNTER = "moe.expert_slots"


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    qk_nope_dim: int = 16
    qk_rope_dim: int = 8
    v_head_dim: int = 16
    kv_lora_rank: int = 32
    n_layers: int = 3
    first_k_dense: int = 1  # leading dense layers
    dense_inter: int = 128
    moe_inter: int = 32     # one expert's SwiGLU width
    n_experts: int = 8      # the router's outputs, over every chip
    top_k: int = 3
    n_shared: int = 1       # the shared MLP is n_shared * moe_inter wide
    held_experts: tuple[int, ...] = (0, 1, 2, 3)  # the ones this layer holds
    routed_scale: float = 1.0
    rope_theta: float = 50000.0
    rms_eps: float = 1e-5
    max_len: int = 2048
    dtype: torch.dtype = torch.float32
    # "flash" (ops.flash_attention: the CUDA kernels on CUDA tensors) or
    # "recompute" (the same memory profile without a kernel)
    attention: str = "flash"

    def __post_init__(self):
        held = self.held_experts
        if len(set(held)) != len(held) or not all(
                0 <= e < self.n_experts for e in held):
            raise ValueError(f"held_experts {held} must be distinct ids in "
                             f"[0, {self.n_experts})")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} not in [1, "
                             f"{self.n_experts}]")
        if self.qk_rope_dim % 2:
            raise ValueError("qk_rope_dim must be even (RoPE turns pairs)")
        if self.attention not in ("flash", "recompute"):
            raise ValueError(
                f"attention={self.attention!r}: the MLA family runs "
                "'flash' or 'recompute'; 'ring' passes q, k and v at one "
                f"width, and MLA's q/k are {self.qk_dim} wide, its v "
                f"{self.v_head_dim}")

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def n_held(self) -> int:
        return len(self.held_experts)

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense


def param_shapes(cfg: MLAMoEConfig) -> dict[str, Any]:
    """The parameter tree's shapes (a tree of tuples)."""
    d, h = cfg.d_model, cfg.n_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    layers = []
    for i in range(cfg.n_layers):
        layer = {
            "attn_norm": (d,), "wq": (d, h * cfg.qk_dim),
            "wkv_a": (d, r + dr), "kv_norm": (r,),
            "wkv_b": (r, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
            "wo": (h * cfg.v_head_dim, d), "ffn_norm": (d,),
        }
        if cfg.is_moe(i):
            ff, shared = cfg.moe_inter, cfg.n_shared * cfg.moe_inter
            layer.update(
                shared_gate=(d, shared),
                shared_up=(d, shared), shared_down=(shared, d),
                experts=[{"gate": (d, ff), "up": (d, ff), "down": (ff, d)}
                         for _ in cfg.held_experts])
        else:
            ff = cfg.dense_inter
            layer.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
        layers.append(layer)
    return {"embed": (cfg.vocab, d), "head": (d, cfg.vocab),
            "final_norm": (d,), "layers": layers}


def _is_gain(shape: tuple) -> bool:
    return len(shape) == 1


def init_params(generator: torch.Generator, cfg: MLAMoEConfig,
                device: torch.device | str | None = None) -> dict[str, Any]:
    """Matrices 0.02 * N(0, 1) (the engine's scale), RMSNorm gains 1, in
    float32 on ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)

    def make(shape):
        if _is_gain(shape):
            return torch.ones(shape, device=device)
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (INIT_STD * x).to(device)

    return _map_shapes(make, param_shapes(cfg))


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_shapes(fn, v) for v in tree]
    return fn(tree)


def init_buffers(generator: torch.Generator, cfg: MLAMoEConfig,
                 device: torch.device | str | None = None) -> dict[str, Any]:
    """The fixed buffers outside the trained tree, one a MoE layer each:
    the router ``W_g`` [d, n_experts], ``INIT_STD`` * N(0, 1) as the
    matrices, and the ``e_score_correction_bias`` [n_experts], ``BIAS_STD``
    * N(0, 1) (a trained model's is learned by its balancing rule, which
    fine-tuning does not run)."""
    device = resolve_device(device)
    n_moe = sum(cfg.is_moe(i) for i in range(cfg.n_layers))

    def draw(std, *shape):
        return [(std * torch.randn(shape, generator=generator,
                                   device=generator.device)).to(device)
                for _ in range(n_moe)]

    return {"router": draw(INIT_STD, cfg.d_model, cfg.n_experts),
            "score_bias": draw(BIAS_STD, cfg.n_experts)}


# ------------------------------------------------------------------ pieces
def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its statistics and gain in f32, returned in x's
    dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * gain).to(x.dtype)


def rope_tables(t: int, dim: int, theta: float,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [T, dim / 2] in f32: position p, pair i turns by
    p * theta^(-2i / dim)."""
    inv_freq = theta ** (-torch.arange(0, dim, 2, device=device,
                                       dtype=torch.float32) / dim)
    angle = torch.arange(t, device=device, dtype=torch.float32)[:, None] \
        * inv_freq[None]
    return torch.cos(angle), torch.sin(angle)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, H, dim] with each interleaved pair (x[2i], x[2i+1])
    turned by its angle, in f32, returned in x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    c, s = cos[:, None], sin[:, None]  # over the heads
    out = torch.stack((x0 * c - x1 * s, x0 * s + x1 * c), dim=-1)
    return out.flatten(-2).to(x.dtype)


def swiglu(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           attention: str) -> torch.Tensor:
    """Causal attention of q, k [B, T, H, Dqk] and v [B, T, H, Dv] ->
    [B, T, H, Dv], scale Dqk^-0.5. The kernels take one width, so the
    narrower side is zero-padded to the wider and the output sliced."""
    dqk, dv = q.shape[-1], v.shape[-1]
    width = max(dqk, dv)

    def head_major(z):
        z = F.pad(z, (0, width - z.shape[-1]))
        return z.transpose(1, 2).contiguous()

    impl = flash_attention if attention == "flash" else recompute_attention
    o = impl(head_major(q), head_major(k), head_major(v), causal=True,
             scale=dqk ** -0.5)
    return o[..., :dv].transpose(1, 2)


def mla(h: torch.Tensor, layer: dict, cfg: MLAMoEConfig, cos, sin,
        cast) -> torch.Tensor:
    """Latent attention of ``h`` [B, T, d] (already normed)."""
    b, t, _ = h.shape
    nh, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (h @ cast(layer["wq"])).view(b, t, nh, cfg.qk_dim)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c_kv, k_pe = (h @ cast(layer["wkv_a"])).split([cfg.kv_lora_rank, dr],
                                                  dim=-1)
    c_kv = rms_norm(c_kv, layer["kv_norm"], cfg.rms_eps)
    kv = (c_kv @ cast(layer["wkv_b"])).view(b, t, nh, dn + cfg.v_head_dim)
    k_nope, v = kv.split([dn, cfg.v_head_dim], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
    k_pe = apply_rope(k_pe[:, :, None], cos, sin).expand(b, t, nh, dr)
    k = torch.cat([k_nope, k_pe], dim=-1)
    o = attend(q, k, v, cfg.attention)
    return o.reshape(b, t, nh * cfg.v_head_dim) @ cast(layer["wo"])


# ------------------------------------------------------------------ experts
def route(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          cfg: MLAMoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(the chosen experts [N, top_k], global ids; their weights [N,
    top_k], f32) of the tokens ``h`` [N, d]: sigmoid scores in f32 over
    every expert, chosen by score + bias, weighted by the unbiased
    scores."""
    scores = torch.sigmoid(h.float() @ router)
    choice = torch.topk(scores + bias, cfg.top_k, dim=-1,
                        sorted=False).indices
    weights = scores.gather(-1, choice)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return choice, weights * cfg.routed_scale


@functools.lru_cache(maxsize=16)
def _held_lookup(held: tuple[int, ...], n_experts: int,
                 device: torch.device) -> torch.Tensor:
    """[n_experts] int64: each expert's place among the held ones,
    ``len(held)`` for an expert held elsewhere."""
    lookup = torch.full((n_experts,), len(held), dtype=torch.int64)
    lookup[list(held)] = torch.arange(len(held))
    return lookup.to(device)


def held_slots(choice: torch.Tensor, cfg: MLAMoEConfig
               ) -> tuple[torch.Tensor, list[int], torch.Tensor]:
    """(the token-slots ``choice.reshape(-1)`` routes to held experts,
    grouped by held expert in ``held_experts`` order; how many each held
    expert takes, on the host; the same counts on the device)."""
    lookup = _held_lookup(cfg.held_experts, cfg.n_experts, choice.device)
    local = lookup[choice.reshape(-1)]
    order = torch.argsort(local, stable=True)
    counts = torch.bincount(local, minlength=cfg.n_held + 1)[:cfg.n_held]
    sizes = counts.tolist()  # the layer's one read on the host
    return order[:sum(sizes)], sizes, counts


class _HeldExperts(torch.autograd.Function):
    """The held experts' weighted sum for every token: ``h`` [N, d]
    gathered at ``tok`` (the slots' tokens, grouped by expert, ``sizes``
    of them each); for each expert e its rows' ``silu(x G_e) * (x U_e)``
    times ``D_e``; each row times its slot's weight ``slot_w`` and added
    onto its token in f32. Returns the [N, d] f32 sum.

    Nothing the size of the slots is kept for the backward (only ``tok``
    and ``slot_w``): it gathers each expert's rows again and recomputes
    their ``x G_e`` and ``x U_e``, so the memory a station holds does not
    follow the routing, and its transients are one expert's at a time."""

    @staticmethod
    def forward(ctx, h, tok, slot_w, sizes, *weights):
        gates, ups, downs = weights[0::3], weights[1::3], weights[2::3]
        spans = _spans(sizes)
        xs = h.index_select(0, tok)
        with phase("moe.experts"):
            y = xs.new_empty(xs.shape)
            for e, (lo, hi) in enumerate(spans):
                a = F.silu(xs[lo:hi] @ gates[e]) * (xs[lo:hi] @ ups[e])
                torch.matmul(a, downs[e], out=y[lo:hi])
        with phase("moe.combine"):
            routed = torch.zeros(h.shape, device=h.device)
            for lo, hi in spans:
                routed.index_add_(0, tok[lo:hi],
                                  y[lo:hi].float() * slot_w[lo:hi, None])
        ctx.save_for_backward(h, tok, slot_w, *weights)
        ctx.spans = spans
        return routed

    @staticmethod
    def backward(ctx, d_routed):
        h, tok, slot_w, *weights = ctx.saved_tensors
        gates, ups, downs = weights[0::3], weights[1::3], weights[2::3]
        grads = [None] * len(weights)
        dh = torch.zeros(h.shape, device=h.device)
        dw = torch.empty_like(slot_w)
        for e, (lo, hi) in enumerate(ctx.spans):
            t, w = tok[lo:hi], slot_w[lo:hi, None]
            x = h.index_select(0, t)
            g_out = d_routed.index_select(0, t)
            with phase("moe.experts_bwd"):
                g, u = x @ gates[e], x @ ups[e]
                a = F.silu(g) * u
                dy = (g_out * w).to(x.dtype)
                grads[3 * e + 2] = a.T @ dy
                # d/da of the weighted row, before its weight
                da = (g_out.to(x.dtype) @ downs[e].T).float()
                dw[lo:hi] = (a.float() * da).sum(-1)
                da = da * w
                gf = g.float()
                sig = torch.sigmoid(gf)
                dg = (da * u.float() * sig * (1 + gf * (1 - sig))).to(x.dtype)
                du = (da * gf * sig).to(x.dtype)
                grads[3 * e] = x.T @ dg
                grads[3 * e + 1] = x.T @ du
                dx = dg @ gates[e].T
                dx.addmm_(du, ups[e].T)
            dh.index_add_(0, t, dx.float())
        return (dh.to(h.dtype), None, dw, None, *grads)


def _spans(sizes: list[int]) -> list[tuple[int, int]]:
    out, lo = [], 0
    for n in sizes:
        out.append((lo, lo + n))
        lo += n
    return out


def moe(h: torch.Tensor, layer: dict, router: torch.Tensor,
        bias: torch.Tensor, cfg: MLAMoEConfig, cast) -> torch.Tensor:
    """The held experts' share of the MoE layer plus the shared MLP, for
    ``h`` [N, d] (already normed)."""
    with phase("moe.route"):
        choice, weights = route(h, router, bias, cfg)
        sel, sizes, counts = held_slots(choice, cfg)
        tok = sel // cfg.top_k
        slot_w = weights.reshape(-1)[sel]
        tracing.COUNTERS.add(SLOTS_COUNTER, counts)
    weights_bf = [cast(w) for ex in layer["experts"]
                  for w in (ex["gate"], ex["up"], ex["down"])]
    routed = _HeldExperts.apply(h, tok, slot_w, sizes, *weights_bf)
    shared = swiglu(h, cast(layer["shared_gate"]), cast(layer["shared_up"]),
                    cast(layer["shared_down"]))
    return routed.to(h.dtype) + shared


# ------------------------------------------------------------------ model
def forward_local(params: dict[str, Any], tokens_local: torch.Tensor,
                  cfg: MLAMoEConfig, buffers: dict[str, Any]) -> torch.Tensor:
    """Logits [B, T, V] of a station's sequences ``tokens_local`` [B, T]."""
    tokens_local = tokens_local.long()
    b, t = tokens_local.shape

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(cfg.dtype)

    cos, sin = rope_tables(t, cfg.qk_rope_dim, cfg.rope_theta,
                           tokens_local.device)
    x = params["embed"][tokens_local].to(cfg.dtype)
    moe_buffers = zip(buffers["router"], buffers["score_bias"], strict=True)
    for i, layer in enumerate(params["layers"]):
        x = x + mla(rms_norm(x, layer["attn_norm"], cfg.rms_eps), layer,
                    cfg, cos, sin, cast)
        h = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        if cfg.is_moe(i):
            ffn = moe(h.reshape(b * t, -1), layer, *next(moe_buffers), cfg,
                      cast).view(b, t, -1)
        else:
            ffn = swiglu(h, cast(layer["w_gate"]), cast(layer["w_up"]),
                         cast(layer["w_down"]))
        x = x + ffn
    return rms_norm(x, params["final_norm"], cfg.rms_eps) @ cast(
        params["head"])


def loss_local(params: dict[str, Any], tokens_local: torch.Tensor,
               cfg: MLAMoEConfig, buffers: dict[str, Any]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens_local`` [B, T], in f32
    (T - 1 predictions a sequence)."""
    tokens_local = tokens_local.long()
    logits = forward_local(params, tokens_local, cfg, buffers)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens_local[:, 1:, None])
    return nll.sum() / nll.numel()
