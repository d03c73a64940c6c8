"""Ring attention: exact attention over sequence shards.

Counterpart of ``vantage6_tpu/parallel/ring_attention.py``. There the
sequence is sharded over a mesh axis and, inside ``shard_map``, each of P
hops rotates the K/V shard to the next device with ``lax.ppermute`` while
the queries stay put; the softmax is accumulated online (streaming
log-sum-exp), so the result is exact attention.

On one card (``ring_attention_stacked``, behind ``ring_attention_sharded``)
the ``shard_map`` body runs over every shard at once: q, k and v are
stacked by shard, ``[P, B, T/P, H, D]``, every hop is one batched
product over the P shards, and the ``ppermute`` to neighbour i + 1 is a
``torch.roll`` of K/V on the shard axis (at hop ``hop`` shard i holds the
block of shard ``(i - hop) % P``). The numerics are the reference's: an
additive mask (0 or ``NEG_INF``), the running max floored at -1e20, f32
accumulators whatever the input dtype, p cast to v's dtype before p.v, and
every hop taken, fully masked blocks included (such a hop adds exactly
nothing). The gradient flows through the hop loop under autograd, as the
reference's flows through ``lax.scan``.

Across ranks, ``ring_attention(q, k, v, group)`` is the reference's
per-shard form: each rank holds its ``[B, T/P, H, D]`` shard and every hop
sends its K/V block to rank ``(r + 1) % P`` and receives rank
``(r - 1) % P``'s (``dist.batch_isend_irecv``), the next hop's exchange
posted before this hop's products so the transfer overlaps them. The hop
math is the same ``_block_attention``. Send and receive carry no gradient,
so the exchange is an autograd function whose backward sends the K/V
gradients the inverse way, to ``(r - 1) % P``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum with float32 accumulation from native-dtype inputs (the
    ``preferred_element_type=f32`` of the JAX code): bf16 -> f32 is exact,
    so every product is exact and only the summation order differs."""
    return torch.einsum(eq, a.float(), b.float())


def _block_attention(
    q: torch.Tensor,  # [..., Tq, H, D]
    k: torch.Tensor,  # [..., Tk, H, D]
    v: torch.Tensor,  # [..., Tk, H, D]
    m: torch.Tensor,  # [..., H, Tq]     running max
    l: torch.Tensor,  # [..., H, Tq]     running denominator
    o: torch.Tensor,  # [..., Tq, H, D]  running numerator
    mask: torch.Tensor | None,  # additive (0 / NEG_INF), broadcast to
                                # the scores [..., H, Tq, Tk]
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's contribution folded into the online-softmax
    accumulators, which are float32 whatever the q/k/v dtype."""
    scores = _f32_einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        scores = scores + mask
    block_max = torch.amax(scores, dim=-1)  # [..., H, Tq]
    # finite floor: a fully-masked block must contribute exp(-huge) = 0,
    # not exp(NEG_INF - NEG_INF) = 1
    m_new = torch.clamp_min(torch.maximum(m, block_max), -1e20)
    corr = torch.exp(m - m_new)  # correction for the terms so far
    p = torch.exp(scores - m_new[..., None])  # [..., H, Tq, Tk] f32
    l_new = l * corr + p.sum(-1)
    pv = _f32_einsum("...hqk,...khd->...qhd", p.to(v.dtype), v)
    o_new = o * corr.transpose(-1, -2)[..., None] + pv
    return m_new, l_new, o_new


def _post_shift(tensors: list[torch.Tensor], group: Any,
                shift: int) -> tuple[list[torch.Tensor], tuple]:
    """Post the send of each tensor to the rank ``shift`` ahead in
    ``group`` and the receive of its counterpart from the rank ``shift``
    behind; returns the receive buffers and what ``_wait`` takes (the
    requests, and the sent buffers, held until the sends complete)."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % p)
    src = dist.get_global_rank(group, (r - shift) % p)
    tensors = [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in tensors]
           + [dist.P2POp(dist.irecv, b, src, group) for b in recv])
    return recv, (dist.batch_isend_irecv(ops), tensors)


def _wait(pending: tuple) -> None:
    for req in pending[0]:
        req.wait()


def _shift(tensors: list[torch.Tensor], group: Any,
           shift: int) -> list[torch.Tensor]:
    recv, pending = _post_shift(tensors, group, shift)
    _wait(pending)
    return recv


class _RingHop(torch.autograd.Function):
    """K/V received from rank r - 1 (``k_recv``, ``v_recv``, exchanged
    before this call) as the differentiable image of the K/V this rank
    sent (``k``, ``v``). The gradient of what was received belongs to the
    rank that sent it: backward sends it to rank r - 1 and receives, for
    ``k`` and ``v``, the gradients rank r + 1 computed."""

    @staticmethod
    def forward(ctx, k, v, k_recv, v_recv, group):
        ctx.group = group
        return k_recv, v_recv

    @staticmethod
    def backward(ctx, g_k, g_v):
        g_k, g_v = _shift([g_k, g_v], ctx.group, -1)
        return g_k, g_v, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Any,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded across the ranks of
    ``group`` (a ``torch.distributed`` process group of P ranks).

    Every rank calls it with ``q, k, v: [B, T/P, H, D]``, its shard in
    contiguous block layout (rank i holds global positions ``[i*T/P,
    (i+1)*T/P)``), and gets its shard's ``[B, T/P, H, D]`` output after P
    hops. Differentiable: the K/V gradients travel back around the ring."""
    n_shards, me = dist.get_world_size(group), dist.get_rank(group)
    _, t_local, _, d = q.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    pos = torch.arange(t_local, device=q.device)
    q_pos = me * t_local + pos  # global query positions

    # accumulators in f32 whatever the input dtype (see _block_attention)
    m = q.new_full((q.shape[0], q.shape[2], t_local), NEG_INF,
                   dtype=torch.float32)  # [B, H, Tq]
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for hop in range(n_shards):
        last = hop + 1 == n_shards
        if not last:
            # the next hop's blocks travel while this hop's products run
            recv, pending = _post_shift([k_cur.detach(), v_cur.detach()],
                                        group, 1)
        if causal:
            src = (me - hop) % n_shards  # whose block we now hold
            k_pos = src * t_local + pos
            mask = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                               NEG_INF)
        else:
            mask = None
        m, l, o = _block_attention(q, k_cur, v_cur, m, l, o, mask, scale)
        if not last:
            _wait(pending)
            k_cur, v_cur = _RingHop.apply(k_cur, v_cur, *recv, group)
    denom = torch.where(l > 0, l, 1.0).transpose(-1, -2)[..., None]
    return (o / denom).to(q.dtype)


def ring_attention_stacked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact attention over P sequence shards stacked on the leading axis.

    ``q, k, v: [P, B, T/P, H, D]`` in contiguous block layout (shard i
    holds global positions ``[i*T/P, (i+1)*T/P)``). Returns the shards'
    ``[P, B, T/P, H, D]`` attention output after P hops."""
    n_shards, _, t_local, _, d = q.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    dev = q.device
    shard = torch.arange(n_shards, device=dev)
    pos = torch.arange(t_local, device=dev)
    q_pos = shard[:, None] * t_local + pos  # [P, Tq] global positions

    # accumulators in f32 whatever the input dtype (see _block_attention)
    m = q.new_full((*q.shape[:2], q.shape[3], t_local), NEG_INF,
                   dtype=torch.float32)  # [P, B, H, Tq]
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for hop in range(n_shards):
        if causal:
            src = (shard - hop) % n_shards  # whose block each shard holds
            k_pos = src[:, None] * t_local + pos  # [P, Tk]
            visible = q_pos[:, :, None] >= k_pos[:, None, :]
            mask = torch.where(visible, 0.0, NEG_INF)[:, None, None]
        else:
            mask = None
        m, l, o = _block_attention(q, k_cur, v_cur, m, l, o, mask, scale)
        if hop + 1 < n_shards:
            # ppermute to neighbour i + 1 (the reference's last exchange
            # is discarded, so it is not made)
            k_cur = torch.roll(k_cur, 1, dims=0)
            v_cur = torch.roll(v_cur, 1, dims=0)
    # normalise; fully-masked rows (impossible for causal contiguous
    # layouts, guarded anyway) yield zeros, not NaN
    denom = torch.where(l > 0, l, 1.0).transpose(-1, -2)[..., None]
    return (o / denom).to(q.dtype)


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Monolithic attention (``[B, T, H, D]``): the correctness oracle."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    shards: int,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Full ``[B, T, H, D]`` in, the ring over ``shards`` contiguous
    sequence shards inside, ``[B, T, H, D]`` out."""
    b, t, h, d = q.shape
    if t % shards:
        raise ValueError(
            f"sequence length {t} is not divisible by {shards} shards"
        )

    def split(x: torch.Tensor) -> torch.Tensor:  # -> [P, B, T/P, H, D]
        return x.reshape(b, shards, t // shards, h, d).transpose(0, 1)

    out = ring_attention_stacked(split(q), split(k), split(v), causal,
                                 scale)
    return out.transpose(0, 1).reshape(b, t, h, d)
