"""Federated causal-LM training: stations x a decoder transformer.

Counterpart of ``vantage6_tpu/workloads/fed_transformer.py``. Each station
trains on its own token shard; per-station gradients are taken in isolation
(one backward per station), then aggregated by the masked, weighted
``fed_mean`` — the only place station data mixes — and the server steps the
shared model with Adam.

Attention is ``"ring"`` (the default, as in the reference: exact attention
over ``seq_devices`` sequence shards, parallel.ring_attention),
``"flash"`` (the hand-written CUDA kernel, ops.flash_attention; its plain
version on CPU tensors) or ``"recompute"`` (the same memory profile
without a kernel, ops.recompute_attention). The last two need the full
sequence, ``seq_devices == 1``.

On one card (``make_engine`` without a group) the stations fold into one
slot and each station's ``seq_devices`` sequence shards are laid out on
the card. Over a ``torch.distributed`` group of W ranks the engine takes
the reference's (station, seq) layout: ``FederationMesh(n_stations,
group=, devices_per_station=seq_devices)``, W / seq_devices station slots
with the stations packed into them as ``fed_map`` packs them, and the
``seq_devices`` ranks of a slot (its ``device_group``) holding one
sequence shard each. Each rank then attends through the per-rank ring
(``ring_attention(q, k, v, device_group)``), sums the loss's nll and
count over ``device_group``, and all-reduces the station's gradients over
it, as the reference psums them; the stations' gradients are aggregated
over ``station_group``.

The ring path keeps the reference's bookkeeping at ``seq_devices = P``:
positions by global offset, each shard's last position without a target
(T - P predictions a sequence), and an aggregated gradient of P times the
gradient of that loss (see ``FedTransformer.station_grads``).

Under a profiler a round names its parts (``runtime.tracing.phase``):
each station's ``fed.forward`` and ``fed.backward``, then
``fed.aggregate`` and ``server.update``.

The engine runs two model families. ``TransformerConfig`` is GPT-2's
decoder, defined here. ``models.mla_moe.MLAMoEConfig`` is DeepSeek-V3's
block (latent attention, a sigmoid-routed mixture of experts of which the
layer holds a share), on one card with ``seq_devices == 1``; its fixed
buffers (the router and its correction bias) ride the engine as
``buffers``, outside the trained tree. Both share the round: per-station gradients,
``fed_mean``, Adam.

Parameters keep the JAX layout (``qkv`` is ``[d, 3d]`` used as ``h @ W``),
so ``params_from_jax``/``params_to_numpy`` move weights across without a
transpose.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vantage6_tpu_torch._tree import tree_leaves, tree_map, tree_unflatten
from vantage6_tpu_torch.core.mesh import FederationMesh, resolve_device
from vantage6_tpu_torch.fed import collectives
from vantage6_tpu_torch.models import mla_moe
from vantage6_tpu_torch.ops.flash_attention import (
    flash_attention,
    recompute_attention,
)
from vantage6_tpu_torch.optim import Adam, adam, apply_updates
from vantage6_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_sharded,
)
from vantage6_tpu_torch.runtime.tracing import phase


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    max_len: int = 2048
    # Mixed precision: params/optimizer stay float32 (master weights); all
    # matmuls run in `dtype`. Softmax statistics, layernorm and the loss
    # stay f32 either way.
    dtype: torch.dtype = torch.float32
    # "ring": exact ring attention over the sequence shards
    # (parallel.ring_attention; any seq_devices). "flash": the CUDA flash
    # kernel (ops.flash_attention). "recompute": flash-memory attention
    # without a kernel (ops.recompute_attention). The last two need
    # seq_devices == 1 (enforced by make_engine).
    attention: str = "ring"
    # Drop every layer's activations on the forward pass and recompute them
    # during backward (torch.utils.checkpoint per layer block).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: torch.device | str | None = None) -> dict[str, Any]:
    """Same shapes and scale (0.02 * N(0, 1)) as the JAX ``init_params``,
    drawn from ``generator`` (its own stream: jax.random cannot be
    reproduced), in float32 on ``device`` (CUDA unless ``"cpu"`` is asked
    for)."""
    device = resolve_device(device)
    s = 0.02

    def normal(*shape):
        x = torch.randn(shape, generator=generator,
                        device=generator.device)
        return (s * x).to(device)

    params: dict[str, Any] = {
        "embed": normal(cfg.vocab, cfg.d_model),
        "pos": normal(cfg.max_len, cfg.d_model),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "qkv": normal(cfg.d_model, 3 * cfg.d_model),
            "proj": normal(cfg.d_model, cfg.d_model),
            "w_up": normal(cfg.d_model, 4 * cfg.d_model),
            "w_down": normal(4 * cfg.d_model, cfg.d_model),
        })
    return params


def params_from_jax(tree: Any, device: torch.device | str) -> Any:
    """A JAX parameter tree (of numpy or jax arrays) as float32 tensors on
    ``device`` — same layout, no transposes."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, np.float32)).to(device), tree
    )


def params_to_numpy(params: Any) -> Any:
    """The parameter tree as float32 numpy arrays (for JAX, or a file)."""
    return tree_map(lambda x: x.detach().float().cpu().numpy(), params)


def _ln(x: torch.Tensor) -> torch.Tensor:
    # population variance, rsqrt(var + 1e-6), no affine parameters;
    # statistics in f32 even under bf16 compute
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _sequence_group(group: Any) -> tuple[int, int]:
    """(shards, this rank's shard) of a sequence split over ``group``;
    (1, 0) without one."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def forward_local(
    params: dict[str, Any],
    tokens_local: torch.Tensor,  # [B, T] (over a group: [B, T/P])
    cfg: TransformerConfig,
    seq_shards: int = 1,
    group: Any = None,
) -> torch.Tensor:
    """Logits [B, T, V] for a station's full sequence. Under ``"ring"``
    the sequence is ``seq_shards`` contiguous shards whose attention spans
    the whole sequence through the ring; every other layer acts on each
    position alone, so it runs on the sequence unsplit, with each shard's
    positions at its global offset. With ``group`` (the P ranks of a
    station's sequence, ``"ring"`` only) ``tokens_local`` is this rank's
    shard, its positions at the shard's offset, and the ring runs across
    the ranks: logits [B, T/P, V] for the shard."""
    b, t_local = tokens_local.shape
    _, shard = _sequence_group(group)

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(cfg.dtype)

    tokens_local = tokens_local.long()
    x = cast(params["embed"])[tokens_local]
    offset = shard * t_local
    x = x + cast(params["pos"][offset:offset + t_local])[None]

    def heads(z: torch.Tensor) -> torch.Tensor:  # [B, T, d] -> [B, T, H, Dh]
        return z.reshape(b, t_local, cfg.n_heads, cfg.head_dim)

    def attend(q, k, v):  # [B, T, H, Dh] each -> [B, T, H, Dh]
        if cfg.attention == "ring" and group is not None:
            return ring_attention(q, k, v, group, causal=True)
        if cfg.attention == "ring":
            return ring_attention_sharded(q, k, v, seq_shards, causal=True)
        impl = (flash_attention if cfg.attention == "flash"
                else recompute_attention)
        # both want head-major [B, H, T, Dh]
        q, k, v = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        return impl(q, k, v, causal=True).transpose(1, 2)

    def layer_block(x, *layer_leaves):
        qkv_w, proj, w_up, w_down = (cast(w) for w in layer_leaves)
        h = _ln(x)
        q, k, v = (h @ qkv_w).split(cfg.d_model, dim=-1)
        attn = attend(heads(q), heads(k), heads(v))
        x = x + attn.reshape(b, t_local, cfg.d_model) @ proj
        h = _ln(x)
        return x + F.gelu(h @ w_up, approximate="tanh") @ w_down

    for layer in params["layers"]:
        leaves = (layer["qkv"], layer["proj"], layer["w_up"], layer["w_down"])
        if cfg.remat:
            x = checkpoint(layer_block, x, *leaves, use_reentrant=False)
        else:
            x = layer_block(x, *leaves)
    return _ln(x) @ cast(params["embed"]).T


def loss_local(
    params: dict[str, Any],
    tokens_local: torch.Tensor,
    cfg: TransformerConfig,
    seq_shards: int = 1,
    group: Any = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy over all shards of the sequence.

    Within a shard, position t predicts t+1; each shard's final token has
    its target on the next shard, so that position has no prediction, as
    in the reference (T/P - 1 predictions a shard). With ``group`` (the
    ranks of the station's sequence) ``tokens_local`` is this rank's
    shard, and the nll's sum and count are summed over the group, as the
    reference's ``loss_local`` psums them
    (``vantage6_tpu/workloads/fed_transformer.py:188-192``): a
    differentiable all-reduce, whose backward all-reduces the cotangents,
    as the psum transposes to a psum there."""
    tokens_local = tokens_local.long()
    b, t = tokens_local.shape
    if group is not None:
        seq_shards = 1
    logits = forward_local(params, tokens_local, cfg, seq_shards, group)
    shape = (b, seq_shards, t // seq_shards)
    logits = logits.reshape(*shape, -1)
    targets = tokens_local.reshape(shape)[..., 1:]
    logp = torch.log_softmax(logits[..., :-1, :].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if group is None:
        return nll.sum() / nll.numel()
    total = dist_fn.all_reduce(nll.sum(), group=group)
    count = dist_fn.all_reduce(nll.new_full((), nll.numel()), group=group)
    return total / count


@dataclasses.dataclass(eq=False)
class FedTransformer:
    """Training engine over a FederationMesh: one card, or a mesh over a
    process group whose slots are ``seq_devices`` ranks each."""

    mesh: FederationMesh
    cfg: TransformerConfig | mla_moe.MLAMoEConfig
    optimizer: Adam
    seq_devices: int = 1  # sequence shards of each station's sequences
    # the MLA family's fixed buffers (``mla_moe.init_buffers``); None for
    # GPT-2's
    buffers: Any = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def init(self, generator: torch.Generator | int) -> tuple[Any, Any]:
        """Parameters from ``generator`` (or a seed) and the Adam state."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        init = (mla_moe.init_params
                if isinstance(self.cfg, mla_moe.MLAMoEConfig)
                else init_params)
        params = init(generator, self.cfg, self.device)
        return params, self.optimizer.init(params)

    def shard_tokens(self, tokens: np.ndarray | torch.Tensor) -> torch.Tensor:
        """[S, B, T] token ids on the device; over a group, this rank's
        ``[S_local, B, T/P]`` block: its stations' rows, its sequence
        shard's positions."""
        t = tokens.shape[-1]
        if t > self.cfg.max_len:
            raise ValueError(
                f"sequence length {t} exceeds cfg.max_len={self.cfg.max_len}"
            )
        if t % self.seq_devices:
            raise ValueError(
                f"sequence length {t} is not divisible by "
                f"seq_devices={self.seq_devices}"
            )
        tokens = torch.as_tensor(np.asarray(tokens))
        if self.mesh.group is not None:
            # the slot's ranks split the sequences (none at one a slot)
            shards, shard = _sequence_group(self.mesh.device_group)
            width = t // shards
            rows = self.mesh.local_stations
            tokens = tokens[rows.start:rows.stop, :,
                            shard * width:(shard + 1) * width]
        return tokens.to(self.device).long()

    def station_grads(self, params: Any,
                      tokens: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Per-station (loss, grads), each station's backward taken alone,
        stacked on a leading [S] axis.

        At ``seq_devices = P`` each station's gradient is P times the
        gradient of its loss, as the reference's is: its ``loss_local``
        psums the loss over the sequence shards
        (``vantage6_tpu/workloads/fed_transformer.py:190-191``), the psum
        transposes to a psum under ``shard_map``, and ``round`` then psums
        the P shards' equal gradients (``:241``). The port reproduces that
        on purpose (ROADMAP.md, queue 3). Across ranks the factor comes as
        it comes there: the loss's all-reduce over the sequence's ranks
        all-reduces the cotangents in its backward, and the station's
        gradients are then all-reduced over those ranks (the reference's
        ``lax.psum(grads, SEQ_AXIS)``); the stacked values are the local
        stations' ``[S_local]``."""
        p, group = self.seq_devices, self.mesh.device_group

        def one_station(tok, params):
            leaves = tree_map(lambda x: x.detach().requires_grad_(), params)
            with phase("fed.forward"):
                if isinstance(self.cfg, mla_moe.MLAMoEConfig):
                    loss = mla_moe.loss_local(leaves, tok, self.cfg,
                                              self.buffers)
                elif group is None:
                    loss = loss_local(leaves, tok, self.cfg, p)
                else:
                    loss = loss_local(leaves, tok, self.cfg, group=group)
            with phase("fed.backward"):
                if group is None:
                    # the reference's factor P, explicitly (see the
                    # docstring)
                    grads = torch.autograd.grad(p * loss, tree_leaves(leaves))
                else:
                    grads = torch.autograd.grad(loss, tree_leaves(leaves))
                    flat = collectives.flatten_tree(list(grads))
                    dist.all_reduce(flat, group=group)
                    grads = tree_leaves(collectives.unflatten_like(
                        list(grads), flat))
            return loss.detach(), tree_unflatten(params, list(grads))

        return self.mesh.fed_map(one_station, tokens,
                                 replicated_args=(params,))

    def round(
        self,
        params: Any,
        opt_state: Any,
        tokens: torch.Tensor,  # [S, B, T]
        mask: Any,  # [S] participation
    ) -> tuple[Any, Any, torch.Tensor]:
        """One federated round: per-station grads, FedAvg, Adam step.
        Over a group ``tokens`` is this rank's block (``shard_tokens``),
        ``mask`` the global ``[S]``, and the aggregation goes over the
        station group; every rank ends with the same params."""
        mask = torch.as_tensor(mask, device=self.device)
        losses, grads = self.station_grads(params, tokens)
        # explicit cross-station aggregation: the ONLY place station data mixes
        mesh = self.mesh if self.mesh.group is not None else None
        with phase("fed.aggregate"):
            g_mean = collectives.fed_mean(grads, mask=mask, mesh=mesh)
            loss = collectives.fed_mean(losses, mask=mask, mesh=mesh)
        with phase("server.update"):
            updates, opt_state = self.optimizer.update(g_mean, opt_state,
                                                       params)
            params = apply_updates(params, updates)
        return params, opt_state, loss


def make_engine(
    n_stations: int,
    seq_devices: int,
    cfg: TransformerConfig | None = None,
    lr: float = 1e-3,
    device: str | torch.device | None = None,
    group: Any = None,
    buffers: Any = None,
) -> FedTransformer:
    """The engine on ``device`` (CUDA unless ``"cpu"`` is asked for).
    Without ``group`` the S stations fold into the card's one slot, and
    each station's ``seq_devices`` sequence shards are laid out on it.
    Over ``group`` (a ``torch.distributed`` group of W ranks, one card
    each; building it is collective, see ``FederationMesh``) the ranks
    form W / seq_devices slots of ``seq_devices`` ranks, the reference's
    (station, seq) mesh, and every rank of the group must hold a slot.

    With an ``MLAMoEConfig`` the engine runs on one card at
    ``seq_devices == 1``; ``buffers`` are its fixed buffers
    (``mla_moe.init_buffers``), drawn from seed 0 when not given."""
    cfg = cfg or TransformerConfig()
    if isinstance(cfg, mla_moe.MLAMoEConfig):
        if seq_devices != 1 or group is not None:
            raise ValueError(
                "the MLA-MoE family runs on one card with the full "
                f"sequence (seq_devices == 1, no group; got {seq_devices}, "
                f"{group!r})")
        if buffers is None:
            buffers = mla_moe.init_buffers(torch.Generator().manual_seed(0),
                                           cfg, device)
    if cfg.attention in ("flash", "recompute") and seq_devices != 1:
        raise ValueError(
            f"attention={cfg.attention!r} needs the full sequence per "
            f"device (seq_devices == 1, got {seq_devices}); use 'ring' for "
            "sequence-parallel runs"
        )
    if cfg.attention not in ("ring", "flash", "recompute"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if group is None:
        mesh = FederationMesh(n_stations, device=device)
    else:
        mesh = FederationMesh(n_stations, device=device, group=group,
                              devices_per_station=seq_devices)
        if mesh.slot is None:
            raise ValueError(
                f"rank {mesh.rank} of {mesh.world_size} holds no station: "
                f"{n_stations} stations take {mesh.station_axis_size} slots "
                f"of {seq_devices} ranks; run the engine on "
                f"{mesh.station_axis_size * seq_devices} ranks")
    return FedTransformer(mesh=mesh, cfg=cfg, optimizer=adam(lr),
                          seq_devices=seq_devices, buffers=buffers)


def make_federated_tokens(
    n_stations: int, batch: int, seq_len: int, vocab: int, seed: int = 0
) -> np.ndarray:
    """Synthetic per-station corpora with station-distinct statistics."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_stations, batch, seq_len), np.int32)
    for s in range(n_stations):
        # each station's corpus favors a distinct token range (non-IID)
        center = (s + 1) * vocab // (n_stations + 1)
        vals = rng.normal(center, vocab / 6, (batch, seq_len))
        out[s] = np.clip(np.round(vals), 0, vocab - 1)
    return out
