"""Federated causal-LM training on one GPU: stations x a decoder transformer.

Counterpart of ``vantage6_tpu/workloads/fed_transformer.py``. Each station
trains on its own token shard; per-station gradients are taken in isolation
(one backward per station), then aggregated by the masked, weighted
``fed_mean`` — the only place station data mixes — and the server steps the
shared model with Adam.

Attention is ``"flash"`` (the hand-written CUDA kernel, ops.flash_attention;
its plain version on CPU tensors) or ``"recompute"`` (the same memory
profile without a kernel, ops.recompute_attention). ``"ring"`` (sequence
parallelism across devices) is not ported yet; see ROADMAP.md.

Parameters keep the JAX layout (``qkv`` is ``[d, 3d]`` used as ``h @ W``),
so ``params_from_jax``/``params_to_numpy`` move weights across without a
transpose.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vantage6_tpu_torch._tree import tree_leaves, tree_map
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import collectives
from vantage6_tpu_torch.ops.flash_attention import (
    flash_attention,
    recompute_attention,
)
from vantage6_tpu_torch.optim import Adam, adam, apply_updates


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
    # "flash": the CUDA flash kernel (ops.flash_attention). "recompute":
    # flash-memory attention without a kernel (ops.recompute_attention).
    # "ring" is the JAX package's sequence-parallel path, not ported yet.
    attention: str = "ring"
    # Drop every layer's activations on the forward pass and recompute them
    # during backward (torch.utils.checkpoint per layer block).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: torch.device | str = "cpu") -> dict[str, Any]:
    """Same shapes and scale (0.02 * N(0, 1)) as the JAX ``init_params``,
    drawn from ``generator`` (its own stream: jax.random cannot be
    reproduced), in float32 on ``device``."""
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


def forward_local(
    params: dict[str, Any],
    tokens_local: torch.Tensor,  # [B, T]
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Logits [B, T, V] for the full sequence on this device."""
    b, t_local = tokens_local.shape

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(cfg.dtype)

    tokens_local = tokens_local.long()
    x = cast(params["embed"])[tokens_local]
    x = x + cast(params["pos"][:t_local])[None]

    if cfg.attention == "flash":
        attend = flash_attention
    elif cfg.attention == "recompute":
        attend = recompute_attention
    else:
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported yet (ROADMAP.md)"
        )

    def heads(z: torch.Tensor) -> torch.Tensor:  # [B, T, d] -> [B, H, T, Dh]
        z = z.reshape(b, t_local, cfg.n_heads, cfg.head_dim)
        return z.transpose(1, 2).contiguous()

    def layer_block(x, *layer_leaves):
        qkv_w, proj, w_up, w_down = (cast(w) for w in layer_leaves)
        h = _ln(x)
        q, k, v = (h @ qkv_w).split(cfg.d_model, dim=-1)
        attn = attend(heads(q), heads(k), heads(v), causal=True)
        x = x + attn.transpose(1, 2).reshape(b, t_local, cfg.d_model) @ proj
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
) -> torch.Tensor:
    """Mean next-token cross-entropy: position t predicts t+1."""
    tokens_local = tokens_local.long()
    logits = forward_local(params, tokens_local, cfg)
    targets = tokens_local[:, 1:]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.sum() / nll.numel()


@dataclasses.dataclass(eq=False)
class FedTransformer:
    """Training engine over a one-GPU FederationMesh."""

    mesh: FederationMesh
    cfg: TransformerConfig
    optimizer: Adam

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def init(self, generator: torch.Generator | int) -> tuple[Any, Any]:
        """Parameters from ``generator`` (or a seed) and the Adam state."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        params = init_params(generator, self.cfg, self.device)
        return params, self.optimizer.init(params)

    def shard_tokens(self, tokens: np.ndarray | torch.Tensor) -> torch.Tensor:
        """[S, B, T] token ids on the device."""
        t = tokens.shape[-1]
        if t > self.cfg.max_len:
            raise ValueError(
                f"sequence length {t} exceeds cfg.max_len={self.cfg.max_len}"
            )
        return torch.as_tensor(np.asarray(tokens)).to(self.device).long()

    def station_grads(self, params: Any,
                      tokens: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Per-station (loss, grads), each station's backward taken alone,
        stacked on a leading [S] axis."""

        def one_station(tok, params):
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = loss_local(leaves, tok, self.cfg)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
            return loss.detach(), _unflatten(params, list(grads))

        return self.mesh.fed_map(one_station, tokens,
                                 replicated_args=(params,))

    def round(
        self,
        params: Any,
        opt_state: Any,
        tokens: torch.Tensor,  # [S, B, T]
        mask: Any,  # [S] participation
    ) -> tuple[Any, Any, torch.Tensor]:
        """One federated round: per-station grads, FedAvg, Adam step."""
        mask = torch.as_tensor(mask, device=self.device)
        losses, grads = self.station_grads(params, tokens)
        # explicit cross-station aggregation: the ONLY place station data mixes
        g_mean = collectives.fed_mean(grads, mask=mask)
        updates, opt_state = self.optimizer.update(g_mean, opt_state, params)
        params = apply_updates(params, updates)
        loss = collectives.fed_mean(losses, mask=mask)
        return params, opt_state, loss


def _unflatten(like: Any, leaves: list[torch.Tensor]) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_engine(
    n_stations: int,
    seq_devices: int,
    cfg: TransformerConfig | None = None,
    lr: float = 1e-3,
    device: str | torch.device | None = None,
) -> FedTransformer:
    """The engine on one card (``device``; CUDA unless ``"cpu"`` is asked
    for). The S stations fold into the single device slot."""
    cfg = cfg or TransformerConfig()
    if cfg.attention in ("flash", "recompute") and seq_devices != 1:
        raise ValueError(
            f"attention={cfg.attention!r} needs the full sequence per "
            f"device (seq_devices == 1, got {seq_devices}); use 'ring' for "
            "sequence-parallel runs"
        )
    if cfg.attention not in ("flash", "recompute"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported to the PyTorch "
            "package yet; it is queued in ROADMAP.md (use 'flash' or "
            "'recompute')"
        )
    mesh = FederationMesh(n_stations, device=device)
    return FedTransformer(mesh=mesh, cfg=cfg, optimizer=adam(lr))


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
