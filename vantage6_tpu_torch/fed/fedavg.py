"""FedAvg engine on one GPU: a federated round and its fused K-round form.

Counterpart of ``vantage6_tpu/fed/fedavg.py``. A round runs each station's
``local_steps`` of minibatch SGD from the global params (station-batched
through ``FederationMesh.fed_map(batched=True)``), aggregates the
per-station deltas with the count-weighted, masked ``fed_mean``, and steps
the server model with the server optimizer on the pseudo-gradient
(``sgd(1.0)`` by default, which is plain FedAvg).

``run_rounds`` is the fused path. The JAX package folds K rounds into one
``lax.scan`` program; here one round is captured once as a CUDA graph over
static buffers and replayed K times: each round's mask row and batch
indices are copied in, and its loss and stats copied out, on the device,
with no host sync between rounds. On the CPU the same round function runs
K times eagerly. Capture failure raises; there is no eager fallback.

With a ``compressor`` (``fed.compression``), each station's delta is
compressed with error feedback before aggregation: the aggregation consumes
the decompressed deltas, and the per-station accumulators ``[S, N]`` ride
the server state (``{"server", "ef"}``), so the fused path carries them in
the graph's buffers like any other state.

Batch indices are drawn on the device, uniform in ``[0, max(count, 1))``
per station and step, so padded rows are never drawn, from an explicit
``torch.Generator`` (jax.random's stream cannot be reproduced); with an
int8 compressor each round also draws its rounding noise ``[S, n_pad]``.
Each round draws its indices, then its noise, so K fused rounds and K
eager rounds from generators of the same seed draw the same. Every entry
point also takes the draws themselves (``batch_idx``, ``noise``), which is
how the parity tests feed both packages the same draws. The fused path
draws each round's indices and noise just before its replay, from the
host, into the graph's buffers: one round's draws are held at a time, so
its memory does not grow with K.

Not ported yet: the host telemetry and history hooks (``_record_wire``,
``_record_fused``, ``attach_history``; ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import torch
import torch.nn.functional as F

from vantage6_tpu_torch._tree import tree_leaves, tree_map
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import (
    all_gather_stations,
    fed_mean,
    fed_mean_scattered,
    flat_size,
    flatten_stacked,
    flatten_tree,
    padded_flat_size,
    per_round_masks,
    station_update_stats,
    unflatten_like,
    unflatten_stacked,
)
from vantage6_tpu_torch.fed.compression import (
    CompressorSpec,
    compress_stacked,
    draw_noise,
    noise_size,
)
from vantage6_tpu_torch.optim import apply_updates, sgd

Pytree = Any
# loss_fn(params, batch_x, batch_y, example_weights) -> scalar mean loss
LossFn = Callable[[Pytree, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]
# a generator on the engine's device, or the seed of a fresh one
Key = torch.Generator | int

# warm-up rounds on a side stream before a round is captured (lazy library
# handles and workspaces are created here, outside the capture)
WARMUP_ROUNDS = 2
# captured rounds an engine keeps, oldest evicted first (the JAX package's
# RunnerCache bound)
FUSED_CACHE_SIZE = 32


@dataclasses.dataclass(frozen=True)
class FedAvgSpec:
    loss_fn: LossFn
    local_steps: int = 1
    batch_size: int = 32
    local_lr: float = 0.1
    server_optimizer: Any = None  # default sgd(1.0)
    # ZeRO-1 server update: the pseudo-gradient and the server state are
    # flat f32 vectors. On one card the scatter and gather are the identity
    # (fed.collectives), so only the flat layout and f32 arithmetic remain.
    shard_server_update: bool = False
    # dtype the flat delta sum is rounded to, as it would cross the wire; with
    # a compressor, also the cast before quantizing (cast, then quantize)
    comm_dtype: torch.dtype | None = None
    # compression of the per-station delta uplink with error feedback
    # (fed.compression); an identity spec changes nothing
    compressor: CompressorSpec | None = None
    # per-station update norms, cosines and weights, and the pooled update
    # norm, returned as the round's 4th element ({} when off)
    learning_stats: bool = True
    # the JAX package's local-steps scan unroll; the port's local steps are
    # a Python loop, so it has no effect here
    local_unroll: int | bool = 1


@dataclasses.dataclass(frozen=True)
class AsyncRoundSpec:
    """FedBuff-style buffered-async round shape (Nguyen et al. 2022): the
    server dispatches ``quorum + over_select`` stations and aggregates the
    first ``quorum`` results; a station whose update lands late
    participates discounted by ``staleness_discount ** staleness``. The
    discount rides the participation-mask seam."""

    quorum: int                      # K: accept the first K results
    over_select: int = 1             # m: dispatch K + m stations
    staleness_discount: float = 0.5  # weight multiplier per round of staleness
    deadline_s: float = 30.0         # hard per-round wall-clock cap

    def validate(self) -> None:
        if self.quorum < 1:
            raise ValueError("AsyncRoundSpec.quorum must be >= 1")
        if self.over_select < 0:
            raise ValueError("AsyncRoundSpec.over_select must be >= 0")
        if not (0.0 < self.staleness_discount <= 1.0):
            raise ValueError(
                "AsyncRoundSpec.staleness_discount must be in (0, 1]"
            )
        if self.deadline_s <= 0:
            raise ValueError("AsyncRoundSpec.deadline_s must be > 0")

    @property
    def n_select(self) -> int:
        return self.quorum + self.over_select

    def staleness_weights(self, staleness: Any) -> torch.Tensor:
        """Per-station discount ``discount ** staleness`` (f32) for a
        ``[S]`` staleness vector."""
        stale = torch.as_tensor(staleness).to(torch.float32)
        return torch.pow(torch.full_like(stale, self.staleness_discount),
                         stale)


class FedAvg:
    """Runs federated-averaging rounds on a one-GPU FederationMesh."""

    def __init__(self, mesh: FederationMesh, spec: FedAvgSpec):
        self.mesh = mesh
        self.spec = spec
        if spec.compressor is not None:
            spec.compressor.validate()
        # an identity compressor is a no-op: skip the flat-pack round trip
        self._compressing = (spec.compressor is not None
                             and not spec.compressor.identity)
        self.server_opt = spec.server_optimizer or sgd(1.0)
        # captured rounds, keyed on their inputs' structure, shapes, dtypes;
        # at most FUSED_CACHE_SIZE, the oldest evicted first
        self._fused: dict[str, _FusedRound] = {}
        # warm-up and capture seconds of the newest captured round
        self.last_capture: dict[str, float] | None = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------ local step
    def _local_update(
        self,
        x: torch.Tensor,       # [n_pad, ...] this station's (padded) examples
        y: torch.Tensor,       # [n_pad, ...]
        idx: torch.Tensor,     # [local_steps, batch] its batch indices
        params: Pytree,        # the global model
    ) -> tuple[Pytree, torch.Tensor]:
        """``local_steps`` of minibatch SGD from the global params; returns
        (delta, mean loss). Runs per station inside ``fed_map``."""
        spec = self.spec
        w = torch.ones(spec.batch_size, dtype=torch.float32, device=x.device)
        grad_fn = torch.func.grad_and_value(spec.loss_fn)
        p, losses = params, []
        for i in range(spec.local_steps):
            grads, loss = grad_fn(p, x[idx[i]], y[idx[i]], w)
            p = tree_map(lambda a, g: a - spec.local_lr * g, p, grads)
            losses.append(loss)
        delta = tree_map(torch.sub, p, params)
        return delta, torch.stack(losses).mean()

    # ----------------------------------------------------------------- round
    def _round_impl(
        self,
        params: Pytree,
        opt_state: Any,
        stacked_x: torch.Tensor,  # [S, n_pad, ...]
        stacked_y: torch.Tensor,  # [S, n_pad, ...]
        counts: torch.Tensor,     # [S]
        mask: torch.Tensor,       # [S] participation (1.0 = in this round)
        idx: torch.Tensor,        # [S, local_steps, batch]
        noise: torch.Tensor | None = None,  # [S, n_pad] int8 rounding draws
    ):
        deltas, losses = self.mesh.fed_map(
            self._local_update, stacked_x, stacked_y, idx,
            replicated_args=(params,), batched=True,
        )
        weights = counts * mask
        # the aggregation consumes the decompressed deltas, what a server
        # reconstructs from each station's compressed uplink
        ef = flat = None
        if self._compressing:
            server_state = opt_state["server"]
            deltas, ef, flat = self._compress_deltas(deltas, opt_state["ef"],
                                                     noise, mask)
        else:
            server_state = opt_state
        stats: dict[str, Any] = {}
        if self.spec.learning_stats:
            if flat is None:
                flat = flatten_stacked(deltas)
            stats = station_update_stats(flat, weights=weights, ef=ef)
        if self.spec.shard_server_update:
            params, server_state = self._sharded_server_update(
                params, server_state, deltas, weights
            )
        else:
            mean_delta = fed_mean(deltas, weights=weights)
            # server update on the pseudo-gradient (negative mean delta)
            pseudo_grad = tree_map(torch.neg, mean_delta)
            updates, server_state = self.server_opt.update(
                pseudo_grad, server_state, params
            )
            params = apply_updates(params, updates)
        round_loss = fed_mean(losses, weights=weights)
        new_state = ({"server": server_state, "ef": ef} if self._compressing
                     else server_state)
        return params, new_state, round_loss, stats

    def _compress_deltas(
        self, deltas: Pytree, ef: torch.Tensor, noise: torch.Tensor | None,
        mask: torch.Tensor,
    ) -> tuple[Pytree, torch.Tensor, torch.Tensor]:
        """Each station's delta compressed and decompressed with error
        feedback, ``comm_dtype`` as the cast before quantizing. Returns the
        reconstructed deltas, the new EF ``[S, N]`` and the reconstructed
        flat ``[S, N]`` matrix (the learning stats reuse it).

        A masked-out station ships nothing, so its accumulator waits: its
        EF row carries over unchanged."""
        template = tree_map(lambda x: x[0], deltas)
        flat = flatten_stacked(deltas)
        _, hat, new_ef = compress_stacked(
            self.spec.compressor, flat, ef, None,
            cast_dtype=self.spec.comm_dtype, noise=noise,
        )
        new_ef = torch.where((mask != 0).reshape(-1, 1), new_ef, ef)
        return unflatten_stacked(template, hat), new_ef, hat

    def _sharded_server_update(
        self, params: Pytree, opt_state: Any, deltas: Pytree,
        weights: torch.Tensor,
    ) -> tuple[Pytree, Any]:
        """Reduce-scatter -> shard-local update -> all-gather, on one card:
        the server optimizer steps the flat padded f32 param vector."""
        mesh = self.mesh
        grad = -fed_mean_scattered(mesh, deltas, weights=weights,
                                   comm_dtype=self.spec.comm_dtype)
        flat = flatten_tree(params)
        n_pad = padded_flat_size(flat.numel(), mesh.station_axis_size)
        flat = F.pad(flat, (0, n_pad - flat.numel()))
        updates, opt_state = self.server_opt.update(grad, opt_state, flat)
        new_flat = all_gather_stations(mesh, apply_updates(flat, updates))
        return unflatten_like(params, new_flat), opt_state

    # -------------------------------------------------------------- sampling
    def _generator(self, key: Key) -> torch.Generator:
        if isinstance(key, int):
            return torch.Generator(device=self.device).manual_seed(key)
        return key

    def _draw_idx(self, counts: torch.Tensor,
                  gen: torch.Generator) -> torch.Tensor:
        """One round's ``[S, local_steps, batch]`` indices, uniform in
        ``[0, max(count, 1))`` for each station."""
        spec = self.spec
        safe = torch.clamp_min(counts.to(torch.int64), 1).reshape(-1, 1, 1)
        u = torch.rand((counts.shape[0], spec.local_steps, spec.batch_size),
                       generator=gen, device=self.device)
        idx = (u * safe.to(torch.float32)).to(torch.int64)
        return torch.minimum(idx, safe - 1)

    def draw_batch_indices(self, counts: Any, key: Key,
                           n_rounds: int = 1) -> torch.Tensor:
        """``[n_rounds, S, local_steps, batch]`` example indices on the
        device, uniform in ``[0, max(count, 1))`` for each station, drawn
        a round at a time."""
        gen = self._generator(key)
        counts = torch.as_tensor(counts, device=self.device)
        return torch.stack([self._draw_idx(counts, gen)
                            for _ in range(n_rounds)])

    def _noise_shape(self, params: Pytree) -> tuple[int, int] | None:
        """``(S, n_pad)`` of a round's int8 rounding noise, None when the
        compressor draws none."""
        comp = self.spec.compressor
        if not (self._compressing and comp.int8):
            return None
        return (self.mesh.n_stations, noise_size(comp, flat_size(params)))

    def _draws(self, counts: torch.Tensor, params: Pytree, key: Key | None,
               batch_idx: Any | None, noise: Any | None, n_rounds: int):
        """A function of the round ``k`` that returns its batch indices
        ``[S, local_steps, batch]`` and rounding noise ``[S, n_pad]`` (None
        without int8): the given ones (one round's, for every round, or row
        ``k`` of each round's), else drawn with ``key`` when called, its
        indices first. Called for k = 0, 1, ... in turn, it holds one
        round's draws at a time."""
        spec = self.spec
        idx_shape = (n_rounds, self.mesh.n_stations, spec.local_steps,
                     spec.batch_size)
        u_shape = self._noise_shape(params)
        draw_idx = batch_idx is None
        draw_u = u_shape is not None and noise is None
        if key is None and draw_idx:
            raise ValueError("pass a key or batch_idx")
        if key is None and draw_u:
            raise ValueError("pass a key or noise")
        gen = None if key is None else self._generator(key)
        idx = (None if draw_idx else
               self._given("batch_idx", batch_idx, idx_shape, torch.int64))
        u = (None if u_shape is None or draw_u else
             self._given("noise", noise, (n_rounds,) + u_shape,
                         torch.float32))

        def draw(k: int):
            k_idx = self._draw_idx(counts, gen) if draw_idx else idx[k]
            if u_shape is None:
                return k_idx, None
            return k_idx, (draw_noise(gen, u_shape, self.device) if draw_u
                           else u[k])

        return draw

    def _given(self, name: str, x: Any, shape: tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
        t = self._place(x, dtype)
        if tuple(t.shape) != shape[1:] and tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape[1:]} (or [n_rounds, ...] = {shape} "
                f"for fused runs), got {tuple(t.shape)}"
            )
        return t.expand(shape)

    # ------------------------------------------------------------ public API
    def _place(self, x: Any, dtype: torch.dtype | None = None) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    def init(self, params: Pytree) -> Any:
        """Server-optimizer state for ``params``. With
        ``shard_server_update`` it is built over the flat padded f32 param
        vector. A step count lives on the device (a 0-d int32 tensor) so a
        captured round reads it on every replay. With a compressor the
        state is ``{"server": <optimizer state>, "ef": [S, N]}``, each
        station's error-feedback accumulator starting at zero."""
        params = self._device_params(params)
        if self.spec.shard_server_update:
            flat = flatten_tree(params)
            n_pad = padded_flat_size(flat.numel(), self.mesh.station_axis_size)
            state = self.server_opt.init(F.pad(flat, (0, n_pad - flat.numel())))
        else:
            state = self.server_opt.init(params)
        if self._compressing:
            ef = torch.zeros((self.mesh.n_stations, flat_size(params)),
                             dtype=torch.float32, device=self.device)
            state = {"server": state, "ef": ef}
        return self._device_state(state)

    def _device_params(self, params: Pytree) -> Pytree:
        return tree_map(self._place, params)

    def _device_state(self, state: Any) -> Any:
        # a Python int (Adam's step count) becomes a 0-d int32 tensor
        return tree_map(
            lambda x: torch.tensor(x, dtype=torch.int32, device=self.device)
            if isinstance(x, int) else self._place(x),
            state,
        )

    def round(
        self,
        params: Pytree,
        opt_state: Any,
        stacked_x: torch.Tensor,
        stacked_y: torch.Tensor,
        counts: Any,
        key: Key | None = None,
        mask: Any | None = None,
        batch_idx: Any | None = None,
        noise: Any | None = None,
    ):
        """One federated round. Returns (params, opt_state, mean_loss,
        stats); ``stats`` is ``station_update_stats``' dict ({} when
        ``spec.learning_stats`` is off). The batch indices come from
        ``batch_idx`` ([S, local_steps, batch]) and an int8 compressor's
        rounding noise from ``noise`` ([S, n_pad]), or each is drawn with
        ``key``. Every input is moved to the engine's device first."""
        counts = self._place(counts, torch.float32)
        mask = (torch.ones_like(counts) if mask is None
                else self._place(mask, torch.float32))
        params = self._device_params(params)
        idx, u = self._draws(counts, params, key, batch_idx, noise, 1)(0)
        with torch.no_grad():
            return self._round_impl(
                params, self._device_state(opt_state),
                self._place(stacked_x), self._place(stacked_y), counts, mask,
                idx, u,
            )

    def async_round(
        self,
        params: Pytree,
        opt_state: Any,
        stacked_x: torch.Tensor,
        stacked_y: torch.Tensor,
        counts: Any,
        key: Key | None,
        accept_mask: Any,
        staleness: Any,
        spec: AsyncRoundSpec,
        mask: Any | None = None,
        batch_idx: Any | None = None,
        noise: Any | None = None,
    ):
        """One buffered-async round: only ``accept_mask`` stations
        contribute, each discounted by ``spec.staleness_discount **
        staleness``. It is ``round`` with the effective mask ``accept *
        discount**staleness * mask``."""
        spec.validate()
        effective = (self._place(accept_mask, torch.float32)
                     * spec.staleness_weights(self._place(staleness)))
        if mask is not None:
            effective = effective * self._place(mask, torch.float32)
        return self.round(params, opt_state, stacked_x, stacked_y, counts,
                          key, mask=effective, batch_idx=batch_idx,
                          noise=noise)

    def compression_stats(self, params: Pytree) -> dict[str, Any] | None:
        """Per-round wire accounting of the delta uplink: raw and
        compressed bytes across all stations and the reduction ratio. None
        without an effective compressor. Metadata only."""
        if not self._compressing:
            return None
        n = flat_size(params)
        spec = self.spec.compressor
        s = self.mesh.n_stations
        return {
            "n_params": n,
            "raw_bytes_per_round": 4 * n * s,
            "wire_bytes_per_round": spec.wire_nbytes(n) * s,
            "reduction": round(spec.ratio(n), 2),
        }

    def _fused_inputs(self, params, opt_state, counts, key, batch_idx,
                      noise, n_rounds, **row_masks):
        """(carry, row) of a fused run: params and server state on the
        device (a fresh state when ``opt_state`` is None), and a function
        of the round ``k`` that returns its row of each mask (given as
        ``[S]`` or ``[n_rounds, S]``), its batch indices and its rounding
        noise, drawn when it is called."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        params = self._device_params(params)
        if opt_state is None:
            opt_state = self.init(params)
        draw = self._draws(counts, params, key, batch_idx, noise, n_rounds)
        masks = {name: self._place(per_round_masks(self._place(m), n_rounds))
                 for name, m in row_masks.items()}

        def row(k: int) -> dict[str, torch.Tensor]:
            out = {name: m[k] for name, m in masks.items()}
            out["idx"], u = draw(k)
            if u is not None:
                out["noise"] = u
            return out

        return {"params": params,
                "opt_state": self._device_state(opt_state)}, row

    def run_rounds(
        self,
        params: Pytree,
        stacked_x: torch.Tensor,
        stacked_y: torch.Tensor,
        counts: Any,
        key: Key | None,
        n_rounds: int,
        mask: Any | None = None,
        opt_state: Any = None,
        donate: bool = True,
        unroll: int | bool = 1,
        batch_idx: Any | None = None,
        noise: Any | None = None,
    ):
        """``n_rounds`` federated rounds, the fused path: on the card one
        round is a captured CUDA graph replayed ``n_rounds`` times, with no
        host sync between rounds. ``mask`` is ``[S]`` (every round) or
        ``[n_rounds, S]``; ``batch_idx`` is ``[n_rounds, S, local_steps,
        batch]`` (or one round's, for every round) and ``noise`` ``[n_rounds,
        S, n_pad]`` (or one round's), else each is drawn with ``key`` just
        before its round. Returns (params, opt_state, losses[n], stats), the
        stats stacked over rounds ({} when ``spec.learning_stats`` is off).
        Pass ``opt_state`` to continue a run; omitted, a fresh state is
        made. Every input is moved to the engine's device first.

        ``donate`` and ``unroll`` keep the JAX package's signature and have
        no effect: the inputs are copied into the graph's own buffers and
        never consumed, and the round is replayed, not unrolled."""
        del donate, unroll
        counts = self._place(counts, torch.float32)
        carry, row = self._fused_inputs(
            params, opt_state, counts, key, batch_idx, noise, n_rounds,
            mask=torch.ones_like(counts) if mask is None else mask)
        carry, losses, stats = self._run_fused(
            carry, dict(x=stacked_x, y=stacked_y, counts=counts), row,
            n_rounds)
        return carry["params"], carry["opt_state"], losses, stats

    def run_rounds_async(
        self,
        params: Pytree,
        stacked_x: torch.Tensor,
        stacked_y: torch.Tensor,
        counts: Any,
        key: Key | None,
        n_rounds: int,
        accept_masks: Any,
        spec: AsyncRoundSpec,
        staleness: Any | None = None,
        mask: Any | None = None,
        opt_state: Any = None,
        donate: bool = True,
        batch_idx: Any | None = None,
        noise: Any | None = None,
    ):
        """``n_rounds`` buffered-async rounds, fused as ``run_rounds``: the
        staleness vector is carried on the device from round to round, and
        each round's effective mask is ``accept * discount**staleness *
        mask``; accepted stations reset to 0, the others age one round.
        ``accept_masks`` is ``[n_rounds, S]`` or ``[S]``. Returns (params,
        opt_state, staleness[S], losses[n], stats)."""
        del donate
        spec.validate()
        counts = self._place(counts, torch.float32)
        carry, row = self._fused_inputs(
            params, opt_state, counts, key, batch_idx, noise, n_rounds,
            mask=torch.ones_like(counts) if mask is None else mask,
            accept=accept_masks)
        carry["staleness"] = (torch.zeros_like(counts) if staleness is None
                              else self._place(staleness, torch.float32))
        discount = torch.tensor(spec.staleness_discount, dtype=torch.float32,
                                device=self.device)
        carry, losses, stats = self._run_fused(
            carry, dict(x=stacked_x, y=stacked_y, counts=counts,
                        discount=discount), row, n_rounds)
        return (carry["params"], carry["opt_state"], carry["staleness"],
                losses, stats)

    # ------------------------------------------------------------ fused path
    def _round_step(self, b: dict[str, Any]):
        """One round on the buffers ``b``; writes the carry (params, server
        state, staleness) back into ``b`` in place and returns (loss,
        stats)."""
        with torch.no_grad():
            mask = b["mask"]
            if "accept" in b:
                mask = (b["accept"]
                        * torch.pow(b["discount"], b["staleness"]) * mask)
            params, opt_state, loss, stats = self._round_impl(
                b["params"], b["opt_state"], b["x"], b["y"], b["counts"],
                mask, b["idx"], b.get("noise"),
            )
            new = {"params": params, "opt_state": opt_state}
            if "accept" in b:
                new["staleness"] = torch.where(
                    b["accept"] != 0, torch.zeros_like(b["staleness"]),
                    b["staleness"] + 1.0)
            for name, tree in new.items():
                for dst, src in zip(tree_leaves(b[name]), tree_leaves(tree),
                                    strict=True):
                    dst.copy_(src)
        return loss, stats

    def _run_fused(self, carry, consts, row, n_rounds):
        """``n_rounds`` rounds of ``_round_step`` over ``carry`` (written
        back each round), ``consts`` (read) and each round's ``row(k)``;
        the round is captured once per signature."""
        inputs = dict(carry, **tree_map(self._place, consts), **row(0))
        key = repr(tree_map(lambda t: (tuple(t.shape), str(t.dtype)), inputs))
        fused = self._fused.get(key)
        if fused is None:
            if len(self._fused) >= FUSED_CACHE_SIZE:
                self._fused.pop(next(iter(self._fused))).close()
            fused = _FusedRound(self._round_step, inputs,
                                capture=self.device.type == "cuda")
            self._fused[key] = fused
            if fused.seconds is not None:
                self.last_capture = fused.seconds
        return fused.run(self._round_step, inputs, row, list(carry),
                         n_rounds)


class _FusedRound:
    """One round over static buffers, run ``n_rounds`` times in a row.

    ``step(buffers)`` runs a round and writes its carry back into the
    buffers in place, so the next round reads it. On a CUDA device the step
    is captured once as a CUDA graph, after a warm-up on a side stream, and
    each round is one replay; elsewhere it runs eagerly.

    The round does not keep ``step`` (the engine's bound method): the
    engine holds its rounds, and a reference back would make a cycle that
    only the cycle collector frees, at any allocation, possibly in the
    middle of another capture, where destroying a graph invalidates it.
    For the same reason the collector is off while a round is captured."""

    def __init__(self, step: Callable, inputs: dict[str, Any], capture: bool):
        self.buffers = tree_map(torch.clone, inputs)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Any = None
        self.seconds: dict[str, float] | None = None
        if capture:
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ROUNDS):
                    step(self.buffers)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            gc.collect()
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    self.outputs = step(self.buffers)
            finally:
                if gc_was_on:
                    gc.enable()
            torch.cuda.synchronize()
            self.seconds = {"warmup_s": t1 - t0,
                            "capture_s": time.perf_counter() - t1}

    def close(self) -> None:
        """Drop the captured graph and the buffers (an evicted round)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.buffers = self.outputs = None

    def run(self, step: Callable, inputs: dict[str, Any],
            row: Callable[[int], dict[str, torch.Tensor]],
            carry_names: list[str], n_rounds: int):
        """Copy ``inputs`` (round 0's row included) into the buffers, then
        per round copy in ``row(k)`` for k > 0, run it (replay the graph,
        or ``step`` eagerly), and copy out its loss and stats.
        Returns (the carry named by ``carry_names``, losses[n], stats)."""
        b = self.buffers
        for dst, src in zip(tree_leaves(b), tree_leaves(inputs), strict=True):
            dst.copy_(src)
        losses, stats = None, None
        for k in range(n_rounds):
            for name, t in (row(k) if k else {}).items():
                b[name].copy_(t)
            if self.graph is not None:
                self.graph.replay()
                loss, round_stats = self.outputs
            else:
                loss, round_stats = step(b)
            if losses is None:
                losses = loss.new_empty((n_rounds,) + tuple(loss.shape))
                stats = tree_map(
                    lambda s: s.new_empty((n_rounds,) + tuple(s.shape)),
                    round_stats)
            losses[k].copy_(loss)
            for dst, src in zip(tree_leaves(stats), tree_leaves(round_stats),
                                strict=True):
                dst[k].copy_(src)
        carry = {name: tree_map(torch.clone, b[name]) for name in carry_names}
        return carry, losses, stats
