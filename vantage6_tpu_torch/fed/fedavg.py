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

Batch indices are drawn on the device, uniform in ``[0, max(count, 1))``
per station and step, so padded rows are never drawn, from an explicit
``torch.Generator`` (jax.random's stream cannot be reproduced). Every entry
point also takes the indices themselves (``batch_idx``), which is how the
parity tests feed both packages the same draws.

Not ported yet: gradient compression (``compressor``, ROADMAP.md queue 1
item 7) and the host telemetry and history hooks (queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
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
    flatten_stacked,
    flatten_tree,
    padded_flat_size,
    per_round_masks,
    station_update_stats,
    unflatten_like,
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
    # dtype the flat delta sum is rounded to, as it would cross the wire
    comm_dtype: torch.dtype | None = None
    # not ported yet (ROADMAP.md queue 1 item 7); anything but None raises
    compressor: Any = None
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
        if spec.compressor is not None:
            raise NotImplementedError(
                "gradient compression is not ported to the PyTorch package "
                "yet (ROADMAP.md queue 1 item 7); pass compressor=None"
            )
        self.mesh = mesh
        self.spec = spec
        self.server_opt = spec.server_optimizer or sgd(1.0)
        # captured rounds, keyed on their inputs' structure, shapes, dtypes
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
    ):
        deltas, losses = self.mesh.fed_map(
            self._local_update, stacked_x, stacked_y, idx,
            replicated_args=(params,), batched=True,
        )
        weights = counts * mask
        stats: dict[str, Any] = {}
        if self.spec.learning_stats:
            stats = station_update_stats(flatten_stacked(deltas),
                                         weights=weights)
        if self.spec.shard_server_update:
            params, opt_state = self._sharded_server_update(
                params, opt_state, deltas, weights
            )
        else:
            mean_delta = fed_mean(deltas, weights=weights)
            # server update on the pseudo-gradient (negative mean delta)
            pseudo_grad = tree_map(torch.neg, mean_delta)
            updates, opt_state = self.server_opt.update(
                pseudo_grad, opt_state, params
            )
            params = apply_updates(params, updates)
        round_loss = fed_mean(losses, weights=weights)
        return params, opt_state, round_loss, stats

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
    def draw_batch_indices(self, counts: Any, key: Key,
                           n_rounds: int = 1) -> torch.Tensor:
        """``[n_rounds, S, local_steps, batch]`` example indices on the
        device, uniform in ``[0, max(count, 1))`` for each station."""
        if isinstance(key, int):
            key = torch.Generator(device=self.device).manual_seed(key)
        spec = self.spec
        counts = torch.as_tensor(counts, device=self.device)
        safe = torch.clamp_min(counts.to(torch.int64), 1).reshape(1, -1, 1, 1)
        u = torch.rand((n_rounds, counts.shape[0], spec.local_steps,
                        spec.batch_size), generator=key, device=self.device)
        idx = (u * safe.to(torch.float32)).to(torch.int64)
        return torch.minimum(idx, safe - 1)

    def _batch_indices(self, counts: Any, key: Key | None,
                       batch_idx: Any | None, n_rounds: int) -> torch.Tensor:
        spec = self.spec
        shape = (n_rounds, self.mesh.n_stations, spec.local_steps,
                 spec.batch_size)
        if batch_idx is None:
            if key is None:
                raise ValueError("pass a key or batch_idx")
            return self.draw_batch_indices(counts, key, n_rounds)
        idx = torch.as_tensor(batch_idx, device=self.device).to(torch.int64)
        if tuple(idx.shape) != shape[1:] and tuple(idx.shape) != shape:
            raise ValueError(
                f"batch_idx must be [S, local_steps, batch] = {shape[1:]} "
                f"(or [n_rounds, ...] = {shape} for fused runs), got "
                f"{tuple(idx.shape)}"
            )
        return idx.expand(shape)

    # ------------------------------------------------------------ public API
    def _place(self, x: Any, dtype: torch.dtype | None = None) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    def init(self, params: Pytree) -> Any:
        """Server-optimizer state for ``params``. With
        ``shard_server_update`` it is built over the flat padded f32 param
        vector. A step count lives on the device (a 0-d int32 tensor) so a
        captured round reads it on every replay."""
        params = self._device_params(params)
        if self.spec.shard_server_update:
            flat = flatten_tree(params)
            n_pad = padded_flat_size(flat.numel(), self.mesh.station_axis_size)
            state = self.server_opt.init(F.pad(flat, (0, n_pad - flat.numel())))
        else:
            state = self.server_opt.init(params)
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
    ):
        """One federated round. Returns (params, opt_state, mean_loss,
        stats); ``stats`` is ``station_update_stats``' dict ({} when
        ``spec.learning_stats`` is off). The batch indices come from
        ``batch_idx`` ([S, local_steps, batch]) or are drawn with ``key``.
        Every input is moved to the engine's device first."""
        counts = self._place(counts, torch.float32)
        mask = (torch.ones_like(counts) if mask is None
                else self._place(mask, torch.float32))
        idx = self._batch_indices(counts, key, batch_idx, 1)[0]
        with torch.no_grad():
            return self._round_impl(
                self._device_params(params), self._device_state(opt_state),
                self._place(stacked_x), self._place(stacked_y), counts, mask,
                idx,
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
                          key, mask=effective, batch_idx=batch_idx)

    def compression_stats(self, params: Pytree) -> None:
        """Wire accounting of the compressed delta uplink: None, since
        compression is not ported yet (ROADMAP.md queue 1 item 7)."""
        del params
        return None

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
    ):
        """``n_rounds`` federated rounds, the fused path: on the card one
        round is a captured CUDA graph replayed ``n_rounds`` times, with no
        host sync between rounds. ``mask`` is ``[S]`` (every round) or
        ``[n_rounds, S]``; ``batch_idx`` is ``[n_rounds, S, local_steps,
        batch]`` (or one round's, for every round), else indices are drawn
        with ``key``. Returns (params, opt_state, losses[n], stats), the
        stats stacked over rounds ({} when ``spec.learning_stats`` is off).
        Pass ``opt_state`` to continue a run; omitted, a fresh state is
        made. Every input is moved to the engine's device first.

        ``donate`` and ``unroll`` keep the JAX package's signature and have
        no effect: the inputs are copied into the graph's own buffers and
        never consumed, and the round is replayed, not unrolled."""
        del donate, unroll
        counts = self._place(counts, torch.float32)
        rows = {
            "mask": self._place(per_round_masks(
                torch.ones_like(counts) if mask is None else
                self._place(mask), n_rounds)),
            "idx": self._batch_indices(counts, key, batch_idx, n_rounds),
        }
        params = self._device_params(params)
        if opt_state is None:
            opt_state = self.init(params)
        carry = {"params": params, "opt_state": self._device_state(opt_state)}
        carry, losses, stats = self._run_fused(
            carry, dict(x=stacked_x, y=stacked_y, counts=counts), rows,
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
        rows = {
            "mask": self._place(per_round_masks(
                torch.ones_like(counts) if mask is None else
                self._place(mask), n_rounds)),
            "accept": self._place(per_round_masks(
                self._place(accept_masks), n_rounds)),
            "idx": self._batch_indices(counts, key, batch_idx, n_rounds),
        }
        params = self._device_params(params)
        if opt_state is None:
            opt_state = self.init(params)
        carry = {
            "params": params, "opt_state": self._device_state(opt_state),
            "staleness": (torch.zeros_like(counts) if staleness is None
                          else self._place(staleness, torch.float32)),
        }
        discount = torch.tensor(spec.staleness_discount, dtype=torch.float32,
                                device=self.device)
        carry, losses, stats = self._run_fused(
            carry, dict(x=stacked_x, y=stacked_y, counts=counts,
                        discount=discount), rows, n_rounds)
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
                mask, b["idx"],
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

    def _run_fused(self, carry, consts, rows, n_rounds):
        """``n_rounds`` rounds of ``_round_step`` over ``carry`` (written
        back each round), ``consts`` (read) and one row per round of each
        tensor in ``rows``; the round is captured once per signature."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        inputs = dict(carry, **tree_map(self._place, consts),
                      **{name: t[0] for name, t in rows.items()})
        key = repr(tree_map(lambda t: (tuple(t.shape), str(t.dtype)), inputs))
        fused = self._fused.get(key)
        if fused is None:
            fused = _FusedRound(self._round_step, inputs,
                                capture=self.device.type == "cuda")
            self._fused[key] = fused
            if fused.seconds is not None:
                self.last_capture = fused.seconds
        return fused.run(inputs, rows, list(carry), n_rounds)


class _FusedRound:
    """One round over static buffers, run ``n_rounds`` times in a row.

    ``step(buffers)`` runs a round and writes its carry back into the
    buffers in place, so the next round reads it. On a CUDA device the step
    is captured once as a CUDA graph, after a warm-up on a side stream, and
    each round is one replay; elsewhere it runs eagerly."""

    def __init__(self, step: Callable, inputs: dict[str, Any], capture: bool):
        self.step = step
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
            with torch.cuda.graph(self.graph):
                self.outputs = step(self.buffers)
            torch.cuda.synchronize()
            self.seconds = {"warmup_s": t1 - t0,
                            "capture_s": time.perf_counter() - t1}

    def run(self, inputs: dict[str, Any], rows: dict[str, torch.Tensor],
            carry_names: list[str], n_rounds: int):
        """Copy ``inputs`` into the buffers, then per round copy in its row
        of each ``rows`` tensor, run it, and copy out its loss and stats.
        Returns (the carry named by ``carry_names``, losses[n], stats)."""
        b = self.buffers
        for dst, src in zip(tree_leaves(b), tree_leaves(inputs), strict=True):
            dst.copy_(src)
        losses, stats = None, None
        for k in range(n_rounds):
            for name, t in rows.items():
                b[name].copy_(t[k])
            if self.graph is not None:
                self.graph.replay()
                loss, round_stats = self.outputs
            else:
                loss, round_stats = self.step(b)
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
