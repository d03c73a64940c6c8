"""Tensor parallelism: Megatron-style blocks over a shard axis.

Counterpart of ``vantage6_tpu/parallel/tensor.py``. There a station's
local model is sharded over the ``device`` mesh axis: a column-parallel
matmul (weights split on the output features, no communication) feeds a
row-parallel matmul (weights split on the input features, one ``psum``).
On one card the mesh axis is a leading shard axis ``[P, ...]`` on the
local weights and activations, and the ``psum`` is a sum over it.

With ``group=`` (a station's ranks, ``FederationMesh.device_group``) each
rank holds its own blocks, without the shard axis, and the ``psum`` is an
``all_reduce`` over the group.

Backward rule (deliberate): the gradients equal the dense MLP's. The
row-parallel all-reduce passes its gradient through unchanged (every rank
already holds the whole output's gradient), and the column-parallel
layer's replicated input all-reduces the gradient it gets from each
rank's block (Megatron's f/g pair). The JAX package's ``psum`` transposes
to a ``psum`` instead, which multiplies a replicated loss's gradient by P
(ROADMAP.md queue 3); ``torch.distributed.nn.functional.all_reduce``
would do the same. The port does not reproduce that factor here.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``group`` (each
    rank's block contributes a part of the replicated input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None

from vantage6_tpu_torch._tree import tree_map_with_path


def column_parallel_dense(
    x: torch.Tensor, w_local: torch.Tensor,
    b_local: torch.Tensor | None = None,
    group: Any = None,
) -> torch.Tensor:
    """``[..., d_in] @ [P, d_in, d_out/P] -> [P, ..., d_out/P]``: no
    communication; the output stays feature-sharded for the next
    (row-parallel) layer. ``x`` is the same on every shard. With
    ``group``: this rank's ``[..., d_in] @ [d_in, d_out/P]``, the input's
    gradient all-reduced over the group (module doc)."""
    if group is not None:
        y = _CopyToGroup.apply(x, group) @ w_local
        return y if b_local is None else y + b_local
    y = torch.einsum("...i,pio->p...o", x, w_local)
    if b_local is not None:
        y = y + b_local.reshape(b_local.shape[0], *[1] * (x.dim() - 1),
                                b_local.shape[-1])
    return y


def row_parallel_dense(
    x_local: torch.Tensor,
    w_local: torch.Tensor,
    b: torch.Tensor | None = None,
    group: Any = None,
) -> torch.Tensor:
    """``[P, ..., d_in/P] @ [P, d_in/P, d_out] -> [..., d_out]``: each
    shard's partial product, then the sum over shards (the ``psum``); the
    bias is added after the reduction. With ``group``: this rank's
    ``[..., d_in/P] @ [d_in/P, d_out]``, all-reduced over the group, its
    gradient passed through (module doc)."""
    if group is not None:
        y = _ReduceFromGroup.apply(x_local @ w_local, group)
        return y if b is None else y + b
    y = torch.einsum("p...i,pio->p...o", x_local, w_local).sum(0)
    if b is not None:
        y = y + b
    return y


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


def tp_mlp(
    x: torch.Tensor,
    w_up_local: torch.Tensor,
    w_down_local: torch.Tensor,
    activation: Callable[[torch.Tensor], torch.Tensor] = _gelu,
    group: Any = None,
) -> torch.Tensor:
    """The canonical 2-layer TP block: column-parallel up, activation,
    row-parallel down; exactly one reduction for the whole MLP. With
    ``group``, the weights are this rank's blocks (``[d_in, d_h/P]``,
    ``[d_h/P, d_out]``) and the reduction is one all-reduce."""
    h = activation(column_parallel_dense(x, w_up_local, group=group))
    return row_parallel_dense(h, w_down_local, group=group)


def shard_params_for_tp(
    params: Any, axis_index: int, axis_size: int, rules: dict[str, int]
) -> Any:
    """Slice a replicated param tree into shard ``axis_index``'s blocks.

    ``rules`` maps a parameter path substring to the axis to split (e.g.
    ``{"w_up": 1, "w_down": 0}``); a path reads as
    ``jax.tree_util.keystr`` writes it (``"['layers'][0]['w_up']"``), so
    one set of rules selects the same leaves in both packages. Unmatched
    params stay replicated."""

    def slice_leaf(path: str, x: torch.Tensor) -> torch.Tensor:
        for pat, dim in rules.items():
            if pat in path:
                size = x.shape[dim]
                if size % axis_size:
                    raise ValueError(
                        f"{path}: dim {dim} ({size}) not divisible by "
                        f"tp={axis_size}"
                    )
                block = size // axis_size
                return x.narrow(dim, axis_index * block, block)
        return x

    return tree_map_with_path(slice_leaf, params)
