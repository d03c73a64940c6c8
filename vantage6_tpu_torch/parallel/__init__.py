"""Parallelism beyond the station axis.

- ring_attention: sequence (context) parallelism, over shards stacked on
  one card or across the ranks of a process group
- tensor: Megatron-style tensor parallelism, over a leading shard axis on
  one card or across the ranks of a process group
The station axis itself lives in core.mesh.
"""
from vantage6_tpu_torch.parallel.ring_attention import (  # noqa: F401
    reference_attention,
    ring_attention,
    ring_attention_sharded,
    ring_attention_stacked,
)
from vantage6_tpu_torch.parallel.tensor import (  # noqa: F401
    column_parallel_dense,
    row_parallel_dense,
    shard_params_for_tp,
    tp_mlp,
)
