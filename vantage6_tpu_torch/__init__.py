"""vantage6-tpu's PyTorch/CUDA port: the federated data plane on one GPU.

Beside the JAX package (``vantage6_tpu``), which stays the reference. This
package imports ``torch`` and never ``jax`` or ``vantage6_tpu``. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from vantage6_tpu_torch.core.mesh import FederationMesh, Station  # noqa: F401
from vantage6_tpu_torch.fed.collectives import fed_mean, fed_sum  # noqa: F401
from vantage6_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
from vantage6_tpu_torch.workloads.fed_transformer import (  # noqa: F401
    FedTransformer,
    TransformerConfig,
    make_engine,
)
