"""Algorithm-facing API (parity with vantage6-algorithm-tools).

The container ABI (``wrap_algorithm``) comes with the port's node.
"""

from vantage6_tpu_torch.algorithm.client import AlgorithmClient  # noqa: F401
from vantage6_tpu_torch.algorithm.decorators import (  # noqa: F401
    algorithm_client,
    data,
    device_step,
    metadata,
)
from vantage6_tpu_torch.algorithm.mock_client import (  # noqa: F401
    MockAlgorithmClient,
)
