"""Data-station agent (parity: vantage6-node, SURVEY.md §2 items 10-15)."""
from vantage6_tpu_torch.node.daemon import NodeDaemon  # noqa: F401
from vantage6_tpu_torch.node.runner import TaskRunner  # noqa: F401
