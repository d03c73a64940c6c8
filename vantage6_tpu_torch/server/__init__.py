"""Control plane (parity: vantage6-server, SURVEY.md §2 items 1-8)."""
from vantage6_tpu_torch.server.app import ServerApp, run_server  # noqa: F401
