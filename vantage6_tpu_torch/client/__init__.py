"""Researcher SDK (parity: vantage6-client, SURVEY.md §2 item 16)."""
from vantage6_tpu_torch.client.client import ClientError, UserClient  # noqa: F401
