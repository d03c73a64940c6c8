"""Transfer guards: make a host sync inside a round a hard error.

Counterpart of ``vantage6_tpu/utils/guards.py``. The federated hot loop
must stay on the card: a device->host pull inside a round (``.item()``,
``float(t)``, ``.cpu()``, a data-dependent shape such as ``nonzero``)
stalls the host until the card drains, and in a captured round it is a
capture error. JAX guards with ``jax.transfer_guard``; PyTorch has no
twin of it, and the nearest is ``torch.cuda.set_sync_debug_mode``, which
these guards set for the block and restore on exit.

What they catch: every synchronizing CUDA call in the block, which
includes each device->host pull and each blocking host->device copy.
What they do not need to catch: PyTorch already refuses an operation that
mixes a CUDA tensor with a CPU tensor (except a 0-d CPU tensor, which it
reads as a scalar), so an array that "fell off the card" fails loudly
without a guard. On a CPU-only run there is no CUDA stream to sync, and
the guards change nothing.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def _sync_debug_mode(mode: str) -> Iterator[None]:
    if not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def no_implicit_transfers() -> Iterator[None]:
    """Raise on any host sync (a device->host pull, a blocking copy)
    inside the block. Asynchronous work on the card stays allowed; pull
    results after the block."""
    with _sync_debug_mode("error"):
        yield


@contextlib.contextmanager
def log_transfers() -> Iterator[None]:
    """Diagnostic mode: warn on each host sync without failing."""
    with _sync_debug_mode("warn"):
        yield
