"""Server hot-path caches: token→principal auth and collaboration visibility.

The control plane re-resolves the SAME bearer token (JWT verify + principal
row + rule graph) and re-derives the SAME org→collaborations visibility set
on every request of a polling daemon or a paginating client. Both are
read-mostly with rare, well-identified writers, so each gets a small cache
with EXPLICIT invalidation at every mutation site (resources.py calls the
invalidate hooks) plus a short TTL as belt-and-braces:

- `AuthCache` — token string → (kind, principal). For users the principal
  carries its precomputed rule-id set (`User.rule_ids` honors it), so a
  permission check costs zero queries on a warm token. Invalidation:
  per-principal on user/node mutation, global on role/rule mutation (a
  role's rule set reaches arbitrarily many users). Entries also die at the
  token's own `exp` — a cache hit must never outlive the JWT.
- `VisibilityCache` — organization_id → frozenset of collaboration ids the
  org belongs to (the check `resources.py` used to re-query per run/row).
  Invalidation: global on any collaboration-membership mutation.

Both caches are process-local. On a single-replica server that matches the
consistency domain exactly: every mutation that must invalidate goes
through this same process's REST handlers. With N replicas over a shared
store (docs/control_plane.md), a mutation can land on a DIFFERENT replica —
there `resources._invalidate` also publishes a `CACHE_INVALIDATE` event on
the shared stream and every replica's auth hot path drains it
(`ServerApp.drain_invalidations`, rate-limited to ~25 ms), so cross-replica
staleness is bounded by the drain interval with the TTL as the backstop.
"""
from __future__ import annotations

import threading
import time
from typing import Any


class AuthCache:
    """Bounded TTL cache: token → (kind, principal, expires_at)."""

    def __init__(self, ttl: float = 30.0, maxsize: int = 2048):
        self.ttl = ttl
        self.maxsize = maxsize
        self._lock = threading.Lock()
        # replica-local: coherent via the CACHE_INVALIDATE bus + TTL
        self._entries: dict[str, tuple[float, str, Any]] = {}  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock

    def get(self, token: str) -> tuple[str, Any] | None:
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(token)
            if entry is None or entry[0] < now:
                if entry is not None:
                    del self._entries[token]
                self.misses += 1
                return None
            self.hits += 1
            return entry[1], entry[2]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def put(
        self, token: str, kind: str, principal: Any,
        token_exp: float | None = None,
    ) -> None:
        now = time.monotonic()
        expires = now + self.ttl
        if token_exp is not None:
            # token_exp is wall-clock; convert the remaining lifetime
            expires = min(expires, now + max(0.0, token_exp - time.time()))
        with self._lock:
            if len(self._entries) >= self.maxsize:
                # simple pressure valve: drop everything (cheap, rare, and
                # correctness never depends on residency)
                self._entries.clear()
            self._entries[token] = (expires, kind, principal)

    # ------------------------------------------------------- invalidation
    def invalidate_principal(self, kind: str, principal_id: int) -> None:
        """Evict every token resolving to this user/node — called on any
        mutation of the principal (credentials, roles, fields, deletion)."""
        with self._lock:
            dead = [
                tok for tok, (_, k, p) in self._entries.items()
                if k == kind and getattr(p, "id", None) == principal_id
            ]
            for tok in dead:
                del self._entries[tok]

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()


class VisibilityCache:
    """organization_id → frozenset(collaboration ids containing the org)."""

    def __init__(self, ttl: float = 30.0):
        self.ttl = ttl
        self._lock = threading.Lock()
        # replica-local: coherent via the CACHE_INVALIDATE bus + TTL
        self._entries: dict[int, tuple[float, frozenset[int]]] = {}  # guarded-by: _lock
        # hit/miss accounting for the unified telemetry registry — the
        # same observability the AuthCache already had
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock

    def get(self, org_id: int) -> frozenset[int] | None:
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(org_id)
            if entry is None or entry[0] < now:
                if entry is not None:
                    # drop the expired entry NOW: a quiet org must not
                    # keep inflating the v6t_visibility_cache_entries gauge
                    del self._entries[org_id]
                self.misses += 1
                return None
            self.hits += 1
            return entry[1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def put(self, org_id: int, collab_ids: frozenset[int]) -> None:
        with self._lock:
            self._entries[org_id] = (time.monotonic() + self.ttl, collab_ids)

    def invalidate_all(self) -> None:
        """Collaboration membership changed — the mapping is many-to-many,
        so any mutation can affect any org's entry."""
        with self._lock:
            self._entries.clear()
