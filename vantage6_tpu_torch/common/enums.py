"""Status and policy enums.

Parity: vantage6-common/vantage6/common/enum.py (reference mount was empty;
member set reconstructed per SURVEY.md §2 item 23 — RunStatus lifecycle
PENDING..KILLED plus failure refinements).

The port's copy of ``vantage6_tpu/common/enums.py`` (framework-free).
"""
from __future__ import annotations

import enum


class TaskStatus(str, enum.Enum):
    """Lifecycle of a federated task (and of each per-station run).

    The reference drives these transitions over SocketIO + REST; here the
    orchestrator drives them in-process, but the state machine is identical so
    client code observing statuses ports unchanged.
    """

    PENDING = "pending"
    INITIALIZING = "initializing"
    ACTIVE = "active"
    COMPLETED = "completed"
    FAILED = "failed"
    CRASHED = "crashed"
    KILLED = "killed by user"
    NOT_ALLOWED = "not allowed"
    NO_IMAGE = "non-existing image"

    @classmethod
    def failed_statuses(cls) -> set["TaskStatus"]:
        return {cls.FAILED, cls.CRASHED, cls.KILLED, cls.NOT_ALLOWED, cls.NO_IMAGE}

    @property
    def has_failed(self) -> bool:
        return self in self.failed_statuses()

    @property
    def is_finished(self) -> bool:
        return self == TaskStatus.COMPLETED or self.has_failed


# The reference models per-station execution as a `Run` row with its own status
# mirroring the task statuses; keep the alias so both names resolve.
RunStatus = TaskStatus


class Scope(str, enum.Enum):
    """RBAC scope axis (scope x operation permission matrix)."""

    OWN = "own"
    ORGANIZATION = "organization"
    COLLABORATION = "collaboration"
    GLOBAL = "global"


class Operation(str, enum.Enum):
    """RBAC operation axis."""

    VIEW = "view"
    CREATE = "create"
    EDIT = "edit"
    DELETE = "delete"
    SEND = "send"
    RECEIVE = "receive"


class StationPolicy(str, enum.Enum):
    """Node/station-level execution policies (reference: NodePolicy)."""

    ALLOWED_ALGORITHMS = "allowed_algorithms"
    ALLOWED_USERS = "allowed_users"
    ALLOWED_ORGANIZATIONS = "allowed_organizations"
    REQUIRE_ALGORITHM_REVIEW = "require_algorithm_review"


class AggregationKind(str, enum.Enum):
    """How a central step combines per-station partials on-device."""

    SUM = "sum"
    MEAN = "mean"
    WEIGHTED_MEAN = "weighted_mean"
    SECURE_SUM = "secure_sum"
    CONCAT = "concat"
