"""Rule-based access control: scope × operation per resource.

Parity: vantage6-server `PermissionManager` (SURVEY.md §2 item 4). A *rule*
grants one operation on one resource at one scope; roles bundle rules;
users hold roles (plus optional extra rules). Default roles (Root, …)
mirror the reference's seeded set.
"""
from __future__ import annotations

import enum
from typing import Iterable

from vantage6_tpu_torch.server import models as m


class Scope(str, enum.Enum):
    OWN = "own"
    ORGANIZATION = "organization"
    COLLABORATION = "collaboration"
    GLOBAL = "global"

    @property
    def level(self) -> int:
        return _SCOPE_ORDER.index(self)


# replica-local: code-derived constant, identical on every replica
_SCOPE_ORDER = [Scope.OWN, Scope.ORGANIZATION, Scope.COLLABORATION, Scope.GLOBAL]


class Operation(str, enum.Enum):
    VIEW = "view"
    CREATE = "create"
    EDIT = "edit"
    DELETE = "delete"
    SEND = "send"
    RECEIVE = "receive"


# resource -> operations that exist for it (the rule matrix the reference
# seeds at server start)
# replica-local: code-derived constant, identical on every replica
RESOURCE_OPERATIONS: dict[str, list[Operation]] = {
    "user": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "organization": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "collaboration": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "study": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "node": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "task": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "run": [Operation.VIEW],
    "role": [Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE],
    "rule": [Operation.VIEW],
    "event": [Operation.SEND, Operation.RECEIVE],
    "port": [Operation.VIEW],
    "session": [
        Operation.VIEW, Operation.CREATE, Operation.EDIT, Operation.DELETE
    ],
}

# scopes that make sense per resource: OWN only where a row has an owner
# replica-local: code-derived constant, identical on every replica
_OWNED = {"user", "task", "run", "session"}


def applicable_scopes(resource: str) -> list[Scope]:
    scopes = [Scope.ORGANIZATION, Scope.COLLABORATION, Scope.GLOBAL]
    if resource in _OWNED:
        scopes = [Scope.OWN, *scopes]
    return scopes


class PermissionManager:
    """Seeds the rule matrix and answers 'may user U do O on R at scope S?'"""

    def __init__(self) -> None:
        # cache of store-seeded rule ids — every replica derives the
        # replica-local: identical mapping from the shared store
        self._rule_ids: dict[tuple[str, str, str], int] = {}
        self.seed_rules()

    # ------------------------------------------------------------------ seed
    def seed_rules(self) -> None:
        existing = {
            (r.name, r.scope, r.operation): r.id for r in m.Rule.list()
        }
        for resource, ops in RESOURCE_OPERATIONS.items():
            for scope in applicable_scopes(resource):
                for op in ops:
                    key = (resource, scope.value, op.value)
                    if key not in existing:
                        rule = m.Rule(
                            name=resource, scope=scope.value, operation=op.value
                        ).save()
                        existing[key] = rule.id
        self._rule_ids = existing

    def rule(self, resource: str, scope: Scope, operation: Operation) -> int:
        try:
            return self._rule_ids[(resource, scope.value, operation.value)]
        except KeyError:
            raise KeyError(
                f"no rule {resource}/{scope.value}/{operation.value}"
            ) from None

    # ----------------------------------------------------------------- roles
    def ensure_default_roles(self) -> dict[str, m.Role]:
        """Seed the reference's default roles (Root, Collaboration Admin,
        Organization Admin, Researcher, Viewer, Container)."""
        out: dict[str, m.Role] = {}

        def role(name: str, desc: str, rules: Iterable[int]) -> m.Role:
            r = m.Role.first(name=name, organization_id=None)
            if r is None:
                r = m.Role(name=name, description=desc).save()
            for rid in rules:
                m.role_rule.add(r.id, rid)
            out[name] = r
            return r

        role("Root", "all permissions", self._rule_ids.values())
        org_admin = [
            rid
            for (res, sc, _), rid in self._rule_ids.items()
            if sc == Scope.ORGANIZATION.value
        ]
        role("Organization Admin", "manage own organization", org_admin)
        collab = [
            rid
            for (res, sc, _), rid in self._rule_ids.items()
            if sc == Scope.COLLABORATION.value
        ]
        role("Collaboration Admin", "manage own collaborations", collab)
        researcher = [
            self.rule("task", Scope.COLLABORATION, Operation.VIEW),
            self.rule("task", Scope.COLLABORATION, Operation.CREATE),
            self.rule("run", Scope.COLLABORATION, Operation.VIEW),
            self.rule("organization", Scope.COLLABORATION, Operation.VIEW),
            self.rule("collaboration", Scope.ORGANIZATION, Operation.VIEW),
            self.rule("node", Scope.COLLABORATION, Operation.VIEW),
            self.rule("event", Scope.COLLABORATION, Operation.RECEIVE),
            self.rule("session", Scope.COLLABORATION, Operation.VIEW),
            self.rule("session", Scope.COLLABORATION, Operation.CREATE),
            self.rule("session", Scope.OWN, Operation.DELETE),
        ]
        role("Researcher", "create and view tasks", researcher)
        viewer = [
            rid
            for (res, sc, op), rid in self._rule_ids.items()
            if sc == Scope.ORGANIZATION.value and op == Operation.VIEW.value
        ]
        role("Viewer", "view everything in own organization", viewer)
        return out

    # ----------------------------------------------------------------- check
    def user_scope(
        self, user: m.User, resource: str, operation: Operation
    ) -> Scope | None:
        """Widest scope at which the user may perform the operation."""
        rules = user.rule_ids()
        best: Scope | None = None
        for scope in applicable_scopes(resource):
            key = (resource, scope.value, operation.value)
            rid = self._rule_ids.get(key)
            if rid is not None and rid in rules:
                if best is None or scope.level > best.level:
                    best = scope
        return best

    def allowed(
        self,
        user: m.User,
        resource: str,
        operation: Operation,
        *,
        organization_id: int | None = None,
        collaboration_id: int | None = None,
        owner_id: int | None = None,
    ) -> bool:
        """Check against a concrete target.

        A GLOBAL rule always passes; COLLABORATION requires the user's org in
        the target collaboration; ORGANIZATION requires same org; OWN
        requires the user to own the row.
        """
        scope = self.user_scope(user, resource, operation)
        if scope is None:
            return False
        if scope == Scope.GLOBAL:
            return True
        if scope == Scope.COLLABORATION:
            if collaboration_id is None:
                # no collaboration context: org-level fallback
                return (
                    organization_id is not None
                    and organization_id == user.organization_id
                ) or owner_id == user.id
            collab = m.Collaboration.get(collaboration_id)
            return (
                collab is not None
                and user.organization_id in collab.organization_ids()
            )
        if scope == Scope.ORGANIZATION:
            if organization_id is not None:
                return organization_id == user.organization_id
            return owner_id == user.id
        # OWN
        return owner_id is not None and owner_id == user.id
