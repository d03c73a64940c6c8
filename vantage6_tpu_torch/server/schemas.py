"""Input validation schemas for the REST resources.

Parity: the reference validates request bodies with marshmallow schemas
(SURVEY.md §2 item 5) — one per mutating endpoint, `validate()` raising
HTTP 400 via the web layer. Real marshmallow is preferred when installed;
environments without it get `_schemas_fallback`, a drop-in implementing
exactly the subset used here, so input validation (and its 400s) never
silently disappears with the dependency.
"""
from __future__ import annotations

from typing import Any

try:
    from marshmallow import EXCLUDE, Schema, ValidationError, fields, validate
except ModuleNotFoundError:  # pragma: no cover - exercised in CI env
    from vantage6_tpu_torch.server._schemas_fallback import (  # type: ignore
        EXCLUDE, Schema, ValidationError, fields, validate,
    )

from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.server.web import HTTPError


class _Base(Schema):
    class Meta:
        unknown = EXCLUDE


class TokenUserInput(_Base):
    username = fields.Str(required=True, validate=validate.Length(min=1))
    password = fields.Str(required=True)
    mfa_code = fields.Str(load_default=None)


class TokenNodeInput(_Base):
    api_key = fields.Str(required=True)


class TokenContainerInput(_Base):
    task_id = fields.Int(required=True)
    image = fields.Str(required=True)


class RefreshInput(_Base):
    refresh_token = fields.Str(required=True)


class RecoverLostInput(_Base):
    username = fields.Str(load_default=None)
    email = fields.Email(load_default=None)


class RecoverResetInput(_Base):
    reset_token = fields.Str(required=True)
    password = fields.Str(required=True, validate=validate.Length(min=8))


class Recover2FAResetInput(_Base):
    reset_token = fields.Str(required=True)


class UserInput(_Base):
    username = fields.Str(required=True, validate=validate.Length(min=1, max=128))
    password = fields.Str(required=True, validate=validate.Length(min=8))
    email = fields.Email(load_default=None)
    firstname = fields.Str(load_default="")
    lastname = fields.Str(load_default="")
    organization_id = fields.Int(load_default=None)
    roles = fields.List(fields.Int(), load_default=list)


class UserPatch(_Base):
    email = fields.Email(load_default=None)
    firstname = fields.Str(load_default=None)
    lastname = fields.Str(load_default=None)
    password = fields.Str(load_default=None, validate=validate.Length(min=8))
    roles = fields.List(fields.Int(), load_default=None)


class OrganizationInput(_Base):
    name = fields.Str(required=True, validate=validate.Length(min=1, max=128))
    address1 = fields.Str(load_default="")
    address2 = fields.Str(load_default="")
    zipcode = fields.Str(load_default="")
    country = fields.Str(load_default="")
    domain = fields.Str(load_default="")
    public_key = fields.Str(load_default="")


class OrganizationPatch(_Base):
    name = fields.Str(load_default=None)
    country = fields.Str(load_default=None)
    domain = fields.Str(load_default=None)
    public_key = fields.Str(load_default=None)


class CollaborationInput(_Base):
    name = fields.Str(required=True, validate=validate.Length(min=1, max=128))
    encrypted = fields.Bool(load_default=False)
    organization_ids = fields.List(fields.Int(), load_default=list)


class StudyInput(_Base):
    name = fields.Str(required=True)
    collaboration_id = fields.Int(required=True)
    organization_ids = fields.List(fields.Int(), load_default=list)


class NodeInput(_Base):
    name = fields.Str(load_default=None)
    organization_id = fields.Int(load_default=None)
    collaboration_id = fields.Int(required=True)
    station_index = fields.Int(load_default=None)


class DatabaseSpec(_Base):
    label = fields.Str(required=True)
    type = fields.Str(load_default=None)
    # sessions: type="session" reads the named dataframe from the node's
    # session store instead of a source database
    dataframe = fields.Str(load_default=None)


class SessionInput(_Base):
    name = fields.Str(required=True, validate=validate.Length(min=1))
    collaboration_id = fields.Int(required=True)
    study_id = fields.Int(load_default=None)
    scope = fields.Str(
        load_default="collaboration",
        validate=validate.OneOf(["own", "collaboration"]),
    )


class SessionDataframePatch(_Base):
    ready = fields.Bool(load_default=None)
    columns = fields.List(fields.Dict(keys=fields.Str()), load_default=None)


class TaskInput(_Base):
    name = fields.Str(load_default="task")
    description = fields.Str(load_default="")
    method = fields.Str(load_default="")
    image = fields.Str(required=True, validate=validate.Length(min=1))
    collaboration_id = fields.Int(required=True)
    study_id = fields.Int(load_default=None)
    # one entry per target organization: {"id": org_id, "input": "<blob>"}
    # (input is pre-encrypted per org when the collaboration is encrypted)
    organizations = fields.List(
        fields.Dict(keys=fields.Str()), required=True,
        validate=validate.Length(min=1),
    )
    databases = fields.List(fields.Nested(DatabaseSpec), load_default=list)
    # sessions
    session_id = fields.Int(load_default=None)
    store_as = fields.Str(load_default=None)
    # execution engine: "process" (node-local sandbox/inline run, default)
    # or "device" (one SPMD program over the nodes' global device mesh —
    # every targeted node joins the same collective computation)
    engine = fields.Str(
        load_default=None,
        validate=validate.OneOf(["process", "device"]),
    )


class PasswordChangeInput(_Base):
    current_password = fields.Str(required=True)
    new_password = fields.Str(required=True, validate=validate.Length(min=8))


class RunPatch(_Base):
    # a free-form status would later make TaskStatus(run.status) raise (500)
    # and Task.status() misclassify the run — reject it at the boundary
    status = fields.Str(
        load_default=None,
        validate=validate.OneOf([s.value for s in TaskStatus]),
    )
    result = fields.Str(load_default=None)
    log = fields.Str(load_default=None)
    started_at = fields.Float(load_default=None)
    finished_at = fields.Float(load_default=None)


class ClaimBatchInput(_Base):
    """POST /api/run/claim-batch — the node sweep/dispatch coalesced."""

    # explicit dispatch: fetch exactly these runs (event fast path);
    # absent -> sweep mode (all claimable pending runs for the node)
    run_ids = fields.List(fields.Int(), load_default=None)
    # runs the daemon is executing right now: never orphan-reset them and
    # don't re-deliver them in the pending listing
    exclude_run_ids = fields.List(fields.Int(), load_default=list)
    # also re-queue INITIALIZING/ACTIVE orphans (anti-entropy sweep mode)
    reset_orphans = fields.Bool(load_default=False)
    max = fields.Int(
        load_default=250, validate=validate.Range(min=1, max=250)
    )


class RunBatchItem(RunPatch):
    """One entry of PATCH /api/run/batch — RunPatch plus the target id."""

    id = fields.Int(required=True)


class RunBatchPatch(_Base):
    runs = fields.List(
        fields.Nested(RunBatchItem), required=True,
        validate=validate.Length(min=1, max=250),
    )


class RoleInput(_Base):
    name = fields.Str(required=True)
    description = fields.Str(load_default="")
    organization_id = fields.Int(load_default=None)
    rules = fields.List(fields.Int(), load_default=list)


class RolePatch(_Base):
    name = fields.Str(load_default=None)
    description = fields.Str(load_default=None)
    rules = fields.List(fields.Int(), load_default=None)


class PortInput(_Base):
    run_id = fields.Int(required=True)
    port = fields.Int(required=True, validate=validate.Range(min=1, max=65535))
    label = fields.Str(load_default="")


def load(schema: Schema, payload: Any) -> dict[str, Any]:
    """Validate `payload` against `schema`, raising HTTP 400 on failure."""
    if not isinstance(payload, dict):
        raise HTTPError(400, "body must be a JSON object")
    try:
        return schema.load(payload)
    except ValidationError as e:
        raise HTTPError(400, f"invalid input: {e.messages}") from None
