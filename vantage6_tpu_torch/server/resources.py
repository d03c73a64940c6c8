"""REST resources: one section per entity, CRUD + pagination + RBAC.

Parity: vantage6-server's resource modules (SURVEY.md §2 item 3) and the
auth endpoints of item 7. Routes live under `/api/*` with the reference's
wire shapes (`{"data": [...]}` lists, task fan-out to runs, node PATCH of
run status/result, kill events, cursor-based event sync).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any

from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.server import events as ev
from vantage6_tpu_torch.server import models as m
from vantage6_tpu_torch.server import schemas as sch
from vantage6_tpu_torch.server.auth import AuthError, decode_jwt, verify_totp
from vantage6_tpu_torch.server.permission import Operation, Scope
from vantage6_tpu_torch.server.web import HTTPError, Request

if TYPE_CHECKING:  # pragma: no cover
    from vantage6_tpu_torch.server.app import ServerApp


# --------------------------------------------------------------- auth helpers


def identity_from_token(srv: "ServerApp", token: str | None) -> tuple[str, Any]:
    """Resolve a bearer token to (kind, principal); raises HTTPError(401).
    Shared by the REST auth path and the websocket bridge.

    Resolutions are cached (`srv.auth_cache`, token → principal, with the
    user's rule-id set precomputed) so a polling daemon or batching client
    pays the JWT verify + principal/rule queries once per TTL, not per
    request. Every mutation that could change the answer — credential
    rotation, role/rule edits, principal deletion — explicitly invalidates
    (see the endpoints below); the entry also dies at the token's own exp.
    """
    if not token:
        raise HTTPError(401, "missing bearer token")
    # cross-replica coherence: apply peers' pending cache invalidations
    # BEFORE consulting this replica's caches (rate-limited; no-op on an
    # in-process hub — see ServerApp.drain_invalidations)
    srv.drain_invalidations()
    cached = srv.auth_cache.get(token)
    if cached is not None:
        return cached
    try:
        sub, claims = srv.tokens.identity_claims(token)
    except AuthError as e:
        raise HTTPError(401, str(e)) from None
    kind = sub["type"]
    if kind == "user":
        user = m.User.get(sub["id"])
        if user is None:
            raise HTTPError(401, "unknown user")
        if not srv.tokens.fingerprint_ok(
            claims, user.password_hash, user.totp_secret
        ):
            # credentials rotated after issuance: the session is dead —
            # this is what makes a password change evict a stolen session
            raise HTTPError(401, "token superseded by a credential change")
        # warm the rule set so permission checks on this cached principal
        # cost zero queries (User.rule_ids honors _rules_cache)
        user._rules_cache = frozenset(user.rule_ids())
        srv.auth_cache.put(token, "user", user, claims.get("exp"))
        return "user", user
    if kind == "node":
        node = m.Node.get(sub["id"])
        if node is None:
            raise HTTPError(401, "unknown node")
        srv.auth_cache.put(token, "node", node, claims.get("exp"))
        return "node", node
    if kind == "container":
        srv.auth_cache.put(token, "container", sub, claims.get("exp"))
        return "container", sub
    raise HTTPError(401, "unknown principal type")


def _visible_collab_ids(srv: "ServerApp", org_id: int) -> frozenset[int]:
    """Collaboration ids containing `org_id` — THE visibility check the
    listing endpoints and event-room scoping previously re-derived from a
    full Collaboration scan per request (and per run, in the run listing).
    Cached on the server; invalidated on any membership mutation."""
    cached = srv.vis_cache.get(org_id)
    if cached is not None:
        return cached
    ids = frozenset(
        c.id for c in m.Collaboration.list() if org_id in c.organization_ids()
    )
    srv.vis_cache.put(org_id, ids)
    return ids


def _identity(srv: "ServerApp", req: Request) -> tuple[str, Any]:
    return identity_from_token(srv, req.bearer_token)


def _invalidate(srv: "ServerApp", entity: str, id_: int | None = None) -> None:
    """ONE invalidation call per mutation site: applies to this replica's
    caches immediately and — when the event hub is the shared-store bus —
    publishes a CACHE_INVALIDATE event so every OTHER replica applies it
    too (ServerApp.drain_invalidations). Entities: user/node evict the
    principal's tokens; role/rule evict the whole auth cache (a role's
    rule set reaches arbitrarily many users); collaboration evicts the
    visibility cache."""
    if entity in ("user", "node") and id_ is not None:
        srv.auth_cache.invalidate_principal(entity, id_)
    elif entity in ("role", "rule"):
        srv.auth_cache.invalidate_all()
    elif entity == "collaboration":
        srv.vis_cache.invalidate_all()
    if getattr(srv.hub, "SHARED", False):
        from vantage6_tpu_torch.server.events import CACHE_INVALIDATE, REPLICA_ROOM

        try:
            srv.hub.emit(
                CACHE_INVALIDATE, {"entity": entity, "id": id_},
                room=REPLICA_ROOM,
            )
        except Exception:  # the local invalidation already happened;
            pass  # peers' TTL is the backstop if the emit is lost


def _require_user(srv: "ServerApp", req: Request) -> m.User:
    kind, principal = _identity(srv, req)
    if kind != "user":
        raise HTTPError(403, "user credentials required")
    return principal


def _require_node(srv: "ServerApp", req: Request) -> m.Node:
    kind, principal = _identity(srv, req)
    if kind != "node":
        raise HTTPError(403, "node credentials required")
    return principal


def _check(ok: bool) -> None:
    if not ok:
        raise HTTPError(403)


def _paginate(req: Request, rows: list[Any]) -> dict[str, Any]:
    start = (req.page - 1) * req.per_page
    return {
        "data": [r.to_dict() for r in rows[start : start + req.per_page]],
        "pagination": {
            "page": req.page,
            "per_page": req.per_page,
            "total": len(rows),
        },
    }


def _get_or_404(model: type, id_: int) -> Any:
    row = model.get(id_)
    if row is None:
        raise HTTPError(404)
    return row


def _node_for_org(collaboration_id: int, organization_id: int) -> m.Node | None:
    return m.Node.first(
        collaboration_id=collaboration_id, organization_id=organization_id
    )


def _container_task(principal: dict[str, Any]) -> m.Task:
    """The parent task of a container principal; 401 if it was deleted
    (container tokens outlive task deletion)."""
    task = m.Task.get(principal["task_id"])
    if task is None:
        raise HTTPError(401, "container's task no longer exists")
    return task


def _user_for_reset_token(srv: "ServerApp", token: str) -> m.User:
    """Resolve a password-reset token to its user; 401 on expiry, tamper,
    or reuse (the token binds the password hash it was issued against)."""
    # peek at the subject first so the pwh check runs against the right user
    try:
        sub = decode_jwt(token, srv.tokens.secret).get("sub") or {}
        user = m.User.get(int(sub.get("id", -1))) if sub else None
        if user is None:
            raise AuthError("unknown user")
        srv.tokens.validate_password_reset(
            token, user.password_hash, user.totp_secret
        )
    except AuthError as e:
        raise HTTPError(401, str(e)) from None
    return user


def _grant_role_rules(
    user: m.User, role: m.Role, rule_ids: list[int], *, replace: bool = False
) -> None:
    """Attach rules to a role — the grantor may only hand out rules they
    hold themselves (reference rule; without this, any role-CREATE/EDIT
    holder could mint a super-role). Shared by role create and PATCH."""
    own = user.rule_ids()
    for rid in rule_ids:
        if rid not in own:
            raise HTTPError(403, f"cannot grant rule {rid} you do not have")
    if replace:
        for rid in list(role.rule_ids()):
            m.role_rule.remove(role.id, rid)
    for rid in rule_ids:
        role.add_rule(_get_or_404(m.Rule, rid))


def _check_role_grant(user: m.User, role_ids: list[int]) -> list[m.Role]:
    """A grantor may only hand out roles whose rules they hold themselves —
    without this, any user-EDIT holder could self-assign Root."""
    own = user.rule_ids()
    roles = []
    for rid in role_ids:
        role = _get_or_404(m.Role, rid)
        missing = set(role.rule_ids()) - own
        if missing:
            raise HTTPError(
                403,
                f"cannot assign role {role.name!r}: it grants rules you "
                "do not have",
            )
        roles.append(role)
    return roles


def register_resources(srv: "ServerApp") -> None:
    app = srv.app
    pm = srv.pm

    # ------------------------------------------------------------- service
    @app.route("/api/health")
    def health(req: Request):
        """Real health verdict, not just a capability card: `status` is
        "ok" or "degraded" — degraded when any registered component
        (event hub, tracer sink, the watchdog's own evaluation loop)
        fails its self-check, or a critical alert is active. The
        capability flags the clients probe stay unchanged."""
        from vantage6_tpu_torch import __version__
        from vantage6_tpu_torch.runtime.tracing import TRACER

        verdict = srv.watchdog.health()
        out = {
            "status": verdict["status"],
            "components": verdict["components"],
            "alerts": {**verdict["alerts"], "url": "/api/alerts"},
            "uptime": time.time() - srv.started_at,
            "replica_id": srv.replica_id,
            "version": __version__,
            # advertised so nodes/UIs can upgrade from polling to push
            "websocket_url": srv.ws_url,
            # capability flags the clients probe (see docs/observability.md)
            "long_poll": True,
            "metrics": "/api/metrics",
            "tracing": TRACER.enabled,
        }
        if srv.db.SHARED:
            # shared-store deployments: the fleet view, read from DB truth
            # (replica_heartbeat) — "did a replica die" is answered here
            from vantage6_tpu_torch.server import pubsub

            out["replicas"] = pubsub.list_replicas(srv.db)
        # fleet telemetry census: how many sources push here, how many
        # went quiet (full view at /api/fleet)
        from vantage6_tpu_torch.server import fleet

        out["fleet"] = {**fleet.health_block(srv.db), "url": "/api/fleet"}
        return out

    @app.route("/api/alerts")
    def alerts(req: Request):
        """Watchdog alert state: active alerts, recently resolved ones,
        and the rule catalog (what each alert means + its runbook line).
        Unauthenticated like /api/health and /api/metrics — it carries
        operational state (rule names, run/node ids), never payloads or
        principals."""
        from vantage6_tpu_torch.runtime.watchdog import RULE_CATALOG

        return {
            "status": srv.watchdog.health()["status"],
            "active": srv.watchdog.active_alerts(),
            "recent": srv.watchdog.recent_alerts(
                limit=min(200, max(1, req.int_arg("limit", 50)))
            ),
            "rules": RULE_CATALOG,
        }

    @app.route("/api/telemetry", methods=("POST",))
    def telemetry_push(req: Request):
        """Fleet push ingest: daemons and Federation processes POST their
        compact telemetry snapshot + flight-note deltas here (wire-v2
        blob, base64 in a JSON envelope — see `common.fleet.encode_push`).
        Samples land as CAS-free appends in the fleet tables, so pushing
        through ANY replica of a shared store feeds the same fleet view.
        Any authenticated principal may push: nodes push their daemon's
        snapshot, users push a Federation's — the payload carries
        aggregate counters and ops notes, never secrets."""
        _identity(srv, req)
        from vantage6_tpu_torch.common.fleet import decode_push
        from vantage6_tpu_torch.server import fleet

        body = req.json
        if not isinstance(body, dict):
            raise HTTPError(400, "body must be a JSON object")
        try:
            payload = decode_push(body)
        except ValueError as e:
            from vantage6_tpu_torch.common.telemetry import REGISTRY

            REGISTRY.counter("v6t_fleet_ingest_rejects_total").inc()
            raise HTTPError(400, f"undecodable telemetry push: {e}") from None
        return {"accepted": True, **fleet.ingest(srv.db, payload)}, 201

    @app.route("/api/fleet")
    def fleet_index(req: Request):
        """The aggregated fleet view: per-source freshness, the merged
        counter/gauge census, top-k counter deltas over the SLO fast
        window, recent cross-host events, and the daemon-liveness ratio.
        Read from the shared store, so every replica serves the SAME
        answer. Unauthenticated like /api/health and /api/metrics — it
        carries aggregate operational state only, never payloads or
        principals."""
        from vantage6_tpu_torch.server import fleet

        return fleet.fleet_view(srv.db)

    @app.route("/api/rounds")
    def rounds_index(req: Request):
        """Learning-plane index: every task the process learning registry
        tracks, with its convergence summary (rounds, first/last/peak
        pooled-update norm, decay, per-station contribution table).
        Unauthenticated like /api/alerts — it carries aggregate update
        STATISTICS (norms, cosines), never payloads or principals."""
        from vantage6_tpu_torch.runtime.learning import LEARNING

        return {"tasks": LEARNING.summaries()}

    @app.route("/api/rounds/<int:id>")
    def rounds_for_task(req: Request, id: int):
        """One task's learning-plane round history: per-round loss, the
        pooled update norm (convergence trajectory), and per-station
        norms/cosines/EF mass — what the `anomalous_station` /
        `non_convergence` / `model_divergence` watchdog rules read, served
        raw so an operator (or the doctor) can see WHY an alert fired.
        404 for tasks the learning registry never tracked (host-mode
        tasks without an engine/aggregation recording). Served from the
        MERGED view: on a shared backend, rounds recorded via other
        replicas (per-round subtasks land wherever the daemon's poll
        lands) are part of this task's one trajectory."""
        from vantage6_tpu_torch.runtime.learning import LEARNING

        hist = LEARNING.merged(id)
        if hist is None:
            raise HTTPError(
                404,
                f"no learning-plane history for task {id} (not an "
                "engine/aggregated task, or evicted)",
            )
        limit = min(512, max(1, req.int_arg("limit", 128)))
        return {
            "task_id": id,
            "summary": hist.summary(),
            "rounds": hist.rounds(limit=limit),
        }

    @app.route("/api/debug/dump", methods=("POST",))
    def debug_dump(req: Request):
        """Dump this server process's flight recorder to a JSONL bundle
        (crash forensics on demand — the REST twin of `kill -USR2`).
        User-only: each call writes a fresh file to server disk, so a
        compromised node/container credential must not be able to fill
        the disk one bundle at a time — operators dump, stations don't."""
        _require_user(srv, req)
        from vantage6_tpu_torch.common.flight import FLIGHT

        path = FLIGHT.dump(reason="api")
        if path is None:
            raise HTTPError(500, "flight dump failed (disk unwritable?)")
        return {"path": path, "counts": FLIGHT.stats()}, 201

    @app.route("/api/debug/profile", methods=("POST",))
    def debug_profile(req: Request):
        """Open an on-demand torch.profiler window on THIS server process
        (body: ``{"seconds": 1.0}``, clamped server-side) and return the
        artifact path (``path``, the window's directory, and ``trace``,
        the Chrome trace JSON in it, with the card's kernels when CUDA is
        available). The window is recorded as a ``device.profile``
        span inside the requesting trace (the handler runs in the joined
        request span) and registered in the flight recorder, so a later
        doctor of a bundle names where the Perfetto session lives.
        User-only like debug/dump — each call writes server disk and
        holds a worker for the window; operators profile, stations
        don't. 409 when a window is already open."""
        _require_user(srv, req)
        from vantage6_tpu_torch.runtime.profiling import (
            ProfileBusyError,
            profile_window,
        )

        body = req.json
        if body is None:
            body = {}
        if not isinstance(body, dict):
            raise HTTPError(400, "body must be a JSON object")
        seconds = body.get("seconds", 1.0)
        if isinstance(seconds, bool) or not isinstance(seconds, (int, float)):
            raise HTTPError(400, "seconds must be a number")
        try:
            out = profile_window(float(seconds))
        except ProfileBusyError as e:
            raise HTTPError(409, str(e)) from None
        return out, 201

    @app.route("/api/metrics")
    def metrics(req: Request):
        """Prometheus text exposition of the unified telemetry registry:
        wire, REST, HTTP, executor-queue, event-hub, cache-hit and tracing
        series in one scrape (docs/observability.md). Unauthenticated by
        design, like /api/health — it carries aggregate counters only,
        never payloads or principals."""
        from vantage6_tpu_torch.common.telemetry import (
            PROMETHEUS_CONTENT_TYPE,
            REGISTRY,
        )
        from vantage6_tpu_torch.server.web import Response

        return Response(
            REGISTRY.render_prometheus(),
            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE},
        )

    @app.route("/api/version")
    def version(req: Request):
        from vantage6_tpu_torch import __version__

        return {"version": __version__}

    # -------------------------------------------------------------- tokens
    @app.route("/api/token/user", methods=("POST",))
    def token_user(req: Request):
        body = sch.load(sch.TokenUserInput(), req.json)
        user = m.User.first(username=body["username"])
        if user is None:
            raise HTTPError(401, "invalid username or password")
        if user.is_locked_out():
            raise HTTPError(401, "account locked, retry later")
        if not user.check_password(body["password"]):
            user.record_login(False)
            raise HTTPError(401, "invalid username or password")
        if user.totp_secret:
            code = body.get("mfa_code")
            if not code or not verify_totp(user.totp_secret, code):
                user.record_login(False)
                raise HTTPError(401, "MFA code required or invalid")
        user.record_login(True)
        return {
            **srv.tokens.user_tokens(
                user.id,
                fingerprint=srv.tokens._credential_fingerprint(
                    user.password_hash, user.totp_secret
                ),
            ),
            "user": user.to_dict(),
        }

    @app.route("/api/token/node", methods=("POST",))
    def token_node(req: Request):
        body = sch.load(sch.TokenNodeInput(), req.json)
        node = m.Node.by_api_key(body["api_key"])
        if node is None:
            raise HTTPError(401, "invalid api key")
        return {**srv.tokens.node_tokens(node.id), "node": node.to_dict()}

    @app.route("/api/token/container", methods=("POST",))
    def token_container(req: Request):
        node = _require_node(srv, req)
        body = sch.load(sch.TokenContainerInput(), req.json)
        task = _get_or_404(m.Task, body["task_id"])
        if task.collaboration_id != node.collaboration_id:
            raise HTTPError(403, "task is not in this node's collaboration")
        return {
            "container_token": srv.tokens.container_token(
                node_id=node.id,
                task_id=task.id,
                image=body["image"],
                organization_id=node.organization_id,
            )
        }

    @app.route("/api/token/refresh", methods=("POST",))
    def token_refresh(req: Request):
        body = sch.load(sch.RefreshInput(), req.json)
        try:
            sub, claims = srv.tokens.identity_claims(
                body["refresh_token"], use="refresh"
            )
        except AuthError as e:
            raise HTTPError(401, str(e)) from None
        if sub["type"] == "user":
            user = m.User.get(sub["id"])
            if user is None:
                raise HTTPError(401, "unknown user")
            if not srv.tokens.fingerprint_ok(
                claims, user.password_hash, user.totp_secret
            ):
                # a stolen refresh token must not outlive a password change
                raise HTTPError(
                    401, "token superseded by a credential change"
                )
            return srv.tokens.user_tokens(
                user.id,
                fingerprint=srv.tokens._credential_fingerprint(
                    user.password_hash, user.totp_secret
                ),
            )
        if sub["type"] == "node":
            return srv.tokens.node_tokens(sub["id"])
        raise HTTPError(401, "container tokens cannot be refreshed")

    # ------------------------------------------------------------- recovery
    # Parity: the reference's recover.py — password reset (and 2FA reset)
    # over emailed single-use tokens (SURVEY.md §2 item 7). Responses never
    # reveal whether an account exists.
    @app.route("/api/recover/lost", methods=("POST",))
    def recover_lost(req: Request):
        body = sch.load(sch.RecoverLostInput(), req.json)
        user = None
        if body.get("username"):
            user = m.User.first(username=body["username"])
        if user is None and body.get("email"):
            user = m.User.first(email=body["email"])
        if user is not None and user.email:
            token = srv.tokens.password_reset_token(
                user.id, user.password_hash, user.totp_secret
            )
            srv.mailer.send(
                user.email,
                "vantage6: password reset",
                "A password reset was requested for your account "
                f"{user.username!r}.\n\nReset token (valid "
                f"{int(srv.tokens.RESET_TTL // 60)} minutes, single use):\n\n"
                f"{token}\n\nIf you did not request this, ignore this mail.",
            )
        return {
            "msg": "if the account exists and has an email address, a "
            "reset token was sent"
        }

    @app.route("/api/recover/reset", methods=("POST",))
    def recover_reset(req: Request):
        body = sch.load(sch.RecoverResetInput(), req.json)
        user = _user_for_reset_token(srv, body["reset_token"])
        user.set_password(body["password"])
        user.failed_login_attempts = 0
        user.save()
        # the fingerprint rotation must bite NOW, not at cache TTL
        _invalidate(srv, "user", user.id)
        return {"msg": "password updated"}

    @app.route("/api/password/change", methods=("POST",))
    def password_change(req: Request):
        """Self-service password change (reference: /password/change):
        the CURRENT password is required even with a valid token, so a
        stolen session cannot silently take over the account. Wrong
        guesses feed the lockout counter — a token holder must not get a
        free password-guessing oracle (same stance as recover_2fa_lost) —
        and a successful change rotates the credential fingerprint, which
        kills every outstanding token including the attacker's."""
        user = _require_user(srv, req)
        body = sch.load(sch.PasswordChangeInput(), req.json)
        if user.is_locked_out():
            raise HTTPError(401, "account locked, retry later")
        if not user.check_password(body["current_password"]):
            user.record_login(False)
            raise HTTPError(401, "current password is incorrect")
        user.set_password(body["new_password"])
        user.failed_login_attempts = 0
        user.save()
        # every outstanding token (incl. a cached attacker session) dies now
        _invalidate(srv, "user", user.id)
        return {"msg": "password updated — all sessions are now invalid; "
                       "log in again"}

    @app.route("/api/recover/2fa/lost", methods=("POST",))
    def recover_2fa_lost(req: Request):
        """Lost authenticator: prove password, get an emailed reset token
        (the reference gates 2FA reset on the password the same way)."""
        body = sch.load(sch.TokenUserInput(), req.json)
        user = m.User.first(username=body["username"])
        if user is not None and not user.is_locked_out():
            if not user.check_password(body["password"]):
                # same lockout accounting as /api/token/user — this endpoint
                # must not be a password-guessing oracle outside the counter
                user.record_login(False)
            elif user.email:
                user.record_login(True)
                token = srv.tokens.password_reset_token(
                    user.id, user.password_hash, user.totp_secret
                )
                srv.mailer.send(
                    user.email,
                    "vantage6: two-factor reset",
                    f"Reset token for account {user.username!r}:\n\n{token}",
                )
        return {
            "msg": "if the credentials are valid and the account has an "
            "email address, a reset token was sent"
        }

    @app.route("/api/recover/2fa/reset", methods=("POST",))
    def recover_2fa_reset(req: Request):
        from vantage6_tpu_torch.server.auth import generate_totp_secret

        body = sch.load(sch.Recover2FAResetInput(), req.json)
        user = _user_for_reset_token(srv, body["reset_token"])
        user.totp_secret = generate_totp_secret()
        user.save()
        _invalidate(srv, "user", user.id)
        # the new secret is returned ONCE for authenticator re-enrollment
        return {"totp_secret": user.totp_secret}

    # --------------------------------------------------------------- users
    @app.route("/api/user", methods=("GET", "POST"))
    def users(req: Request):
        user = _require_user(srv, req)
        if req.method == "GET":
            scope = pm.user_scope(user, "user", Operation.VIEW)
            _check(scope is not None)
            rows = m.User.list()
            if scope != Scope.GLOBAL:
                rows = [
                    u
                    for u in rows
                    if u.organization_id == user.organization_id
                    or u.id == user.id
                ]
            return _paginate(req, rows)
        body = sch.load(sch.UserInput(), req.json)
        org_id = body["organization_id"] or user.organization_id
        _check(pm.allowed(user, "user", Operation.CREATE, organization_id=org_id))
        if m.User.first(username=body["username"]) is not None:
            raise HTTPError(409, "username taken")
        new = m.User(
            username=body["username"],
            email=body["email"],
            firstname=body["firstname"],
            lastname=body["lastname"],
            organization_id=org_id,
        )
        roles = _check_role_grant(user, body["roles"])
        new.set_password(body["password"])
        new.save()
        for role in roles:
            m.user_role.add(new.id, role.id)
        return new.to_dict(), 201

    @app.route("/api/user/<int:id>", methods=("GET", "PATCH", "DELETE"))
    def user_one(req: Request, id: int):
        user = _require_user(srv, req)
        target = _get_or_404(m.User, id)
        if req.method == "GET":
            _check(
                pm.allowed(
                    user, "user", Operation.VIEW,
                    organization_id=target.organization_id, owner_id=target.id,
                )
                or user.id == target.id
            )
            return target.to_dict()
        if req.method == "DELETE":
            _check(
                pm.allowed(
                    user, "user", Operation.DELETE,
                    organization_id=target.organization_id, owner_id=target.id,
                )
            )
            target.delete()
            _invalidate(srv, "user", target.id)
            return {}, 204
        _check(
            pm.allowed(
                user, "user", Operation.EDIT,
                organization_id=target.organization_id, owner_id=target.id,
            )
            or user.id == target.id
        )
        body = sch.load(sch.UserPatch(), req.json)
        for field in ("email", "firstname", "lastname"):
            if body[field] is not None:
                setattr(target, field, body[field])
        if body["password"]:
            target.set_password(body["password"])
        if body["roles"] is not None:
            # assigning roles is an admin action even on yourself
            _check(
                pm.allowed(
                    user, "user", Operation.EDIT,
                    organization_id=target.organization_id,
                )
            )
            roles = _check_role_grant(user, body["roles"])
            for rid in set(target.role_ids()):
                m.user_role.remove(target.id, rid)
            for role in roles:
                m.user_role.add(target.id, role.id)
        target.save()
        # fields/credentials/roles may all have changed: drop cached tokens
        _invalidate(srv, "user", target.id)
        return target.to_dict()

    # ------------------------------------------------------- organizations
    @app.route("/api/organization", methods=("GET", "POST"))
    def organizations(req: Request):
        kind, principal = _identity(srv, req)
        if req.method == "GET":
            if kind == "user":
                scope = pm.user_scope(principal, "organization", Operation.VIEW)
                _check(scope is not None)
                rows = m.Organization.list()
                if scope == Scope.ORGANIZATION:
                    rows = [
                        o for o in rows if o.id == principal.organization_id
                    ]
                elif scope == Scope.COLLABORATION:
                    visible: set[int] = {principal.organization_id}
                    for cid in _visible_collab_ids(
                        srv, principal.organization_id
                    ):
                        visible.update(
                            m.Collaboration.get(cid).organization_ids()
                        )
                    rows = [o for o in rows if o.id in visible]
                return _paginate(req, rows)
            # nodes/containers see their collaboration's organizations (needed
            # for task fan-out and E2E encryption pubkeys)
            collab_id = (
                principal.collaboration_id
                if kind == "node"
                else _container_task(principal).collaboration_id
            )
            ids = m.Collaboration.get(collab_id).organization_ids()
            rows = [o for o in m.Organization.list() if o.id in ids]
            return _paginate(req, rows)
        user = _require_user(srv, req)
        _check(pm.user_scope(user, "organization", Operation.CREATE) == Scope.GLOBAL)
        body = sch.load(sch.OrganizationInput(), req.json)
        org = m.Organization(**body).save()
        return org.to_dict(), 201

    @app.route("/api/organization/<int:id>", methods=("GET", "PATCH"))
    def organization_one(req: Request, id: int):
        kind, principal = _identity(srv, req)
        org = _get_or_404(m.Organization, id)
        if req.method == "GET":
            if kind == "user":
                _check(
                    pm.allowed(
                        principal, "organization", Operation.VIEW,
                        organization_id=org.id,
                    )
                    or any(
                        org.id
                        in m.Collaboration.get(cid).organization_ids()
                        for cid in _visible_collab_ids(
                            srv, principal.organization_id
                        )
                    )
                )
            else:
                # nodes/containers: own org or a fellow collaboration member
                collab_id = (
                    principal.collaboration_id
                    if kind == "node"
                    else _container_task(principal).collaboration_id
                )
                own_org = (
                    principal.organization_id
                    if kind == "node"
                    else principal["organization_id"]
                )
                _check(
                    org.id == own_org
                    or org.id
                    in m.Collaboration.get(collab_id).organization_ids()
                )
            return org.to_dict()
        if kind == "node":
            # a node registers/rotates its OWN organization's public key
            # (reference: node start uploads the org pubkey) — nothing else
            _check(principal.organization_id == org.id)
            body = sch.load(sch.OrganizationPatch(), req.json)
            if body.get("public_key") is not None:
                org.public_key = body["public_key"]
                org.save()
            return org.to_dict()
        user = _require_user(srv, req)
        _check(
            pm.allowed(user, "organization", Operation.EDIT, organization_id=org.id)
        )
        body = sch.load(sch.OrganizationPatch(), req.json)
        for field, value in body.items():
            if value is not None:
                setattr(org, field, value)
        org.save()
        return org.to_dict()

    # ------------------------------------------------------ collaborations
    @app.route("/api/collaboration", methods=("GET", "POST"))
    def collaborations(req: Request):
        kind, principal = _identity(srv, req)
        if req.method == "GET":
            rows = m.Collaboration.list()
            if kind == "user":
                scope = pm.user_scope(principal, "collaboration", Operation.VIEW)
                _check(scope is not None)
                if scope != Scope.GLOBAL:
                    rows = [
                        c
                        for c in rows
                        if principal.organization_id in c.organization_ids()
                    ]
            elif kind == "node":
                rows = [c for c in rows if c.id == principal.collaboration_id]
            else:
                raise HTTPError(403)
            return _paginate(req, rows)
        user = _require_user(srv, req)
        _check(
            pm.user_scope(user, "collaboration", Operation.CREATE) == Scope.GLOBAL
        )
        body = sch.load(sch.CollaborationInput(), req.json)
        collab = m.Collaboration(
            name=body["name"], encrypted=body["encrypted"]
        ).save()
        for oid in body["organization_ids"]:
            collab.add_organization(_get_or_404(m.Organization, oid))
        _invalidate(srv, "collaboration")
        return collab.to_dict(), 201

    @app.route("/api/collaboration/<int:id>", methods=("GET", "PATCH", "DELETE"))
    def collaboration_one(req: Request, id: int):
        kind, principal = _identity(srv, req)
        collab = _get_or_404(m.Collaboration, id)
        if req.method == "GET":
            if kind == "user":
                _check(
                    pm.allowed(
                        principal, "collaboration", Operation.VIEW,
                        collaboration_id=collab.id,
                        organization_id=principal.organization_id
                        if principal.organization_id in collab.organization_ids()
                        else None,
                    )
                )
            elif kind == "node":
                _check(principal.collaboration_id == collab.id)
            else:  # container: its own collaboration only
                _check(
                    _container_task(principal).collaboration_id == collab.id
                )
            return collab.to_dict()
        user = _require_user(srv, req)
        if req.method == "DELETE":
            _check(
                pm.user_scope(user, "collaboration", Operation.DELETE)
                == Scope.GLOBAL
            )
            collab.delete()
            _invalidate(srv, "collaboration")
            return {}, 204
        _check(
            pm.allowed(
                user, "collaboration", Operation.EDIT, collaboration_id=collab.id
            )
        )
        body = sch.load(sch.CollaborationInput(partial=True), req.json)
        if body.get("name"):
            collab.name = body["name"]
        if "encrypted" in body:
            collab.encrypted = body["encrypted"]
        collab.save()
        if body.get("organization_ids"):
            for oid in body["organization_ids"]:
                collab.add_organization(_get_or_404(m.Organization, oid))
            _invalidate(srv, "collaboration")
        return collab.to_dict()

    # -------------------------------------------------------------- studies
    @app.route("/api/study", methods=("GET", "POST"))
    def studies(req: Request):
        user = _require_user(srv, req)
        if req.method == "GET":
            scope = pm.user_scope(user, "study", Operation.VIEW)
            _check(scope is not None)
            rows = m.Study.list()
            if scope != Scope.GLOBAL:
                rows = [
                    s
                    for s in rows
                    if user.organization_id
                    in m.Collaboration.get(s.collaboration_id).organization_ids()
                ]
            return _paginate(req, rows)
        body = sch.load(sch.StudyInput(), req.json)
        collab = _get_or_404(m.Collaboration, body["collaboration_id"])
        _check(
            pm.allowed(
                user, "study", Operation.CREATE, collaboration_id=collab.id
            )
        )
        study = m.Study(name=body["name"], collaboration_id=collab.id).save()
        for oid in body["organization_ids"]:
            if oid not in collab.organization_ids():
                raise HTTPError(400, f"organization {oid} not in collaboration")
            study.add_organization(_get_or_404(m.Organization, oid))
        return study.to_dict(), 201

    @app.route("/api/study/<int:id>", methods=("GET", "DELETE"))
    def study_one(req: Request, id: int):
        user = _require_user(srv, req)
        study = _get_or_404(m.Study, id)
        if req.method == "GET":
            _check(
                pm.allowed(
                    user, "study", Operation.VIEW,
                    collaboration_id=study.collaboration_id,
                )
            )
            return study.to_dict()
        _check(
            pm.allowed(
                user, "study", Operation.DELETE,
                collaboration_id=study.collaboration_id,
            )
        )
        study.delete()
        return {}, 204

    # ------------------------------------------------------------- sessions
    def _session_visible(user: m.User, s: m.Session) -> bool:
        if (s.scope or "collaboration") == "own" and s.owner_id != user.id:
            return False
        return pm.allowed(
            user, "session", Operation.VIEW,
            collaboration_id=s.collaboration_id, owner_id=s.owner_id,
        )

    @app.route("/api/session", methods=("GET", "POST"))
    def sessions(req: Request):
        user = _require_user(srv, req)
        if req.method == "GET":
            rows = [
                s for s in m.Session.list() if _session_visible(user, s)
            ]
            return _paginate(req, rows)
        body = sch.load(sch.SessionInput(), req.json)
        collab = _get_or_404(m.Collaboration, body["collaboration_id"])
        _check(
            pm.allowed(
                user, "session", Operation.CREATE,
                collaboration_id=collab.id,
            )
        )
        if body["study_id"] is not None:
            study = _get_or_404(m.Study, body["study_id"])
            if study.collaboration_id != collab.id:
                raise HTTPError(400, "study not in collaboration")
        session = m.Session(
            name=body["name"],
            collaboration_id=collab.id,
            study_id=body["study_id"],
            owner_id=user.id,
            scope=body["scope"],
        ).save()
        return session.to_dict(), 201

    @app.route("/api/session/<int:id>", methods=("GET", "DELETE"))
    def session_one(req: Request, id: int):
        kind, principal = _identity(srv, req)
        session = _get_or_404(m.Session, id)
        if req.method == "GET":
            if kind == "node":
                # nodes probe session existence to reconcile their local
                # stores after downtime (a 404 means: drop the store)
                _check(
                    principal.collaboration_id == session.collaboration_id
                )
                return session.to_dict()
            _check(kind == "user")
            _check(_session_visible(principal, session))
            return session.to_dict()
        user = _require_user(srv, req)
        _check(
            pm.allowed(
                user, "session", Operation.DELETE,
                collaboration_id=session.collaboration_id,
                owner_id=session.owner_id,
            )
        )
        for df in session.dataframes():
            df.delete()
        session.delete()
        # nodes drop their local stores on this event
        srv.hub.emit(
            ev.SESSION_DELETED,
            {"session_id": id},
            room=ev.collaboration_room(session.collaboration_id),
        )
        return {}, 204

    @app.route("/api/session/<int:id>/dataframe", methods=("GET",))
    def session_dataframes(req: Request, id: int):
        user = _require_user(srv, req)
        session = _get_or_404(m.Session, id)
        _check(_session_visible(user, session))
        return _paginate(req, session.dataframes())

    @app.route("/api/session/<int:id>/dataframe/<handle>", methods=("PATCH",))
    def session_dataframe_patch(req: Request, id: int, handle: str):
        """Nodes report materialization: ready flag + column metadata.
        Content never crosses this endpoint — bookkeeping only."""
        kind, principal = _identity(srv, req)
        session = _get_or_404(m.Session, id)
        df = m.SessionDataframe.first(session_id=id, handle=handle)
        if df is None:
            raise HTTPError(404, f"session has no dataframe {handle!r}")
        if kind == "node":
            if principal.collaboration_id != session.collaboration_id:
                raise HTTPError(403, "node outside session collaboration")
        else:
            raise HTTPError(403, "only nodes report dataframe state")
        body = sch.load(sch.SessionDataframePatch(), req.json)
        if body["ready"]:
            # ready means "EVERY node has materialized it": each node
            # reports after completing its extraction run, so recompute
            # from the task's run statuses — the LAST reporter flips it
            task = m.Task.get(df.last_task_id) if df.last_task_id else None
            runs = task.runs() if task else []
            df.ready = bool(runs) and all(
                r.status == TaskStatus.COMPLETED.value for r in runs
            )
        elif body["ready"] is not None:
            df.ready = False
        if body["columns"] is not None:
            df.columns = body["columns"]
        df.save()
        return df.to_dict()

    # ---------------------------------------------------------------- nodes
    @app.route("/api/node", methods=("GET", "POST"))
    def nodes(req: Request):
        kind, principal = _identity(srv, req)
        if req.method == "GET":
            rows = m.Node.list()
            if kind == "user":
                scope = pm.user_scope(principal, "node", Operation.VIEW)
                _check(scope is not None)
                if scope == Scope.ORGANIZATION:
                    rows = [
                        n
                        for n in rows
                        if n.organization_id == principal.organization_id
                    ]
                elif scope == Scope.COLLABORATION:
                    rows = [
                        n
                        for n in rows
                        if principal.organization_id
                        in m.Collaboration.get(n.collaboration_id).organization_ids()
                    ]
            elif kind == "node":
                rows = [
                    n
                    for n in rows
                    if n.collaboration_id == principal.collaboration_id
                ]
            else:
                raise HTTPError(403)
            return _paginate(req, rows)
        user = _require_user(srv, req)
        body = sch.load(sch.NodeInput(), req.json)
        org_id = body["organization_id"] or user.organization_id
        collab = _get_or_404(m.Collaboration, body["collaboration_id"])
        if org_id not in collab.organization_ids():
            raise HTTPError(400, "organization is not in the collaboration")
        _check(pm.allowed(user, "node", Operation.CREATE, organization_id=org_id))
        if _node_for_org(collab.id, org_id) is not None:
            raise HTTPError(409, "node already exists for this org+collaboration")
        api_key = m.Node.generate_api_key()
        node = m.Node(
            name=body["name"]
            or f"{m.Organization.get(org_id).name} {collab.name} node",
            organization_id=org_id,
            collaboration_id=collab.id,
            station_index=body["station_index"],
            status="offline",
        )
        node.set_api_key(api_key)
        node.save()
        # the api key is returned exactly once, at creation
        return {**node.to_dict(), "api_key": api_key}, 201

    @app.route("/api/node/<int:id>", methods=("GET", "PATCH", "DELETE"))
    def node_one(req: Request, id: int):
        kind, principal = _identity(srv, req)
        node = _get_or_404(m.Node, id)
        if req.method == "GET":
            if kind == "user":
                _check(
                    pm.allowed(
                        principal, "node", Operation.VIEW,
                        organization_id=node.organization_id,
                        collaboration_id=node.collaboration_id,
                    )
                )
            elif kind == "node":
                _check(node.collaboration_id == principal.collaboration_id)
            else:  # container: nodes of its own collaboration only
                _check(
                    node.collaboration_id
                    == _container_task(principal).collaboration_id
                )
            return node.to_dict()
        if kind == "node":
            # a node may PATCH its own status (online/offline heartbeat) —
            # nothing else
            _check(req.method == "PATCH" and principal.id == node.id)
            status = (req.json or {}).get("status")
            if status in ("online", "offline"):
                _set_node_status(srv, node, status)
            return node.to_dict()
        user = _require_user(srv, req)
        if req.method == "DELETE":
            _check(
                pm.allowed(
                    user, "node", Operation.DELETE,
                    organization_id=node.organization_id,
                )
            )
            node.delete()
            _invalidate(srv, "node", node.id)
            return {}, 204
        _check(
            pm.allowed(
                user, "node", Operation.EDIT,
                organization_id=node.organization_id,
            )
        )
        name = (req.json or {}).get("name")
        if name:
            node.name = name
            node.save()
        return node.to_dict()

    # ---------------------------------------------------------------- tasks
    @app.route("/api/task", methods=("GET", "POST"))
    def tasks(req: Request):
        kind, principal = _identity(srv, req)
        if req.method == "GET":
            if kind == "user":
                scope = pm.user_scope(principal, "task", Operation.VIEW)
                _check(scope is not None)
                rows = m.Task.list()
                if scope != Scope.GLOBAL:
                    visible_collabs = _visible_collab_ids(
                        srv, principal.organization_id
                    )
                    rows = [
                        t
                        for t in rows
                        if t.collaboration_id in visible_collabs
                        or t.init_user_id == principal.id
                    ]
            elif kind == "node":
                rows = m.Task.list(collaboration_id=principal.collaboration_id)
            else:
                # container: its own task tree (job) only — a malicious
                # algorithm must not enumerate other tasks' inputs/results
                # across the collaboration
                rows = m.Task.list(job_id=_container_task(principal).job_id)
            return _paginate(req, rows)
        return _create_task(srv, req)

    @app.route("/api/task/<int:id>", methods=("GET", "DELETE"))
    def task_one(req: Request, id: int):
        kind, principal = _identity(srv, req)
        task = _get_or_404(m.Task, id)
        if req.method == "GET":
            if kind == "user":
                _check(
                    pm.allowed(
                        principal, "task", Operation.VIEW,
                        collaboration_id=task.collaboration_id,
                        owner_id=task.init_user_id,
                    )
                )
            elif kind == "node":
                _check(task.collaboration_id == principal.collaboration_id)
            else:  # container: its own task tree (job) only
                _check(task.job_id == _container_task(principal).job_id)
            return task.to_dict()
        user = _require_user(srv, req)
        _check(
            pm.allowed(
                user, "task", Operation.DELETE,
                collaboration_id=task.collaboration_id,
                owner_id=task.init_user_id,
            )
        )
        for run in task.runs():
            run.delete()
        task.delete()
        return {}, 204

    @app.route("/api/task/<int:id>/run", methods=("GET",))
    def task_runs(req: Request, id: int):
        kind, principal = _identity(srv, req)
        task = _get_or_404(m.Task, id)
        if kind == "user":
            _check(
                pm.allowed(
                    principal, "run", Operation.VIEW,
                    collaboration_id=task.collaboration_id,
                    owner_id=task.init_user_id,
                )
            )
        runs = task.runs()
        if kind == "node":
            # same policy as GET /api/run: a node sees only its own org's
            # runs (others' inputs/results are not its business)
            _check(task.collaboration_id == principal.collaboration_id)
            if (task.engine or "process") == "device":
                # collective coordination: a member daemon decides whether
                # to ENTER the SPMD program by watching every peer run's
                # status (node._await_device_peers). Statuses are shared
                # with all member nodes; payloads stay private — redact
                # input/result/log.
                start = (req.page - 1) * req.per_page
                return {
                    "data": [
                        {
                            "id": r.id,
                            "task": {"id": r.task_id},
                            "organization": {"id": r.organization_id},
                            "node": {"id": r.node_id},
                            "status": r.status,
                            "assigned_at": r.assigned_at,
                            "started_at": r.started_at,
                            "finished_at": r.finished_at,
                        }
                        for r in runs[start : start + req.per_page]
                    ],
                    "pagination": {
                        "page": req.page,
                        "per_page": req.per_page,
                        "total": len(runs),
                    },
                }
            runs = [
                r for r in runs if r.organization_id == principal.organization_id
            ]
        elif kind == "container":
            # own task tree (job) only, mirroring GET /api/run
            _check(task.job_id == _container_task(principal).job_id)
        return _paginate(req, runs)

    @app.route("/api/kill/task", methods=("POST",))
    def kill_task(req: Request):
        user = _require_user(srv, req)
        task_id = (req.json or {}).get("task_id")
        if not task_id:
            raise HTTPError(400, "task_id required")
        task = _get_or_404(m.Task, task_id)
        _check(
            pm.allowed(
                user, "task", Operation.EDIT,
                collaboration_id=task.collaboration_id,
                owner_id=task.init_user_id,
            )
        )
        killed = []
        for run in task.runs():
            if run.status not in (
                TaskStatus.COMPLETED.value,
                TaskStatus.FAILED.value,
                TaskStatus.CRASHED.value,
            ):
                run.status = TaskStatus.KILLED.value
                run.finished_at = time.time()
                run.save()
                killed.append(run.id)
                node = _node_for_org(task.collaboration_id, run.organization_id)
                if node:
                    srv.hub.emit(
                        ev.KILL_TASK,
                        {"task_id": task.id, "run_id": run.id},
                        room=ev.node_room(node.id),
                    )
        return {"killed_runs": killed}

    # ----------------------------------------------------------------- runs
    @app.route("/api/run", methods=("GET",))
    def runs(req: Request):
        kind, principal = _identity(srv, req)
        task_id = req.int_arg("task_id")
        where: dict[str, Any] = {}
        if task_id is not None:
            where["task_id"] = task_id
        status = req.arg("status")
        if status is not None:
            where["status"] = status
        rows = m.TaskRun.list(**where)
        # request-scoped task memo: the visibility filters below resolve
        # the task of EVERY run — without this, a busy listing is an N+1
        # query storm (one Task.get per run, most of them duplicates)
        tasks: dict[int, m.Task | None] = {}

        def _task_of(r: m.TaskRun) -> m.Task | None:
            if r.task_id not in tasks:
                tasks[r.task_id] = m.Task.get(r.task_id)
            return tasks[r.task_id]

        if kind == "user":
            scope = pm.user_scope(principal, "run", Operation.VIEW)
            _check(scope is not None)
            if scope != Scope.GLOBAL:
                visible = _visible_collab_ids(srv, principal.organization_id)
                rows = [
                    r
                    for r in rows
                    if (t := _task_of(r)) is not None
                    and t.collaboration_id in visible
                ]
        elif kind == "node":
            # org AND collaboration: a node is per (org, collaboration), and
            # a sibling node of the same org in another collaboration must
            # not see (or reclaim — daemon._sync_missed_runs) these runs
            rows = [
                r for r in rows
                if r.organization_id == principal.organization_id
                and (t := _task_of(r)) is not None
                and t.collaboration_id == principal.collaboration_id
            ]
        else:  # container: runs of its own task tree (job) only
            own_job = _container_task(principal).job_id
            job_tasks = {t.id for t in m.Task.list(job_id=own_job)}
            rows = [r for r in rows if r.task_id in job_tasks]
        return _paginate(req, rows)

    @app.route("/api/run/<int:id>", methods=("GET", "PATCH"))
    def run_one(req: Request, id: int):
        kind, principal = _identity(srv, req)
        run = _get_or_404(m.TaskRun, id)
        task = m.Task.get(run.task_id)
        if req.method == "GET":
            if kind == "user":
                _check(
                    pm.allowed(
                        principal, "run", Operation.VIEW,
                        collaboration_id=task.collaboration_id,
                        owner_id=task.init_user_id,
                    )
                )
            elif kind == "node":
                _check(
                    run.organization_id == principal.organization_id
                    and task.collaboration_id == principal.collaboration_id
                )
            else:  # container: its own task tree (job) only
                _check(task.job_id == _container_task(principal).job_id)
            return run.to_dict()
        # PATCH: only the executing node updates status/result (org AND
        # collaboration — same scoping as the node's run listing)
        node = _require_node(srv, req)
        body = sch.load(sch.RunPatch(), req.json)
        return _apply_run_patch(srv, node, run, task, body)

    @app.route("/api/run/claim-batch", methods=("POST",))
    def run_claim_batch(req: Request):
        """Batched node dispatch: the whole claim sweep in ONE request.

        Sweep mode (no `run_ids`): optionally re-queue this node's
        INITIALIZING/ACTIVE orphans (excluding `exclude_run_ids` — the
        runs the daemon is executing right now), then return up to `max`
        claimable PENDING runs. Dispatch mode (`run_ids`): return exactly
        those runs if still pending and in scope. Either way each entry
        carries the run, its full task, and a pre-minted container token —
        collapsing the daemon's per-run GET run + GET task +
        POST token/container round-trips into none.

        "Claiming" mints no lease: runs stay PENDING until the daemon
        PATCHes them ACTIVE, exactly as on the per-run path, so an
        un-upgraded daemon (or a restarted one) interoperates unchanged —
        idempotency still comes from the daemon's claim set plus the
        terminal-status 409 guard.
        """
        node = _require_node(srv, req)
        body = sch.load(sch.ClaimBatchInput(), req.json)
        exclude = set(body["exclude_run_ids"] or [])
        tasks: dict[int, m.Task | None] = {}

        def _task_of(run: m.TaskRun) -> m.Task | None:
            if run.task_id not in tasks:
                tasks[run.task_id] = m.Task.get(run.task_id)
            return tasks[run.task_id]

        def _in_scope(run: m.TaskRun) -> bool:
            t = _task_of(run)
            return (
                t is not None
                and run.organization_id == node.organization_id
                and t.collaboration_id == node.collaboration_id
            )

        claimable: list[m.TaskRun] = []
        if body["run_ids"] is not None:
            # explicit dispatch: `exclude_run_ids` does not apply — the
            # daemon claims BEFORE fetching, so its own id is in there
            for rid in body["run_ids"][: body["max"]]:
                run = m.TaskRun.get(rid)
                # batch semantics: out-of-scope / non-pending entries are
                # silently skipped, not errors — the daemon treats absence
                # as "nothing to execute" (same as a non-pending GET run)
                if (
                    run is None
                    or not _in_scope(run)
                    or run.status != TaskStatus.PENDING.value
                ):
                    continue
                claimable.append(run)
        else:
            n_reset = 0
            if body["reset_orphans"]:
                for status in (TaskStatus.INITIALIZING, TaskStatus.ACTIVE):
                    for run in m.TaskRun.list(
                        status=status.value,
                        organization_id=node.organization_id,
                    ):
                        if run.id in exclude or not _in_scope(run):
                            continue
                        # compare-and-swap, not save(): between the
                        # listing and this write the run may have been
                        # COMPLETED by a concurrent report — or ACTIVATED
                        # by the daemon through ANOTHER replica. A stale
                        # full-row save would clobber the result or
                        # re-queue live work; the status guard makes the
                        # reset atomic, and a False return means someone
                        # else moved the run on — leave it alone.
                        if not m.TaskRun.compare_and_swap(
                            run.id,
                            sets={
                                "status": TaskStatus.PENDING.value,
                                "log": (
                                    "orphaned mid-run (daemon restart or "
                                    "lost report); re-queued by claim-batch"
                                ),
                            },
                            expect={"status": status.value},
                        ):
                            continue
                        n_reset += 1
                        task = _task_of(run)
                        srv.hub.emit(
                            ev.STATUS_UPDATE,
                            {
                                "task_id": task.id,
                                "run_id": run.id,
                                "status": TaskStatus.PENDING.value,
                                "organization_id": run.organization_id,
                                "task_status": task.status(),
                            },
                            room=ev.collaboration_room(task.collaboration_id),
                        )
            for run in m.TaskRun.list(
                status=TaskStatus.PENDING.value,
                organization_id=node.organization_id,
            ):
                if run.id in exclude or not _in_scope(run):
                    continue
                claimable.append(run)
                if len(claimable) >= body["max"]:
                    break
        data = []
        for run in claimable:
            task = _task_of(run)
            entry = run.to_dict()
            entry["task"] = task.to_dict()
            entry["container_token"] = srv.tokens.container_token(
                node_id=node.id,
                task_id=task.id,
                image=task.image,
                organization_id=node.organization_id,
            )
            data.append(entry)
        out: dict[str, Any] = {"data": data}
        if body["run_ids"] is None and body["reset_orphans"]:
            out["n_reset"] = n_reset
        return out

    @app.route("/api/run/batch", methods=("PATCH",))
    def run_patch_batch(req: Request):
        """Batched status/result upload: N run PATCHes in one request,
        with PER-ITEM outcomes (200/403/404/409 + msg) so one conflicting
        run — e.g. killed mid-execution — doesn't fail its batch-mates.
        Semantics per item are EXACTLY `PATCH /api/run/<id>`, including
        terminal-state immutability and the status-update event."""
        node = _require_node(srv, req)
        body = sch.load(sch.RunBatchPatch(), req.json)
        results = []
        for item in body["runs"]:
            rid = item["id"]
            run = m.TaskRun.get(rid)
            if run is None:
                results.append(
                    {"id": rid, "status_code": 404, "msg": "not found"}
                )
                continue
            task = m.Task.get(run.task_id)
            try:
                _apply_run_patch(srv, node, run, task, item)
            except HTTPError as e:
                results.append(
                    {"id": rid, "status_code": e.status, "msg": e.msg}
                )
                continue
            results.append({"id": rid, "status_code": 200})
        return {"data": results}

    # ------------------------------------------------------------ rbac views
    @app.route("/api/role", methods=("GET", "POST"))
    def roles(req: Request):
        user = _require_user(srv, req)
        if req.method == "GET":
            _check(pm.user_scope(user, "role", Operation.VIEW) is not None)
            return _paginate(req, m.Role.list())
        body = sch.load(sch.RoleInput(), req.json)
        org_id = body["organization_id"]
        _check(
            pm.allowed(user, "role", Operation.CREATE, organization_id=org_id)
            if org_id
            else pm.user_scope(user, "role", Operation.CREATE) == Scope.GLOBAL
        )
        role = m.Role(
            name=body["name"],
            description=body["description"],
            organization_id=org_id,
        ).save()
        _grant_role_rules(user, role, body["rules"])
        return role.to_dict(), 201

    @app.route("/api/role/<int:id>", methods=("GET", "PATCH", "DELETE"))
    def role_one(req: Request, id: int):
        user = _require_user(srv, req)
        role = _get_or_404(m.Role, id)
        if req.method == "GET":
            _check(pm.user_scope(user, "role", Operation.VIEW) is not None)
            return role.to_dict()
        op = Operation.EDIT if req.method == "PATCH" else Operation.DELETE
        _check(
            pm.allowed(user, "role", op, organization_id=role.organization_id)
            if role.organization_id
            else pm.user_scope(user, "role", op) == Scope.GLOBAL
        )
        if req.method == "DELETE":
            role.delete()
            # the role's rules reached arbitrarily many users: global evict
            _invalidate(srv, "role")
            return {}, 204
        body = sch.load(sch.RolePatch(), req.json)
        for field in ("name", "description"):
            if body[field] is not None:
                setattr(role, field, body[field])
        if body["rules"] is not None:
            _grant_role_rules(user, role, body["rules"], replace=True)
            _invalidate(srv, "role")
        role.save()
        return role.to_dict()

    @app.route("/api/rule", methods=("GET",))
    def rules(req: Request):
        _require_user(srv, req)
        return _paginate(req, m.Rule.list())

    # ---------------------------------------------------------------- ports
    @app.route("/api/port", methods=("GET", "POST"))
    def ports(req: Request):
        kind, principal = _identity(srv, req)
        if req.method == "GET":
            run_id = req.int_arg("run_id")
            where = {"run_id": run_id} if run_id is not None else {}
            rows = m.Port.list(**where)
            # request-scoped run→collaboration memo (ports of one run share
            # the same resolution; previously two queries PER PORT)
            port_collabs: dict[int, int | None] = {}

            def _collab_of(p: m.Port) -> int | None:
                if p.run_id not in port_collabs:
                    run = m.TaskRun.get(p.run_id)
                    task = m.Task.get(run.task_id) if run else None
                    port_collabs[p.run_id] = (
                        task.collaboration_id if task else None
                    )
                return port_collabs[p.run_id]

            # scope to collaborations the principal can see (port VIEW rule
            # for users; own collaboration for nodes/containers)
            if kind == "user":
                scope = pm.user_scope(principal, "port", Operation.VIEW)
                _check(scope is not None)
                if scope != Scope.GLOBAL:
                    visible = _visible_collab_ids(
                        srv, principal.organization_id
                    )
                    rows = [p for p in rows if _collab_of(p) in visible]
            else:
                own_collab = (
                    principal.collaboration_id
                    if kind == "node"
                    else _container_task(principal).collaboration_id
                )
                rows = [p for p in rows if _collab_of(p) == own_collab]
            return _paginate(req, rows)
        node = _require_node(srv, req)
        body = sch.load(sch.PortInput(), req.json)
        run = _get_or_404(m.TaskRun, body["run_id"])
        _check(run.organization_id == node.organization_id)
        port = m.Port(**body).save()
        return port.to_dict(), 201

    # ----------------------------------------------------------------- store
    @app.route("/api/store", methods=("GET",))
    def store_info(req: Request):
        """The linked algorithm store, if any (UI + clients discover it
        here instead of each needing their own store config)."""
        _identity(srv, req)
        return {"url": srv.store_url}

    def _store_forward(
        req: Request, path: str, *,
        params: dict[str, Any] | None = None,
        forward_auth: bool = True,
    ):
        """Same-origin proxy to the linked store, so the browser UI drives
        the FULL store workflow (submit → review → approve) without
        cross-origin requests or separate store credentials. The caller's
        bearer token is forwarded together with a ``Server-Url`` naming THIS
        server (derived from the request's Host — the URL the browser used
        IS the URL the store's trust handshake will call ``whoami`` on)."""
        _identity(srv, req)
        if not srv.store_url:
            raise HTTPError(404, "no algorithm store linked to this server")
        import requests

        headers: dict[str, str] = {}
        if forward_auth and req.bearer_token:
            host = req.headers.get("host")
            if host:
                proto = req.headers.get("x-forwarded-proto", "http")
                headers["Authorization"] = f"Bearer {req.bearer_token}"
                headers["Server-Url"] = f"{proto}://{host}"
        body = req.json if req.method in ("POST", "PATCH") else None
        try:
            resp = requests.request(
                req.method,
                f"{srv.store_url}/api/{path}",
                json=body,
                params=params or {},
                headers=headers,
                timeout=10,
            )
        except requests.RequestException as e:
            raise HTTPError(502, f"store unreachable: {e}") from None
        if resp.status_code >= 400:
            try:
                msg = resp.json().get("msg", "")
            except Exception:
                msg = resp.text[:200]
            raise HTTPError(resp.status_code, f"store: {msg}")
        data = {} if resp.status_code == 204 else resp.json()
        return data, resp.status_code

    @app.route("/api/store/algorithm", methods=("GET", "POST"))
    def store_algorithms(req: Request):
        """GET: the algorithm registry (token forwarded only when a status
        filter asks for non-public rows, so the default listing stays the
        approved set exactly as before). POST: submit an algorithm."""
        params = {
            k: req.arg(k)
            for k in ("status", "name")
            if req.arg(k) is not None
        }
        return _store_forward(
            req, "algorithm", params=params,
            forward_auth=req.method == "POST" or "status" in params,
        )

    @app.route("/api/store/algorithm/<int:id>", methods=("GET", "DELETE"))
    def store_algorithm_one(req: Request, id: int):
        return _store_forward(req, f"algorithm/{id}")

    @app.route("/api/store/algorithm/<int:id>/review", methods=("POST",))
    def store_start_review(req: Request, id: int):
        return _store_forward(req, f"algorithm/{id}/review")

    @app.route("/api/store/review", methods=("GET",))
    def store_reviews(req: Request):
        params = {}
        if req.int_arg("algorithm_id") is not None:
            params["algorithm_id"] = req.int_arg("algorithm_id")
        return _store_forward(req, "review", params=params)

    @app.route("/api/store/review/<int:id>", methods=("GET", "PATCH"))
    def store_review_one(req: Request, id: int):
        return _store_forward(req, f"review/{id}")

    # --------------------------------------------------------------- events
    # untimed: the ?wait=S long-poll blocks by design and must not skew
    # the v6t_http_request_seconds histogram (see web.App.route)
    @app.route("/api/event", methods=("GET",), untimed=True)
    def events_fetch(req: Request):
        """Cursor catch-up (reference: socket reconnect re-sync) — now
        long-poll capable: `?wait=S` blocks up to S seconds (capped at 25)
        until an event lands in one of the caller's rooms, waking
        IMMEDIATELY on emit. `long_poll: true` in the response is how
        clients detect the capability (an old server ignores the unknown
        param and returns at once, without the flag — callers then keep
        their fixed-interval sleeps). `truncated: true` means the bounded
        replay buffer evicted events past the caller's cursor: the caller
        MUST resync from primary state (runs/kills/sessions), not trust
        the event stream alone."""
        kind, principal = _identity(srv, req)
        since = req.int_arg("since", 0)
        raw_wait = req.arg("wait")
        try:
            wait = min(25.0, max(0.0, float(raw_wait))) if raw_wait else 0.0
        except ValueError:
            raise HTTPError(400, "query param 'wait' must be a number") \
                from None
        # optional comma-separated name filter: narrows BOTH the returned
        # events and (crucially) the long-poll wake set — a daemon must
        # not wake on every status-update flooding its collaboration room
        raw_names = req.arg("names")
        names = (
            {n for n in raw_names.split(",") if n} if raw_names else None
        )
        rooms = _rooms_for(srv, kind, principal)
        if since < 0:
            # cursor probe: "where is the stream NOW?" — lets a client
            # start tailing without replaying the whole buffer first
            events: list = []
            cursor, truncated = srv.hub.cursor, False
        else:
            # collect() pairs the cursor with the event snapshot
            # ATOMICALLY — cursor read after a separate fetch could cover
            # an event emitted in the gap without delivering it
            events, cursor, truncated = srv.hub.collect(
                since, rooms, timeout=wait, names=names
            )
        if truncated:
            # the watchdog's event_cursor_lag signal: a consumer ACTUALLY
            # asked for history the ring already evicted (eviction alone
            # is steady-state on any busy server and proves nothing)
            from vantage6_tpu_torch.common.telemetry import REGISTRY

            REGISTRY.counter("v6t_event_truncated_total").inc()
        return {
            "cursor": cursor,
            "data": [e.to_dict() for e in events],
            "long_poll": True,
            "truncated": truncated,
        }

    @app.route("/api/whoami", methods=("GET",))
    def whoami(req: Request):
        """Identity introspection (the algorithm store's trust handshake
        validates a caller's token by asking the caller's server)."""
        kind, principal = _identity(srv, req)
        if kind == "user":
            return {"type": "user", **principal.to_dict()}
        if kind == "node":
            return {"type": "node", **principal.to_dict()}
        return {"type": "container", **principal}

    @app.route("/api/ping", methods=("POST",))
    def ping(req: Request):
        node = _require_node(srv, req)
        _set_node_status(srv, node, "online", quiet=True)
        return {"pong": time.time()}


# ------------------------------------------------------------- task creation


def _create_task(srv: "ServerApp", req: Request) -> tuple[dict[str, Any], int]:
    kind, principal = _identity(srv, req)
    body = sch.load(sch.TaskInput(), req.json)
    collab = m.Collaboration.get(body["collaboration_id"])
    if collab is None:
        raise HTTPError(404, "collaboration not found")

    parent_id = None
    job_id = None
    if kind == "user":
        _check(
            srv.pm.allowed(
                principal, "task", Operation.CREATE, collaboration_id=collab.id
            )
        )
        init_org_id = principal.organization_id
        init_user_id = principal.id
    elif kind == "container":
        # a running algorithm creates subtasks within its own task tree
        parent = _container_task(principal)
        if parent is None or parent.collaboration_id != collab.id:
            raise HTTPError(403, "subtask outside parent collaboration")
        if parent.image != body["image"]:
            raise HTTPError(403, "subtask must use the parent's algorithm")
        parent_id = parent.id
        job_id = parent.job_id
        init_org_id = principal["organization_id"]
        init_user_id = parent.init_user_id
    else:
        raise HTTPError(403, "nodes cannot create tasks")

    if srv.algorithm_policy is not None and not srv.algorithm_policy(body["image"]):
        raise HTTPError(403, f"algorithm {body['image']!r} not allowed by store policy")

    member_ids = collab.organization_ids()
    study_id = body["study_id"]
    if study_id is not None:
        study = m.Study.get(study_id)
        if study is None or study.collaboration_id != collab.id:
            raise HTTPError(400, "study not in collaboration")
        member_ids = study.organization_ids()

    org_specs = body["organizations"]
    for spec in org_specs:
        if "id" not in spec:
            raise HTTPError(400, 'each organization entry needs an "id"')
        if int(spec["id"]) not in member_ids:
            raise HTTPError(
                400, f"organization {spec['id']} not in collaboration/study"
            )

    # sessions: validate the workspace and any dataframe references; the
    # server only bookkeeps handles — content stays at the nodes
    session_id = body["session_id"]
    session = None
    if session_id is not None:
        session = m.Session.get(session_id)
        if session is None or session.collaboration_id != collab.id:
            raise HTTPError(400, "session not in collaboration")
        if kind == "user" and (session.scope or "collaboration") == "own" \
                and session.owner_id != principal.id:
            raise HTTPError(403, "session is private to its owner")
    handles = {d.handle for d in session.dataframes()} if session else set()
    for db in body["databases"] or []:
        if db.get("type") == "session":
            if session is None:
                raise HTTPError(
                    400, "session dataframe reference without session_id"
                )
            if not db.get("dataframe"):
                raise HTTPError(
                    400, 'session database entries need a "dataframe" handle'
                )
            if db["dataframe"] not in handles:
                raise HTTPError(
                    400,
                    f"session has no dataframe {db['dataframe']!r} "
                    f"(known: {sorted(handles)})",
                )
    store_as = body["store_as"]
    if store_as is not None:
        if session is None:
            raise HTTPError(400, "store_as requires a session_id")
        if not store_as.replace("_", "").replace("-", "").isalnum():
            raise HTTPError(400, "store_as must be a simple identifier")

    engine = body["engine"]
    if engine == "device":
        # a device-engine run is ONE collective SPMD program: every process
        # of the global device mesh must enter it, or the collectives hang.
        # The server enforces the coarse proxy it can see — the task targets
        # every organization of the COLLABORATION (not a study subset: the
        # mesh spans all member daemons, and a daemon outside the study
        # would never receive a run yet its process must join the program).
        targeted = {int(s["id"]) for s in org_specs}
        collab_members = set(collab.organization_ids())
        if targeted != collab_members or len(org_specs) != len(targeted):
            raise HTTPError(
                400,
                "device-engine tasks must target every organization of the "
                f"collaboration exactly once (targeted "
                f"{sorted(int(s['id']) for s in org_specs)}, members "
                f"{sorted(collab_members)}): the SPMD program is collective "
                "and a duplicate or missing run would hang it",
            )

    # distributed tracing: persist the creating request's trace context on
    # the task. The current context here is the server's own http span
    # (child of the client's traceparent header), so daemon claim/exec/
    # report spans parented on it chain client → server → daemon in one
    # trace. No ambient trace (old client, tracing off) → NULLs.
    from vantage6_tpu_torch.runtime.tracing import TRACER

    trace_ctx = TRACER.current_context()
    task = m.Task(
        name=body["name"],
        description=body["description"],
        image=body["image"],
        method=body["method"],
        collaboration_id=collab.id,
        study_id=study_id,
        parent_id=parent_id,
        init_org_id=init_org_id,
        init_user_id=init_user_id,
        databases=body["databases"] or [{"label": "default"}],
        session_id=session_id,
        store_as=store_as,
        engine=engine,
        trace_id=trace_ctx.trace_id if trace_ctx else None,
        traceparent=trace_ctx.to_traceparent() if trace_ctx else None,
    ).save()
    if store_as is not None:
        df = m.SessionDataframe.first(
            session_id=session_id, handle=store_as
        )
        if df is None:
            df = m.SessionDataframe(
                session_id=session_id, handle=store_as
            )
        df.last_task_id = task.id
        df.ready = False
        df.save()
    if job_id is None:
        job_id = task.id  # a root task starts its own job group
    task.job_id = job_id
    task.save()

    method = body["method"]
    # the run fan-out + event emits ARE "server dispatch" — one span so
    # the timeline separates dispatch cost from the surrounding request
    with TRACER.span(
        "server.dispatch", kind="dispatch", service="server",
        attrs={"task_id": task.id, "n_runs": len(org_specs)},
        require_parent=True,
    ):
        for spec in org_specs:
            org_id = int(spec["id"])
            node = _node_for_org(collab.id, org_id)
            run = m.TaskRun(
                task_id=task.id,
                organization_id=org_id,
                node_id=node.id if node else None,
                status=TaskStatus.PENDING.value,
                input=spec.get("input", ""),
                assigned_at=time.time(),
            ).save()
            if node:
                srv.hub.emit(
                    ev.TASK_CREATED,
                    {
                        "task_id": task.id,
                        "run_id": run.id,
                        "method": method,
                        "image": task.image,
                        "organization_id": org_id,
                    },
                    room=ev.node_room(node.id),
                )
        srv.hub.emit(
            ev.TASK_CREATED,
            {"task_id": task.id, "image": task.image},
            room=ev.collaboration_room(collab.id),
        )
    return task.to_dict(), 201


# ------------------------------------------------------------------- helpers


def _observe_dispatch(srv: "ServerApp", run: m.TaskRun) -> None:
    """Assigned->started dispatch latency of one run, observed at the
    activation CAS: into the process histogram (scrape-grade) AND as a
    per-event fleet sample (store-backed — the dispatch-latency SLO's
    burn windows read these rows, from whichever replica served the
    activation). Telemetry must never fail a dispatch."""
    try:
        assigned = float(run.assigned_at or 0.0)
        if assigned <= 0.0:
            return
        started = float(run.started_at or time.time())
        lat = max(0.0, started - assigned)
        from vantage6_tpu_torch.common.telemetry import REGISTRY
        from vantage6_tpu_torch.server import fleet

        REGISTRY.histogram("v6t_run_dispatch_seconds").observe(lat)
        fleet.record_sample(
            srv.db, srv.replica_id, "server",
            "v6t_run_dispatch_seconds", lat,
        )
    except Exception:
        pass


def _apply_run_patch(
    srv: "ServerApp",
    node: m.Node,
    run: m.TaskRun,
    task: m.Task | None,
    body: dict[str, Any],
) -> dict[str, Any]:
    """The one node-updates-a-run core, shared by `PATCH /api/run/<id>`
    and the batched `PATCH /api/run/batch` (per item). Raises HTTPError;
    the batch endpoint maps that to a per-item outcome."""
    if task is None:
        raise HTTPError(404, "run's task no longer exists")
    _check(
        run.organization_id == node.organization_id
        and task.collaboration_id == node.collaboration_id
    )
    new_status = body["status"]
    if new_status:
        # status transitions are compare-and-swap on the status we READ:
        # with N replicas over one store, the check and the write must be
        # one atomic statement or two replicas interleave (the
        # double-dispatch hole). One winner; losers get 409. The guards:
        # terminal states are immutable (a node finishing late must not
        # overwrite KILLED or re-open a completed run), and activating an
        # already-ACTIVE run is a lost activation race — the 409 is what
        # makes the daemon drop the run instead of executing it twice.
        # (The container token minted at claim time is a stateless JWT;
        # THIS activation CAS is the dispatch serialization point.)
        for _attempt in range(2):
            cur_status = run.status
            if cur_status and TaskStatus(cur_status).is_finished:
                raise HTTPError(
                    409, f"run {run.id} already {cur_status}; cannot change"
                )
            if (
                new_status == TaskStatus.ACTIVE.value
                and cur_status == TaskStatus.ACTIVE.value
            ):
                raise HTTPError(
                    409,
                    f"run {run.id} already active "
                    "(activation race lost to another claimant)",
                )
            sets: dict[str, Any] = {"status": new_status}
            for field in ("result", "log", "started_at", "finished_at"):
                if body[field] is not None:
                    sets[field] = body[field]
            if run.node_id is None:
                sets["node_id"] = node.id
            if m.TaskRun.compare_and_swap(
                run.id, sets, expect={"status": cur_status}
            ):
                for k, v in sets.items():
                    setattr(run, k, v)
                if new_status == TaskStatus.ACTIVE.value:
                    # the activation CAS winner IS the dispatch: record
                    # assigned->started latency, the dispatch SLO's series
                    _observe_dispatch(srv, run)
                break
            # lost the race: re-read and re-decide against the NEW state
            reread = m.TaskRun.get(run.id)
            if reread is None:
                raise HTTPError(404, "run deleted mid-update")
            run = reread
        else:  # two lost races in a row: punt to the caller
            raise HTTPError(
                409, f"run {run.id} status contended; re-fetch and retry"
            )
    else:
        for field in ("result", "log", "started_at", "finished_at"):
            if body[field] is not None:
                setattr(run, field, body[field])
        run.save()
    if body["status"]:
        srv.hub.emit(
            ev.STATUS_UPDATE,
            {
                "task_id": task.id,
                "run_id": run.id,
                "status": run.status,
                "organization_id": run.organization_id,
                "task_status": task.status(),
            },
            room=ev.collaboration_room(task.collaboration_id),
        )
    return run.to_dict()


def _rooms_for(
    srv: "ServerApp", kind: str, principal: Any
) -> list[str] | None:
    """Event rooms for a principal; None = every room (operator view)."""
    if kind == "user":
        if (
            srv.pm.user_scope(principal, "event", Operation.RECEIVE)
            == Scope.GLOBAL
        ):
            # a global event-receive holder (root/operators) watches the
            # whole stream — membership rooms would hide every
            # collaboration their org hasn't joined, which for root is
            # ALL of them
            return None
        return [
            ev.collaboration_room(cid)
            for cid in sorted(
                _visible_collab_ids(srv, principal.organization_id)
            )
        ]
    if kind == "node":
        return [
            ev.node_room(principal.id),
            ev.collaboration_room(principal.collaboration_id),
        ]
    # container: its node's collaboration room
    task = _container_task(principal)
    return [ev.collaboration_room(task.collaboration_id)]


def _set_node_status(
    srv: "ServerApp", node: m.Node, status: str, quiet: bool = False
) -> None:
    changed = node.status != status
    node.status = status
    node.last_seen_at = time.time()
    node.save()
    if changed and not quiet:
        srv.hub.emit(
            ev.NODE_ONLINE if status == "online" else ev.NODE_OFFLINE,
            {"node_id": node.id, "organization_id": node.organization_id},
            room=ev.collaboration_room(node.collaboration_id),
        )
