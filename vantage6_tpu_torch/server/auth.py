"""Authentication: JWT access/refresh tokens, node API keys, container
tokens, optional TOTP MFA.

Parity: SURVEY.md §2 item 7 — `/api/token/user` (username+password [+TOTP]),
`/api/token/node` (api_key), `/api/token/container` (issued by the node for
a running algorithm so subtask creation is authenticated), plus refresh.
JWTs are HS256, implemented on stdlib hmac (PyJWT is not in the image).
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import struct
import time
from typing import Any


class AuthError(Exception):
    """Invalid credentials / token (HTTP 401)."""


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def encode_jwt(claims: dict[str, Any], secret: str) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def decode_jwt(token: str, secret: str) -> dict[str, Any]:
    try:
        header_s, payload_s, sig_s = token.split(".")
        signing_input = f"{header_s}.{payload_s}".encode()
        expect = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expect, _unb64url(sig_s)):
            raise AuthError("bad token signature")
        claims = json.loads(_unb64url(payload_s))
    except AuthError:
        raise
    except Exception:
        # bad base64, wrong part count, non-JSON payload, ... — all are a
        # client's malformed token (401), never a server error
        raise AuthError("malformed token") from None
    if claims.get("exp") is not None and claims["exp"] < time.time():
        raise AuthError("token expired")
    return claims


# ------------------------------------------------------------------- TOTP


def generate_totp_secret() -> str:
    return base64.b32encode(secrets.token_bytes(20)).decode("ascii")


def totp_code(secret: str, at: float | None = None, step: int = 30) -> str:
    """RFC 6238 6-digit code (SHA-1, 30s steps)."""
    counter = int((at if at is not None else time.time()) // step)
    key = base64.b32decode(secret)
    msg = struct.pack(">Q", counter)
    digest = hmac.new(key, msg, hashlib.sha1).digest()
    offset = digest[-1] & 0x0F
    code = struct.unpack(">I", digest[offset : offset + 4])[0] & 0x7FFFFFFF
    return f"{code % 1_000_000:06d}"


def verify_totp(secret: str, code: str, at: float | None = None) -> bool:
    """Accept the current step ±1 (clock skew), constant-time compare."""
    now = at if at is not None else time.time()
    return any(
        hmac.compare_digest(totp_code(secret, now + drift * 30), code)
        for drift in (-1, 0, 1)
    )


# ---------------------------------------------------------------- token mint


class TokenAuthority:
    """Mints and validates the three principal token types."""

    ACCESS_TTL = 6 * 3600.0
    REFRESH_TTL = 48 * 3600.0

    def __init__(self, secret: str | None = None):
        self.secret = secret or secrets.token_urlsafe(32)

    def _mint(self, claims: dict[str, Any], ttl: float) -> str:
        now = time.time()
        return encode_jwt(
            {**claims, "iat": now, "exp": now + ttl, "jti": secrets.token_hex(8)},
            self.secret,
        )

    def user_tokens(
        self, user_id: int, fingerprint: str | None = None
    ) -> dict[str, str]:
        """``fingerprint`` (credential_fingerprint of the user's current
        password hash + TOTP secret) binds BOTH tokens to the credentials
        they were issued under: a password change rotates the fingerprint
        and every outstanding session dies — stateless revocation, the
        same construction reset tokens use."""
        sub = {"type": "user", "id": user_id}
        extra = {"pwh": fingerprint} if fingerprint else {}
        return {
            "access_token": self._mint(
                {"sub": sub, "use": "access", **extra}, self.ACCESS_TTL
            ),
            "refresh_token": self._mint(
                {"sub": sub, "use": "refresh", **extra}, self.REFRESH_TTL
            ),
        }

    def node_tokens(self, node_id: int) -> dict[str, str]:
        sub = {"type": "node", "id": node_id}
        return {
            "access_token": self._mint({"sub": sub, "use": "access"}, self.ACCESS_TTL),
            "refresh_token": self._mint({"sub": sub, "use": "refresh"}, self.REFRESH_TTL),
        }

    def container_token(
        self, node_id: int, task_id: int, image: str, organization_id: int
    ) -> str:
        """Short-lived token a node issues to a running algorithm."""
        sub = {
            "type": "container",
            "node_id": node_id,
            "task_id": task_id,
            "image": image,
            "organization_id": organization_id,
        }
        return self._mint({"sub": sub, "use": "access"}, self.ACCESS_TTL)

    # -------------------------------------------------------- password reset
    RESET_TTL = 3600.0

    @staticmethod
    def _credential_fingerprint(
        password_hash: str | None, totp_secret: str | None
    ) -> str:
        """Fingerprint of BOTH credentials: a reset token dies the moment
        either the password or the TOTP secret changes — so one token can
        perform exactly one reset (password OR 2FA), never be replayed."""
        material = (password_hash or "") + ":" + (totp_secret or "")
        return hashlib.sha256(material.encode()).hexdigest()[:16]

    def password_reset_token(
        self, user_id: int, password_hash: str | None,
        totp_secret: str | None = None,
    ) -> str:
        """Single-use-by-construction reset token — stateless revocation via
        the credential fingerprint (see _credential_fingerprint)."""
        return self._mint(
            {
                "sub": {"type": "user", "id": user_id},
                "use": "password_reset",
                "pwh": self._credential_fingerprint(
                    password_hash, totp_secret
                ),
            },
            self.RESET_TTL,
        )

    def validate_password_reset(
        self, token: str, current_password_hash: str | None,
        current_totp_secret: str | None = None,
    ) -> int:
        """Returns the user id; raises AuthError on any mismatch."""
        claims = decode_jwt(token, self.secret)
        if claims.get("use") != "password_reset":
            raise AuthError("not a password reset token")
        if not hmac.compare_digest(
            claims.get("pwh", ""),
            self._credential_fingerprint(
                current_password_hash, current_totp_secret
            ),
        ):
            raise AuthError("reset token already used or superseded")
        sub = claims.get("sub") or {}
        if sub.get("type") != "user" or "id" not in sub:
            raise AuthError("malformed subject")
        return int(sub["id"])

    # ------------------------------------------------------------ validation
    def identity(self, token: str, use: str = "access") -> dict[str, Any]:
        return self.identity_claims(token, use)[0]

    def identity_claims(
        self, token: str, use: str = "access"
    ) -> tuple[dict[str, Any], dict[str, Any]]:
        """(subject, full claims) — callers needing the credential
        fingerprint ("pwh") read it from the claims."""
        claims = decode_jwt(token, self.secret)
        if claims.get("use") != use:
            raise AuthError(f"expected a {use} token")
        sub = claims.get("sub")
        if not isinstance(sub, dict) or "type" not in sub:
            raise AuthError("malformed subject")
        return sub, claims

    def fingerprint_ok(
        self,
        claims: dict[str, Any],
        password_hash: str | None,
        totp_secret: str | None,
    ) -> bool:
        """False when the token carries a credential fingerprint that no
        longer matches — i.e. the password/2FA changed after issuance. A
        token WITHOUT a fingerprint passes (node/container tokens; the
        claim cannot be stripped — the JWT is signed)."""
        pwh = claims.get("pwh")
        if not pwh:
            return True
        return hmac.compare_digest(
            pwh, self._credential_fingerprint(password_hash, totp_secret)
        )

    def refresh(self, refresh_token: str) -> dict[str, str]:
        sub = self.identity(refresh_token, use="refresh")
        if sub["type"] == "user":
            return self.user_tokens(sub["id"])
        if sub["type"] == "node":
            return self.node_tokens(sub["id"])
        raise AuthError("container tokens cannot be refreshed")
