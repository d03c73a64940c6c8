"""Outbound mail for account recovery (reference: SMTP password reset,
SURVEY.md §2 item 7).

The reference server sends password-reset emails via configured SMTP. This
image has no network, so the mailer is PLUGGABLE: `ServerApp(mailer=...)`
takes anything with ``send(to, subject, body)``. The default `LogMailer`
logs and records messages (what tests and dev networks read); `SMTPMailer`
is the production implementation for deployments with a mail host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol

from vantage6_tpu_torch.common.log import setup_logging

log = setup_logging("vantage6_tpu_torch/server.mail")


class Mailer(Protocol):  # pragma: no cover - typing only
    def send(self, to: str, subject: str, body: str) -> None: ...


@dataclasses.dataclass
class Message:
    to: str
    subject: str
    body: str


class LogMailer:
    """Default: log + retain messages in memory (dev/test deployments)."""

    def __init__(self) -> None:
        # replica-local: dev/test capture buffer, never authoritative
        self.sent: list[Message] = []

    def send(self, to: str, subject: str, body: str) -> None:
        self.sent.append(Message(to=to, subject=subject, body=body))
        log.info("mail to %s: %s", to, subject)


class SMTPMailer:
    """SMTP delivery (reference parity); construct from server config
    ``smtp: {host, port, username, password, use_tls, from}``."""

    def __init__(
        self,
        host: str,
        port: int = 587,
        username: str = "",
        password: str = "",
        use_tls: bool = True,
        from_addr: str = "noreply@vantage6",
    ):
        self.host, self.port = host, port
        self.username, self.password = username, password
        self.use_tls = use_tls
        self.from_addr = from_addr

    def send(self, to: str, subject: str, body: str) -> None:
        import smtplib
        from email.message import EmailMessage

        msg = EmailMessage()
        msg["From"], msg["To"], msg["Subject"] = self.from_addr, to, subject
        msg.set_content(body)
        with smtplib.SMTP(self.host, self.port, timeout=30) as smtp:
            if self.use_tls:
                smtp.starttls()
            if self.username:
                smtp.login(self.username, self.password)
            smtp.send_message(msg)


def mailer_from_config(cfg: dict[str, Any] | None) -> LogMailer | SMTPMailer:
    if not cfg or not cfg.get("host"):
        return LogMailer()
    return SMTPMailer(
        host=cfg["host"],
        port=int(cfg.get("port", 587)),
        username=cfg.get("username", ""),
        password=cfg.get("password", ""),
        use_tls=bool(cfg.get("use_tls", True)),
        from_addr=cfg.get("from", "noreply@vantage6"),
    )
