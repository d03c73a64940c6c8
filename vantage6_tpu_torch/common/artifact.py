"""Algorithm artifact naming: parse/compare image-style references.

Parity: vantage6-common docker addons (SURVEY.md §2 item 25) — the reference
addresses algorithms by Docker image reference and checks digests before
running. Here an algorithm *artifact* keeps the same reference grammar
(``[registry/]name[:tag][@sha256:digest]``) but names a registered algorithm
module/package; digest checking becomes content-hash verification of the
registered code object or wheel.

The port's copy of ``vantage6_tpu/common/artifact.py``, unchanged.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

_REF_RE = re.compile(
    r"^(?:(?P<registry>[\w.\-]+(?::\d+)?)/)?"
    r"(?P<name>[a-z0-9][a-z0-9._\-/]*?)"
    r"(?::(?P<tag>[\w.\-]+))?"
    r"(?:@(?P<digest>sha256:[0-9a-f]{64}))?$"
)


@dataclasses.dataclass(frozen=True)
class ArtifactRef:
    """A parsed algorithm reference."""

    registry: str
    name: str
    tag: str
    digest: str  # "" or "sha256:<hex>"

    @property
    def full(self) -> str:
        s = f"{self.registry}/{self.name}" if self.registry else self.name
        if self.tag:
            s += f":{self.tag}"
        if self.digest:
            s += f"@{self.digest}"
        return s

    @property
    def without_digest(self) -> str:
        s = f"{self.registry}/{self.name}" if self.registry else self.name
        return f"{s}:{self.tag}" if self.tag else s


def parse_ref(ref: str) -> ArtifactRef:
    m = _REF_RE.match(ref)
    if not m:
        raise ValueError(f"invalid algorithm reference {ref!r}")
    d = m.groupdict()
    # "host.tld/name" vs "name:tag" ambiguity: a registry must contain a dot
    # or a port, like docker's own heuristic.
    registry = d["registry"] or ""
    name = d["name"]
    if registry and "." not in registry and ":" not in registry:
        name = f"{registry}/{name}"
        registry = ""
    return ArtifactRef(
        registry=registry,
        name=name,
        tag=d["tag"] or "",
        digest=d["digest"] or "",
    )


def content_digest(blob: bytes) -> str:
    """sha256 content digest in reference format."""
    return "sha256:" + hashlib.sha256(blob).hexdigest()


def digests_match(ref: str, blob: bytes) -> bool:
    """True when `ref` pins no digest or pins the digest of `blob`."""
    parsed = parse_ref(ref)
    return not parsed.digest or parsed.digest == content_digest(blob)


def same_artifact(a: str, b: str) -> bool:
    """Do two references address the same artifact (ignoring digests)?"""
    pa, pb = parse_ref(a), parse_ref(b)
    return (pa.registry, pa.name, pa.tag or "latest") == (
        pb.registry,
        pb.name,
        pb.tag or "latest",
    )
