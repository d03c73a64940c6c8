"""Network gates: VPN, outbound whitelist, SSH tunnels.

Parity: vantage6-node's optional networking containers (SURVEY.md §2 items
13-15) — WireGuard VPN for cross-station algorithm traffic, a squid proxy
whitelisting outbound HTTP, and SSH tunnels to internal services. On one
accelerator host none of these transports exist (cross-station traffic is
device memory or NVLink; stations are mesh slots, not firewalled
hospitals), so these managers keep the reference's *configuration and
policy surface* — parse/validate config, answer reachability questions,
register ports — while the transport itself is the mesh. Each manager
states its stance via `supported`/`reason`.
"""
from __future__ import annotations

import fnmatch
import ipaddress
from dataclasses import dataclass, field
from typing import Any
from urllib.parse import urlparse

from vantage6_tpu_torch.common.log import setup_logging

log = setup_logging("vantage6_tpu_torch/node.gates")


@dataclass
class VPNManager:
    """Reference: WireGuard client container + server-registered ports.

    Here "VPN connectivity" between algorithm runs maps to device-mesh
    neighbor exchange; the manager still tracks per-run exposed ports (the
    server's `Port` entity) so iterative/MPC algorithms can discover peers.
    """

    enabled: bool = False
    subnet: str = "10.76.0.0/16"
    supported: bool = False
    reason: str = (
        "cross-station traffic rides the device mesh (ICI), not WireGuard; "
        "port registration is kept for peer discovery parity"
    )

    def __post_init__(self) -> None:
        # the subnet is config other tools consume (the reference hands it
        # to wireguard) — a typo must fail at daemon start, not at first
        # use. strict=False: WireGuard-style interface addresses
        # (10.76.0.1/16) have host bits set and are fine. A DISABLED vpn's
        # subnet is never consumed, so stale garbage there only warns —
        # it must not brick a daemon whose feature is off.
        try:
            ipaddress.ip_network(self.subnet, strict=False)
        except ValueError as e:
            if self.enabled:
                raise ValueError(f"vpn subnet {self.subnet!r}: {e}") from None
            log.warning("ignoring invalid subnet on disabled vpn: %s", e)

    def setup(self) -> bool:
        if self.enabled:
            log.warning("vpn requested: %s", self.reason)
        return False

    def exposed_ports(self, algorithm_env: dict[str, Any]) -> list[int]:
        """Ports an algorithm declares (reference: image EXPOSE labels).
        Out-of-range numbers are dropped with a warning — the server's
        Port entity validates 1..65535 and one bad entry must not sink
        the whole registration."""
        raw = str(algorithm_env.get("ports", "") or "")
        ports = []
        for p in raw.split(","):
            if not p.strip().isdigit():
                continue
            n = int(p)
            if 1 <= n <= 65535:
                ports.append(n)
            else:
                log.warning("ignoring out-of-range exposed port %s", n)
        return ports


@dataclass
class OutboundWhitelist:
    """Reference: squid proxy restricting algorithm egress (item 14).

    The policy *decision* survives: `allows(url)` is consulted by
    `algorithm.data_loading.load_data` for every remote database URI, on
    both execution paths — inline (TaskRunner.egress, built from node
    policies.egress) and sandboxed (the V6T_EGRESS env var re-builds the
    whitelist inside the child; see algorithm.wrap._env_gates).
    """

    enabled: bool = False
    domains: list[str] = field(default_factory=list)
    ips: list[str] = field(default_factory=list)
    ports: list[int] = field(default_factory=list)

    def _ip_allowed(self, addr: "ipaddress.IPv4Address | ipaddress.IPv6Address") -> bool:
        """`ips` entries are exact addresses OR CIDR networks — the same
        semantics as squid's `dst` acls (the reference whitelists
        ip/subnet entries distinctly from dstdomain globs)."""
        # [::ffff:10.0.0.1] IS 10.0.0.1: an IPv4 CIDR entry must treat
        # both spellings identically (version-mismatched containment is
        # silently False otherwise)
        mapped = getattr(addr, "ipv4_mapped", None)
        if mapped is not None:
            addr = mapped
        for entry in self.ips:
            try:
                if addr in ipaddress.ip_network(entry, strict=False):
                    return True
            except ValueError:
                # not CIDR/address syntax: fall back to glob on the string
                if fnmatch.fnmatch(str(addr), entry):
                    return True
        return False

    def allows(self, url: str) -> bool:
        if not self.enabled:
            return True
        try:
            parsed = urlparse(url if "//" in url else f"//{url}")
            host = parsed.hostname or ""
            port = parsed.port
        except ValueError:
            # malformed URL (unclosed IPv6 bracket, ":99999", ":abc"): the
            # GATE must answer, and fail-closed beats a ValueError escaping
            # into the algorithm run as a confusing non-policy crash
            return False
        try:
            addr = ipaddress.ip_address(host)
        except ValueError:
            addr = None
        if addr is not None:
            # a literal-IP URL must match an ip/CIDR entry; domain globs
            # deliberately do NOT apply (squid: dstdomain never matches
            # raw IPs — matching would let 10.* style globs leak)
            host_ok = self._ip_allowed(addr)
        else:
            host_ok = any(fnmatch.fnmatch(host, pat) for pat in self.domains)
        port_ok = port is None or not self.ports or port in self.ports
        return host_ok and port_ok


@dataclass
class SSHTunnelManager:
    """Reference: ssh tunnels from node to whitelisted internal hosts
    (item 15). Tracked as *named endpoints* databases may address via
    ``options.ssh_tunnel`` — `data_loading` resolves the name to the
    endpoint's station-local ``local_uri`` (TaskRunner.ssh_tunnels inline;
    V6T_SSH_TUNNELS over the sandbox ABI). Actual ssh transport is out of
    scope on-pod (data is mounted/loaded directly)."""

    tunnels: dict[str, dict[str, Any]] = field(default_factory=dict)
    supported: bool = False
    reason: str = "station data is mounted locally; no remote DB hop exists"

    @classmethod
    def from_config(cls, cfg: list[dict[str, Any]] | None) -> "SSHTunnelManager":
        mgr = cls()
        for t in cfg or []:
            name = t.get("hostname") or t.get("name")
            if not name:
                raise ValueError("ssh tunnel config needs a hostname/name")
            cls._validate_shape(name, t)
            mgr.tunnels[name] = dict(t)
        if mgr.tunnels:
            log.warning("ssh tunnels configured: %s", mgr.reason)
        return mgr

    @staticmethod
    def _validate_shape(name: str, t: dict[str, Any]) -> None:
        """Reject malformed reference-shaped config at daemon start.

        The reference's tunnel entry nests ``ssh: {host, port, identity:
        {username, key}}`` and ``tunnel: {bind: {ip, port}, dest: {ip,
        port}}``; both blocks are optional here (the transport is N/A
        on-pod) but when present they must be well-formed — a silently
        mis-typed port would otherwise surface only as a confusing
        data-loading failure deep inside an algorithm run."""
        ssh = t.get("ssh")
        if ssh is not None:
            if not isinstance(ssh, dict) or not ssh.get("host"):
                raise ValueError(f"ssh tunnel {name!r}: ssh block needs host")
            port = ssh.get("port", 22)
            if not isinstance(port, int) or not 1 <= port <= 65535:
                raise ValueError(f"ssh tunnel {name!r}: bad ssh port {port!r}")
        tunnel = t.get("tunnel")
        if tunnel is not None:
            for leg in ("bind", "dest"):
                block = (tunnel or {}).get(leg)
                if not isinstance(block, dict):
                    raise ValueError(
                        f"ssh tunnel {name!r}: tunnel needs a {leg} block"
                    )
                p = block.get("port")
                if not isinstance(p, int) or not 1 <= p <= 65535:
                    raise ValueError(
                        f"ssh tunnel {name!r}: bad {leg} port {p!r}"
                    )

    def endpoint(self, name: str) -> dict[str, Any]:
        if name not in self.tunnels:
            raise KeyError(
                f"no tunnel {name!r} (configured: {sorted(self.tunnels)})"
            )
        return self.tunnels[name]
