"""Network gates (node.gates) — wired, not decorative (VERDICT r1 #5).

The whitelist is enforced inside data loading on BOTH execution paths; ssh
tunnel endpoints resolve database URIs; the VPN manager's port surface is
exercised by the daemon integration test (test_node_integration).

The port's copy of ``tests/test_gates.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.algorithm.data_loading import load_data
from vantage6_tpu_torch.core.config import DatabaseConfig
from vantage6_tpu_torch.node.gates import (
    OutboundWhitelist,
    SSHTunnelManager,
    VPNManager,
)
from vantage6_tpu_torch.node.runner import RunSpec, TaskRunner


class TestOutboundWhitelist:
    def test_disabled_allows_everything(self):
        wl = OutboundWhitelist(enabled=False)
        assert wl.allows("https://anywhere.example:9999/x")

    def test_domain_globs_and_ports(self):
        wl = OutboundWhitelist(
            enabled=True, domains=["*.trusted.org"], ports=[443]
        )
        assert wl.allows("https://db.trusted.org:443/q")
        assert not wl.allows("https://db.evil.org:443/q")
        assert not wl.allows("https://db.trusted.org:8443/q")

    def test_ip_entries(self):
        wl = OutboundWhitelist(enabled=True, ips=["10.0.0.*"])
        assert wl.allows("http://10.0.0.7/x")
        assert not wl.allows("http://192.168.1.1/x")


class TestLoadDataEgress:
    def test_local_files_never_gated(self, tmp_path):
        csv = tmp_path / "d.csv"
        pd.DataFrame({"x": [1, 2]}).to_csv(csv, index=False)
        wl = OutboundWhitelist(enabled=True, domains=[])  # deny-all
        df = load_data(
            DatabaseConfig(label="d", type="csv", uri=str(csv)), whitelist=wl
        )
        assert len(df) == 2

    def test_sqlite_uri_never_gated(self, tmp_path):
        import sqlite3

        db = tmp_path / "t.db"
        with sqlite3.connect(db) as conn:
            conn.execute("CREATE TABLE t (x REAL)")
            conn.execute("INSERT INTO t VALUES (1.5)")
        wl = OutboundWhitelist(enabled=True, domains=[])
        df = load_data(
            DatabaseConfig(
                label="d", type="sql", uri=f"sqlite:///{db}",
                options={"query": "SELECT * FROM t"},
            ),
            whitelist=wl,
        )
        assert df["x"].iloc[0] == 1.5

    def test_remote_sql_host_blocked(self):
        wl = OutboundWhitelist(enabled=True, domains=["*.trusted.org"])
        with pytest.raises(PermissionError, match="egress.*blocked"):
            load_data(
                DatabaseConfig(
                    label="d", type="sql",
                    uri="postgresql://db.evil.org:5432/clinical",
                    options={"query": "SELECT 1"},
                ),
                whitelist=wl,
            )

    def test_remote_sql_host_allowed_reaches_connector(self):
        """Gate passes -> the next failure is the (absent) DB connection,
        proving the gate did not block."""
        wl = OutboundWhitelist(enabled=True, domains=["*.trusted.org"])
        with pytest.raises(Exception) as e:
            load_data(
                DatabaseConfig(
                    label="d", type="sql",
                    uri="postgresql://db.trusted.org:5432/clinical",
                    options={"query": "SELECT 1"},
                ),
                whitelist=wl,
            )
        assert not isinstance(e.value, PermissionError)

    def test_http_csv_blocked(self):
        wl = OutboundWhitelist(enabled=True, domains=[])
        with pytest.raises(PermissionError):
            load_data(
                DatabaseConfig(
                    label="d", type="csv", uri="https://evil.org/data.csv"
                ),
                whitelist=wl,
            )


class TestSSHTunnelResolution:
    def test_named_endpoint_rewrites_uri(self, tmp_path):
        csv = tmp_path / "remote.csv"
        pd.DataFrame({"x": [7.0]}).to_csv(csv, index=False)
        tunnels = SSHTunnelManager.from_config(
            [{"hostname": "warehouse", "local_uri": str(csv)}]
        )
        df = load_data(
            DatabaseConfig(
                label="d", type="csv", uri="ssh-placeholder",
                options={"ssh_tunnel": "warehouse"},
            ),
            ssh_tunnels=tunnels,
        )
        assert df["x"].iloc[0] == 7.0

    def test_unknown_tunnel_fails_loudly(self):
        tunnels = SSHTunnelManager.from_config(
            [{"hostname": "warehouse", "local_uri": "/x"}]
        )
        with pytest.raises(KeyError, match="no tunnel"):
            load_data(
                DatabaseConfig(
                    label="d", type="csv", uri="x",
                    options={"ssh_tunnel": "nope"},
                ),
                ssh_tunnels=tunnels,
            )

    def test_endpoint_without_local_uri_fails(self):
        tunnels = SSHTunnelManager.from_config([{"hostname": "w"}])
        with pytest.raises(ValueError, match="local_uri"):
            load_data(
                DatabaseConfig(
                    label="d", type="csv", uri="x",
                    options={"ssh_tunnel": "w"},
                ),
                ssh_tunnels=tunnels,
            )

    def test_tunnel_unconfigured_fails(self):
        with pytest.raises(ValueError, match="no ssh_tunnels"):
            load_data(
                DatabaseConfig(
                    label="d", type="csv", uri="x",
                    options={"ssh_tunnel": "w"},
                ),
            )


class TestRunnerGateIntegration:
    def _spec(self):
        return RunSpec(
            run_id=1, task_id=1, image="avg", method="partial_average",
            input_payload={"method": "partial_average",
                           "kwargs": {"column": "x"}},
        )

    def test_inline_runner_enforces_egress(self, tmp_path):
        runner = TaskRunner(
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            databases=[{
                "label": "default", "type": "sql",
                "uri": "postgresql://db.evil.org/x",
                "options": {"query": "SELECT 1"},
            }],
            policies={"egress": {"enabled": True, "domains": ["*.ok.org"]}},
            mode="inline",
            work_dir=tmp_path,
        )
        with pytest.raises(PermissionError, match="egress"):
            runner.run(self._spec())

    def test_sandbox_runner_enforces_egress(self, tmp_path):
        runner = TaskRunner(
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            databases=[{
                "label": "default", "type": "sql",
                "uri": "postgresql://db.evil.org/x",
                "options": {"query": "SELECT 1"},
            }],
            policies={"egress": {"enabled": True, "domains": ["*.ok.org"]}},
            mode="sandbox",
            work_dir=tmp_path,
        )
        with pytest.raises(RuntimeError, match="egress.*blocked"):
            runner.run(self._spec())

    def test_sandbox_passes_sql_options(self, tmp_path):
        """DATABASE_*_OPTIONS crosses the ABI: a sqlite query works in the
        sandbox (it needs options.query on the far side)."""
        import sqlite3

        db = tmp_path / "t.db"
        with sqlite3.connect(db) as conn:
            conn.execute("CREATE TABLE t (x REAL)")
            conn.executemany(
                "INSERT INTO t VALUES (?)", [(1.0,), (2.0,), (3.0,)]
            )
        runner = TaskRunner(
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            databases=[{
                "label": "default", "type": "sql",
                "uri": f"sqlite:///{db}",
                "options": {"query": "SELECT x FROM t"},
            }],
            mode="sandbox",
            work_dir=tmp_path,
        )
        out = runner.run(self._spec())
        assert out == {"sum": 6.0, "count": 3}

    def test_algorithm_ports_reads_module_declaration(self, monkeypatch):
        from vantage6_tpu_torch.workloads import average as avg_mod

        runner = TaskRunner(
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            mode="inline",
        )
        assert runner.algorithm_ports("avg") == []
        monkeypatch.setattr(avg_mod, "EXPOSED_PORTS", [7001, 7002],
                            raising=False)
        assert runner.algorithm_ports("avg") == [7001, 7002]
        assert runner.algorithm_ports("unknown-image") == []


class TestVPNManager:
    def test_exposed_ports_parsing(self):
        vpn = VPNManager(enabled=True)
        assert vpn.exposed_ports({"ports": "7001, 7002"}) == [7001, 7002]
        assert vpn.exposed_ports({}) == []

    def test_setup_reports_unsupported_transport(self):
        assert VPNManager(enabled=True).setup() is False


class TestWhitelistCIDRSemantics:
    """Round-5 depth: squid-parity dst semantics — CIDR networks for IP
    literals, and domain globs that can NEVER match a raw IP."""

    def test_cidr_entries(self):
        wl = OutboundWhitelist(enabled=True, ips=["10.0.0.0/8"])
        assert wl.allows("http://10.200.3.4/x")
        assert not wl.allows("http://11.0.0.1/x")

    def test_exact_ip_entry(self):
        wl = OutboundWhitelist(enabled=True, ips=["192.168.7.9"])
        assert wl.allows("http://192.168.7.9:80/x")
        assert not wl.allows("http://192.168.7.10/x")

    def test_domain_glob_never_matches_raw_ip(self):
        # squid: dstdomain acls do not match literal-IP requests — a
        # permissive hostname glob must not leak IP egress
        wl = OutboundWhitelist(enabled=True, domains=["1*"])
        assert not wl.allows("http://10.0.0.1/x")

    def test_ip_glob_fallback_still_works(self):
        wl = OutboundWhitelist(enabled=True, ips=["10.0.0.*"])
        assert wl.allows("http://10.0.0.7/x")
        assert not wl.allows("http://10.0.1.7/x")

    def test_ipv6_literal(self):
        wl = OutboundWhitelist(enabled=True, ips=["2001:db8::/32"])
        assert wl.allows("http://[2001:db8::1]:8080/x")
        assert not wl.allows("http://[2001:db9::1]/x")


class TestConfigValidation:
    def test_bad_vpn_subnet_fails_at_construction(self):
        import pytest

        with pytest.raises(ValueError, match="subnet"):
            VPNManager(enabled=True, subnet="10.76.0.0/99")

    def test_out_of_range_exposed_port_dropped(self):
        vpn = VPNManager()
        assert vpn.exposed_ports({"ports": "80,70000,443"}) == [80, 443]

    def test_ssh_tunnel_shape_validation(self):
        import pytest

        from vantage6_tpu_torch.node.gates import SSHTunnelManager

        ok = SSHTunnelManager.from_config([{
            "hostname": "warehouse",
            "ssh": {"host": "internal.host", "port": 22},
            "tunnel": {"bind": {"ip": "0.0.0.0", "port": 5432},
                       "dest": {"ip": "10.0.0.5", "port": 5432}},
            "local_uri": "postgresql://localhost:5432/db",
        }])
        assert ok.endpoint("warehouse")["local_uri"].startswith("postgresql")
        with pytest.raises(ValueError, match="ssh block needs host"):
            SSHTunnelManager.from_config(
                [{"hostname": "t", "ssh": {"port": 22}}]
            )
        with pytest.raises(ValueError, match="bad dest port"):
            SSHTunnelManager.from_config([{
                "hostname": "t",
                "tunnel": {"bind": {"ip": "0.0.0.0", "port": 1},
                           "dest": {"ip": "x", "port": "5432"}},
            }])

    def test_disabled_vpn_tolerates_bad_subnet(self):
        vpn = VPNManager(enabled=False, subnet="garbage")
        assert vpn.exposed_ports({"ports": "80"}) == [80]

    def test_wireguard_interface_address_subnet_ok(self):
        VPNManager(enabled=True, subnet="10.76.0.1/16")  # host bits set

    def test_ipv4_mapped_ipv6_matches_v4_cidr(self):
        wl = OutboundWhitelist(enabled=True, ips=["10.0.0.0/8"])
        assert wl.allows("http://[::ffff:10.0.0.1]/x")
        assert not wl.allows("http://[::ffff:11.0.0.1]/x")

    def test_malformed_port_fails_closed(self):
        wl = OutboundWhitelist(enabled=True, domains=["*"])
        assert not wl.allows("http://any.host:99999/x")

    def test_malformed_ipv6_url_fails_closed(self):
        wl = OutboundWhitelist(enabled=True, domains=["*"])
        assert not wl.allows("http://[::1/x")
