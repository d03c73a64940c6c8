"""The port's control plane against the JAX package's, both on the CPU in one
process.

(a) the two ``ServerApp``s register the same (methods, rule) set;
(b) one scripted REST session gets the same status codes and JSON bodies
    from both servers' ``TestClient``s once generated keys, tokens and
    timestamps are masked, in this process and again in a child process with
    ``marshmallow`` blocked (the schema fallback);
(c) mixed stacks: each package's ``UserClient`` drives ``central_average``
    through the other package's server and daemons, and both results equal
    the all-JAX and all-port stacks';
(d) a SQLite file written by one server opens in the other at the same
    schema version and reads back the same rows;
(e) the same ``engine="device"`` tasks through the JAX stack and through the
    port's stack (``device_engine={"device": "cpu"}``) agree within the
    tolerances of ``tests/test_torch_device_engine.py``.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

JAX_PKG, PORT_PKG = "vantage6_tpu", "vantage6_tpu_torch"
PKGS = (JAX_PKG, PORT_PKG)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_RTOL = 1e-6


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------------- (a) routes
def _routes(pkg):
    srv = _mod(pkg, "server.app").ServerApp()
    try:
        return {(method, pattern) for _regex, table, pattern
                in srv.app._routes for method in table}
    finally:
        srv.close()


def test_route_tables_match():
    jax_routes, port_routes = (_routes(p) for p in PKGS)
    assert len(port_routes) > 75
    assert port_routes == jax_routes, (sorted(jax_routes - port_routes),
                                       sorted(port_routes - jax_routes))


# ---------------------------------------------------------- (b) responses
_MASKED_KEYS = {"api_key", "trace_id", "traceparent", "ts", "uptime_s",
                "started", "now"}


def _mask(obj, key=""):
    """Generated keys, tokens and timestamps become placeholders."""
    if key in _MASKED_KEYS or key.endswith("_at") or "token" in key:
        return "<masked>" if obj is not None else None
    if isinstance(obj, dict):
        return {k: _mask(v, k) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def scripted_session(pkg):
    """One researcher's session against a fresh server of ``pkg``; returns
    ``[(step, status, masked JSON body)]``."""
    srv = _mod(pkg, "server.app").ServerApp()
    out = []
    try:
        srv.ensure_root(password="rootpass123")
        c = srv.test_client()

        def step(name, resp, body=True):
            out.append([name, resp.status, _mask(resp.json) if body
                        else sorted(resp.json)])
            return resp.json

        tok = step("login", c.post("/api/token/user", {
            "username": "root", "password": "rootpass123"}))
        c.token = tok["access_token"]
        orgs = [step(f"org {n}", c.post("/api/organization", {"name": n}))
                for n in ("hospital_a", "hospital_b")]
        collab = step("collaboration", c.post("/api/collaboration", {
            "name": "demo", "organization_ids": [o["id"] for o in orgs]}))
        for o in orgs:
            step("node", c.post("/api/node", {
                "organization_id": o["id"],
                "collaboration_id": collab["id"]}))
        step("nodes", c.get("/api/node"))
        roles = step("roles", c.get("/api/role"))
        researcher = next(r for r in roles["data"]
                          if r["name"] == "Researcher")
        step("role create", c.post("/api/role", {
            "name": "auditor", "description": "reads", "rules": [],
            "organization_id": orgs[0]["id"]}))
        step("user create", c.post("/api/user", {
            "username": "alice", "password": "alicepass123",
            "organization_id": orgs[0]["id"],
            "roles": [researcher["id"]]}))
        step("users", c.get("/api/user"))
        task = step("task", c.post("/api/task", {
            "name": "avg", "image": "v6-average-py",
            "collaboration_id": collab["id"],
            "organizations": [{"id": o["id"], "input": "e30="}
                              for o in orgs]}))
        step("task get", c.get(f"/api/task/{task['id']}"))
        step("task runs", c.get(f"/api/task/{task['id']}/run"))
        step("runs", c.get(f"/api/run?task_id={task['id']}"))
        step("whoami", c.get("/api/whoami"))
        step("version", c.get("/api/version"))
        step("health keys", c.get("/api/health"), body=False)
        step("bad body", c.post("/api/organization", {"name": 42}))
        step("bad task", c.post("/api/task", {"image": "x"}))
        step("anonymous", srv.test_client().get("/api/organization"))
        alice = srv.test_client()
        alice.token = alice.post("/api/token/user", {
            "username": "alice", "password": "alicepass123"},
        ).json["access_token"]
        step("forbidden", alice.post("/api/organization", {"name": "x"}))
        step("forbidden delete",
             alice.delete(f"/api/collaboration/{collab['id']}"))
    finally:
        srv.close()
    return out


def _assert_same_session(jax_steps, port_steps):
    assert [s[0] for s in port_steps] == [s[0] for s in jax_steps]
    for j, p in zip(jax_steps, port_steps):
        assert p == j, (j[0], j, p)


def test_scripted_session_matches():
    jax_steps, port_steps = (scripted_session(p) for p in PKGS)
    statuses = {s[0]: s[1] for s in port_steps}
    assert statuses["bad body"] == 400 and statuses["bad task"] == 400
    assert statuses["anonymous"] == 401 and statuses["forbidden"] == 403
    _assert_same_session(jax_steps, port_steps)


def test_scripted_session_matches_without_marshmallow(tmp_path):
    code = textwrap.dedent("""
        import json, sys
        sys.modules["marshmallow"] = None
        sys.path.insert(0, sys.argv[1])
        import test_torch_control_plane_parity as t
        from vantage6_tpu_torch.server import schemas
        assert schemas.Schema.__module__.endswith("_schemas_fallback")
        out = {p: t.scripted_session(p) for p in t.PKGS}
        with open(sys.argv[2], "w") as f:
            json.dump(out, f)
    """)
    dest = tmp_path / "sessions.json"
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-c", code, os.path.join(REPO, "tests"), str(dest)],
        capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(dest.read_text())
    assert {s[0]: s[1] for s in out[PORT_PKG]}["bad body"] == 400
    _assert_same_session(out[JAX_PKG], out[PORT_PKG])
    # and the fallback answers as marshmallow does
    _assert_same_session(json.loads(json.dumps(scripted_session(PORT_PKG))),
                         out[PORT_PKG])


# ----------------------------------------------------------- (c) stacks
class _Stack:
    """A server of ``server_pkg`` on a real socket, two inline daemons of
    ``daemon_pkg`` (each on its own CSV) and a root ``UserClient`` of
    ``client_pkg``."""

    def __init__(self, tmp, server_pkg, daemon_pkg, client_pkg, frames,
                 image="v6-average-py", module="workloads.average",
                 device_engine=None, uri="sqlite:///:memory:"):
        self.srv = _mod(server_pkg, "server.app").ServerApp(uri=uri)
        self.srv.ensure_root(password="rootpass123")
        self.http = self.srv.serve(port=0, background=True)
        self.daemons = []
        try:
            self.client = _mod(client_pkg, "client").UserClient(
                self.http.url)
            self.client.authenticate("root", "rootpass123")
            self.orgs = [self.client.organization.create(name=f"org{i}")
                         for i in range(len(frames))]
            self.collab = self.client.collaboration.create(
                name="parity", organization_ids=[o["id"] for o in self.orgs])
            NodeDaemon = _mod(daemon_pkg, "node.daemon").NodeDaemon
            for i, (org, df) in enumerate(zip(self.orgs, frames)):
                csv = tmp / f"{daemon_pkg}_{server_pkg}_s{i}.csv"
                df.to_csv(csv, index=False)
                key = self.client.node.create(
                    organization_id=org["id"],
                    collaboration_id=self.collab["id"])["api_key"]
                d = NodeDaemon(
                    api_url=self.http.url, api_key=key,
                    algorithms={image: f"{daemon_pkg}.{module}"},
                    databases=[{"label": "default", "type": "csv",
                                "uri": str(csv)}],
                    mode="inline", poll_interval=0.05,
                    device_engine=device_engine)
                d.start()
                self.daemons.append(d)
        except BaseException:
            self.close()
            raise

    def run(self, input_, organizations=None, engine=None, image=None):
        kw = {"engine": engine} if engine else {}
        task = self.client.task.create(
            collaboration=self.collab["id"],
            organizations=organizations or [self.orgs[0]["id"]],
            image=image or "v6-average-py", input_=input_, **kw)
        return self.client.wait_for_results(task["id"], interval=0.05,
                                            timeout=120)

    def close(self):
        for d in self.daemons:
            d.stop()
        self.http.stop()
        self.srv.close()


def _age_frames(seed=7):
    rng = np.random.default_rng(seed)
    return [pd.DataFrame({"age": rng.normal(50 + 4 * i, 8, 60 + 20 * i)})
            for i in range(2)]


@pytest.mark.parametrize("server_pkg,client_pkg", [
    (JAX_PKG, JAX_PKG), (PORT_PKG, JAX_PKG), (JAX_PKG, PORT_PKG),
    (PORT_PKG, PORT_PKG)], ids=["jax", "jax-client-port-stack",
                                "port-client-jax-stack", "port"])
def test_mixed_stacks_central_average(tmp_path, server_pkg, client_pkg):
    frames = _age_frames()
    stack = _Stack(tmp_path, server_pkg, server_pkg, client_pkg, frames)
    try:
        result = stack.run({"method": "central_average",
                            "kwargs": {"column": "age"}})
    finally:
        stack.close()
    pooled = pd.concat(frames)["age"]
    assert result == [{"average": pytest.approx(pooled.mean(), rel=1e-12),
                       "count": len(pooled)}]
    # every stack computes the same float64 sums in the same order
    sums = [float(f["age"].sum()) for f in frames]
    assert result[0]["average"] == sum(sums) / len(pooled)


# ------------------------------------------------------- (d) database files
def _write_db(pkg, uri):
    srv = _mod(pkg, "server.app").ServerApp(uri=uri)
    try:
        srv.ensure_root(password="rootpass123")
        c = srv.test_client()
        c.token = c.post("/api/token/user", {
            "username": "root", "password": "rootpass123",
        }).json["access_token"]
        orgs = [c.post("/api/organization", {"name": n}).json
                for n in ("db_a", "db_b")]
        collab = c.post("/api/collaboration", {
            "name": "dbc", "organization_ids": [o["id"] for o in orgs]}).json
        for o in orgs:
            c.post("/api/node", {"organization_id": o["id"],
                                 "collaboration_id": collab["id"]})
        c.post("/api/task", {
            "name": "t", "image": "v6-average-py",
            "collaboration_id": collab["id"],
            "organizations": [{"id": o["id"], "input": "e30="}
                              for o in orgs]})
    finally:
        srv.close()


def _read_db(pkg, uri):
    srv = _mod(pkg, "server.app").ServerApp(uri=uri)
    try:
        version = _mod(pkg, "server.migrations").current_version(srv.db)
        c = srv.test_client()
        c.token = c.post("/api/token/user", {
            "username": "root", "password": "rootpass123",
        }).json["access_token"]
        rows = {ep: _mask(c.get(f"/api/{ep}").json["data"])
                for ep in ("organization", "collaboration", "node", "task",
                           "run", "user", "role")}
    finally:
        srv.close()
    return version, rows


@pytest.mark.parametrize("writer,reader", [(JAX_PKG, PORT_PKG),
                                           (PORT_PKG, JAX_PKG)])
def test_database_file_crosses_packages(tmp_path, writer, reader):
    uri = "sqlite:///" + str(tmp_path / "cp.db")
    _write_db(writer, uri)
    w_version, w_rows = _read_db(writer, uri)
    r_version, r_rows = _read_db(reader, uri)
    assert w_version == r_version == _mod(
        reader, "server.migrations").SCHEMA_VERSION
    assert len(r_rows["run"]) == 2 and len(r_rows["node"]) == 2
    assert r_rows == w_rows


# ------------------------------------------------------- (e) device engine
def _engine_station(seed=42):
    """One station: tests/test_device_engine_mp.py's columns."""
    rng = np.random.default_rng(seed)
    age = rng.uniform(20, 80, 90).round(1)
    x0 = rng.normal(0, 1, age.size)
    label = (x0 + 0.1 * rng.normal(0, 1, age.size) > 0).astype(float)
    return pd.DataFrame({"age": age, "x0": x0,
                         "x1": rng.normal(0, 1, age.size), "label": label})


def _engine_results(tmp, pkg, df):
    device_engine = {"device": "cpu"} if pkg == PORT_PKG else {}
    stack = _Stack(tmp, pkg, pkg, pkg, [df], image="device-engine",
                   module="workloads.device_engine",
                   device_engine=device_engine)
    try:
        stats = stack.run({"method": "device_column_stats",
                           "kwargs": {"column": "age", "pad_to": 128}},
                          engine="device", image="device-engine")
        fit = stack.run({"method": "device_logistic_fit", "kwargs": {
            "feature_columns": ["x0", "x1"], "label_column": "label",
            "rounds": 3, "local_steps": 4, "batch_rows": 128, "lr": 0.5}},
            engine="device", image="device-engine")
    finally:
        stack.close()
    return stats[0], fit[0]


def test_device_engine_tasks_match(tmp_path):
    df = _engine_station()
    (j_stats, j_fit), (p_stats, p_fit) = (
        _engine_results(tmp_path, p, df) for p in PKGS)
    np.testing.assert_allclose(p_stats["mean"], j_stats["mean"],
                               rtol=F32_RTOL)
    np.testing.assert_allclose(p_stats["std"], j_stats["std"], rtol=F32_RTOL)
    assert p_stats["count"] == j_stats["count"] == len(df)
    assert p_stats["n_stations"] == j_stats["n_stations"] == 1
    np.testing.assert_allclose(p_fit["weights"], j_fit["weights"],
                               rtol=F32_RTOL, atol=1e-7)
    np.testing.assert_allclose(p_fit["bias"], j_fit["bias"], rtol=F32_RTOL,
                               atol=1e-7)
    assert p_fit["local_accuracy"] == j_fit["local_accuracy"]
    assert p_fit["local_rows"] == j_fit["local_rows"] == len(df)
