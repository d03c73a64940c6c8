"""Sessions (reference v4.7+): named dataframes persisted AT THE NODES
between tasks.

Covers the server bookkeeping (CRUD, permissions, task validation), the
node-side store (materialize via store_as, reuse via type="session"
databases, drop on session delete), and the full researcher flow over real
localhost sockets: extract → persisted locally → compute on the persisted
frame → only aggregates ever travel.

The port's copy of ``tests/test_sessions.py`` with its imports switched to
``vantage6_tpu_torch``. Its in-process federations run on the CPU
(``device="cpu"``).
"""
import sys
import time
import types

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.algorithm.decorators import data
from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.node.daemon import NodeDaemon
from vantage6_tpu_torch.server.app import ServerApp

ALGO_MODULE = "v6t_test_session_algo"


def _make_algo_module():
    mod = types.ModuleType(ALGO_MODULE)

    @data(1)
    def extract_adults(df, min_age: float):
        # extraction task: RETURNS the dataframe the node should persist
        return df[df["age"] >= min_age]

    @data(1)
    def mean_age(df):
        return {"sum": float(df["age"].sum()), "count": int(len(df))}

    mod.extract_adults = extract_adults
    mod.mean_age = mean_age
    sys.modules[ALGO_MODULE] = mod
    return mod


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sessions")
    _make_algo_module()
    rng = np.random.default_rng(13)
    frames = []
    for i in range(2):
        df = pd.DataFrame({"age": rng.uniform(10, 90, 100).round(1)})
        df.to_csv(tmp / f"s{i}.csv", index=False)
        frames.append(df)

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    orgs = [client.organization.create(name=f"org{i}") for i in range(2)]
    collab = client.collaboration.create(
        name="sess", organization_ids=[o["id"] for o in orgs]
    )
    daemons = []
    for i, org in enumerate(orgs):
        node_info = client.node.create(
            organization_id=org["id"], collaboration_id=collab["id"]
        )
        d = NodeDaemon(
            api_url=http.url,
            api_key=node_info["api_key"],
            algorithms={"session-algo": ALGO_MODULE},
            databases=[
                {"label": "default", "type": "csv",
                 "uri": str(tmp / f"s{i}.csv")}
            ],
            mode="inline",
            poll_interval=0.05,
        )
        d.start()
        daemons.append(d)
    yield {
        "client": client, "orgs": orgs, "collab": collab,
        "daemons": daemons, "frames": frames,
    }
    for d in daemons:
        d.stop()
    http.stop()
    srv.close()


class TestServerBookkeeping:
    def test_create_list_get(self, stack):
        c = stack["client"]
        s = c.session.create(
            name="workspace1", collaboration_id=stack["collab"]["id"]
        )
        assert s["name"] == "workspace1" and s["dataframes"] == []
        assert any(x["id"] == s["id"] for x in c.session.list())
        assert c.session.get(s["id"])["scope"] == "collaboration"

    def test_task_validation(self, stack):
        c, collab = stack["client"], stack["collab"]
        s = c.session.create(name="val", collaboration_id=collab["id"])
        orgs = [stack["orgs"][0]["id"]]
        # store_as without session
        with pytest.raises(Exception, match="session_id"):
            c.task.create(
                collaboration=collab["id"], organizations=orgs,
                image="session-algo",
                input_={"method": "extract_adults"}, store_as="x",
            )
        # unknown session dataframe reference
        with pytest.raises(Exception, match="no dataframe"):
            c.task.create(
                collaboration=collab["id"], organizations=orgs,
                image="session-algo", session=s["id"],
                input_={"method": "mean_age"},
                databases=[{"label": "d", "type": "session",
                            "dataframe": "nope"}],
            )
        # bad handle
        with pytest.raises(Exception, match="identifier"):
            c.task.create(
                collaboration=collab["id"], organizations=orgs,
                image="session-algo", session=s["id"],
                input_={"method": "extract_adults"},
                store_as="../escape",
            )


class TestEndToEnd:
    def test_extract_persist_compute_delete(self, stack):
        c, collab, orgs = stack["client"], stack["collab"], stack["orgs"]
        org_ids = [o["id"] for o in orgs]
        s = c.session.create(name="e2e", collaboration_id=collab["id"])

        # 1) extraction: every node filters its OWN data and persists the
        #    result locally; only metadata goes back
        t1 = c.task.create(
            collaboration=collab["id"], organizations=org_ids,
            image="session-algo", session=s["id"], store_as="adults",
            input_={"method": "extract_adults",
                    "kwargs": {"min_age": 18.0}},
        )
        metas = c.wait_for_results(t1["id"], interval=0.05, timeout=30)
        assert all(m["stored"] == "adults" for m in metas)
        assert all("age" in [col["name"] for col in m["columns"]]
                   for m in metas)
        # no raw rows travelled: results carry counts, not values
        assert all(set(m) == {"stored", "session_id", "rows", "columns"}
                   for m in metas)

        # server bookkeeping: dataframe registered and ready, with columns
        dfs = c.session.dataframes(s["id"])
        assert [d["handle"] for d in dfs] == ["adults"]
        assert dfs[0]["ready"] is True
        assert dfs[0]["columns"][0]["name"] == "age"

        # 2) compute on the PERSISTED dataframe (no source DB read)
        t2 = c.task.create(
            collaboration=collab["id"], organizations=org_ids,
            image="session-algo", session=s["id"],
            input_={"method": "mean_age"},
            databases=[{"label": "d", "type": "session",
                        "dataframe": "adults"}],
        )
        results = c.wait_for_results(t2["id"], interval=0.05, timeout=30)
        pooled = pd.concat(stack["frames"])
        adults = pooled[pooled["age"] >= 18.0]["age"]
        total = sum(r["sum"] for r in results)
        count = sum(r["count"] for r in results)
        assert count == len(adults)
        assert abs(total / count - adults.mean()) < 1e-9

        # 3) node stores exist, then are dropped on session delete
        stores = [
            d.runner.session_file(s["id"], "adults")
            for d in stack["daemons"]
        ]
        assert all(p.exists() for p in stores)
        c.session.delete(s["id"])
        deadline = time.monotonic() + 10
        while any(p.exists() for p in stores):
            if time.monotonic() > deadline:
                raise AssertionError("session stores not dropped")
            time.sleep(0.05)
        assert not any(x["id"] == s["id"] for x in c.session.list())

    def test_compute_before_extract_fails_cleanly(self, stack):
        c, collab = stack["client"], stack["collab"]
        s = c.session.create(name="cold", collaboration_id=collab["id"])
        # register the handle via a store_as task that we never let finish
        # first — simplest: reference a handle that IS registered but not
        # yet materialized at the node
        t1 = c.task.create(
            collaboration=collab["id"],
            organizations=[stack["orgs"][0]["id"]],
            image="session-algo", session=s["id"], store_as="late",
            input_={"method": "extract_adults", "kwargs": {"min_age": 0.0}},
        )
        c.wait_for_results(t1["id"], interval=0.05, timeout=30)
        # the OTHER node never ran the extraction; its compute must fail
        # with the materialization error, not crash undiagnosed
        t2 = c.task.create(
            collaboration=collab["id"],
            organizations=[stack["orgs"][1]["id"]],
            image="session-algo", session=s["id"],
            input_={"method": "mean_age"},
            databases=[{"label": "d", "type": "session",
                        "dataframe": "late"}],
        )
        deadline = time.monotonic() + 30
        while True:
            task = c.task.get(t2["id"])
            if task["status"] in ("crashed", "failed"):
                break
            assert time.monotonic() < deadline, task["status"]
            time.sleep(0.05)
        run = c.run.from_task(t2["id"])[0]
        assert "materialized" in (run["log"] or "")


class TestRuntimeSessions:
    """The in-process Federation runtime (the MockAlgorithmClient
    substrate) speaks the same session API, so algorithm developers test
    session flows locally with zero infrastructure."""

    def _fed(self):
        from vantage6_tpu_torch.runtime.federation import federation_from_datasets

        _make_algo_module()
        rng = np.random.default_rng(3)
        frames = [
            pd.DataFrame({"age": rng.uniform(1, 90, 50).round(1)})
            for _ in range(3)
        ]
        fed = federation_from_datasets(
            frames, {"session-algo": sys.modules[ALGO_MODULE]}, device="cpu"
        )
        return fed, frames

    def test_extract_then_compute(self):
        fed, frames = self._fed()
        s = fed.create_session("prep")
        t1 = fed.create_task(
            "session-algo",
            {"method": "extract_adults", "kwargs": {"min_age": 18.0}},
            session=s, store_as="adults",
        )
        metas = fed.wait_for_results(t1.id)
        assert all(m["stored"] == "adults" for m in metas)
        book = fed.session_dataframes(s)["adults"]
        assert book["ready"] is True
        assert book["columns"][0]["name"] == "age"

        t2 = fed.create_task(
            "session-algo",
            {"method": "mean_age"},
            databases=[{"label": "d", "type": "session",
                        "dataframe": "adults"}],
            session=s,
        )
        rs = fed.wait_for_results(t2.id)
        pooled = pd.concat(frames)
        adults = pooled[pooled.age >= 18.0].age
        assert sum(r["count"] for r in rs) == len(adults)
        assert abs(sum(r["sum"] for r in rs) / len(adults)
                   - adults.mean()) < 1e-9

        fed.delete_session(s)
        with pytest.raises(KeyError):
            fed.session_dataframes(s)

    def test_delete_session_while_store_as_run_executes(self):
        """A session deleted while a store_as run is mid-execution must
        neither crash the run (the bookkeeping vanished under it) nor
        leave an orphaned dataframe re-inserted after the cleanup —
        _store_session_result and delete_session share one locked region
        gated on the session still existing."""
        import threading as _threading

        from vantage6_tpu_torch.algorithm.decorators import data
        from vantage6_tpu_torch.runtime.federation import federation_from_datasets

        started = _threading.Event()
        proceed = _threading.Event()

        @data(1)
        def slow_extract(df):
            started.set()
            assert proceed.wait(10)
            return df

        fed = federation_from_datasets(
            [pd.DataFrame({"age": [1.0, 2.0]})],
            {"algo": {"slow_extract": slow_extract}},
            executor_workers=1, device="cpu",
        )
        s = fed.create_session("doomed")
        t = fed.create_task(
            "algo", {"method": "slow_extract"},
            session=s, store_as="x", wait=False,
        )
        assert started.wait(10)
        fed.delete_session(s)  # mid-execution: bookkeeping disappears
        proceed.set()
        metas = fed.wait_for_results(t.id)  # completes, does not crash
        assert metas[0]["stored"] == "x"
        # no orphaned store survived the delete
        assert all(s not in store for store in fed._session_stores)
        fed.close()

    def test_validation(self):
        fed, _ = self._fed()
        with pytest.raises(ValueError, match="requires a session"):
            fed.create_task(
                "session-algo", {"method": "extract_adults"}, store_as="x"
            )
        s = fed.create_session()
        with pytest.raises(ValueError, match="no dataframe"):
            fed.create_task(
                "session-algo", {"method": "mean_age"}, session=s,
                databases=[{"label": "d", "type": "session",
                            "dataframe": "missing"}],
            )

    def test_unmaterialized_station_crashes_cleanly(self):
        fed, _ = self._fed()
        s = fed.create_session()
        # extraction only at station 0; station 1's compute must crash with
        # the materialization error
        fed.wait_for_results(fed.create_task(
            "session-algo",
            {"method": "extract_adults", "kwargs": {"min_age": 0.0}},
            organizations=[0], session=s, store_as="part",
        ).id)
        t = fed.create_task(
            "session-algo", {"method": "mean_age"},
            organizations=[1], session=s,
            databases=[{"label": "d", "type": "session",
                        "dataframe": "part"}],
        )
        with pytest.raises(RuntimeError, match="materialized"):
            fed.wait_for_results(t.id)
