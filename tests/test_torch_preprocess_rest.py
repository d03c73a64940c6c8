"""The v4.7 session ladder through the port's server and daemons: an
extraction task persists a session dataframe, a preprocessing task derives
another, compute runs on the derived frame, raw rows never travel.

The port's copy of ``tests/test_preprocess.py``'s ``TestSessionFlow``,
which waited for the server and the daemon.
"""
import numpy as np
import pandas as pd


class TestSessionFlow:
    def test_extract_preprocess_compute(self, tmp_path):
        """The v4.7 ladder through real server+nodes: the preprocessing
        task reads one session dataframe and persists another; compute
        runs on the derived frame; raw rows never travel."""
        import secrets as pysecrets

        from vantage6_tpu_torch.client import UserClient
        from vantage6_tpu_torch.node.daemon import NodeDaemon
        from vantage6_tpu_torch.server.app import ServerApp

        rng = np.random.default_rng(3)
        frames = []
        for i in range(2):
            df = pd.DataFrame({
                "age": rng.uniform(10, 90, 60).round(1),
                "weight_kg": rng.uniform(50, 110, 60).round(1),
                "height_m": rng.uniform(1.5, 2.0, 60).round(2),
            })
            df.to_csv(tmp_path / f"s{i}.csv", index=False)
            frames.append(df)

        srv = ServerApp()
        srv.ensure_root(password="rootpass123")
        http = srv.serve(port=0, background=True)
        daemons = []
        try:
            c = UserClient(http.url)
            c.authenticate("root", "rootpass123")
            orgs = [
                c.organization.create(name=f"pp{i}") for i in range(2)
            ]
            collab = c.collaboration.create(
                name="pp", organization_ids=[o["id"] for o in orgs]
            )
            for i, org in enumerate(orgs):
                info = c.node.create(
                    organization_id=org["id"],
                    collaboration_id=collab["id"],
                )
                d = NodeDaemon(
                    api_url=http.url, api_key=info["api_key"],
                    algorithms={
                        "v6-preprocess-py":
                            "vantage6_tpu_torch.workloads.preprocess",
                        "v6-average-py": "vantage6_tpu_torch.workloads.average",
                    },
                    databases=[{"label": "default", "type": "csv",
                                "uri": str(tmp_path / f"s{i}.csv")}],
                    mode="inline", poll_interval=0.05,
                    station_secret=pysecrets.token_hex(32),
                )
                d.start()
                daemons.append(d)

            session = c.session.create(
                name="ladder", collaboration_id=collab["id"]
            )
            all_orgs = [o["id"] for o in orgs]
            # 1) EXTRACT: source db -> session dataframe "adults"
            t1 = c.task.create(
                collaboration=collab["id"], organizations=all_orgs,
                image="v6-preprocess-py", session=session["id"],
                store_as="adults",
                input_={"method": "preprocess", "kwargs": {"steps": [
                    {"op": "filter", "column": "age", "cmp": "ge",
                     "value": 18},
                ]}},
            )
            c.wait_for_results(t1["id"], timeout=60)
            # 2) PREPROCESS: "adults" -> derived dataframe "with_bmi"
            t2 = c.task.create(
                collaboration=collab["id"], organizations=all_orgs,
                image="v6-preprocess-py", session=session["id"],
                store_as="with_bmi",
                databases=[{"label": "d", "type": "session",
                            "dataframe": "adults"}],
                input_={"method": "preprocess", "kwargs": {"steps": [
                    {"op": "derive", "column": "bmi",
                     "expr": {"op": "div",
                              "args": ["weight_kg", "height_m"]}},
                    {"op": "derive", "column": "bmi",
                     "expr": {"op": "div", "args": ["bmi", "height_m"]}},
                ]}},
            )
            c.wait_for_results(t2["id"], timeout=60)
            dfs = {d_["handle"]: d_ for d_ in
                   c.session.dataframes(session["id"])}
            assert dfs["with_bmi"]["ready"]
            assert "bmi" in [col["name"] for col in
                             dfs["with_bmi"]["columns"]]
            # 3) COMPUTE on the derived frame (only aggregates travel)
            t3 = c.task.create(
                collaboration=collab["id"], organizations=all_orgs,
                image="v6-average-py", session=session["id"],
                databases=[{"label": "d", "type": "session",
                            "dataframe": "with_bmi"}],
                input_={"method": "partial_average",
                        "kwargs": {"column": "bmi"}},
            )
            parts = c.wait_for_results(t3["id"], timeout=60)
            pooled = pd.concat(frames, ignore_index=True)
            pooled = pooled[pooled["age"] >= 18]
            bmi = pooled["weight_kg"] / pooled["height_m"] ** 2
            got = sum(p["sum"] for p in parts) / sum(
                p["count"] for p in parts
            )
            np.testing.assert_allclose(got, bmi.mean(), rtol=1e-9)
        finally:
            for d in daemons:
                d.stop()
            http.stop()
            srv.close()
