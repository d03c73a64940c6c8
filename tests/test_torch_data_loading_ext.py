"""The port's SPARQL + OMOP loaders: the copy of
``tests/test_data_loading_ext.py`` with its imports switched to
``vantage6_tpu_torch``.

The SPARQL test runs a real HTTP endpoint (the framework's own WSGI
server) speaking application/sparql-results+json; the OMOP test uses a
sqlite CDM with the marker table."""
import json
import sqlite3

import pytest

from vantage6_tpu_torch.algorithm.data_loading import load_data
from vantage6_tpu_torch.core.config import DatabaseConfig
from vantage6_tpu_torch.node.gates import OutboundWhitelist
from vantage6_tpu_torch.server.web import App, AppServer, Request, Response


@pytest.fixture()
def sparql_endpoint():
    """A minimal SPARQL endpoint: accepts POSTed query, returns bindings."""
    app = App("fake-sparql")
    seen = {}

    @app.route("/sparql", methods=("POST",))
    def sparql(req: Request):
        from urllib.parse import parse_qs

        seen["query"] = parse_qs(req.body.decode()).get("query", [""])[0]
        return Response(
            json.dumps({
                "head": {"vars": ["name", "age"]},
                "results": {"bindings": [
                    {"name": {"type": "literal", "value": "ada"},
                     "age": {"type": "literal", "value": "36"}},
                    {"name": {"type": "literal", "value": "grace"},
                     "age": {"type": "literal", "value": "47"}},
                    {"name": {"type": "literal", "value": "mary"}},
                ]},
            }).encode(),
            headers={"Content-Type": "application/sparql-results+json"},
        )

    server = AppServer(app, "127.0.0.1", 0).start_background()
    yield server, seen
    server.stop()


class TestSparql:
    def test_query_roundtrip(self, sparql_endpoint):
        server, seen = sparql_endpoint
        df = load_data(DatabaseConfig(
            label="kg", type="sparql", uri=f"{server.url}/sparql",
            options={"query": "SELECT ?name ?age WHERE { ... }"},
        ))
        assert list(df.columns) == ["name", "age"]
        assert list(df["name"]) == ["ada", "grace", "mary"]
        import pandas as pd

        assert pd.isna(df["age"].iloc[2])  # unbound variable -> null
        assert "SELECT" in seen["query"]

    def test_missing_query_rejected(self):
        with pytest.raises(ValueError, match="options.query"):
            load_data(DatabaseConfig(
                label="kg", type="sparql", uri="http://localhost/x",
            ))

    def test_endpoint_error_surfaces(self, sparql_endpoint):
        server, _ = sparql_endpoint
        with pytest.raises(ValueError, match="404"):
            load_data(DatabaseConfig(
                label="kg", type="sparql", uri=f"{server.url}/nope",
                options={"query": "SELECT 1"},
            ))

    def test_unreachable_endpoint(self):
        with pytest.raises(ConnectionError, match="unreachable"):
            load_data(DatabaseConfig(
                label="kg", type="sparql", uri="http://127.0.0.1:9/sparql",
                options={"query": "SELECT 1", "timeout": 2},
            ))

    def test_egress_gate_applies(self, sparql_endpoint):
        server, _ = sparql_endpoint
        wl = OutboundWhitelist(enabled=True, domains=["*.trusted.org"])
        with pytest.raises(PermissionError, match="egress"):
            load_data(
                DatabaseConfig(
                    label="kg", type="sparql", uri=f"{server.url}/sparql",
                    options={"query": "SELECT 1"},
                ),
                whitelist=wl,
            )


class TestOmop:
    def _cdm(self, tmp_path):
        db = tmp_path / "cdm.db"
        with sqlite3.connect(db) as conn:
            conn.execute(
                "CREATE TABLE person (person_id INTEGER, year_of_birth "
                "INTEGER, gender_concept_id INTEGER)"
            )
            conn.executemany(
                "INSERT INTO person VALUES (?, ?, ?)",
                [(1, 1980, 8507), (2, 1975, 8532), (3, 1990, 8507)],
            )
            conn.execute(
                "CREATE TABLE condition_occurrence (person_id INTEGER, "
                "condition_concept_id INTEGER)"
            )
            conn.execute("INSERT INTO condition_occurrence VALUES (1, 201820)")
        return db

    def test_cdm_query(self, tmp_path):
        db = self._cdm(tmp_path)
        df = load_data(DatabaseConfig(
            label="cdm", type="omop", uri=f"sqlite:///{db}",
            options={"query": (
                "SELECT p.person_id, p.year_of_birth FROM person p "
                "JOIN condition_occurrence c ON c.person_id = p.person_id"
            )},
        ))
        assert len(df) == 1 and df["year_of_birth"].iloc[0] == 1980

    def test_non_cdm_database_rejected(self, tmp_path):
        db = tmp_path / "plain.db"
        with sqlite3.connect(db) as conn:
            conn.execute("CREATE TABLE t (x REAL)")
        with pytest.raises(ValueError, match="OMOP CDM"):
            load_data(DatabaseConfig(
                label="cdm", type="omop", uri=f"sqlite:///{db}",
                options={"query": "SELECT * FROM t"},
            ))

    def test_remote_omop_gated(self):
        wl = OutboundWhitelist(enabled=True, domains=[])
        with pytest.raises(PermissionError, match="egress"):
            load_data(
                DatabaseConfig(
                    label="cdm", type="omop",
                    uri="postgresql://cdm.evil.org/omop",
                    options={"query": "SELECT 1"},
                ),
                whitelist=wl,
            )
