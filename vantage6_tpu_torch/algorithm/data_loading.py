"""Per-database-type data readers.

Parity: the reference's `load_data` dispatch keyed by the node config's
database ``type`` (SURVEY.md §2 item 20): csv, parquet, excel, sql, sparql,
omop — each yielding a pandas DataFrame for ``@data`` injection. Added here:
``array`` (npy/npz or in-memory) for the device fast path, where a station's
shard is an array pytree rather than a DataFrame.

sparql speaks plain HTTP (application/sparql-results+json) so it needs no
SPARQLWrapper; omop treats the CDM as the SQL database it is (marker-table
check + query). Non-sqlite SQL dialects need sqlalchemy at the node (not in
this image) and say so explicitly.

The port's copy of ``vantage6_tpu/algorithm/data_loading.py``. pandas,
sqlalchemy and requests are imported only inside the loaders that need
them: the ``array`` type needs none of them. The gates (``whitelist``,
``ssh_tunnels``) are duck-typed: the node's ``OutboundWhitelist`` and
``SSHTunnelManager`` come with the node.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any
from urllib.parse import urlparse

import numpy as np

from vantage6_tpu_torch.core.config import DatabaseConfig


def _check_egress(db: DatabaseConfig, whitelist: Any):
    """Node egress gate (reference: squid whitelist, SURVEY.md item 14).

    Any database URI that names a remote host — http(s)/ftp readers or a
    sql URL with a hostname — must pass the node's OutboundWhitelist before
    a single byte leaves the station. Local files (csv paths, sqlite:///)
    never hit the gate."""
    if whitelist is None:
        return
    uri = db.uri or ""
    parsed = urlparse(uri)
    is_remote = bool(parsed.hostname) and (
        parsed.scheme in ("http", "https", "ftp", "ftps")
        or db.type in ("sql", "omop", "sparql")
    )
    if is_remote and not whitelist.allows(uri):
        raise PermissionError(
            f"egress to {parsed.hostname!r} blocked by this node's outbound "
            f"whitelist (database {db.label!r})"
        )


def _resolve_ssh_tunnel(
    db: DatabaseConfig, tunnels: Any
) -> DatabaseConfig:
    """Reference item 15: a db may address a named SSH tunnel endpoint
    (``options.ssh_tunnel``). The endpoint's ``local_uri`` — the tunnel's
    station-local end — replaces the database uri; an unknown name fails
    loudly instead of leaking a connection attempt to the raw address."""
    name = (db.options or {}).get("ssh_tunnel")
    if not name:
        return db
    if tunnels is None:
        raise ValueError(
            f"database {db.label!r} wants ssh tunnel {name!r} but this node "
            "has no ssh_tunnels configured"
        )
    ep = tunnels.endpoint(str(name))
    local_uri = ep.get("local_uri")
    if not local_uri:
        raise ValueError(
            f"ssh tunnel {name!r} has no local_uri configured — on this "
            "platform the operator must point it at a station-reachable "
            "address (no WireGuard/ssh transport exists on-pod; see "
            "node.gates.SSHTunnelManager.reason)"
        )
    opts = {k: v for k, v in db.options.items() if k != "ssh_tunnel"}
    return DatabaseConfig(
        label=db.label, type=db.type, uri=str(local_uri), options=opts
    )


def load_data(
    db: DatabaseConfig,
    data: Any = None,
    whitelist: Any = None,
    ssh_tunnels: Any = None,
) -> Any:
    """Load one database for one station.

    ``data`` short-circuits loading for programmatically supplied datasets
    (MockAlgorithmClient-style in-memory DataFrames/arrays). ``whitelist``
    and ``ssh_tunnels`` are the node's network gates (node.gates), applied
    to remote URIs before any connection is made.
    """
    if data is not None:
        return data
    db = _resolve_ssh_tunnel(db, ssh_tunnels)
    _check_egress(db, whitelist)
    kind = db.type
    if kind == "csv":
        return _pandas().read_csv(db.uri, **db.options)
    if kind == "parquet":
        return _pandas().read_parquet(db.uri, **db.options)
    if kind == "excel":
        return _pandas().read_excel(db.uri, **db.options)
    if kind == "sql":
        return _load_sql(db)
    if kind == "array":
        if not db.uri:
            raise ValueError(
                f"array database {db.label!r} has no uri and no in-memory data"
            )
        p = Path(db.uri)
        if p.suffix == ".npz":
            with np.load(p) as z:
                return {k: z[k] for k in z.files}
        return np.load(p)
    if kind == "sparql":
        return _load_sparql(db)
    if kind == "omop":
        return _load_omop(db)
    if kind == "session":
        # a dataframe an earlier task materialized in this node's session
        # store (node.runner resolves the handle to a local pickle path;
        # reference v4.7 'sessions')
        return _pandas().read_pickle(db.uri)
    raise ValueError(f"unknown database type {kind!r}")


def _load_sql(db: DatabaseConfig) -> Any:
    query = db.options.get("query")
    if not query:
        raise ValueError(f"sql database {db.label!r} needs options.query")
    scheme = urlparse(db.uri).scheme
    if scheme in ("sqlite", ""):
        # stdlib path: sqlite:///file.db or a bare file path — no
        # sqlalchemy needed (and none ships in this image)
        import contextlib
        import sqlite3

        path = db.uri.split("///", 1)[-1] if "///" in db.uri else db.uri
        # closing(): sqlite3's context manager only commits, it does NOT
        # close — a daemon loading per-run would leak one fd per run
        with contextlib.closing(sqlite3.connect(path)) as conn:
            return _pandas().read_sql_query(query, conn)
    try:
        import sqlalchemy
    except ImportError as e:
        raise NotImplementedError(
            f"sql dialect {scheme!r} needs sqlalchemy, which this "
            "environment does not ship; use sqlite:/// or install "
            "sqlalchemy at the node"
        ) from e
    engine = sqlalchemy.create_engine(db.uri)
    with engine.connect() as conn:
        return _pandas().read_sql(sqlalchemy.text(query), conn)


def _load_sparql(db: DatabaseConfig) -> Any:
    """SPARQL endpoint -> DataFrame (reference: SPARQLWrapper-based loader).

    A SPARQL endpoint is plain HTTP: POST the query, ask for
    ``application/sparql-results+json``, flatten the bindings. No
    SPARQLWrapper dependency needed. The egress gate has already vetted the
    endpoint host (http scheme) before this runs.
    """
    query = db.options.get("query")
    if not query:
        raise ValueError(f"sparql database {db.label!r} needs options.query")
    import requests

    try:
        resp = requests.post(
            db.uri,
            data={"query": query},
            headers={"Accept": "application/sparql-results+json"},
            timeout=float(db.options.get("timeout", 60)),
        )
    except requests.RequestException as e:
        raise ConnectionError(
            f"sparql endpoint {db.uri!r} unreachable: {e}"
        ) from None
    if resp.status_code != 200:
        raise ValueError(
            f"sparql endpoint returned {resp.status_code}: {resp.text[:300]}"
        )
    payload = resp.json()
    variables = payload.get("head", {}).get("vars", [])
    rows = [
        {var: binding.get(var, {}).get("value") for var in variables}
        for binding in payload.get("results", {}).get("bindings", [])
    ]
    return _pandas().DataFrame(rows, columns=variables)


def _load_omop(db: DatabaseConfig) -> Any:
    """OMOP CDM database -> DataFrame (reference: OHDSI-tooling loader).

    An OMOP source IS a SQL database holding the CDM schema; the loader
    verifies the CDM marker table (``person``) exists, then runs the
    configured query through the sql path — same URI forms and gates.
    """
    probe = DatabaseConfig(
        label=db.label, type="sql", uri=db.uri,
        options={"query": "SELECT 1 FROM person LIMIT 1"},
    )
    try:
        _load_sql(probe)
    except ValueError:
        raise
    except NotImplementedError:
        raise
    except Exception as e:
        raise ValueError(
            f"database {db.label!r} does not look like an OMOP CDM source "
            f"(no readable 'person' table): {e}"
        ) from None
    return _load_sql(
        DatabaseConfig(label=db.label, type="sql", uri=db.uri,
                       options=db.options)
    )


def _pandas():
    import pandas as pd

    return pd
