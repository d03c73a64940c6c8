"""Lightweight sqlite3-backed persistence for the control plane.

Parity: the reference persists its control plane through SQLAlchemy ORM
models (SURVEY.md §2 items 2, 8). SQLAlchemy is not in this image, so this
module provides the small declarative core the server models need: typed
columns, foreign keys, many-to-many link tables, and schema migration by
additive DDL (the reference uses alembic; here `ensure_schema` creates
missing tables/columns on startup, which covers the same upgrade path for a
single-writer control plane).

Thread safety: one connection per thread (the WSGI server is threaded);
sqlite handles cross-process locking.

Storage backends: the server binds its models through `open_backend(uri)`,
which dispatches on the URI scheme via the `BACKENDS` registry:

- ``sqlite`` — the `Database` below: single replica, dev/test default
  (`:memory:` supported through one shared connection).
- ``sqlite+wal`` — `WalDatabase`: one WAL file SHARED by N server replica
  processes; every statement retries on SQLITE_BUSY with backoff, and the
  backend advertises ``SHARED = True`` so the app layer switches the event
  hub, cache invalidation and learning plane onto shared-store substrates.

A Postgres driver drops in by registering another class with the same
execute/query/close surface (rowcount-bearing cursors are the only
contract `Model.compare_and_swap` needs).
"""
from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, ClassVar, Iterable, TypeVar

T = TypeVar("T", bound="Model")

_TYPES = {
    "int": "INTEGER",
    "float": "REAL",
    "str": "TEXT",
    "bool": "INTEGER",
    "json": "TEXT",
    "blob": "BLOB",
}


class Database:
    """One sqlite database; thread-local connections."""

    # backend identity: the scheme this class serves in `BACKENDS`, and
    # whether N server processes may share one store (drives the app
    # layer's hub/cache/learning substrate selection)
    KIND: ClassVar[str] = "sqlite"
    SHARED: ClassVar[bool] = False

    def __init__(self, uri: str = "sqlite:///:memory:"):
        self.uri = uri
        self.path = uri.split(":///", 1)[1] if ":///" in uri else uri
        self._local = threading.local()
        self._memory_conn: sqlite3.Connection | None = None
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        else:
            # :memory: is per-connection; share ONE connection (+lock) so all
            # threads see the same in-memory database (test mode).
            self._memory_conn = self._connect()
        self._memory_lock = threading.RLock()

    def _connect(self) -> sqlite3.Connection:
        # cached_statements: sqlite3 keeps per-connection PREPARED
        # statements keyed by SQL text; the generated CRUD SQL is highly
        # repetitive (one shape per model/filter combination), so a larger
        # cache keeps the whole hot set compiled across the federation's
        # polling/batch sweeps instead of re-parsing per request
        conn = sqlite3.connect(
            self.path, check_same_thread=False, cached_statements=256
        )
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA foreign_keys = ON")
        conn.execute("PRAGMA journal_mode = WAL")
        # thread-per-request server (server/web.py): concurrent writers
        # queue on the sqlite write lock. sqlite3.connect's default
        # timeout already installs a 5 s busy handler; the pragma makes
        # that contract EXPLICIT so nobody "optimizes" connect(timeout=0)
        # without tripping over this line
        conn.execute("PRAGMA busy_timeout = 5000")
        # durable-enough with WAL (fsync at checkpoint, not per-commit);
        # the per-commit fsync of FULL is the single-writer bottleneck
        # under federation-scale polling
        conn.execute("PRAGMA synchronous = NORMAL")
        return conn

    @property
    def conn(self) -> sqlite3.Connection:
        if self._memory_conn is not None:
            return self._memory_conn
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self._connect()
            self._local.conn = c
        return c

    def execute(self, sql: str, params: Iterable[Any] = ()) -> sqlite3.Cursor:
        if self._memory_conn is not None:
            with self._memory_lock:
                cur = self.conn.execute(sql, tuple(params))
                self.conn.commit()
                return cur
        cur = self.conn.execute(sql, tuple(params))
        self.conn.commit()
        return cur

    def query(self, sql: str, params: Iterable[Any] = ()) -> list[sqlite3.Row]:
        if self._memory_conn is not None:
            with self._memory_lock:
                return self.conn.execute(sql, tuple(params)).fetchall()
        return self.conn.execute(sql, tuple(params)).fetchall()

    def execute_batch(
        self, statements: Iterable[tuple[str, Iterable[Any]]]
    ) -> None:
        """Run ``(sql, params)`` statements as ONE transaction: one commit
        and, in memory mode, one hold of the shared connection's lock, so
        a multi-statement write (a fleet push) pays neither a commit nor a
        lock round per statement. A failing statement rolls the whole
        batch back."""
        statements = [(sql, tuple(params)) for sql, params in statements]
        if not statements:
            return
        if self._memory_conn is not None:
            with self._memory_lock:
                self._run_batch(statements)
            return
        self._run_batch(statements)

    def _run_batch(self, statements: list[tuple[str, tuple]]) -> None:
        conn = self.conn
        try:
            for sql, params in statements:
                conn.execute(sql, params)
        except BaseException:
            conn.rollback()
            raise
        conn.commit()

    def close(self) -> None:
        if self._memory_conn is not None:
            self._memory_conn.close()
            self._memory_conn = None
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None


class WalDatabase(Database):
    """Shared-file WAL backend: N server replica PROCESSES over one store.

    The base class already opens every connection in WAL mode with a 5 s
    busy handler; what changes here is the failure contract. A single
    replica can treat SQLITE_BUSY as a bug (nothing else holds the file);
    with N replicas it is a normal collision on the single WAL writer
    slot, so every statement retries with exponential backoff before
    giving up. Statements that pass through here are safe to re-issue:
    the model layer's guarded updates (`Model.compare_and_swap`) carry
    their own `WHERE` state guards, and a retried INSERT only runs again
    when the first attempt's transaction rolled back.
    """

    KIND = "sqlite+wal"
    SHARED = True
    BUSY_RETRIES = 6

    def __init__(self, uri: str):
        super().__init__(uri)
        if self.path == ":memory:":
            raise ValueError(
                "sqlite+wal needs a file path shared between replicas; "
                ":memory: is per-process by construction"
            )

    def _retry(self, fn):
        delay = 0.005
        for attempt in range(self.BUSY_RETRIES):
            try:
                return fn()
            except sqlite3.OperationalError as e:
                msg = str(e).lower()
                if "locked" not in msg and "busy" not in msg:
                    raise
                try:  # drop any half-open transaction before re-issuing
                    self.conn.rollback()
                except sqlite3.Error:  # pragma: no cover - teardown race
                    pass
                if attempt == self.BUSY_RETRIES - 1:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 0.25)

    def execute(self, sql: str, params: Iterable[Any] = ()) -> sqlite3.Cursor:
        params = tuple(params)  # a generator must survive the re-issue
        return self._retry(lambda: Database.execute(self, sql, params))

    def query(self, sql: str, params: Iterable[Any] = ()) -> list[sqlite3.Row]:
        params = tuple(params)
        return self._retry(lambda: Database.query(self, sql, params))

    def execute_batch(
        self, statements: Iterable[tuple[str, Iterable[Any]]]
    ) -> None:
        # a busy collision rolls the batch back, so the retry re-issues
        # all of it
        statements = [(sql, tuple(params)) for sql, params in statements]
        self._retry(lambda: Database.execute_batch(self, statements))


# scheme -> backend class; `open_backend` dispatches on the URI scheme so a
# Postgres driver later is one registry entry, not an app-layer rewrite
BACKENDS: dict[str, type[Database]] = {
    Database.KIND: Database,
    WalDatabase.KIND: WalDatabase,
}


def open_backend(uri: str) -> Database:
    """Open the storage backend the URI scheme names (default: sqlite)."""
    scheme = uri.split(":///", 1)[0] if ":///" in uri else "sqlite"
    cls = BACKENDS.get(scheme)
    if cls is None:
        raise ValueError(
            f"unknown storage backend {scheme!r} "
            f"(registered: {sorted(BACKENDS)})"
        )
    return cls(uri)


class Model:
    """Declarative row: subclasses set TABLE and COLUMNS.

    COLUMNS maps field name -> type key in `_TYPES`; `"<name>_id"` columns
    ending in `_id` get an index. `id` (PK) and `created_at` are implicit.
    """

    TABLE: ClassVar[str] = ""
    COLUMNS: ClassVar[dict[str, str]] = {}

    # Bound per model *hierarchy*: `Model.db = ...` serves the server models;
    # a service with its own DB (algorithm store) subclasses Model with its
    # own `db = None` class attribute and binds that instead.
    db: ClassVar[Database | None] = None

    def __init__(self, **kw: Any):
        self.id: int | None = kw.pop("id", None)
        self.created_at: float = kw.pop("created_at", None) or time.time()
        for col in self.COLUMNS:
            setattr(self, col, kw.pop(col, None))
        if kw:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(kw)}")

    # ------------------------------------------------------------------ class
    @classmethod
    def _db(cls) -> Database:
        db = cls.db  # class-attribute lookup: nearest hierarchy binding wins
        if db is None:
            raise RuntimeError("no database bound — call db.init(uri) first")
        return db

    @classmethod
    def _sql_columns(cls) -> frozenset[str]:
        """Column names that may appear in generated SQL (where/order).

        Derived from PRAGMA table_info on first use (covers legacy columns
        an old database may carry beyond COLUMNS) and cached per class.
        Defense-in-depth for the f-string SQL assembly in list/first/count:
        a bad kwarg fails HERE with a clear TypeError naming the field,
        before any SQL string is built.
        """
        cached = cls.__dict__.get("_SQL_COLUMNS")
        if cached is None:
            have = {
                r["name"]
                for r in cls._db().query(f"PRAGMA table_info({cls.TABLE})")
            }
            cached = frozenset(have | set(cls.COLUMNS) | {"id", "created_at"})
            cls._SQL_COLUMNS = cached  # per-class, not inherited
        return cached

    @classmethod
    def _check_columns(cls, names: Iterable[str], what: str) -> None:
        unknown = [n for n in names if n not in cls._sql_columns()]
        if unknown:
            raise TypeError(
                f"{cls.__name__}: unknown {what} column(s) {sorted(unknown)} "
                f"(known: {sorted(cls._sql_columns())})"
            )

    @classmethod
    def ensure_schema(cls) -> None:
        if "_SQL_COLUMNS" in cls.__dict__:
            delattr(cls, "_SQL_COLUMNS")  # re-derive after DDL
        cols = ", ".join(
            f'"{name}" {_TYPES[t]}' for name, t in cls.COLUMNS.items()
        )
        cls._db().execute(
            f"CREATE TABLE IF NOT EXISTS {cls.TABLE} "
            f"(id INTEGER PRIMARY KEY AUTOINCREMENT, created_at REAL"
            + (", " + cols if cols else "")
            + ")"
        )
        # additive migration: add any columns that an older schema lacks
        have = {
            r["name"]
            for r in cls._db().query(f"PRAGMA table_info({cls.TABLE})")
        }
        for name, t in cls.COLUMNS.items():
            if name not in have:
                cls._db().execute(
                    f'ALTER TABLE {cls.TABLE} ADD COLUMN "{name}" {_TYPES[t]}'
                )
        for name in cls.COLUMNS:
            if name.endswith("_id"):
                cls._db().execute(
                    f"CREATE INDEX IF NOT EXISTS idx_{cls.TABLE}_{name} "
                    f'ON {cls.TABLE}("{name}")'
                )

    # ------------------------------------------------------------- marshal
    @classmethod
    def _encode_value(cls, col: str, v: Any) -> Any:
        t = cls.COLUMNS.get(col)
        if v is None:
            return None
        if t == "json":
            return json.dumps(v)
        if t == "bool" or isinstance(v, bool):
            return int(v)
        return v

    def _encode(self, col: str) -> Any:
        return self._encode_value(col, getattr(self, col))

    @classmethod
    def _from_row(cls: type[T], row: sqlite3.Row) -> T:
        kw: dict[str, Any] = {"id": row["id"], "created_at": row["created_at"]}
        for col, t in cls.COLUMNS.items():
            v = row[col]
            if v is not None and t == "json":
                v = json.loads(v)
            elif v is not None and t == "bool":
                v = bool(v)
            kw[col] = v
        return cls(**kw)

    # ----------------------------------------------------------------- CRUD
    def save(self: T) -> T:
        cols = list(self.COLUMNS)
        vals = [self._encode(c) for c in cols]
        if self.id is None:
            placeholders = ", ".join("?" for _ in range(len(cols) + 1))
            cur = self._db().execute(
                f"INSERT INTO {self.TABLE} (created_at"
                + (", " + ", ".join(f'"{c}"' for c in cols) if cols else "")
                + f") VALUES ({placeholders})",
                [self.created_at, *vals],
            )
            self.id = cur.lastrowid
        else:
            sets = ", ".join(f'"{c}" = ?' for c in cols)
            self._db().execute(
                f"UPDATE {self.TABLE} SET {sets} WHERE id = ?",
                [*vals, self.id],
            )
        return self

    def delete(self) -> None:
        if self.id is not None:
            self._db().execute(
                f"DELETE FROM {self.TABLE} WHERE id = ?", [self.id]
            )

    @classmethod
    def get(cls: type[T], id_: int) -> T | None:
        rows = cls._db().query(
            f"SELECT * FROM {cls.TABLE} WHERE id = ?", [id_]
        )
        return cls._from_row(rows[0]) if rows else None

    @classmethod
    def list(
        cls: type[T],
        order: str = "id",
        limit: int | None = None,
        offset: int = 0,
        **where: Any,
    ) -> list[T]:
        cls._check_columns(where, "where")
        order_col, _, order_dir = order.partition(" ")
        cls._check_columns([order_col], "order")
        if order_dir and order_dir.lower() not in ("asc", "desc"):
            raise TypeError(f"{cls.__name__}: bad order direction {order!r}")
        sql = f"SELECT * FROM {cls.TABLE}"
        params: list[Any] = []
        if where:
            conds = []
            for k, v in where.items():
                if v is None:
                    conds.append(f'"{k}" IS NULL')
                else:
                    conds.append(f'"{k}" = ?')
                    params.append(int(v) if isinstance(v, bool) else v)
            sql += " WHERE " + " AND ".join(conds)
        sql += f" ORDER BY {order}"
        if limit is not None:
            sql += " LIMIT ? OFFSET ?"
            params += [limit, offset]
        return [cls._from_row(r) for r in cls._db().query(sql, params)]

    @classmethod
    def first(cls: type[T], **where: Any) -> T | None:
        rows = cls.list(limit=1, **where)
        return rows[0] if rows else None

    @classmethod
    def compare_and_swap(
        cls, id_: int, sets: dict[str, Any], expect: dict[str, Any]
    ) -> bool:
        """Atomic guarded update — the ONE primitive every cross-replica
        read-modify-write (run claim/activation, status transition, orphan
        reset) is built on: ``UPDATE ... SET <sets> WHERE id = ? AND
        <expect>`` in a single statement, so the state check and the write
        cannot interleave with another replica's. Returns True iff the row
        was in exactly the expected state and is now updated; False means
        the caller lost the race and must re-read before deciding."""
        if not sets:
            raise TypeError(f"{cls.__name__}.compare_and_swap: empty sets")
        cls._check_columns(sets, "set")
        cls._check_columns(expect, "where")
        set_sql = ", ".join(f'"{c}" = ?' for c in sets)
        params: list[Any] = [cls._encode_value(c, v) for c, v in sets.items()]
        conds = ["id = ?"]
        params.append(id_)
        for k, v in expect.items():
            if v is None:
                conds.append(f'"{k}" IS NULL')
            else:
                conds.append(f'"{k}" = ?')
                params.append(cls._encode_value(k, v))
        cur = cls._db().execute(
            f"UPDATE {cls.TABLE} SET {set_sql} WHERE " + " AND ".join(conds),
            params,
        )
        return cur.rowcount == 1

    @classmethod
    def count(cls, **where: Any) -> int:
        cls._check_columns(where, "where")
        sql = f"SELECT COUNT(*) AS n FROM {cls.TABLE}"
        params: list[Any] = []
        if where:
            conds = []
            for k, v in where.items():
                if v is None:
                    conds.append(f'"{k}" IS NULL')
                else:
                    conds.append(f'"{k}" = ?')
                    params.append(int(v) if isinstance(v, bool) else v)
            sql += " WHERE " + " AND ".join(conds)
        return int(cls._db().query(sql, params)[0]["n"])


class LinkTable:
    """Many-to-many link: two id columns, unique pairs."""

    def __init__(
        self, table: str, left: str, right: str, base: type[Model] = Model
    ):
        self.table, self.left, self.right = table, left, right
        self.base = base  # which model hierarchy's db binding to use

    def _db(self) -> Database:
        return self.base._db()

    def ensure_schema(self) -> None:
        self._db().execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} ("
            f"{self.left} INTEGER NOT NULL, {self.right} INTEGER NOT NULL, "
            f"UNIQUE({self.left}, {self.right}))"
        )

    def add(self, left_id: int, right_id: int) -> None:
        self._db().execute(
            f"INSERT OR IGNORE INTO {self.table} ({self.left}, {self.right}) "
            "VALUES (?, ?)",
            [left_id, right_id],
        )

    def remove(self, left_id: int, right_id: int) -> None:
        self._db().execute(
            f"DELETE FROM {self.table} WHERE {self.left} = ? AND {self.right} = ?",
            [left_id, right_id],
        )

    def rights_for(self, left_id: int) -> list[int]:
        return [
            r[self.right]
            for r in self._db().query(
                f"SELECT {self.right} FROM {self.table} WHERE {self.left} = ?",
                [left_id],
            )
        ]

    def lefts_for(self, right_id: int) -> list[int]:
        return [
            r[self.left]
            for r in self._db().query(
                f"SELECT {self.left} FROM {self.table} WHERE {self.right} = ?",
                [right_id],
            )
        ]

    def exists(self, left_id: int, right_id: int) -> bool:
        return bool(
            self._db().query(
                f"SELECT 1 FROM {self.table} WHERE {self.left} = ? AND {self.right} = ?",
                [left_id, right_id],
            )
        )
