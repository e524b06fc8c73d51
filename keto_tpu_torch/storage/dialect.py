"""SQL dialect layer: DSN routing and the SQLite rendering of the schema.

The schema is written once, as templates (storage/sqlite.py
MIGRATION_TEMPLATES); a `Dialect` renders the DDL and the few statements
that differ between SQL engines (insert-or-ignore, the version upsert,
the aliased delete, the table-exists probe, autoincrement, epoch
defaults, partial indexes).

This package stores tuples in SQLite only. `dialect_for_dsn` routes
`postgres://`, `cockroach://` and `mysql://` as the JAX package does, to
dialects that render nothing: their `connect` raises
`StoreDriverMissing`, naming the driver the DSN needs, as the JAX
package's does where that driver is not installed.
"""

from __future__ import annotations

import re
from typing import Sequence

__all__ = [
    "Dialect",
    "SQLiteDialect",
    "PostgresDialect",
    "CockroachDialect",
    "MySQLDialect",
    "DIALECTS",
    "dialect_for_dsn",
    "StoreDriverMissing",
    "BUSY_TIMEOUT_MS",
]


class StoreDriverMissing(RuntimeError):
    """A DSN named an engine whose Python driver is not installed."""


# {partial:WHERE ...}: a partial index's clause (the JAX package's MySQL
# rendering drops it; SQLite keeps it)
_PARTIAL_RE = re.compile(r"\{partial:([^{}]*)\}", re.S)


class Dialect:
    """Fragments and statement shapes of one SQL engine. The persister's
    statements are written in qmark style and `prep()`ed per driver."""

    name = "sqlite3"
    #: DB-API placeholder the driver expects ("?" qmark / "%s" format)
    placeholder = "?"
    #: template fragments (storage/sqlite.py MIGRATION_TEMPLATES)
    fragments = {
        "uuid_t": "TEXT",        # uuid-encoded columns (object, subject_id ...)
        "nid_t": "TEXT",         # network ids: arbitrary strings ("default")
        "ns_t": "TEXT",          # namespace names
        "rel_t": "TEXT",         # relation names
        "obj_t": "TEXT",         # legacy-table string objects
        "op_t": "TEXT",          # change-log op tags ('insert' / 'delete')
        "ver_t": "TEXT",         # migration version keys
        "text_t": "TEXT",        # unbounded strings (mapping values, log rows)
        "float_t": "REAL",
        "epoch_default": "DEFAULT (strftime('%s','now'))",
        "autoinc_pk": "INTEGER PRIMARY KEY AUTOINCREMENT",
    }

    # -- statement rendering ---------------------------------------------------

    def render(self, template: str) -> str:
        """Render one migration-template statement for this engine."""
        return _PARTIAL_RE.sub(lambda m: m.group(1), template).format(**self.fragments)

    #: a complete SQL string literal, including '' escapes ('it''s ok')
    _SQL_LITERAL_RE = re.compile(r"'(?:[^']|'')*'")

    def prep(self, sql: str) -> str:
        """Canonical qmark statement -> this driver's paramstyle. A '?'
        inside a single-quoted string literal is never rewritten (the
        regex consumes whole literals, '' escapes included); no statement
        of the persister has a '?' in a double-quoted identifier, a
        comment or a dollar-quoted string."""
        if self.placeholder == "?":
            return sql
        out = []
        last = 0
        for m in self._SQL_LITERAL_RE.finditer(sql):
            out.append(sql[last:m.start()].replace("?", self.placeholder))
            out.append(m.group(0))
            last = m.end()
        out.append(sql[last:].replace("?", self.placeholder))
        return "".join(out)

    def insert_ignore(self, table: str, cols: Sequence[str]) -> str:
        """Idempotent insert: duplicate-key rows are skipped."""
        ph = ", ".join("?" * len(cols))
        return (
            f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({ph})"
            " ON CONFLICT DO NOTHING"
        )

    def version_upsert(self, table: str = "keto_store_version") -> str:
        """Insert-or-increment of the per-nid write counter."""
        return (
            f"INSERT INTO {table} (nid, version) VALUES (?, 1)"
            " ON CONFLICT(nid) DO UPDATE SET version = version + 1"
        )

    def delete_aliased(self, table: str, alias: str, where: str) -> str:
        """DELETE with an alias usable inside `where` (the query builder
        qualifies every column with the alias)."""
        return f"DELETE FROM {table} AS {alias} WHERE {where}"

    def table_exists_sql(self) -> str:
        """One-param probe: does a table with this name exist?"""
        return (
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name = ?"
        )

    # -- connection ------------------------------------------------------------

    def connect(self, dsn: str):
        raise NotImplementedError

    def on_connect(self, conn) -> None:
        """Per-connection session setup (pragmas / session vars)."""

    def is_transient(self, err: Exception) -> bool:
        """Should the connect backoff retry this error? sqlite3 exposes
        no SQLSTATE: SQLITE_BUSY / LOCKED surface only in the message."""
        msg = str(err).lower()
        return "locked" in msg or "busy" in msg


# how long a statement that meets a sibling's lock retries inside the
# driver before SQLITE_BUSY surfaces (SQLiteDialect.on_connect)
BUSY_TIMEOUT_MS = 5000


class SQLiteDialect(Dialect):
    def insert_ignore(self, table: str, cols: Sequence[str]) -> str:
        # OR IGNORE also covers CHECK-constraint races and predates
        # sqlite's ON CONFLICT DO NOTHING
        ph = ", ".join("?" * len(cols))
        return f"INSERT OR IGNORE INTO {table} ({', '.join(cols)}) VALUES ({ph})"

    def connect(self, dsn: str):
        import sqlite3

        path = ":memory:" if dsn in ("memory", ":memory:") else dsn
        conn = sqlite3.connect(path, check_same_thread=False)
        try:
            # a locked or corrupt file fails here, not at first use
            conn.execute("SELECT 1").fetchone()
        except Exception:
            conn.close()
            raise
        return conn

    def on_connect(self, conn) -> None:
        # the durability contract, set on every connection rather than
        # left to the driver's defaults:
        #   journal_mode=WAL  — a committed transaction is in the
        #     write-ahead log when COMMIT returns; a process killed
        #     mid-write leaves the log without the commit record (rolled
        #     back on open) or with it (replayed), never a torn page
        #   synchronous=FULL  — COMMIT fsyncs the WAL, so an acked write
        #     survives power loss too, not only the process's death
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=FULL")
        conn.execute("PRAGMA foreign_keys=ON")
        #   busy_timeout      — a statement that meets a sibling's lock
        #     retries in the driver before SQLITE_BUSY surfaces (as the
        #     typed StoreBusyError, storage/sqlite.py _PrepConn)
        conn.execute(f"PRAGMA busy_timeout={BUSY_TIMEOUT_MS}")


class _ServerDialect(Dialect):
    """A server engine that DSNs route to and that this package does not
    render: `connect` names the driver the DSN needs."""

    placeholder = "%s"
    driver = ""

    def connect(self, dsn: str):
        try:
            __import__(self.driver)
        except ImportError as e:
            raise StoreDriverMissing(
                f"DSN {dsn!r} needs the {self.driver!r} driver, which is not"
                " installed in this environment; use a sqlite:// or"
                " memory DSN, or install the driver"
            ) from e
        raise ValueError(
            f"DSN {dsn!r}: keto_tpu_torch stores tuples in SQLite only; "
            "use a sqlite:// or memory DSN")


class PostgresDialect(_ServerDialect):
    name = "postgres"
    driver = "psycopg2"


class CockroachDialect(PostgresDialect):
    name = "cockroach"

    def connect(self, dsn: str):
        # cockroach:// is a routing scheme, not a wire scheme
        return super().connect(
            re.sub(r"^cockroach(db)?://", "postgres://", dsn)
        )


class MySQLDialect(_ServerDialect):
    name = "mysql"
    driver = "pymysql"


DIALECTS: dict[str, Dialect] = {
    "sqlite": SQLiteDialect(),
    "postgres": PostgresDialect(),
    "postgresql": PostgresDialect(),
    "cockroach": CockroachDialect(),
    "cockroachdb": CockroachDialect(),
    "mysql": MySQLDialect(),
}


def dialect_for_dsn(dsn: str) -> tuple[Dialect, str]:
    """DSN -> (dialect, driver-facing dsn): sqlite:// strips to a path,
    memory and :memory: route to in-process sqlite, server engines keep
    the full URL. Strict: any other bare string is refused as a probable
    typo ('Memory', 'colummnar') rather than opened as a fresh sqlite
    file; a file database is spelled sqlite://<path>."""
    if dsn in ("memory", ":memory:"):
        return DIALECTS["sqlite"], ":memory:"
    scheme, sep, rest = dsn.partition("://")
    if not sep:
        raise ValueError(f"unsupported DSN: {dsn!r}")
    d = DIALECTS.get(scheme)
    if d is None:
        raise ValueError(f"unsupported DSN scheme: {dsn!r}")
    if isinstance(d, SQLiteDialect):
        return d, rest
    return d, dsn
