"""The durable store: SQLite, with a changelog, behind the Manager verbs.

Keto's final SQL schema (internal/persistence/sql/migrations/sql/
20220513200300000000_create-intermediary-uuid-table.*):
  - keto_relation_tuples_uuid: primary key (shard_id, nid), UUID-encoded
    object / subject_id / subject_set_object columns (dictionary encoding
    through keto_uuid_mappings), string namespace and relation columns, a
    CHECK of subject exclusivity, the forward index on (nid, namespace,
    object, relation) and the partial reverse subject indexes;
  - keto_uuid_mappings(id, nid, string_representation): deterministic
    UUIDv5 ids (mapping.py), written with INSERT OR IGNORE;
plus a per-nid write counter (keto_store_version), a bounded per-nid
changelog (keto_change_log) that feeds the engine's delta overlay and the
Watch hub, and a migration box (versioned up / down / status) in place of
Keto's popx, with the same version names and data migrations as the JAX
package's store, so that either package opens a file the other wrote.

The persister speaks the public string Manager protocol; the UUID
encoding is internal, with JOINs against the mapping table on reads.
`all_tuple_columns` hands the rows to the engine's columnar builders as
TupleColumns. The schema is written once, as templates
(`MIGRATION_TEMPLATES`), rendered by a dialect (storage/dialect.py);
this package renders SQLite only.

Fault points (faults.py): `store_read` in `get_relation_tuples`,
`store_commit_pre` inside a write transaction before COMMIT,
`store_commit_post` after it, `changelog_append` between the tuple
writes and the changelog insert.
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Iterable, Sequence

import numpy as np

from .. import faults as _faults
from ..errors import NotFoundError, StoreBusyError
from ..ketoapi import RelationQuery, RelationTuple, SubjectSet
from .definitions import (
    DEFAULT_NETWORK,
    DEFAULT_PAGE_SIZE,
    WriteHookMixin,
    shard_id,
    validate_page_token,
)
from .columns import TupleColumns
from .dialect import Dialect, SQLiteDialect, dialect_for_dsn
from .mapping import map_string_to_uuid

# each migration is (version, up_steps, down_steps); every step is
# IDEMPOTENT (IF [NOT] EXISTS / idempotent inserts) so a run interrupted
# mid-version converges on retry; a step is either a
# SQL *template* (rendered per dialect — storage/dialect.py) or the
# registered name of a Python data migration — Keto's
# popx.WithGoMigrations data migrations
# (internal/persistence/sql/migrations/uuidmapping/uuid_mapping_migrator.go)
MIGRATION_TEMPLATES: list[tuple[str, list, list]] = [
    (
        "20210623162417_create_legacy_relation_tuples",
        [
            # Keto's FIRST schema (string object, numeric
            # namespace id; 20210623162417000000_relationtuple.*.up.sql)
            # — kept so pre-UUID databases can data-migrate forward
            """
            CREATE TABLE IF NOT EXISTS keto_relation_tuples (
                shard_id {uuid_t} NOT NULL,
                nid {nid_t} NOT NULL,
                namespace_id INTEGER NOT NULL,
                object {obj_t} NOT NULL,
                relation {rel_t} NOT NULL,
                subject_id {obj_t} NULL,
                subject_set_namespace_id INTEGER NULL,
                subject_set_object {obj_t} NULL,
                subject_set_relation {rel_t} NULL,
                commit_time {float_t} NOT NULL {epoch_default},
                PRIMARY KEY (shard_id, nid),
                CONSTRAINT chk_keto_rt_subject_type CHECK
                    ((subject_id IS NULL AND subject_set_namespace_id IS NOT NULL
                      AND subject_set_object IS NOT NULL
                      AND subject_set_relation IS NOT NULL)
                     OR
                     (subject_id IS NOT NULL AND subject_set_namespace_id IS NULL
                      AND subject_set_object IS NULL
                      AND subject_set_relation IS NULL))
            )
            """
        ],
        ["DROP TABLE IF EXISTS keto_relation_tuples"],
    ),
    (
        "20220513200300_create_uuid_mappings",
        [
            # Keto table has no nid column (uuid_mapping.go); we
            # add one so reverse lookups are tenant-scoped like the
            # in-memory UUIDMappingManager — UUIDv5 already embeds the nid,
            # so the composite key costs nothing and prevents cross-tenant
            # string disclosure.
            """
            CREATE TABLE IF NOT EXISTS keto_uuid_mappings (
                id {uuid_t} NOT NULL,
                nid {nid_t} NOT NULL,
                string_representation {text_t} NOT NULL,
                PRIMARY KEY (id, nid)
            )
            """
        ],
        ["DROP TABLE IF EXISTS keto_uuid_mappings"],
    ),
    (
        "20220513200302_create_store_version",
        [
            """
            CREATE TABLE IF NOT EXISTS keto_store_version (
                nid {nid_t} PRIMARY KEY,
                version INTEGER NOT NULL DEFAULT 0
            )
            """
        ],
        ["DROP TABLE IF EXISTS keto_store_version"],
    ),
    (
        "20220513200303_create_change_log",
        [
            # bounded per-nid write log consumed by the engine's delta
            # overlay (incremental device-mirror refresh) and the Watch
            # hub; Keto has none: its replicas re-read SQL on every query
            """
            CREATE TABLE IF NOT EXISTS keto_change_log (
                seq {autoinc_pk},
                nid {nid_t} NOT NULL,
                version INTEGER NOT NULL,
                op {op_t} NOT NULL,
                tuple {text_t} NOT NULL
            )
            """,
            """
            CREATE INDEX IF NOT EXISTS keto_change_log_nid_version_idx
                ON keto_change_log (nid, version)
            """,
        ],
        ["DROP TABLE IF EXISTS keto_change_log"],
    ),
    (
        "20220513200301_create_relation_tuples_uuid",
        [
            """
            CREATE TABLE IF NOT EXISTS keto_relation_tuples_uuid (
                shard_id {uuid_t} NOT NULL,
                nid {nid_t} NOT NULL,
                namespace {ns_t} NOT NULL,
                object {uuid_t} NOT NULL,
                relation {rel_t} NOT NULL,
                subject_id {uuid_t} NULL,
                subject_set_namespace {ns_t} NULL,
                subject_set_object {uuid_t} NULL,
                subject_set_relation {rel_t} NULL,
                commit_time {float_t} NOT NULL {epoch_default},
                PRIMARY KEY (shard_id, nid),
                CHECK (
                    (subject_id IS NOT NULL AND subject_set_namespace IS NULL
                        AND subject_set_object IS NULL AND subject_set_relation IS NULL)
                    OR
                    (subject_id IS NULL AND subject_set_namespace IS NOT NULL
                        AND subject_set_object IS NOT NULL AND subject_set_relation IS NOT NULL)
                )
            )
            """,
            """
            CREATE INDEX IF NOT EXISTS keto_relation_tuples_uuid_full_idx
                ON keto_relation_tuples_uuid (nid, namespace, object, relation)
            """,
            """
            CREATE INDEX IF NOT EXISTS keto_relation_tuples_uuid_reverse_subject_ids_idx
                ON keto_relation_tuples_uuid (nid, subject_id, relation, namespace)
                {partial:WHERE subject_id IS NOT NULL}
            """,
            """
            CREATE INDEX IF NOT EXISTS keto_relation_tuples_uuid_reverse_subject_sets_idx
                ON keto_relation_tuples_uuid
                   (nid, subject_set_namespace, subject_set_object, subject_set_relation)
                {partial:WHERE subject_set_namespace IS NOT NULL}
            """,
        ],
        ["DROP TABLE IF EXISTS keto_relation_tuples_uuid"],
    ),
    (
        # popx.WithGoMigrations analog: code, not SQL (uuid_mapping_migrator
        # .go:150-330) — batches legacy string rows into the UUID-encoded
        # table, writing the string->UUID mappings as it goes
        "20220513200400_migrate_strings_to_uuids",
        ["__migrate_strings_to_uuids__"],
        [],
    ),
    (
        # Keto drops the legacy table once its rows are moved
        # (20220513200600000000_drop-old-non-uuid-table.up.sql); down
        # restores the empty legacy schema like Keto's .down.sql
        "20220513200600_drop_legacy_relation_tuples",
        ["DROP TABLE IF EXISTS keto_relation_tuples"],
        ["__recreate_legacy_relation_tuples__"],
    ),
    (
        # the pre-watch changelog trim cut by seq and could split the
        # oldest surviving commit's op group; changelog_since now proves
        # completeness back to min_version - 1 on the invariant that
        # version groups are intact (the version-aligned _trim). This
        # one-time data migration re-establishes the invariant for
        # databases trimmed by the old code.
        "20220513200700_align_change_log_trim",
        ["__align_change_log__"],
        [],
    ),
]


def render_migrations(dialect: Dialect) -> list[tuple[str, list, list]]:
    """The migration box rendered for one SQL engine, in place of Keto's
    hand-written per-dialect migration files (internal/persistence/sql/
    migrations/sql/). Data-migration markers (``__…__``) pass through
    unrendered."""
    def r(steps: list) -> list:
        return [
            s if s.startswith("__") else dialect.render(s) for s in steps
        ]

    return [(v, r(ups), r(downs)) for v, ups, downs in MIGRATION_TEMPLATES]


# the sqlite rendering, which the migration box runs
MIGRATIONS: list[tuple[str, list, list]] = render_migrations(SQLiteDialect())


def _migrate_strings_to_uuids(persister) -> None:
    """Data migration: legacy keto_relation_tuples (string object, numeric
    namespace_id) -> keto_relation_tuples_uuid + keto_uuid_mappings.

    Keto's migrator's shape (keyset batches of 100 ordered
    by shard id, batched mapping writes, then batched inserts,
    uuid_mapping_migrator.go:150-330). Namespace ids resolve through
    `persister.legacy_namespaces` (the config namespaces' deprecated
    numeric ids); unknown ids fail the migration loudly, like Keto's
    namespaceIDtoName error."""
    conn = persister._conn
    if not persister._table_exists("keto_relation_tuples"):
        return  # post-drop database: nothing left to migrate
    names = persister.legacy_namespaces or {}
    # composite keyset cursor: the legacy PK is (shard_id, nid), so two
    # networks may share a shard_id — paginating on shard_id alone would
    # silently skip same-shard rows of the next nid at batch boundaries
    last_sid, last_nid = "", ""
    while True:
        rows = conn.execute(
            """SELECT shard_id, nid, namespace_id, object, relation,
                      subject_id, subject_set_namespace_id,
                      subject_set_object, subject_set_relation
                 FROM keto_relation_tuples
                WHERE shard_id > ? OR (shard_id = ? AND nid > ?)
                ORDER BY shard_id, nid LIMIT 100""",
            (last_sid, last_sid, last_nid),
        ).fetchall()
        if not rows:
            break
        last_sid, last_nid = rows[-1][0], rows[-1][1]
        inserts = []
        for (_sid, nid, ns_id, obj, rel, sub_id, ss_ns_id, ss_obj, ss_rel) in rows:
            if ns_id not in names:
                raise NotFoundError(
                    f"cannot migrate: unknown legacy namespace id {ns_id}"
                )
            ns = names[ns_id]
            if sub_id is not None:
                t = RelationTuple(
                    namespace=ns, object=obj, relation=rel, subject_id=sub_id
                )
            else:
                if ss_ns_id not in names:
                    raise NotFoundError(
                        f"cannot migrate: unknown legacy namespace id {ss_ns_id}"
                    )
                t = RelationTuple(
                    namespace=ns, object=obj, relation=rel,
                    subject_set=SubjectSet(
                        namespace=names[ss_ns_id],
                        object=ss_obj,
                        relation=ss_rel,
                    ),
                )
            inserts.append((nid, t))
        # write through the normal (idempotent) insert path: mappings,
        # deterministic shard ids, store-version bump, and change log all
        # behave exactly like ordinary writes (the lock is re-entrant)
        by_nid: dict[str, list[RelationTuple]] = {}
        for nid, t in inserts:
            by_nid.setdefault(nid, []).append(t)
        for nid, ts in by_nid.items():
            persister.write_relation_tuples(ts, nid=nid)


def _recreate_legacy_relation_tuples(persister) -> None:
    """Down-path of the drop: restore the empty legacy schema (the
    Keto's drop-old-non-uuid-table.down.sql recreates the table)."""
    ups = next(
        u for v, u, _ in persister._migrations
        if v == "20210623162417_create_legacy_relation_tuples"
    )
    for stmt in ups:
        persister._conn.execute(stmt)


def _align_change_log(persister) -> None:
    """Drop the oldest version group of any changelog that may ever have
    been trimmed (count at/over the cap — a log that never filled was
    never trimmed). The old seq-based trim could leave that group
    partial; version-aligned completeness (changelog_since) relies on
    every surviving group being whole."""
    conn = persister._conn
    if not persister._table_exists("keto_change_log"):
        return
    rows = conn.execute(
        "SELECT nid, COUNT(*), MIN(version) FROM keto_change_log GROUP BY nid"
    ).fetchall()
    for nid, count, min_version in rows:
        if min_version is not None and count >= persister.CHANGE_LOG_CAP:
            conn.execute(
                "DELETE FROM keto_change_log WHERE nid = ? AND version = ?",
                (nid, min_version),
            )


_DATA_MIGRATIONS = {
    "__migrate_strings_to_uuids__": _migrate_strings_to_uuids,
    "__recreate_legacy_relation_tuples__": _recreate_legacy_relation_tuples,
    "__align_change_log__": _align_change_log,
}

_SELECT = """
SELECT t.namespace, mo.string_representation, t.relation,
       ms.string_representation, t.subject_set_namespace,
       mss.string_representation, t.subject_set_relation, t.shard_id
  FROM keto_relation_tuples_uuid t
  JOIN keto_uuid_mappings mo ON mo.id = t.object AND mo.nid = t.nid
  LEFT JOIN keto_uuid_mappings ms ON ms.id = t.subject_id AND ms.nid = t.nid
  LEFT JOIN keto_uuid_mappings mss ON mss.id = t.subject_set_object AND mss.nid = t.nid
"""


class _PrepConn:
    """Thin DB-API connection shim: converts the persister's canonical
    qmark statements to the driver's paramstyle on the way through
    (identity for sqlite), runs everything through an explicit cursor,
    maps busy errors to the typed StoreBusyError, and is a transaction
    context manager that always commits or rolls back."""

    __slots__ = ("raw", "_d")

    def __init__(self, raw, dialect: Dialect):
        self.raw = raw
        self._d = dialect

    def _classified(self, err: Exception) -> Exception:
        """SQLITE_BUSY / "database is locked" (Dialect.is_transient)
        becomes the typed, retryable StoreBusyError, 503 / UNAVAILABLE on
        the wire, the code ReadClient's RetryPolicy backs off on, in
        place of an opaque 500. busy_timeout (dialect.py) already retried
        in the driver: what still surfaces is sustained contention."""
        if self._d.is_transient(err):
            return StoreBusyError(
                debug=f"{type(err).__name__}: {err}"
            )
        return err

    def execute(self, sql: str, params: Sequence = ()):
        cur = self.raw.cursor()
        try:
            cur.execute(self._d.prep(sql), params)
        except Exception as e:
            raise self._classified(e) from e
        return cur

    def executemany(self, sql: str, rows: Sequence):
        cur = self.raw.cursor()
        try:
            cur.executemany(self._d.prep(sql), rows)
        except Exception as e:
            raise self._classified(e) from e
        return cur

    def commit(self) -> None:
        self.raw.commit()

    def close(self) -> None:
        self.raw.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.raw.commit()
        else:
            self.raw.rollback()
        return False


class SQLPersister(WriteHookMixin):
    """The durable persister.

    dsn: 'memory' / ':memory:' or sqlite://<path>, routed by the strict
    dialect_for_dsn (storage/dialect.py); a postgres:// | cockroach:// |
    mysql:// URL raises StoreDriverMissing at connect. Every statement
    below is canonical qmark SQL or a dialect hook; the schema comes from
    render_migrations(dialect)."""

    # connect backoff, as Keto's connector (internal/driver/
    # pop_connection.go:40-66: exponential retry, capped total wait): a
    # file briefly locked by a sibling process (a WAL checkpoint, a
    # backup) does not fail startup
    CONNECT_MAX_WAIT = 60.0
    CONNECT_BASE_DELAY = 0.1

    def __init__(
        self,
        dsn: str = "memory",
        auto_migrate: bool = True,
        legacy_namespaces: dict | None = None,
        dialect: Dialect | None = None,
    ):
        if dialect is None:
            dialect, dsn = dialect_for_dsn(dsn)
        self._d = dialect
        self._migrations = render_migrations(dialect)
        raw = self._connect_with_backoff(dsn)
        dialect.on_connect(raw)
        self._conn = _PrepConn(raw, dialect)
        self._lock = threading.RLock()
        # post-commit write hooks (WriteHookMixin) + changelog trim guard
        self._write_listeners: list = []
        self._trim_guard = None
        # numeric namespace-id -> name map for the strings-to-uuids data
        # migration (Keto resolves via namespace.Manager configs)
        self.legacy_namespaces = legacy_namespaces
        if auto_migrate:
            self.migrate_up()

    def _connect_with_backoff(self, dsn: str):
        import time as _time

        delay = self.CONNECT_BASE_DELAY
        deadline = _time.monotonic() + self.CONNECT_MAX_WAIT
        while True:
            try:
                return self._d.connect(dsn)
            except Exception as err:
                # only transient contention retries; a permanent error
                # (missing directory, permissions, absent driver) fails
                # startup now
                if not self._d.is_transient(err):
                    raise
                if _time.monotonic() + delay > deadline:
                    raise
                _time.sleep(delay)
                delay = min(delay * 2, 5.0)

    def _table_exists(self, name: str) -> bool:
        return (
            self._conn.execute(self._d.table_exists_sql(), (name,)).fetchone()
            is not None
        )

    # -- migration box (popx stand-in) ----------------------------------------

    def _ensure_migration_table(self) -> None:
        self._conn.execute(
            self._d.render(
                """CREATE TABLE IF NOT EXISTS keto_migrations (
                       version {ver_t} PRIMARY KEY,
                       applied_at {float_t} NOT NULL {epoch_default}
                   )"""
            )
        )

    def migration_status(self) -> list[tuple[str, str]]:
        """[(version, 'Applied'|'Pending')], the `keto migrate status` view."""
        with self._lock:
            self._ensure_migration_table()
            applied = {
                row[0]
                for row in self._conn.execute("SELECT version FROM keto_migrations")
            }
        return [
            (version, "Applied" if version in applied else "Pending")
            for version, _, _ in self._migrations
        ]

    def legacy_row_count(self, namespace_id: int | None = None) -> int:
        """Rows still in the pre-UUID keto_relation_tuples table
        (optionally for one deprecated numeric namespace id); 0 once the
        drop-legacy migration has run or on a fresh database."""
        with self._lock:
            if not self._table_exists("keto_relation_tuples"):
                return 0
            if namespace_id is None:
                (n,) = self._conn.execute(
                    "SELECT COUNT(*) FROM keto_relation_tuples"
                ).fetchone()
            else:
                (n,) = self._conn.execute(
                    "SELECT COUNT(*) FROM keto_relation_tuples"
                    " WHERE namespace_id = ?",
                    (namespace_id,),
                ).fetchone()
            return n

    def migrate_up(self) -> None:
        with self._lock:
            self._ensure_migration_table()
            applied = {
                row[0]
                for row in self._conn.execute("SELECT version FROM keto_migrations")
            }
            for version, ups, _ in self._migrations:
                if version in applied:
                    continue
                for stmt in ups:
                    runner = _DATA_MIGRATIONS.get(stmt)
                    if runner is not None:
                        runner(self)
                    else:
                        self._conn.execute(stmt)
                self._conn.execute(
                    "INSERT INTO keto_migrations (version) VALUES (?)", (version,)
                )
            self._conn.commit()

    def migrate_down(self, steps: int = 1) -> None:
        with self._lock:
            self._ensure_migration_table()
            applied = [
                row[0]
                for row in self._conn.execute(
                    "SELECT version FROM keto_migrations ORDER BY version"
                )
            ]
            by_version = {v: downs for v, _, downs in self._migrations}
            for version in reversed(applied[-steps:] if steps > 0 else []):
                for stmt in by_version.get(version, []):
                    runner = _DATA_MIGRATIONS.get(stmt)
                    if runner is not None:
                        runner(self)
                    else:
                        self._conn.execute(stmt)
                self._conn.execute(
                    "DELETE FROM keto_migrations WHERE version = ?", (version,)
                )
            self._conn.commit()

    # -- mapping helpers ------------------------------------------------------

    def _ensure_mappings(self, nid: str, strings: Iterable[str]) -> dict[str, str]:
        """Idempotently persist string→UUID mappings; returns str→uuid-str."""
        out: dict[str, str] = {}
        rows = []
        for s in set(strings):
            u = str(map_string_to_uuid(nid, s))
            out[s] = u
            rows.append((u, nid, s))
        self._conn.executemany(
            self._d.insert_ignore(
                "keto_uuid_mappings", ("id", "nid", "string_representation")
            ),
            rows,
        )
        return out

    # -- row (de)construction -------------------------------------------------

    @staticmethod
    def _row_to_tuple(row) -> RelationTuple:
        ns, obj, rel, sid, ssn, sso, ssr = row[:7]
        if sid is not None:
            return RelationTuple(ns, obj, rel, subject_id=sid)
        return RelationTuple(ns, obj, rel, subject_set=SubjectSet(ssn, sso, ssr))

    def _tuple_row(self, nid: str, t: RelationTuple, m: dict[str, str]):
        if t.subject_set is not None:
            s = t.subject_set
            return (
                shard_id(nid, t), nid, t.namespace, m[t.object], t.relation,
                None, s.namespace, m[s.object], s.relation,
            )
        return (
            shard_id(nid, t), nid, t.namespace, m[t.object], t.relation,
            m[t.subject_id or ""], None, None, None,
        )

    def _tuple_strings(self, t: RelationTuple) -> list[str]:
        out = [t.object]
        if t.subject_set is not None:
            out.append(t.subject_set.object)
        else:
            out.append(t.subject_id or "")
        return out

    # -- query building -------------------------------------------------------

    def _where(self, nid: str, query: RelationQuery):
        clauses = ["t.nid = ?"]
        params: list = [nid]
        if query.namespace is not None:
            clauses.append("t.namespace = ?")
            params.append(query.namespace)
        if query.object is not None:
            clauses.append("t.object = ?")
            params.append(str(map_string_to_uuid(nid, query.object)))
        if query.relation is not None:
            clauses.append("t.relation = ?")
            params.append(query.relation)
        # NULL-aware subject predicates hitting the partial reverse indexes
        # (ref: internal/persistence/sql/relationtuples.go:124-144)
        if query.subject_id is not None:
            clauses.append("t.subject_id IS NOT NULL AND t.subject_id = ?")
            params.append(str(map_string_to_uuid(nid, query.subject_id)))
        elif query.subject_set is not None:
            s = query.subject_set
            clauses.append(
                "t.subject_set_namespace IS NOT NULL"
                " AND t.subject_set_namespace = ?"
                " AND t.subject_set_object = ?"
                " AND t.subject_set_relation = ?"
            )
            params.extend(
                (s.namespace, str(map_string_to_uuid(nid, s.object)), s.relation)
            )
        return " AND ".join(clauses), params

    # -- Manager protocol -----------------------------------------------------

    def get_relation_tuples(
        self,
        query: RelationQuery,
        page_token: str = "",
        page_size: int = DEFAULT_PAGE_SIZE,
        nid: str = DEFAULT_NETWORK,
    ) -> tuple[list[RelationTuple], str]:
        _faults.inject("store_read")
        token = validate_page_token(page_token)
        if page_size <= 0:
            page_size = DEFAULT_PAGE_SIZE
        where, params = self._where(nid, query)
        sql = _SELECT + f" WHERE {where}"
        if token:
            sql += " AND t.shard_id > ?"
            params.append(token)
        # N+1 probe for the next-page indicator (relationtuples.go:203-244)
        sql += " ORDER BY t.shard_id LIMIT ?"
        params.append(page_size + 1)
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        next_token = ""
        if len(rows) > page_size:
            rows = rows[:page_size]
            next_token = rows[-1][7]
        return [self._row_to_tuple(r) for r in rows], next_token

    def relation_tuple_exists(
        self, t: RelationTuple, nid: str = DEFAULT_NETWORK
    ) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM keto_relation_tuples_uuid WHERE shard_id = ? AND nid = ?",
                (shard_id(nid, t), nid),
            ).fetchone()
        return row is not None

    def all_relation_tuples(self, nid: str = DEFAULT_NETWORK) -> list[RelationTuple]:
        with self._lock:
            rows = self._conn.execute(
                _SELECT + " WHERE t.nid = ? ORDER BY t.shard_id", (nid,)
            ).fetchall()
        return [self._row_to_tuple(r) for r in rows]

    def all_tuple_columns(self, nid: str = DEFAULT_NETWORK):
        """The store's rows as TupleColumns, in shard-id order, so that
        the engine builds its mirror with the columnar builders (no
        RelationTuple object between the file and the device). The same
        columns as a scan of `_SELECT` (its inner join on the object's
        mapping, left joins on the subjects'), read as two sequential
        table scans joined in memory: the indexed plan of that SELECT
        makes a random page read for each row and each mapping, and a
        file past the page cache then reads at the disk's seek rate."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT shard_id, namespace, object, relation, subject_id,"
                " subject_set_namespace, subject_set_object, subject_set_relation"
                " FROM keto_relation_tuples_uuid NOT INDEXED WHERE nid = ?", (nid,)
            ).fetchall()
            strings = dict(self._conn.execute(
                "SELECT id, string_representation FROM keto_uuid_mappings"
                " WHERE nid = ?", (nid,)
            ).fetchall())
        rows = sorted((r for r in rows if r[2] in strings), key=lambda r: r[0])
        n = len(rows)
        if n == 0:
            return TupleColumns.empty()
        _sid, ns, obj, rel, sub, sns, sobj, srel = zip(*rows)
        sub = [None if u is None else strings.get(u) for u in sub]
        is_set = np.array([s is None for s in sub], dtype=bool)
        return TupleColumns(
            ns=np.array(ns, dtype="U"),
            obj=np.array([strings[u] for u in obj], dtype="U"),
            rel=np.array(rel, dtype="U"),
            skind=is_set.astype(np.int8),
            sns=np.array([c if c is not None else "" for c in sns], dtype="U"),
            # plain subjects carry the subject id in sobj (columns.py)
            sobj=np.array(
                [
                    ((strings.get(sobj[i]) or "") if is_set[i] else sub[i])
                    for i in range(n)
                ],
                dtype="U",
            ),
            srel=np.array([c if c is not None else "" for c in srel], dtype="U"),
        )

    def version(self, nid: str = DEFAULT_NETWORK) -> int:
        """Durable per-nid write counter (device-mirror staleness signal);
        survives reopen, unaffected by other tenants' writes."""
        with self._lock:
            row = self._conn.execute(
                "SELECT version FROM keto_store_version WHERE nid = ?", (nid,)
            ).fetchone()
        return row[0] if row else 0

    def _bump_version(self, nid: str) -> None:
        self._conn.execute(self._d.version_upsert(), (nid,))

    def write_relation_tuples(
        self, tuples: Sequence[RelationTuple], nid: str = DEFAULT_NETWORK
    ) -> None:
        self.transact_relation_tuples(tuples, (), nid=nid)

    def delete_relation_tuples(
        self, tuples: Sequence[RelationTuple], nid: str = DEFAULT_NETWORK
    ) -> None:
        self.transact_relation_tuples((), tuples, nid=nid)

    def delete_all_relation_tuples(
        self, query: RelationQuery, nid: str = DEFAULT_NETWORK
    ) -> None:
        where, params = self._where(nid, query)
        # the WHERE clause (incl. its nid guard) applies directly to the
        # DELETE; "t" aliases the deleted table itself
        changed = False
        with self._lock, self._conn:
            doomed = [
                self._row_to_tuple(r)
                for r in self._conn.execute(
                    f"{_SELECT} WHERE {where}", params
                ).fetchall()
            ]
            cur = self._conn.execute(
                self._d.delete_aliased("keto_relation_tuples_uuid", "t", where),
                params,
            )
            if cur.rowcount:
                changed = True
                self._bump_version(nid)
                self._log_changes(nid, [("delete", t) for t in doomed])
            _faults.inject("store_commit_pre")  # see transact_relation_tuples
        _faults.inject("store_commit_post")
        self._notify_write(nid, changed)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
        nid: str = DEFAULT_NETWORK,
    ) -> None:
        with self._lock, self._conn:  # one transaction, like popx.Transaction
            strings: list[str] = []
            for t in insert:
                strings.extend(self._tuple_strings(t))
            m = self._ensure_mappings(nid, strings)
            # identify real inserts/deletes (idempotent ops don't log),
            # simulating SQL order: all inserts, then all deletes
            present = self._existing_shard_ids(
                nid, [shard_id(nid, t) for t in [*insert, *delete]]
            )
            ops = []
            for t in insert:
                sid = shard_id(nid, t)
                if sid not in present:
                    ops.append(("insert", t))
                    present.add(sid)
            for t in delete:
                sid = shard_id(nid, t)
                if sid in present:
                    ops.append(("delete", t))
                    present.discard(sid)
            self._conn.executemany(
                self._d.insert_ignore(
                    "keto_relation_tuples_uuid",
                    ("shard_id", "nid", "namespace", "object", "relation",
                     "subject_id", "subject_set_namespace",
                     "subject_set_object", "subject_set_relation"),
                ),
                [self._tuple_row(nid, t, m) for t in insert],
            )
            self._conn.executemany(
                "DELETE FROM keto_relation_tuples_uuid WHERE shard_id = ? AND nid = ?",
                [(shard_id(nid, t), nid) for t in delete],
            )
            # `ops` — computed above from the pre-probe under the same
            # lock + transaction — is exactly the set of rows this
            # transaction really changes, so it is the change signal.
            # (sqlite3's total_changes is connection-global, and an
            # executemany's rowcount is not a per-row signal.)
            if ops:
                self._bump_version(nid)
                self._log_changes(nid, ops)
            # crash point (faults.py): die inside the write transaction,
            # rows and changelog staged, before COMMIT: the whole commit
            # is lost (the client was never acked)
            _faults.inject("store_commit_pre")
        # crash point: die AFTER the commit, before the post-commit write
        # hooks — durable but unacked (the client's connection just died)
        _faults.inject("store_commit_post")
        self._notify_write(nid, bool(ops))

    # -- change log (delta-overlay + watch feed) ------------------------------

    CHANGE_LOG_CAP = 1 << 16
    # retention hard cap: an active watch cursor (see set_trim_guard) can
    # hold rows past CHANGE_LOG_CAP, but never past HARD_FACTOR times it —
    # a stuck subscriber must not grow the durable log without bound (it
    # gets a RESET once its history is finally trimmed)
    CHANGE_LOG_HARD_FACTOR = 4

    def _existing_shard_ids(self, nid: str, sids: Sequence[str]) -> set[str]:
        out: set[str] = set()
        for i in range(0, len(sids), 500):
            chunk = sids[i : i + 500]
            placeholders = ",".join("?" * len(chunk))
            rows = self._conn.execute(
                "SELECT shard_id FROM keto_relation_tuples_uuid"
                f" WHERE nid = ? AND shard_id IN ({placeholders})",
                [nid, *chunk],
            ).fetchall()
            out.update(r[0] for r in rows)
        return out

    def set_trim_guard(self, fn) -> None:
        """Retention policy hook: `fn(nid)` returns the lowest store
        version an active watch cursor may still resume from (or None
        for no constraint). Rows with version > that value survive the
        CHANGE_LOG_CAP trim — a resumable snaptoken held by an active
        cursor is never trimmed out from under it — up to the
        CHANGE_LOG_HARD_FACTOR bound."""
        self._trim_guard = fn

    def _log_changes(self, nid: str, ops: Sequence[tuple[str, RelationTuple]]) -> None:
        """Called inside the write transaction, after _bump_version."""
        if not ops:
            return
        version = self._conn.execute(
            "SELECT version FROM keto_store_version WHERE nid = ?", (nid,)
        ).fetchone()[0]
        # crash point (faults.py): die between the tuple writes and the
        # changelog append, still inside the transaction: the crash loses
        # both (a tuple without its changelog row would starve a resumed
        # watch cursor)
        _faults.inject("changelog_append")
        self._conn.executemany(
            "INSERT INTO keto_change_log (nid, version, op, tuple) VALUES (?, ?, ?, ?)",
            [(nid, version, op, json.dumps(t.to_dict())) for op, t in ops],
        )
        # bounded: prune the oldest rows beyond the cap (the cutoff
        # subquery in a derived table, the statement the JAX package's
        # store runs on every dialect)
        guard = None
        if self._trim_guard is not None:
            try:
                guard = self._trim_guard(nid)
            except Exception:  # a broken policy hook must not fail writes
                guard = None
        if guard is None:
            self._trim(nid, self.CHANGE_LOG_CAP)
        else:
            # retention-aware trim: below the soft cap only rows an
            # active cursor can no longer need (version <= guard) go;
            # the hard cap prunes unconditionally but is AMORTIZED —
            # its boundary subquery walks OFFSET 4*cap index entries,
            # too much for every write, and between passes the log can
            # only overshoot the hard cap by the amortization interval
            self._trim(nid, self.CHANGE_LOG_CAP, max_version=int(guard))
            hard_every = max(1, self.CHANGE_LOG_CAP // 16)
            if version % hard_every == 0:
                self._trim(
                    nid, self.CHANGE_LOG_CAP * self.CHANGE_LOG_HARD_FACTOR
                )

    def _trim(self, nid: str, cap: int, max_version: int | None = None) -> None:
        # VERSION-ALIGNED prune (strictly below the boundary row's
        # version): a commit's op group is never split, so the oldest
        # surviving version is always complete — that invariant is what
        # lets changelog_since prove completeness back to min_version - 1
        # (a resumable cursor pinned by the trim guard stays resumable)
        guard_clause = "" if max_version is None else " AND version <= ?"
        params: list = [nid]
        if max_version is not None:
            params.append(max_version)
        params.extend((nid, cap))
        self._conn.execute(
            "DELETE FROM keto_change_log WHERE nid = ?" + guard_clause +
            " AND version < ("
            "  SELECT cutoff FROM ("
            "    SELECT version AS cutoff FROM keto_change_log WHERE nid = ?"
            "    ORDER BY seq DESC LIMIT 1 OFFSET ?) AS boundary)",
            params,
        )

    def changes_since(self, version: int, nid: str = DEFAULT_NETWORK):
        """Ordered (op, tuple) ops after `version`, or None when the
        bounded log can't prove completeness back that far (see
        memory.MemoryManager.changes_since)."""
        triples = self.changelog_since(version, nid=nid)
        if triples is None:
            return None
        return [(op, t) for _v, op, t in triples]

    def changelog_since(self, version: int, nid: str = DEFAULT_NETWORK):
        """Versioned changelog slice: (version, op, tuple) triples after
        `version` in commit order, or None when the bounded log can't
        prove completeness back that far (the watch feed; see
        memory.MemoryManager.changelog_since)."""
        with self._lock:
            if version >= self.version(nid):
                return []
            (min_version,) = self._conn.execute(
                "SELECT MIN(version) FROM keto_change_log WHERE nid = ?",
                (nid,),
            ).fetchone()
            # completeness is proved from the oldest surviving version
            # alone: the version-aligned trim (_trim) and the alignment
            # migration never leave a split commit group, so the log
            # provably covers everything after min_version - 1 (a
            # never-trimmed log has min_version 1 and covers all
            # history). A row-count heuristic would be unsound — the
            # alignment migration can shrink a trimmed log below the
            # cap, which must not make it look untrimmed.
            if min_version is None:
                # rows exist for this nid's version counter but the log
                # is empty (wiped by the alignment migration): nothing
                # is reconstructable below the head
                return None
            if version < min_version - 1:
                return None
            rows = self._conn.execute(
                "SELECT version, op, tuple FROM keto_change_log"
                # version first, then seq inside one version: replay
                # follows commit order
                " WHERE nid = ? AND version > ? ORDER BY version, seq",
                (nid, version),
            ).fetchall()
        return [
            (v, op, RelationTuple.from_dict(json.loads(raw)))
            for v, op, raw in rows
        ]

    # -- mapping manager protocol (durable) -----------------------------------

    def map_strings_to_uuids(
        self, strings: Sequence[str], nid: str = DEFAULT_NETWORK
    ) -> list[uuid.UUID]:
        with self._lock, self._conn:
            m = self._ensure_mappings(nid, strings)
        return [uuid.UUID(m[s]) for s in strings]

    def map_uuids_to_strings(
        self, uuids: Sequence[uuid.UUID], nid: str = DEFAULT_NETWORK
    ) -> list[str]:
        # one batched IN-query per 500 ids, as Keto's batched lookup
        # with its duplicate-index fixup (uuid_mapping.go:68-114)
        distinct = list({str(u) for u in uuids})
        found: dict[str, str] = {}
        with self._lock:
            for i in range(0, len(distinct), 500):  # stay under host-param cap
                chunk = distinct[i : i + 500]
                placeholders = ",".join("?" * len(chunk))
                rows = self._conn.execute(
                    "SELECT id, string_representation FROM keto_uuid_mappings"
                    f" WHERE nid = ? AND id IN ({placeholders})",
                    [nid, *chunk],
                ).fetchall()
                found.update(rows)
        out = []
        for u in uuids:
            try:
                out.append(found[str(u)])
            except KeyError:
                raise NotFoundError(f"no mapping for uuid {u}")
        return out

    def close(self) -> None:
        self._conn.close()


class SQLitePersister(SQLPersister):
    """SQLPersister bound to the sqlite dialect: dsn is a file path, or
    'memory' / ':memory:' for an in-process database, with no DSN
    routing."""

    def __init__(
        self,
        dsn: str = "memory",
        auto_migrate: bool = True,
        legacy_namespaces: dict | None = None,
    ):
        super().__init__(
            dsn,
            auto_migrate=auto_migrate,
            legacy_namespaces=legacy_namespaces,
            dialect=SQLiteDialect(),
        )
