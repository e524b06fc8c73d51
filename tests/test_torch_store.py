"""The port's durable store (keto_tpu_torch/storage/sqlite.py, dialect.py,
mapping.py) held against keto_tpu's on the CPU.

  (a) conformance: every case of tests/test_store.py's
      TestManagerConformance, TestIsolation, TestMapping, TestMapper,
      TestMigrations, TestRegressions, TestLegacyDataMigration (the golden
      upgrade), TestMigrationKeysetBoundary, TestChangelogParity,
      TestChangelogTrimCutoff and TestDurabilityPragmas, run through both
      packages on the same stores (memory, sqlite, columnar, as keto_tpu's
      suite runs them): keto_tpu's assertions hold on each, and what each
      case observes (rows, pages, tokens, versions, changelogs, errors)
      is equal between them, row for row;
  (b) the dialect layer: tests/test_dialect.py's TestRouting, the SQLite
      spellings of TestStatements, and TestPrepQuoteAwareness; the
      Registry on every DSN kind against keto_tpu's;
  (c) a file written by keto_tpu's SQLPersister read by the port's, and
      the reverse: tuples, pages, version, changelog_since(0) and
      migration_status() equal;
  (d) the engines over SQLite: TorchCheckEngine(device="cpu") over the
      port's persister against TPUCheckEngine over keto_tpu's, both
      layouts: every packed vector bit for bit, before a write, after one
      (the overlay, fed by the SQLite changelog) and after a compaction
      (the counterpart of tests/test_store.py's TestSQLiteColumnarSurface);
  (e) C5: a config with `tenancy.header` or `follower.enabled`, which
      keto_tpu serves (network B from network B; a follower that refuses
      a local write), is refused by the port's Registry at construction.

Tolerance: exact equality; every output is a name, a count or a verdict.
"""

import sqlite3
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import keto_tpu.errors as jerrors
import keto_tpu.storage.columnar as jcolumnar
import keto_tpu.storage.dialect as jdialect
import keto_tpu.storage.mapping as jmapping
import keto_tpu.storage.memory as jmemory
import keto_tpu.storage.sqlite as jsqlite
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.reference import ReferenceEngine as JReference
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationQuery as JQuery
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
from keto_tpu.registry import Registry as JRegistry
from keto_tpu.storage.columns import TupleColumns as JColumns

import keto_tpu_torch.errors as terrors
import keto_tpu_torch.storage.columnar as tcolumnar
import keto_tpu_torch.storage.dialect as tdialect
import keto_tpu_torch.storage.mapping as tmapping
import keto_tpu_torch.storage.memory as tmemory
import keto_tpu_torch.storage.sqlite as tsqlite
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.config import ConfigError
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationQuery as TQuery
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage.columns import TupleColumns as TColumns

from test_torch_columnar import (
    ColPair,
    assert_snapshots_equal,
    captured,
    check_queries,
    compacting_writes,
    legs,
    normalize,
    seeded_columns,
    small_writes,
    ENGINE_TUPLES,
    FIELDS,
    MAX_DEPTH,
    namespaces,
)
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

PKGS = {
    "jax": SimpleNamespace(
        errors=jerrors, memory=jmemory, columnar=jcolumnar, sqlite=jsqlite, dialect=jdialect,
        mapping=jmapping, Tuple=JTuple, Query=JQuery, SubjectSet=JSubjectSet,
        Columns=JColumns, Config=JConfig, Registry=JRegistry),
    "port": SimpleNamespace(
        errors=terrors, memory=tmemory, columnar=tcolumnar, sqlite=tsqlite, dialect=tdialect,
        mapping=tmapping, Tuple=TTuple, Query=TQuery, SubjectSet=TSubjectSet,
        Columns=TColumns, Config=TConfig, Registry=TRegistry),
}
STORES = ["memory", "sqlite", "columnar"]


def ts(P, *strs):
    return [P.Tuple.from_string(s) for s in strs]


def make_store(P, kind):
    if kind == "memory":
        return P.memory.MemoryManager()
    if kind == "columnar":
        return P.columnar.ColumnarStore()
    return P.sqlite.SQLitePersister("memory")


def both(case, *args):
    """Run `case(P, *args)` through each package; what it returns (its
    observations) must be equal."""
    got = {name: case(P, *args) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def on_stores(case, kind, *args):
    return both(lambda P: case(P, make_store(P, kind), *args))


def qmake(P, subject=None, **kw):
    """keto_tpu's RelationQuery.make, spelled for both packages."""
    if isinstance(subject, P.SubjectSet):
        return P.Query(subject_set=subject, **kw)
    return P.Query(subject_id=subject, **kw)


def strs(rows):
    return [str(t) for t in rows]


def triples(log):
    return None if log is None else [(v, op, str(t)) for v, op, t in log]


def raises(exc, fn, *args, **kw):
    """The raised exception's type name and status, for comparing."""
    with pytest.raises(exc) as e:
        fn(*args, **kw)
    return type(e.value).__name__, getattr(e.value, "status", None)


# -- (a) TestManagerConformance ------------------------------------------------------


def c_write_and_get(P, store):
    tuples = ts(P, "n:obj#rel@user1", "n:obj#rel@user2", "n:obj#rel2@(n:obj2#rel)",
                "n2:obj#rel@user1")
    store.write_relation_tuples(tuples)
    got, token = store.get_relation_tuples(P.Query())
    assert token == "" and set(got) == set(tuples)
    return strs(got), token


def c_query_shapes(P, store):
    store.write_relation_tuples(ts(P, "n:o#r@u1", "n:o#r@u2", "n:o#r2@u1", "n:o2#r@u1",
                                   "n:o#r@(x:y#z)", "m:o#r@u1"))
    cases = [
        (P.Query(namespace="n"), 5),
        (P.Query(namespace="n", object="o"), 4),
        (P.Query(namespace="n", object="o", relation="r"), 3),
        (qmake(P, namespace="n", object="o", relation="r", subject="u1"), 1),
        (qmake(P, subject="u1"), 4),
        (qmake(P, subject=P.SubjectSet("x", "y", "z")), 1),
        (P.Query(relation="r2"), 1),
        (P.Query(namespace="missing"), 0),
    ]
    out = []
    for q, want in cases:
        got, _ = store.get_relation_tuples(q)
        assert len(got) == want, f"query {q} -> {got}"
        out.append(strs(got))
    return out


def c_exists(P, store):
    t = ts(P, "n:o#r@u")[0]
    out = [store.relation_tuple_exists(t)]
    store.write_relation_tuples([t])
    out += [store.relation_tuple_exists(t), store.relation_tuple_exists(ts(P, "n:o#r@v")[0])]
    assert out == [False, True, False]
    return out


def c_idempotent_insert(P, store):
    t = ts(P, "n:o#r@u")[0]
    store.write_relation_tuples([t])
    store.write_relation_tuples([t])
    got, _ = store.get_relation_tuples(P.Query())
    assert len(got) == 1
    return strs(got), store.version()


def c_pagination(P, store):
    tuples = ts(P, *[f"n:o#r@user-{i}" for i in range(25)])
    store.write_relation_tuples(tuples)
    pages, seen, token = [], [], ""
    while True:
        got, token = store.get_relation_tuples(P.Query(namespace="n"), page_token=token,
                                               page_size=10)
        seen.extend(got)
        pages.append((strs(got), token))
        if not token:
            break
    assert len(pages) == 3 and len(seen) == 25 and set(seen) == set(tuples)
    got, token = store.get_relation_tuples(P.Query(namespace="n"), page_size=25)
    assert len(got) == 25 and token == ""
    return pages


def c_invalid_page_token(P, store):
    return raises(P.errors.InvalidPageTokenError, store.get_relation_tuples, P.Query(),
                  page_token="not-a-uuid")


def c_delete(P, store):
    tuples = ts(P, "n:o#r@u1", "n:o#r@u2", "n:o#r@u3")
    store.write_relation_tuples(tuples)
    store.delete_relation_tuples([tuples[0]])
    got, _ = store.get_relation_tuples(P.Query())
    assert set(got) == set(tuples[1:])
    store.delete_relation_tuples(ts(P, "nope:o#r@u"))  # a no-op
    return strs(got), store.version()


def c_delete_all_by_query(P, store):
    tuples = ts(P, "n:o#r@u1", "n:o#r@u2", "n:o2#r@u1", "n:o#r@(x:y#z)")
    store.write_relation_tuples(tuples)
    store.delete_all_relation_tuples(P.Query(namespace="n", object="o"))
    got, _ = store.get_relation_tuples(P.Query())
    assert got == [tuples[2]]
    return strs(got), store.version()


def c_delete_all_by_subject(P, store):
    tuples = ts(P, "n:o#r@u1", "n:o2#r@u1", "n:o#r@u2")
    store.write_relation_tuples(tuples)
    store.delete_all_relation_tuples(qmake(P, subject="u1"))
    got, _ = store.get_relation_tuples(P.Query())
    assert got == [tuples[2]]
    return strs(got)


def c_transact(P, store):
    a, b, c = ts(P, "n:o#r@a", "n:o#r@b", "n:o#r@c")
    store.write_relation_tuples([a, b])
    store.transact_relation_tuples(insert=[c], delete=[a])
    got, _ = store.get_relation_tuples(P.Query())
    assert set(got) == {b, c}
    return strs(got), triples(store.changelog_since(0))


def c_all_relation_tuples(P, store):
    tuples = ts(P, "n:o#r@u1", "m:o#r@(a:b#c)")
    store.write_relation_tuples(tuples)
    got = store.all_relation_tuples()
    assert set(got) == set(tuples)
    return strs(got)


CONFORMANCE = {f.__name__[2:]: f for f in (
    c_write_and_get, c_query_shapes, c_exists, c_idempotent_insert, c_pagination,
    c_invalid_page_token, c_delete, c_delete_all_by_query, c_delete_all_by_subject, c_transact,
    c_all_relation_tuples)}


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("case", sorted(CONFORMANCE))
def test_manager_conformance_equals_keto_tpu(case, kind):
    on_stores(CONFORMANCE[case], kind)


# -- TestIsolation, TestRegressions ----------------------------------------------------


def c_nid_isolation(P, store):
    t1, t2 = ts(P, "n:o#r@u1", "n:o#r@u2")
    store.write_relation_tuples([t1], nid="net-a")
    store.write_relation_tuples([t2], nid="net-b")
    got_a, _ = store.get_relation_tuples(P.Query(), nid="net-a")
    got_b, _ = store.get_relation_tuples(P.Query(), nid="net-b")
    assert got_a == [t1] and got_b == [t2]
    assert store.relation_tuple_exists(t1, nid="net-a")
    assert not store.relation_tuple_exists(t1, nid="net-b")
    store.delete_all_relation_tuples(P.Query(), nid="net-a")
    assert store.all_relation_tuples(nid="net-b") == [t2]
    return strs(store.all_relation_tuples(nid="net-a")), store.version(nid="net-a")


def c_shard_id_not_fooled(P, store):
    a = P.Tuple("n", "o", "r", subject_id="(a:b#c)")
    b = P.Tuple("n", "o", "r", subject_set=P.SubjectSet("a", "b", "c"))
    store.write_relation_tuples([a])
    out = [store.relation_tuple_exists(b)]
    store.write_relation_tuples([b])
    got, _ = store.get_relation_tuples(P.Query())
    store.delete_relation_tuples([a])
    out += [len(got), store.relation_tuple_exists(b)]
    assert out == [False, 2, True]
    return out, strs(got)


def c_separator_chars(P, store):
    store.write_relation_tuples([P.Tuple.make("n", "b#c", "r", "u"),
                                 P.Tuple.make("n", "b", "c#r", "u")])
    got, _ = store.get_relation_tuples(P.Query())
    assert len(got) == 2
    return strs(got)


def c_version_per_nid(P, store):
    v0 = store.version(nid="a")
    store.write_relation_tuples(ts(P, "n:o#r@u"), nid="a")
    assert store.version(nid="a") == v0 + 1 and store.version(nid="b") == 0
    return v0, store.version(nid="a")


STORE_CASES = {f.__name__[2:]: f for f in (
    c_nid_isolation, c_shard_id_not_fooled, c_separator_chars, c_version_per_nid)}


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_isolation_and_regressions_equal_keto_tpu(case, kind):
    on_stores(STORE_CASES[case], kind)


# -- TestMapping, TestMapper -------------------------------------------------------------


def make_mapping(P, kind):
    return P.mapping.UUIDMappingManager() if kind == "memory" else \
        P.sqlite.SQLitePersister("memory")


def m_deterministic(P, m):
    u1 = m.map_strings_to_uuids(["hello"])
    assert u1 == m.map_strings_to_uuids(["hello"])
    assert u1[0] == P.mapping.map_string_to_uuid("default", "hello")
    return [str(u) for u in u1]


def m_nid_scoped(P, m):
    a = m.map_strings_to_uuids(["x"], nid="a")[0]
    b = m.map_strings_to_uuids(["x"], nid="b")[0]
    assert a != b
    return str(a), str(b)


def m_round_trip_batch(P, m):
    strings = [f"s{i}" for i in range(10)] + ["s0"]
    uuids = m.map_strings_to_uuids(strings)
    assert uuids[0] == uuids[-1]
    assert m.map_uuids_to_strings(uuids) == strings
    return [str(u) for u in uuids]


def m_unknown_uuid(P, m):
    return raises(P.errors.NotFoundError, m.map_uuids_to_strings,
                  [uuid.UUID("00000000-0000-4000-8000-000000000001")])


def m_reverse_lookup_is_nid_scoped(P, m):
    u = m.map_strings_to_uuids(["secret-doc"], nid="tenant-a")
    return raises(P.errors.NotFoundError, m.map_uuids_to_strings, u, nid="tenant-b")


MAPPING_CASES = {f.__name__[2:]: f for f in (
    m_deterministic, m_nid_scoped, m_round_trip_batch, m_unknown_uuid,
    m_reverse_lookup_is_nid_scoped)}


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("case", sorted(MAPPING_CASES))
def test_mapping_equals_keto_tpu(case, kind):
    both(lambda P: MAPPING_CASES[case](P, make_mapping(P, kind)))


def test_mapper_round_trip_equals_keto_tpu():
    def case(P):
        mapper = P.mapping.Mapper(P.mapping.UUIDMappingManager())
        tuples = ts(P, "n:o#r@u", "n:o#r@(a:b#c)")
        internal = mapper.from_tuples(tuples)
        assert internal[0].subject_id is not None and internal[1].subject_set is not None
        assert mapper.to_tuples(internal) == tuples
        return [repr(i) for i in internal]

    both(case)


# -- TestMigrations, TestLegacyDataMigration, TestMigrationKeysetBoundary -------------------


def test_migration_status_and_down_equal_keto_tpu():
    def case(P):
        p = P.sqlite.SQLitePersister("memory", auto_migrate=False)
        out = [p.migration_status()]
        assert all(s == "Pending" for _, s in out[0])
        p.migrate_up()
        out.append(p.migration_status())
        assert all(s == "Applied" for _, s in out[1])
        p.migrate_down(6)
        status = dict(p.migration_status())
        out.append(sorted(status.items()))
        for v in ("20220513200700_align_change_log_trim",
                  "20220513200600_drop_legacy_relation_tuples",
                  "20220513200400_migrate_strings_to_uuids",
                  "20220513200302_create_store_version", "20220513200303_create_change_log",
                  "20220513200301_create_relation_tuples_uuid"):
            assert status[v] == "Pending", v
        assert status["20220513200300_create_uuid_mappings"] == "Applied"
        p.migrate_up()
        p.write_relation_tuples(ts(P, "n:o#r@u"))
        assert p.relation_tuple_exists(ts(P, "n:o#r@u")[0])
        return out

    both(case)


def test_migrations_render_the_same_sqlite_ddl():
    assert tsqlite.MIGRATIONS == jsqlite.MIGRATIONS
    assert tsqlite.MIGRATION_TEMPLATES == jsqlite.MIGRATION_TEMPLATES


def test_check_constraint_equals_keto_tpu():
    def case(P):
        p = P.sqlite.SQLitePersister("memory")
        return raises(sqlite3.IntegrityError, p._conn.execute,
                      "INSERT INTO keto_relation_tuples_uuid "
                      "(shard_id, nid, namespace, object, relation) "
                      "VALUES ('x', 'n', 'ns', 'obj', 'rel')")

    both(case)


GOLDEN = [
    ("00000000-0000-0000-0000-000000000001", "net1", 1, "/photos", "owner",
     "maureen", None, None, None),
    ("00000000-0000-0000-0000-000000000002", "net1", 1, "/photos/summer.jpg",
     "view", None, 1, "/photos", "owner"),
    ("00000000-0000-0000-0000-000000000003", "net2", 2, "report", "editor",
     "amy", None, None, None),
]


def legacy_persister(P, legacy_namespaces, rows):
    """A database at the legacy schema alone, holding `rows`."""
    p = P.sqlite.SQLitePersister("memory", auto_migrate=False,
                                 legacy_namespaces=legacy_namespaces)
    with p._lock:
        p._ensure_migration_table()
        version, ups, _ = P.sqlite.MIGRATIONS[0]
        for stmt in ups:
            p._conn.execute(stmt)
        p._conn.execute("INSERT INTO keto_migrations (version) VALUES (?)", (version,))
    for row in rows:
        p._conn.execute(
            """INSERT INTO keto_relation_tuples
               (shard_id, nid, namespace_id, object, relation, subject_id,
                subject_set_namespace_id, subject_set_object, subject_set_relation)
               VALUES (?,?,?,?,?,?,?,?,?)""", row)
    p._conn.commit()
    return p


def test_golden_upgrade_equals_keto_tpu():
    def case(P):
        p = legacy_persister(P, {1: "files", 2: "docs"}, GOLDEN)
        p.migrate_up()
        got1 = sorted(strs(p.all_relation_tuples(nid="net1")))
        assert got1 == ["files:/photos#owner@maureen",
                        "files:/photos/summer.jpg#view@(files:/photos#owner)"]
        got2 = strs(p.all_relation_tuples(nid="net2"))
        assert got2 == ["docs:report#editor@amy"]
        assert p.relation_tuple_exists(ts(P, "files:/photos#owner@maureen")[0], nid="net1")
        P.sqlite._migrate_strings_to_uuids(p)  # idempotent
        assert len(p.all_relation_tuples(nid="net1")) == 2
        return (got1, got2, p.version(nid="net1"), p.version(nid="net2"),
                triples(p.changelog_since(0, nid="net1")), p.legacy_row_count(),
                p.migration_status())

    both(case)


def test_unknown_legacy_namespace_id_fails_equal_to_keto_tpu():
    def case(P):
        p = legacy_persister(P, {}, GOLDEN)
        out = raises(P.errors.NotFoundError, p.migrate_up)
        return out, p.legacy_row_count(), p.legacy_row_count(namespace_id=2)

    both(case)


def test_migration_keyset_boundary_equals_keto_tpu():
    rows = [(f"00000000-0000-0000-0000-{i:012d}", nid, 1, f"o{i}", "r", f"u{i}", None, None,
             None) for i in range(120) for nid in ("net-a", "net-b")]

    def case(P):
        p = legacy_persister(P, {1: "n"}, rows)
        p.migrate_up()
        a, b = p.all_relation_tuples(nid="net-a"), p.all_relation_tuples(nid="net-b")
        assert len(a) == len(b) == 120
        return strs(a), strs(b)

    both(case)


# -- TestChangelogParity ---------------------------------------------------------------


def l_matches_changes_since(P, store):
    store.write_relation_tuples(ts(P, "a:1#r@u1", "a:2#r@u2"))
    store.delete_relation_tuples(ts(P, "a:1#r@u1"))
    log = store.changelog_since(0)
    versions = [v for v, _op, _t in log]
    assert versions == sorted(versions) and versions[-1] == store.version()
    assert store.changes_since(0) == [(op, t) for _v, op, t in log]
    alive: set = set()
    for _v, op, t in log:
        (alive.add if op == "insert" else alive.discard)(str(t))
    assert alive == {str(t) for t in store.all_relation_tuples()}
    return triples(log)


def l_midpoint_is_suffix(P, store):
    store.write_relation_tuples(ts(P, "a:1#r@u1"))
    mid = store.version()
    store.write_relation_tuples(ts(P, "a:2#r@u2"))
    store.delete_relation_tuples(ts(P, "a:1#r@u1"))
    full, tail = store.changelog_since(0), store.changelog_since(mid)
    assert tail == [t for t in full if t[0] > mid]
    assert store.changelog_since(store.version()) == []
    return triples(tail), mid


def l_nid_isolation(P, store):
    store.write_relation_tuples(ts(P, "a:1#r@u1"), nid="net-a")
    store.write_relation_tuples(ts(P, "a:2#r@u2"), nid="net-b")
    a, b = store.changelog_since(0, nid="net-a"), store.changelog_since(0, nid="net-b")
    assert [str(t) for _v, _op, t in a] == ["a:1#r@u1"]
    assert [str(t) for _v, _op, t in b] == ["a:2#r@u2"]
    assert store.changelog_since(0, nid="net-c") == []
    return triples(a), triples(b)


def l_write_listener(P, store):
    calls = []
    store.add_write_listener(calls.append)
    store.write_relation_tuples(ts(P, "a:1#r@u1"), nid="net-x")
    out = [list(calls)]
    store.write_relation_tuples(ts(P, "a:1#r@u1"), nid="net-x")  # idempotent: no commit
    out.append(list(calls))
    store.delete_relation_tuples(ts(P, "a:1#r@u1"), nid="net-x")
    out.append(list(calls))
    store.delete_relation_tuples(ts(P, "a:1#r@u1"), nid="net-x")
    out.append(list(calls))
    assert out[-1] == ["net-x", "net-x"]
    return out


CHANGELOG_CASES = {f.__name__[2:]: f for f in (
    l_matches_changes_since, l_midpoint_is_suffix, l_nid_isolation, l_write_listener)}


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("case", sorted(CHANGELOG_CASES))
def test_changelog_parity_equals_keto_tpu(case, kind):
    on_stores(CHANGELOG_CASES[case], kind)


# -- TestChangelogTrimCutoff --------------------------------------------------------------


def capped(P, cap):
    p = P.sqlite.SQLitePersister("memory")
    p.CHANGE_LOG_CAP = cap
    return p


def log_rows(p):
    return p._conn.execute("SELECT version, op, tuple FROM keto_change_log"
                           " ORDER BY version, seq").fetchall()


def t_reports_none_beyond_cutoff(P):
    p = capped(P, 8)
    for i in range(20):
        p.write_relation_tuples(ts(P, f"a:{i}#r@u"))
    assert p.changelog_since(0) is None and p.changes_since(0) is None
    log = p.changelog_since(15)
    assert [str(t) for _v, _op, t in log] == [f"a:{i}#r@u" for i in range(15, 20)]
    return triples(log), log_rows(p)


def t_never_splits_a_version_group(P):
    p = capped(P, 4)
    p.write_relation_tuples(ts(P, *[f"a:batch{i}#r@u" for i in range(6)]))
    for i in range(6):
        p.write_relation_tuples(ts(P, f"a:single{i}#r@u"))
    rows = p._conn.execute("SELECT version, COUNT(*) FROM keto_change_log"
                           " GROUP BY version ORDER BY version").fetchall()
    oldest_version, oldest_count = rows[0]
    assert oldest_count == (6 if oldest_version == 1 else 1)
    assert p.changelog_since(oldest_version - 1) is not None
    if oldest_version > 1:
        assert p.changelog_since(oldest_version - 2) is None
    return rows


def t_memory_log_cap_is_explicit_none(P):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P.memory, "CHANGE_LOG_CAP", 8)
        m = P.memory.MemoryManager()
        for i in range(20):
            m.write_relation_tuples(ts(P, f"a:{i}#r@u"))
    assert m.changelog_since(0) is None and len(m.changelog_since(15)) == 5
    return triples(m.changelog_since(15))


def t_columnar_bulk_load_resets_log_floor(P):
    s = P.columnar.ColumnarStore()
    s.write_relation_tuples(ts(P, "a:1#r@u1"))
    s.bulk_load(P.Columns.from_tuples(ts(P, "a:2#r@u2", "a:3#r@u3")))
    assert s.changelog_since(0) is None and s.changelog_since(s.version()) == []
    return s.version()


def t_align_migration_restores_group_invariant(P):
    p = capped(P, 4)
    p.write_relation_tuples(ts(P, *[f"a:b{i}#r@u" for i in range(3)]))
    for i in range(4):
        p.write_relation_tuples(ts(P, f"a:s{i}#r@u"))
    # the old seq-based trim, cutting through version 1's group
    p._conn.execute("DELETE FROM keto_change_log WHERE seq ="
                    " (SELECT MIN(seq) FROM keto_change_log)")
    P.sqlite._align_change_log(p)
    (min_version,) = p._conn.execute("SELECT MIN(version) FROM keto_change_log").fetchone()
    assert min_version == 2
    log = p.changelog_since(1)
    assert [str(t) for _v, _op, t in log] == [f"a:s{i}#r@u" for i in range(4)]
    return triples(log)


def t_wiped_log_below_head_is_explicit_none(P):
    p = capped(P, 8)
    for i in range(3):
        p.write_relation_tuples(ts(P, f"a:{i}#r@u"))
    p._conn.execute("DELETE FROM keto_change_log")
    assert p.changelog_since(0) is None and p.changelog_since(p.version()) == []
    return p.version()


def t_align_migration_leaves_unfilled_logs_alone(P):
    p = capped(P, 1024)
    p.write_relation_tuples(ts(P, "a:1#r@u"))
    P.sqlite._align_change_log(p)
    assert len(p.changelog_since(0)) == 1
    return triples(p.changelog_since(0))


TRIM_CASES = {f.__name__[2:]: f for f in (
    t_reports_none_beyond_cutoff, t_never_splits_a_version_group,
    t_memory_log_cap_is_explicit_none, t_columnar_bulk_load_resets_log_floor,
    t_align_migration_restores_group_invariant, t_wiped_log_below_head_is_explicit_none,
    t_align_migration_leaves_unfilled_logs_alone)}


@pytest.mark.parametrize("case", sorted(TRIM_CASES))
def test_changelog_trim_cutoff_equals_keto_tpu(case):
    both(TRIM_CASES[case])


# -- TestDurabilityPragmas ------------------------------------------------------------------


def pragmas(p):
    raw = p._conn.raw
    return [raw.execute(f"PRAGMA {k}").fetchone()[0]
            for k in ("journal_mode", "synchronous", "foreign_keys", "busy_timeout")]


def test_file_backed_pragmas_equal_keto_tpu(tmp_path):
    def case(P):
        p = P.sqlite.SQLitePersister(str(tmp_path / f"durable-{P.Tuple.__module__}.sqlite"))
        try:
            got = pragmas(p)
        finally:
            p.close()
        # WAL; synchronous 2 == FULL; busy_timeout BUSY_TIMEOUT_MS
        assert got == ["wal", 2, 1, P.dialect.BUSY_TIMEOUT_MS]
        return got

    both(case)


def test_busy_errors_map_to_typed_retryable_equal_keto_tpu(tmp_path):
    def case(P):
        path = str(tmp_path / f"busy-{P.Tuple.__module__}.sqlite")
        p = P.sqlite.SQLitePersister(path)
        try:
            p._conn.raw.execute("PRAGMA busy_timeout=50")
            blocker = sqlite3.connect(path)
            try:
                blocker.execute("BEGIN EXCLUSIVE")
                with pytest.raises(P.errors.StoreBusyError) as e:
                    p.write_relation_tuples(ts(P, "a:1#r@u"))
                assert isinstance(e.value, P.errors.StoreUnavailableError)
                out = [type(e.value).__name__, e.value.status, e.value.code, str(e.value)]
            finally:
                blocker.rollback()
                blocker.close()
            p.write_relation_tuples(ts(P, "a:1#r@u"))
            out.append(p.version())
            assert out[1:3] == [503, "store_unavailable"] and out[-1] == 1
            return out
        finally:
            p.close()

    both(case)


def test_memory_db_gets_same_session_setup_equal_keto_tpu():
    def case(P):
        p = P.sqlite.SQLitePersister("memory")
        try:
            got = pragmas(p)
        finally:
            p.close()
        assert got[:2] == ["memory", 2]
        return got

    both(case)


def test_acked_write_survives_reopen_equal_keto_tpu(tmp_path):
    def case(P):
        path = str(tmp_path / f"reopen-{P.Tuple.__module__}.sqlite")
        p = P.sqlite.SQLitePersister(path)
        p.write_relation_tuples(ts(P, "files:doc#owner@alice"))
        version = p.version()
        p.close()
        p2 = P.sqlite.SQLitePersister(path)
        try:
            assert p2.version() == version
            assert strs(p2.all_relation_tuples()) == ["files:doc#owner@alice"]
            return version, triples(p2.changelog_since(0))
        finally:
            p2.close()

    both(case)


# -- (b) the dialect layer ---------------------------------------------------------------


def test_routing_equals_keto_tpu():
    def case(P):
        D = P.dialect
        out = []
        for dsn in ("memory", ":memory:", "sqlite:///tmp/db.sqlite", "sqlite://:memory:"):
            d, got = D.dialect_for_dsn(dsn)
            assert isinstance(d, D.SQLiteDialect)
            out.append(got)
        for dsn in ("Memory", "colummnar", "/tmp/db.sqlite", "oracle://u@h/db", "sqlite:/db"):
            with pytest.raises(ValueError, match="unsupported DSN") as e:
                D.dialect_for_dsn(dsn)
            out.append(str(e.value))
        for scheme in ("postgres", "postgresql", "cockroach", "cockroachdb", "mysql"):
            dsn = f"{scheme}://u:p@h:1/db"
            d, got = D.dialect_for_dsn(dsn)
            assert got == dsn
            out.append((type(d).__name__, d.name, d.placeholder))
        return out

    both(case)


@pytest.mark.parametrize("dsn", ["postgres://u:p@localhost/keto", "cockroach://u@h/db",
                                 "mysql://u:p@localhost/keto"])
def test_missing_driver_is_named_as_keto_tpu_names_it(dsn):
    def case(P):
        with pytest.raises(P.dialect.StoreDriverMissing,
                           match="pymysql" if dsn.startswith("mysql") else "psycopg2") as e:
            P.sqlite.SQLPersister(dsn)
        return str(e.value)

    both(case)


def test_sqlite_statement_spellings_equal_keto_tpu():
    def case(P):
        d = P.dialect.SQLiteDialect()
        q = "SELECT 1 FROM t WHERE a = ? AND b = ?"
        assert d.prep(q) == q
        out = [d.insert_ignore("t", ("a", "b")), d.version_upsert(),
               d.delete_aliased("x", "t", "t.nid = ?"), d.table_exists_sql()]
        assert out[0].startswith("INSERT OR IGNORE INTO t")
        assert "ON CONFLICT(nid) DO UPDATE" in out[1]
        assert out[2] == "DELETE FROM x AS t WHERE t.nid = ?"
        assert "sqlite_master" in out[3]
        return out, d.render("CREATE INDEX i ON t (a) {partial:WHERE a IS NOT NULL}")

    both(case)


@pytest.mark.parametrize("sql,want", [
    ("SELECT 1 FROM t WHERE note = 'why?' AND name = ?",
     "SELECT 1 FROM t WHERE note = 'why?' AND name = %s"),
    ("SELECT 1 FROM t WHERE note = 'it''s ok?' AND name = ?",
     "SELECT 1 FROM t WHERE note = 'it''s ok?' AND name = %s"),
])
def test_prep_quote_awareness_equals_keto_tpu(sql, want):
    assert both(lambda P: P.dialect.PostgresDialect().prep(sql)) == want


@pytest.mark.parametrize("dsn", ["memory", "sqlite://:memory:", "sqlite://{tmp}/keto.sqlite"])
def test_registry_dsn_serves_as_keto_tpu_does(dsn, tmp_path):
    def case(P):
        cfg = P.Config({"dsn": dsn.format(tmp=tmp_path / P.Tuple.__module__),
                        "check": {"engine": "host"}, "namespaces": [{"name": "n"}]})
        if "{tmp}" in dsn:
            (tmp_path / P.Tuple.__module__).mkdir()
        reg = P.Registry(cfg, **({"device": "cpu"} if P is PKGS["port"] else {}))
        m = reg.relation_tuple_manager()
        m.write_relation_tuples(ts(P, "n:o#r@u", "n:o#r@(n:g#m)"))
        engine = reg.check_engine()
        got = [engine.check_relation_tuple(t).allowed for t in ts(P, "n:o#r@u", "n:o#r@v")]
        return strs(m.all_relation_tuples()), m.version(), got

    assert both(case)[2] == [True, False]


@pytest.mark.parametrize("dsn", ["Memory", "colummnar", "sqlite:/db", "postgres://u:p@h/keto",
                                 "mysql://u:p@h/keto"])
def test_registry_refuses_as_keto_tpu_does(dsn):
    def case(P):
        cfg = P.Config({"dsn": dsn, "namespaces": []},
                       **({} if P is PKGS["port"] else {"validate": False}))
        with pytest.raises((ValueError, P.dialect.StoreDriverMissing)) as e:
            P.Registry(cfg).relation_tuple_manager()
        return type(e.value).__name__, str(e.value)

    both(case)


# -- (c) files crossed between the packages -------------------------------------------------


def write_script(P, p):
    p.write_relation_tuples(ts(P, "files:a#owner@alice", "files:b#view@(files:a#owner)"))
    p.write_relation_tuples(ts(P, *[f"files:f{i}#owner@u{i % 3}" for i in range(25)]),
                            nid="net-b")
    p.transact_relation_tuples(ts(P, "files:c#owner@bob", "files:ü#owner@中文"),
                               ts(P, "files:a#owner@alice"))
    p.delete_all_relation_tuples(P.Query(namespace="files", object="b"))
    p.write_relation_tuples([P.Tuple("files", "d", "owner", subject_id=""),
                             P.Tuple("files", "a\x1fb", "owner", subject_id="x")])


def observe(P, p):
    out = {"migrations": p.migration_status()}
    for nid in ("default", "net-b"):
        pages, token = [], ""
        while True:
            rows, token = p.get_relation_tuples(P.Query(), page_token=token, page_size=7,
                                                nid=nid)
            pages.append((strs(rows), token))
            if not token:
                break
        out[nid] = (pages, p.version(nid=nid), triples(p.changelog_since(0, nid=nid)),
                    strs(p.all_relation_tuples(nid=nid)))
    cols = p.all_tuple_columns(nid="net-b")
    out["columns"] = [getattr(cols, f).tolist() for f in FIELDS]
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_crossed_between_packages(writer, tmp_path):
    path = str(tmp_path / "crossed.sqlite")
    W = PKGS[writer]
    p = W.sqlite.SQLitePersister(path)
    write_script(W, p)
    want = observe(W, p)
    p.close()
    reader = "port" if writer == "jax" else "jax"
    R = PKGS[reader]
    p = R.sqlite.SQLitePersister(path)
    try:
        assert observe(R, p) == want
        # and it writes on: the next version, logged, read back by the writer
        p.write_relation_tuples(ts(R, "files:e#owner@eve"))
        after = observe(R, p)
    finally:
        p.close()
    p = W.sqlite.SQLitePersister(path)
    try:
        assert observe(W, p) == after
        assert after["default"][1] == want["default"][1] + 1
    finally:
        p.close()
    # the same script through the other package alone writes the same file
    q = R.sqlite.SQLitePersister(str(tmp_path / "own.sqlite"))
    try:
        write_script(R, q)
        assert observe(R, q) == want
    finally:
        q.close()


# -- (d) the engines over SQLite -------------------------------------------------------------


class SQLitePair(ColPair):
    """keto_tpu's engine over its SQLitePersister and the port's over its
    own, both written from the same seeded columns in one transaction."""

    def __init__(self, fields, layout):
        cfg = {"limit": {"max_read_depth": MAX_DEPTH}}
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        self.jcfg.set_namespaces(namespaces())
        self.tcfg.set_namespaces(port_namespaces(namespaces()))
        jc, tc = JColumns(**fields), TColumns(**fields)
        self.js, self.tstore = jsqlite.SQLitePersister("memory"), tsqlite.SQLitePersister("memory")
        self.js.write_relation_tuples(list(jc.iter_tuples()))
        self.tstore.write_relation_tuples(list(tc.iter_tuples()))
        self.jax = TPUCheckEngine(self.js, self.jcfg)
        self.port = TorchCheckEngine(self.tstore, self.tcfg, device="cpu", layout=layout)
        self.oracle = TReference(self.tstore, self.tcfg)
        self.joracle = JReference(self.js, self.jcfg)

    def expand(self, subjects, depth=4):
        """Trees equal to keto_tpu's. Against the oracle: the device walks
        a node's children in identity-key order (the columnar builders),
        the oracle in the store's shard-id order, and where the depth
        limit meets the visited set the trees differ; the port's differ
        from its oracle on exactly the subjects where keto_tpu's differ
        from keto_tpu's oracle."""
        got = self.port.expand_batch([TSubjectSet.from_string(s) for s in subjects], depth)
        want = self.jax.expand_batch([JSubjectSet.from_string(s) for s in subjects], depth)
        off_t, off_j = [], []
        for s, g, w in zip(subjects, got, want):
            assert (g and g.to_dict()) == (w and w.to_dict()), s
            if normalize(g) != normalize(self.oracle.expand(TSubjectSet.from_string(s), depth)):
                off_t.append(s)
            if normalize(w) != normalize(self.joracle.expand(JSubjectSet.from_string(s), depth)):
                off_j.append(s)
        assert off_t == off_j


def test_engines_over_sqlite_equal_keto_tpu(layout, monkeypatch):
    """Check, Expand, the list legs and BatchFilter over SQLite mirrors
    (the columnar builders, fed by all_tuple_columns): packed vectors,
    answers and counts equal keto_tpu's on a clean mirror and after a
    small write (the overlay, from the SQLite changelog); Check's after a
    compaction; the snapshots array for array."""
    p = SQLitePair(seeded_columns(n=ENGINE_TUPLES), layout)
    cols_t, cols_j = p.tstore.all_tuple_columns(), p.js.all_tuple_columns()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cols_t, f), getattr(cols_j, f), err_msg=f)
    qs = check_queries()
    with captured(monkeypatch) as got:
        p.check(qs)
        legs(p)
    assert len(got["port"]) == 5
    assert isinstance(p.port._state.snapshot.obj_slots, tsnap.ArrayMap)
    assert_snapshots_equal(p.port._state.snapshot, p.jax._state.snapshot)
    p.same_counts()

    p.write(small_writes())
    p.delete(["videos:/d1/v2#parent@(videos:/d1#...)", "videos:/ünï#owner@中文"])
    with captured(monkeypatch):
        p.check(qs)
        legs(p)
    assert p.port._state.has_delta and p.port.stats["snapshot_builds"] == 1
    p.same_counts()

    p.write(compacting_writes())
    with captured(monkeypatch):
        p.check(qs + ["videos:/d3/w3#view@u1", "videos:/d4/v4#view@writer4"])
    assert p.port.stats["incremental_merges"] == p.jax.stats["incremental_merges"] == 1
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 1
    assert_snapshots_equal(p.port._state.snapshot, p.jax._state.snapshot)
    p.same_counts()


# -- (e) C5: the keys the port refuses -------------------------------------------------------


def test_tenancy_header_refused_where_keto_tpu_serves_network_b():
    cfg = {"dsn": "memory", "tenancy": {"header": "X-Keto-Network"},
           "check": {"engine": "host"}, "namespaces": [{"name": "n"}]}
    jreg = JRegistry(JConfig(cfg))
    m = jreg.relation_tuple_manager()
    m.write_relation_tuples([JTuple.from_string("n:o#r@u")], nid="net-b")
    nid = jreg.nid_for({"X-Keto-Network": "net-b"})
    assert nid == "net-b"
    assert jreg.check_engine(nid).check_relation_tuple(JTuple.from_string("n:o#r@u")).allowed
    assert not jreg.check_engine().check_relation_tuple(JTuple.from_string("n:o#r@u")).allowed
    with pytest.raises(ConfigError, match=r"tenancy\.header.*ketoctx\.py"):
        TRegistry(TConfig(cfg), device="cpu")


def test_follower_refused_where_keto_tpu_refuses_local_writes():
    from keto_tpu.api.follower import ReadOnlyFollowerError

    cfg = {"dsn": "memory", "follower": {"enabled": True}, "namespaces": [{"name": "n"}]}
    jreg = JRegistry(JConfig(cfg))
    with pytest.raises(ReadOnlyFollowerError):
        jreg.relation_tuple_manager().write_relation_tuples([JTuple.from_string("n:o#r@u")])
    with pytest.raises(ConfigError, match=r"follower\.enabled.*api/follower\.py"):
        TRegistry(TConfig(cfg), device="cpu")
