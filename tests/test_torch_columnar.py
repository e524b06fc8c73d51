"""The port's scale tier held against the JAX package's on the same seeded
numpy columns, on the CPU:

- store: ColumnarStore call for call against keto_tpu's: a bulk load
  with duplicates, writes, deletes, transactions, delete by query,
  pagination pages and tokens, changes_since and changelog_since across
  a second bulk load, the write listeners
- snapshot: build_snapshot_columnar (and columnar_encode's edges) array
  for array under both layouts, the vocabularies key for key; ArrayMap's
  get, in, items and merged_with
- engines: TorchCheckEngine(device="cpu") over a columnar store against
  TPUCheckEngine over keto_tpu's: the packed vectors of Check, Expand,
  ListObjects, ListSubjects, BatchFilter and the closure probe, bit for
  bit, before a write, after one (the overlay) and after a compaction
  over ArrayMaps (the merged snapshot array for array); every verdict,
  tree and list equal to keto_tpu's and the host oracle's
- the overlay matrix of tests/test_columnar.py (names of the base and of
  the overlay in one batch), the Registry's `dsn: columnar`, and the 1e7
  generators of keto_tpu_torch/tools/scale.py against tools/scale_bench.py

Names with non-ASCII characters, embedded "\\x1f" separators and empty
subject ids ride every part. Tolerance: exact equality; every output is
an integer, a name or a verdict.
"""

import contextlib
import importlib.util
import os
import random

import numpy as np
import pytest

import keto_tpu.engine.closure_kernel as jck
import keto_tpu.engine.compact as jcompact
import keto_tpu.engine.expand_kernel as jek
import keto_tpu.engine.filter_kernel as jfk
import keto_tpu.engine.kernel as jk
import keto_tpu.engine.reverse_kernel as jrk
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.errors import InvalidPageTokenError as JInvalidToken
from keto_tpu.ketoapi import RelationQuery as JQuery
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.namespace.ast import Relation
from keto_tpu.storage.columnar import ColumnarStore as JColumnar
from keto_tpu.storage.columns import TupleColumns as JColumns

import keto_tpu_torch.engine.compact as tcompact
import keto_tpu_torch.engine.torch_engine as tte
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.errors import InvalidPageTokenError as TInvalidToken
from keto_tpu_torch.ketoapi import RelationQuery as TQuery
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage import ColumnarStore as TColumnar
from keto_tpu_torch.storage.columns import TupleColumns as TColumns
from keto_tpu_torch.storage.columns import concat_columns
from keto_tpu_torch.tools.scale import synth_columns, synth_rbac_columns

from test_columnar import REWRITE_CASES, REWRITE_NAMESPACES, REWRITE_TUPLES, ts
from test_torch_closure import same_index
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)
from test_torch_write import COUNTS, SNAPSHOT_ARRAYS, SNAPSHOT_SCALARS
from test_torch_write import namespaces as write_namespaces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_DEPTH = 6
# the engines' stores: synth_columns at this size has N_FOLDERS folders
# of 80 files (the oracle's ListObjects checks every object, so small)
ENGINE_TUPLES = 600
N_FOLDERS = ENGINE_TUPLES // 81
FIELDS = ("ns", "obj", "rel", "skind", "sns", "sobj", "srel")
# names past ASCII, an embedded separator and an empty subject id
ODD_TUPLES = [
    ("videos", "/ünï/v0", "owner", 0, "", "ü ser", ""),
    ("videos", "/ünï/v1", "parent", 1, "videos", "/ünï", "..."),
    ("videos", "/ünï", "owner", 0, "", "中文", ""),
    ("videos", "/a\x1fb", "owner", 0, "", "x\x1fy", ""),
    ("videos", "/empty", "owner", 0, "", "", ""),
    ("groups", "gü", "member", 0, "", "ü ser", ""),
    ("videos", "/d1", "view", 1, "groups", "gü", "member"),
]


def namespaces():
    return write_namespaces() + [JNamespace(name="rbac", relations=[Relation(name="member")])]


def seeded_columns(seed: int = 3, n: int = 2400) -> dict:
    """The fields of one seeded column set: the scale generators at a
    small size, the odd names, and a slice of the rows again (duplicates
    inside one bulk load)."""
    cols, _f, _o, _fp = synth_columns(n, 24, seed=seed)
    odd = TColumns(*(np.array([t[i] for t in ODD_TUPLES],
                              dtype=np.int8 if f == "skind" else "U")
                     for i, f in enumerate(FIELDS)))
    cols = concat_columns([cols, synth_rbac_columns(20, 24, seed=seed), odd])
    dup = cols.take(np.random.default_rng(seed).integers(0, len(cols), 200))
    cols = concat_columns([cols, dup])
    return {f: getattr(cols, f) for f in FIELDS}


def both_columns(fields: dict):
    return (JColumns(**{k: v.copy() for k, v in fields.items()}),
            TColumns(**{k: v.copy() for k, v in fields.items()}))


def _page_all(store, query, size):
    pages, token = [], ""
    while True:
        rows, token = store.get_relation_tuples(query, page_token=token, page_size=size)
        pages.append(([str(t) for t in rows], token))
        if not token:
            return pages


def same_store(js, tstore, rng):
    """Every read of both stores equal."""
    top = tstore.version()
    assert top == js.version()
    # the floor's neighbourhood, the top's, and a sample between
    versions = set(range(-1, 4)) | set(range(top - 4, top + 2)) | \
        set(rng.sample(range(top + 1), min(top + 1, 24)))
    for v in sorted(versions):
        jt = js.changelog_since(v)
        tt = tstore.changelog_since(v)
        assert (tt is None) == (jt is None), v
        if tt is not None:
            assert [(a, op, str(t)) for a, op, t in tt] == [(a, op, str(t)) for a, op, t in jt]
            assert [(op, str(t)) for op, t in tstore.changes_since(v)] == \
                [(op, str(t)) for op, t in js.changes_since(v)]
    jc, tc = js.all_tuple_columns(), tstore.all_tuple_columns()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    assert [str(t) for t in tstore.all_relation_tuples()] == \
        [str(t) for t in js.all_relation_tuples()]
    # broad queries in a few pages, narrow ones in pages of 1 and 3 too
    for kw, sizes in (({}, (997, 100_000)), ({"namespace": "videos"}, (1500,)),
                      ({"namespace": "videos", "relation": "owner"}, (7, 100)),
                      ({"namespace": "videos", "object": "/ünï", "relation": "owner"}, (1, 3)),
                      # a prefix range holding another row: "/a" + "b\x1fowner" spells
                      # the identity prefix of ("/a\x1fb", "owner")
                      ({"namespace": "videos", "object": "/a", "relation": "b\x1fowner"}, (1,)),
                      ({"namespace": "videos", "object": "/a\x1fb", "relation": "owner"}, (1,)),
                      ({"subject_id": "ü ser"}, (1, 3)), ({"subject_id": ""}, (1, 3)),
                      ({"namespace": "rbac", "object": "role1"}, (1, 5)),
                      ({"namespace": "ghost"}, (1,))):
        for size in sizes:
            assert _page_all(tstore, TQuery(**kw), size) == _page_all(js, JQuery(**kw), size), \
                (kw, size)
    q = TQuery(subject_set=TSubjectSet("videos", "/d1", "..."))
    assert _page_all(tstore, q, 3) == _page_all(
        js, JQuery(subject_set=JSubjectSet("videos", "/d1", "...")), 3)
    for s in rng.sample([str(t) for t in js.all_relation_tuples()], 10) + \
            ["videos:/nope#owner@u1", "videos:/empty#owner@"]:
        assert tstore.relation_tuple_exists(TTuple.from_string(s)) == \
            js.relation_tuple_exists(JTuple.from_string(s)), s


@pytest.mark.parametrize("seed", [0, 1])
def test_store_call_for_call(seed):
    rng = random.Random(seed)
    js, tstore = JColumnar(), TColumnar()
    fired = {"j": [], "t": []}
    js.add_write_listener(fired["j"].append)
    tstore.add_write_listener(fired["t"].append)
    jc, tc = both_columns(seeded_columns(seed, n=800))
    js.bulk_load(jc)
    tstore.bulk_load(tc)
    same_store(js, tstore, rng)

    def each(fn, *tuple_lists):
        getattr(js, fn)(*([JTuple.from_string(s) for s in ss] for ss in tuple_lists))
        getattr(tstore, fn)(*([TTuple.from_string(s) for s in ss] for ss in tuple_lists))

    live = [str(t) for t in js.all_relation_tuples()]
    each("write_relation_tuples", ["videos:/n0#owner@w1", "videos:/n0#owner@w1",
                                   "groups:g1#member@(groups:gü#member)", live[3]])
    each("write_relation_tuples", [live[5]])  # idempotent: no version
    each("delete_relation_tuples", [live[0], live[1], "videos:/nope#owner@x"])
    each("delete_relation_tuples", ["videos:/n0#owner@w1"])  # from the buffer
    each("transact_relation_tuples", ["videos:/t#owner@(groups:g1#member)", live[0]],
         [live[7], "videos:/missing#owner@x"])
    js.delete_all_relation_tuples(JQuery(namespace="rbac", object="role3"))
    tstore.delete_all_relation_tuples(TQuery(namespace="rbac", object="role3"))
    same_store(js, tstore, rng)
    # a write past the buffer threshold folds the buffer into the columns
    many = [f"videos:/m{i}#owner@u{i % 9}" for i in range(4100)]
    each("write_relation_tuples", many)
    same_store(js, tstore, rng)
    # a second bulk load (overlapping the live rows, reviving deleted
    # ones) resets the log's floor: every earlier version answers None
    jc2, tc2 = both_columns(seeded_columns(seed + 7, n=400))
    js.bulk_load(jc2)
    tstore.bulk_load(tc2)
    assert tstore.changes_since(tstore.version() - 1) is None
    same_store(js, tstore, rng)
    each("write_relation_tuples", ["videos:/after#owner@bulk"])
    assert [op for op, _t in tstore.changes_since(tstore.version() - 1)] == ["insert"]
    same_store(js, tstore, rng)
    assert fired["t"] == fired["j"] and len(fired["t"]) == 9
    for bad in ("garbage", "ck1.!!!", "ck1.", "ck1." + "A" * 3):
        with pytest.raises(TInvalidToken):
            tstore.get_relation_tuples(TQuery(), page_token=bad)
        with pytest.raises(JInvalidToken):
            js.get_relation_tuples(JQuery(), page_token=bad)


def test_buffered_reads_call_for_call():
    """Reads while the write buffer holds tuples (no fold before them):
    a query naming its node reads the buffer's bucket of that node, any
    other the whole buffer; pages and tokens equal keto_tpu's."""
    js, tstore = JColumnar(), TColumnar()
    jc, tc = both_columns(seeded_columns(3, n=300))
    js.bulk_load(jc)
    tstore.bulk_load(tc)
    writes = [f"videos:/b{i % 7}#owner@u{i}" for i in range(40)] + \
        ["videos:/b1#owner@(groups:g1#member)", "videos:/ünï#owner@中文",
         "videos:/a#b\x1fowner@x", "videos:/a\x1fb#owner@y", "videos:/b2#view@u3"]
    js.write_relation_tuples([JTuple.from_string(s) for s in writes])
    tstore.write_relation_tuples([TTuple.from_string(s) for s in writes])
    gone = [writes[3], writes[10], writes[41]]
    js.delete_relation_tuples([JTuple.from_string(s) for s in gone])
    tstore.delete_relation_tuples([TTuple.from_string(s) for s in gone])
    assert all(net.buffer for net in tstore._networks.values())  # nothing folded
    for kw in ({}, {"namespace": "videos"}, {"namespace": "videos", "relation": "owner"},
               {"namespace": "videos", "object": "/b1", "relation": "owner"},
               {"namespace": "videos", "object": "/b3", "relation": "owner"},
               {"namespace": "videos", "object": "/b3", "relation": "owner", "subject_id": "u10"},
               {"namespace": "videos", "object": "/ünï", "relation": "owner"},
               {"namespace": "videos", "object": "/a", "relation": "b\x1fowner"},
               {"namespace": "videos", "object": "/a\x1fb", "relation": "owner"},
               {"namespace": "videos", "object": "/b2", "relation": "view"},
               {"subject_id": "u3"}):
        for size in (1, 3, 100):
            assert _page_all(tstore, TQuery(**kw), size) == _page_all(js, JQuery(**kw), size), \
                (kw, size)


def test_bulk_load_of_nothing_new_is_no_version():
    tstore = TColumnar()
    _, tc = both_columns(seeded_columns(4, n=200))
    tstore.bulk_load(tc)
    v = tstore.version()
    tstore.bulk_load(tc)
    tstore.bulk_load(TColumns.empty())
    assert tstore.version() == v
    assert TColumnar().all_tuple_columns().nbytes() == TColumns.empty().nbytes()


# -- the columnar snapshot ----------------------------------------------------------


def vocab_items(m):
    return dict(m.items())


def assert_snapshots_equal(ts_, js_):
    for k in SNAPSHOT_ARRAYS:
        np.testing.assert_array_equal(getattr(ts_, k), np.asarray(getattr(js_, k)), err_msg=k)
    for k in SNAPSHOT_SCALARS:
        assert getattr(ts_, k) == getattr(js_, k), k
    for k in ("ns_ids", "rel_ids", "obj_slots", "subj_ids"):
        tm, jm = getattr(ts_, k), getattr(js_, k)
        assert type(tm).__name__ == type(jm).__name__, k
        assert vocab_items(tm) == vocab_items(jm), k
        if isinstance(tm, tsnap.ArrayMap):
            np.testing.assert_array_equal(tm._keys, jm._keys, err_msg=k)
            assert (tm._values is None) == (jm._values is None), k
            if tm._values is not None:
                np.testing.assert_array_equal(tm._values, jm._values, err_msg=k)
    assert ts_.island_circuits == js_.island_circuits


@pytest.mark.parametrize("seed", [3, 5])
def test_snapshot_columnar_equals_keto_tpu(layout, seed):
    jc, tc = both_columns(seeded_columns(seed))
    nss = namespaces()
    js_ = jsnap.build_snapshot_columnar(jc, nss, K=8, version=4)
    ts_ = tsnap.build_snapshot_columnar(tc, port_namespaces(nss), layout=layout, K=8, version=4)
    assert ts_.layout == layout and ts_.version == 4
    assert_snapshots_equal(ts_, js_)
    _jsnap, jedges = jsnap.columnar_encode(jc, nss)
    _tsnap, tedges = tsnap.columnar_encode(tc, port_namespaces(nss), layout=layout)
    for t, j in zip(tedges, jedges):
        np.testing.assert_array_equal(t, j)
    # the rewrite fixtures of tests/test_columnar.py
    jc, tc = both_columns({f: getattr(JColumns.from_tuples(ts(*REWRITE_TUPLES)), f)
                           for f in FIELDS})
    assert_snapshots_equal(
        tsnap.build_snapshot_columnar(tc, port_namespaces(REWRITE_NAMESPACES), layout=layout),
        jsnap.build_snapshot_columnar(jc, REWRITE_NAMESPACES))


def test_empty_columns_build_an_empty_snapshot(layout):
    ts_ = tsnap.build_snapshot_columnar(TColumns.empty(), port_namespaces(namespaces()),
                                        layout=layout)
    js_ = jsnap.build_snapshot_columnar(JColumns.empty(), namespaces())
    assert_snapshots_equal(ts_, js_)
    assert len(ts_.obj_slots) == 0 and ts_.obj_slots.get((0, "x")) is None


@pytest.mark.parametrize("kind", ["S", "U"])
def test_array_map_equals_keto_tpu(kind):
    rng = np.random.default_rng(8)
    names = sorted({f"{int(rng.integers(0, 4))}\x1f/o{int(rng.integers(0, 500))}"
                    for _ in range(300)} | {"1\x1fünï", "2\x1fa\x1fb", "0\x1f"})
    keys = np.char.encode(np.array(names, "U"), "utf-8") if kind == "S" else \
        np.array(names, "U")
    keys = np.sort(keys)
    enc = dict(encode=tsnap._encode_obj_key, decode=tsnap._decode_obj_key)
    jenc = dict(encode=jsnap._encode_obj_key, decode=jsnap._decode_obj_key)
    tm, jm = tsnap.ArrayMap(keys, **enc), jsnap.ArrayMap(keys, **jenc)
    probes = [tsnap._decode_obj_key(n) for n in names] + \
        [(0, "/nope"), (9, "/o1"), (1, "ü" * 80), (0, "/o1" + "x" * 200), (2, "a")]
    for _ in range(2):
        assert len(tm) == len(jm)
        assert vocab_items(tm) == vocab_items(jm)
        for p in probes:
            assert tm.get(p) == jm.get(p) and (p in tm) == (p in jm), p
            assert tm.get(p, -7) == jm.get(p, -7)
        for i in range(len(tm)):
            assert tm.key_by_id(i) == jm.key_by_id(i)
        np.testing.assert_array_equal(tm.keys_by_id_array(), jm.keys_by_id_array())
        # ids stay put, new names go after them, keys sorted in between
        new = {(3, "/new"): len(tm), (0, "/o1" + "z" * 40): len(tm) + 1, (1, "ünï2"): len(tm) + 2}
        new = {k: v for k, v in new.items() if k not in tm}
        tm, jm = tm.merged_with(new), jm.merged_with(new)
        np.testing.assert_array_equal(tm._keys, jm._keys)
        np.testing.assert_array_equal(tm._values, jm._values)
        probes += list(new)
    assert tm.merged_with({}) is tm
    # the vectorised lookup, queries wider than every key included
    queries = np.array(names[::7] + ["1\x1fünï" + "x" * 90, "", "9\x1f/o1"], dtype="U")
    if kind == "S":
        queries = np.char.encode(queries, "utf-8")
    for vals in (None, np.arange(len(keys), dtype=np.int64)[::-1].copy()):
        np.testing.assert_array_equal(tsnap._sorted_lookup(keys, vals, queries),
                                      jsnap._sorted_lookup(keys, vals, queries))


# -- the engines over columnar stores -----------------------------------------------


PACKED = (("check_kernel_packed", jk), ("closure_kernel_packed", jck),
          ("expand_kernel_packed", jek), ("list_objects_kernel_packed", jrk),
          ("list_subjects_kernel_packed", jrk), ("filter_kernel_packed", jfk))


@contextlib.contextmanager
def captured(mp):
    """Every packed result vector both engines' launches return, by
    kernel entry point, in launch order."""
    got = {"port": {}, "jax": {}}
    for name, jmod in PACKED:
        for side, mod in (("port", tte), ("jax", jmod)):
            orig = getattr(mod, name)

            def wrapped(*a, _o=orig, _side=side, _name=name, **kw):
                out = _o(*a, **kw)
                got[_side].setdefault(_name, []).append(np.asarray(out).copy())
                return out

            mp.setattr(mod, name, wrapped)
    yield got
    for name, _ in PACKED:
        t, j = got["port"].get(name, []), got["jax"].get(name, [])
        assert len(t) == len(j), name
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b, err_msg=name)


class ColPair:
    """keto_tpu's engine over its ColumnarStore and the port's over its
    own, both bulk-loaded from the same numpy columns."""

    def __init__(self, fields, layout, closure=False, tnss=None, jnss=None):
        cfg = {"limit": {"max_read_depth": MAX_DEPTH}, "closure": {"enabled": closure}}
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        jnss = jnss or namespaces()
        self.jcfg.set_namespaces(jnss)
        self.tcfg.set_namespaces(tnss or port_namespaces(jnss))
        self.js, self.tstore = JColumnar(), TColumnar()
        jc, tc = both_columns(fields)
        self.js.bulk_load(jc)
        self.tstore.bulk_load(tc)
        self.jax = TPUCheckEngine(self.js, self.jcfg)
        self.port = TorchCheckEngine(self.tstore, self.tcfg, device="cpu", layout=layout)
        self.oracle = TReference(self.tstore, self.tcfg)

    def write(self, tuples):
        self.js.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tstore.write_relation_tuples([TTuple.from_string(s) for s in tuples])

    def delete(self, tuples):
        self.js.delete_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tstore.delete_relation_tuples([TTuple.from_string(s) for s in tuples])

    def check(self, qs):
        got = self.port.check_batch([TTuple.from_string(q) for q in qs])
        want = self.jax.check_batch([JTuple.from_string(q) for q in qs])
        for q, g, w in zip(qs, got, want):
            o = self.oracle.check_relation_tuple(TTuple.from_string(q))
            assert (g.error is None) == (w.error is None) == (o.error is None), q
            if g.error is None:
                assert g.membership.value == w.membership.value == o.membership.value, q
        return got

    def expand(self, subjects, depth=4):
        got = self.port.expand_batch([TSubjectSet.from_string(s) for s in subjects], depth)
        want = self.jax.expand_batch([JSubjectSet.from_string(s) for s in subjects], depth)
        for s, g, w in zip(subjects, got, want):
            o = self.oracle.expand(TSubjectSet.from_string(s), depth)
            # exactly keto_tpu's tree; the oracle's up to child order (a
            # compaction appends a row's new edges at its end, the oracle
            # reads the store's order)
            assert (g and g.to_dict()) == (w and w.to_dict()), s
            assert normalize(g) == normalize(o), s

    def lists(self, lo, ls):
        got = self.port.list_objects_batch(lo, MAX_DEPTH)
        assert got == self.jax.list_objects_batch(lo, MAX_DEPTH)
        for (n, r, s), g in zip(lo, got):
            assert g == self.oracle.list_objects(n, r, s, MAX_DEPTH), (n, r, s)
        got = self.port.list_subjects_batch(ls, MAX_DEPTH)
        assert got == self.jax.list_subjects_batch(ls, MAX_DEPTH)
        for (n, o, r), g in zip(ls, got):
            assert g == self.oracle.list_subjects(n, o, r, MAX_DEPTH), (n, o, r)

    def filter(self, subject, objects):
        got = self.port.filter_batch("videos", "view", subject, objects)
        assert got == self.jax.filter_batch("videos", "view", subject, objects)
        assert got == self.oracle.filter_objects("videos", "view", subject, objects)

    def same_counts(self):
        for key in COUNTS:
            want = self.jax.stats.get(key, {} if key == "host_cause" else 0)
            assert self.port.stats[key] == want, key
        assert self.port.stats["incremental_merges"] == \
            self.jax.stats.get("incremental_merges", 0)


def normalize(tree):
    """A tree's children as a sorted tuple, recursively."""
    if tree is None:
        return None
    return (tree.type.value, str(tree.tuple) if tree.tuple else None,
            tuple(sorted((normalize(c) for c in tree.children), key=repr)))


def check_queries(seed=1):
    rng = random.Random(seed)
    out = []
    for i in range(40):
        d = rng.randrange(N_FOLDERS)
        obj = f"/d{d}/v{rng.randrange(80)}" if i % 3 else f"/d{d}"
        out.append(f"videos:{obj}#view@u{rng.randrange(24)}")
    out += [f"rbac:role{r}#member@u{u}" for r, u in ((0, 3), (4, 11), (7, 19), (19, 2))]
    out += ["videos:/ünï/v0#view@ü ser", "videos:/ünï/v1#view@中文", "videos:/a\x1fb#view@x\x1fy",
            "videos:/d1/v3#view@ü ser", "groups:gü#member@ü ser", "videos:/nope#view@u1",
            "videos:/d2#view@nobody", "videos:/n0#view@w1", "videos:/d5/v1#view@w2"]
    return out


def legs(p):
    p.expand(["rbac:role0#member", "rbac:role5#member", "videos:/d1#view", "videos:/ünï/v1#parent",
              "videos:/d3/v7#parent", "groups:gü#member", "rbac:role99#member"])
    lo = [("videos", "view", u) for u in ("u1", "ü ser", "w1", "nobody")]
    ls = [("videos", o, "view") for o in ("/d1/v2", "/d4/v0", "/ünï/v1", "/a\x1fb", "/n0")]
    ls += [("rbac", "role2", "member")]
    p.lists(lo, ls)
    objects = [f"/d{d}/v{v}" for d in range(N_FOLDERS) for v in (0, 3, 79)]
    objects += ["/ünï/v0", "/n0", "/x"]
    for subject in ("u1", "w1"):
        p.filter(subject, objects)


def small_writes():
    return ["videos:/n0#owner@w1", "videos:/d5/v1#owner@w2", "videos:/n0/v0#parent@(videos:/n0#...)",
            "rbac:role0#member@wü", "videos:/ünï#owner@w1", "extra:x#rel@w1"]


def compacting_writes(n=2100):
    out = []
    for i in range(n):
        d = i % N_FOLDERS
        out.append(f"videos:/d{d}/w{i}#parent@(videos:/d{d}#...)" if i % 2
                   else f"videos:/d{d}/v{i % 80}#owner@writer{i % 13}")
    return out


def test_engines_over_columnar_stores_equal_keto_tpu(layout, monkeypatch):
    """Check, Expand, the list legs and BatchFilter on a clean columnar
    mirror, after a small write (the overlay) and after a compaction over
    ArrayMaps: packed vectors, answers and counts equal keto_tpu's, the
    merged snapshot array for array, and no full rebuild."""
    p = ColPair(seeded_columns(n=ENGINE_TUPLES), layout)
    qs = check_queries()
    with captured(monkeypatch) as got:
        p.check(qs)
        legs(p)
    assert len(got["port"]) == 5  # every leg but the closure launched
    state = p.port._state
    assert isinstance(state.snapshot.obj_slots, tsnap.ArrayMap)
    assert_snapshots_equal(state.snapshot, p.jax._state.snapshot)
    for k in state.expand_np:
        np.testing.assert_array_equal(state.expand_np[k], np.asarray(p.jax._state.expand_np[k]),
                                      err_msg=k)
    for k in state.reverse_np:
        np.testing.assert_array_equal(state.reverse_np[k],
                                      np.asarray(p.jax._state.reverse_np[k]), err_msg=k)
    assert p.port.stats["host_checks"] == p.jax.stats["host_checks"]
    p.same_counts()

    p.write(small_writes())
    p.delete(["videos:/d1/v2#parent@(videos:/d1#...)", "videos:/ünï#owner@中文"])
    with captured(monkeypatch):
        p.check(qs)
        legs(p)
    assert p.port._state.has_delta and p.port.stats["snapshot_builds"] == 1
    p.same_counts()

    base_t, base_j = p.port._state.snapshot, p.jax._state.snapshot
    p.write(compacting_writes())
    ops_t, ops_j = p.tstore.changes_since(1), p.js.changes_since(1)
    with captured(monkeypatch):
        p.check(qs + ["videos:/d3/w3#view@u1", "videos:/d4/v4#view@writer4"])
        legs(p)
    assert p.port.stats["incremental_merges"] == p.jax.stats["incremental_merges"] == 1
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 1
    merged = p.port._state.snapshot
    assert isinstance(merged.obj_slots, tsnap.ArrayMap) and merged.obj_slots._values is not None
    assert_snapshots_equal(merged, p.jax._state.snapshot)
    # the merge alone, on the same base and ops
    want, enc_j, ins_j = jcompact.merge_ops_into_snapshot(base_j, ops_j, 9, with_encoded=True)
    got_, enc_t, ins_t = tcompact.merge_ops_into_snapshot(base_t, ops_t, 9)
    assert_snapshots_equal(got_, want)
    np.testing.assert_array_equal(enc_t, enc_j)
    np.testing.assert_array_equal(ins_t, ins_j)
    p.same_counts()


def test_closure_over_array_maps_equals_keto_tpu(layout, monkeypatch):
    """The closure index extracted and powered over a columnar mirror:
    the index (same_index), C1's packed vectors and the verdicts equal
    keto_tpu's, before a write, with the written nodes dirty, after the
    refresh (slots decoded through the ArrayMap) and after a compaction."""
    p = ColPair(seeded_columns(6, n=ENGINE_TUPLES), layout, closure=True)
    qs = check_queries(2)
    engine = p.port

    def both():
        with captured(monkeypatch):
            p.check(qs)
        assert engine.stats["closure_hits"] == p.jax.stats.get("closure_hits", 0)
        assert engine.stats["closure_fallback"] == p.jax.stats.get("closure_fallback", {})
        same_index(engine.closure_index(), p.jax.closure_index())

    assert engine.closure_ensure_built() and p.jax.closure_ensure_built()
    both()
    assert engine.stats["closure_hits"] > 0
    p.write(["videos:/d1#owner@w9"])
    p.delete(["videos:/d2/v0#parent@(videos:/d2#...)"])
    both()
    assert engine.stats["closure_fallback"].get("dirty", 0) > 0
    assert engine.closure_ensure_built() and p.jax.closure_ensure_built()
    assert engine.closure_index().stats["refreshes"] >= 1
    both()
    p.write(compacting_writes())
    assert engine.closure_ensure_built() and p.jax.closure_ensure_built()
    assert engine.stats["incremental_merges"] == 1 and engine.stats["snapshot_builds"] == 1
    both()


@pytest.mark.parametrize("query", [
    "b:x#r@u1", "b:x#r@u2", "o:w#r@u9", "o:w#r@u1", "b:z#r@u1", "b:z#r@u2",
    "b:x#s@(o:w#r)", "o:w#s@(b:x#r)", "b:x#s@(b:y#r)", "b:x#s@(b:zzz#r)", "nope:q#r@u1",
])
def test_overlay_matrix_equals_keto_tpu(monkeypatch, query):
    """tests/test_columnar.py's TestVectorizedQueryEncoding matrix: names
    of the columnar base and of the overlay in one query encode as
    keto_tpu's vectorised encoder gives them."""
    nss = [JNamespace(name="b"), JNamespace(name="o")]
    fields = {f: getattr(JColumns.from_tuples(ts("b:x#r@u1", "b:y#r@u2", "b:x#s@(b:y#r)")), f)
              for f in FIELDS}
    p = ColPair(fields, "bucketized", jnss=nss)
    p.check(["b:x#r@u1"])
    p.write(["o:w#r@u9", "b:z#r@u1", "b:x#s@(o:w#r)", "o:w#s@(b:x#r)"])
    with captured(monkeypatch):
        p.check([query, "b:x#r@u1", "o:w#r@u9"])
    with captured(monkeypatch):
        p.expand([query.split("@")[0]], 4)


def test_rewrite_cases_over_columnar_store(monkeypatch):
    """tests/test_columnar.py's rewrite fixtures (AND/NOT islands, TTU,
    the unknown object) through both engines' columnar mirrors."""
    fields = {f: getattr(JColumns.from_tuples(ts(*REWRITE_TUPLES)), f) for f in FIELDS}
    p = ColPair(fields, "bucketized", jnss=REWRITE_NAMESPACES)
    with captured(monkeypatch):
        got = p.port.check_batch([TTuple.from_string(q) for q, _ in REWRITE_CASES], 100)
        p.jax.check_batch([JTuple.from_string(q) for q, _ in REWRITE_CASES], 100)
    for (q, expected), g in zip(REWRITE_CASES, got):
        assert g.error is None and g.allowed == expected, q
    assert p.port.stats["host_checks"] == p.jax.stats["host_checks"] == 1


def test_bulk_load_after_serving_rebuilds_the_mirror():
    tstore = TColumnar()
    cfg = TConfig({"limit": {"max_read_depth": 5}})
    cfg.set_namespaces(port_namespaces([JNamespace(name="n")]))
    engine = TorchCheckEngine(tstore, cfg, device="cpu")
    q = TTuple.from_string("n:o#r@u")
    assert not engine.check_batch([q])[0].allowed
    tstore.bulk_load(TColumns.from_tuples([q]))
    assert engine.check_batch([q])[0].allowed
    q2 = TTuple.from_string("n:o2#r@u")
    tstore.write_relation_tuples([q2])
    assert engine.check_batch([q2])[0].allowed
    assert engine.stats["snapshot_builds"] == 2  # the first and the one after the bulk load


# -- the registry and the generators -------------------------------------------------


def test_registry_dsn_columnar():
    reg = TRegistry(TConfig({"dsn": "columnar"}))
    assert isinstance(reg.relation_tuple_manager(), TColumnar)
    # a misspelt name is refused by the strict DSN router, as keto_tpu's
    # is, and never opens a fresh store of another kind
    with pytest.raises(ValueError, match="unsupported DSN"):
        TRegistry(TConfig({"dsn": "colummnar"})).relation_tuple_manager()


def test_scale_generators_equal_scale_bench():
    spec = importlib.util.spec_from_file_location(
        "scale_bench", os.path.join(REPO, "tools", "scale_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    jcols, jf, jo, jfp = bench.synth_columns(10_000, 1_000, seed=7)
    tcols, tf, to, tfp = synth_columns(10_000, 1_000, seed=7)
    assert tfp == jfp and len(tcols) == len(jcols) > 9_000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(to, jo)
    jr, tr = bench.synth_rbac_columns(100, 1_000), synth_rbac_columns(100, 1_000)
    for a, b in ((tcols, jcols), (tr, jr)):
        for f in FIELDS:
            got, want = getattr(a, f), getattr(b, f)
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
