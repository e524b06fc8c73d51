"""The port's write path held against the JAX package's on the same store
sequence, on the CPU, under both table layouts: the store's change feed
and write listeners, the engine's delta overlay (packed check vectors,
overlay arrays, host replays and counts), incremental compaction (the
merged snapshot array for array, the patched expand and reverse mirrors,
the fallbacks to a full rebuild), Expand, the list legs and the filter
after a write, interleaved churn against the host oracle, the push
refresh, the closure index's dirty marks and refresh after a delete,
and the REST write routes against a keto_tpu daemon.

Tolerance: exact equality; every output is an integer, a name or a
verdict.
"""

import collections
import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

import keto_tpu.engine.compact as jcompact
import keto_tpu.engine.delta as jdelta
from keto_tpu.api.daemon import Daemon
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationQuery as JQuery
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.namespace.ast import (
    ComputedSubjectSet,
    Relation,
    SubjectSetRewrite,
    TupleToSubjectSet,
)
from keto_tpu.registry import Registry
from keto_tpu.storage import MemoryManager as JMemory

import keto_tpu_torch.engine.compact as tcompact
import keto_tpu_torch.storage.memory as tmemory
from keto_tpu_torch.api.daemon import make_batcher
from keto_tpu_torch.api.rest_server import make_server, make_write_server
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import closure as tcl
from keto_tpu_torch.engine.delta import DELTA_COMPACT_THRESHOLD
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.snaptoken import encode_snaptoken
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationQuery as TQuery
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_closure import same_index
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

MAX_DEPTH = 6
N_FOLDERS = 12
FILES = 6
DELTA_KEYS = ("dd_obj", "dd_rel", "dd_skind", "dd_sa", "dd_sb", "dd_val",
              "dirty_obj", "dirty_rel", "dirty_val", "rd_obj", "rd_tag", "rd_val")
SNAPSHOT_ARRAYS = ("dh_obj", "dh_rel", "dh_skind", "dh_sa", "dh_sb", "dh_val", "rh_obj",
                   "rh_rel", "rh_row", "row_ptr", "e_obj", "e_rel", "objslot_ns",
                   "ns_has_config")
SNAPSHOT_SCALARS = ("dh_probes", "rh_probes", "merge_garbage", "n_tuples", "K")
COUNTS = ("device_checks", "host_checks", "snapshot_builds", "host_cause", "device_expands",
          "host_expands", "device_list_objects", "host_list_objects", "device_list_subjects",
          "host_list_subjects", "filter_frontier", "filter_host", "filter_vocab")


def namespaces():
    return [
        JNamespace(name="videos", relations=[
            Relation(name="owner"), Relation(name="parent"),
            Relation(name="view", subject_set_rewrite=SubjectSetRewrite(children=[
                ComputedSubjectSet(relation="owner"),
                TupleToSubjectSet(relation="parent", computed_subject_set_relation="view"),
            ])),
        ]),
        JNamespace(name="groups", relations=[Relation(name="member")]),
    ]


def base_tuples():
    rng = random.Random(2)
    out = []
    for f in range(N_FOLDERS):
        out.append(f"videos:/f{f}#owner@user{f % 5}")
        out.append(f"videos:/f{f}#view@(groups:g{f % 3}#member)")
        for v in range(FILES):
            out.append(f"videos:/f{f}/v{v}#parent@(videos:/f{f}#...)")
            if rng.random() < 0.3:
                out.append(f"videos:/f{f}/v{v}#owner@user{rng.randrange(8)}")
    out += [f"groups:g{g}#member@member{g}{m}" for g in range(3) for m in range(3)]
    out += ["groups:g1#member@(groups:g2#member)"]
    return out


def small_writes():
    """Inserts and deletes under the overlay's capacity: new objects, a
    new subject, a new data-only namespace, removed parent links (check-
    dirty rows) and grants."""
    inserts = [
        "videos:/f0#owner@newbie", "videos:/f99#owner@user1",
        "videos:/f99/v0#parent@(videos:/f99#...)", "extra:x#rel@user1",
        "groups:g0#member@user4", "videos:/f3/v1#owner@member21",
        "videos:/f5#view@(groups:g9#member)", "groups:g9#member@newbie",
    ]
    deletes = ["videos:/f1/v2#parent@(videos:/f1#...)", "videos:/f2#owner@user2",
               "groups:g2#member@member21"]
    return inserts, deletes


def compacting_writes(n=2100):
    """More ops than the overlay holds: new files under existing folders
    and new grants, and a second parent of an existing file (its
    subject-set row rewritten at the CSR's tail: garbage)."""
    out = ["videos:/f1/v3#parent@(videos:/f2#...)"]
    for i in range(n):
        f = i % N_FOLDERS
        if i % 2:
            out.append(f"videos:/f{f}/w{i}#parent@(videos:/f{f}#...)")
        else:
            out.append(f"videos:/f{f}/w{i - 1}#owner@writer{i % 17}")
    return out


def queries():
    rng = random.Random(5)
    out = []
    for i in range(56):
        f = rng.randrange(N_FOLDERS)
        sub = f"user{f % 5}" if i % 2 == 0 else rng.choice(
            ["newbie", "user1", "user4", f"member{f % 3}{rng.randrange(3)}", "writer3"])
        obj = f"/f{f}/v{rng.randrange(FILES)}" if i % 3 else f"/f{f}"
        out.append(f"videos:{obj}#view@{sub}")
    out += ["videos:/f99/v0#view@user1", "videos:/f0/v1#view@newbie", "extra:x#rel@user1",
            "videos:/f1/v2#view@user1", "videos:/f2/v0#view@user2", "groups:g0#member@user4",
            "videos:/f5/v3#view@newbie", "videos:/f1/w1#view@user1"]
    return out


class Pair:
    """The same store sequence and config behind both engines."""

    def __init__(self, tuples=None, max_depth=MAX_DEPTH, closure=False, **kw):
        cfg = {"limit": {"max_read_depth": max_depth}, "closure": {"enabled": closure}}
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        self.jcfg.set_namespaces(namespaces())
        self.tcfg.set_namespaces(port_namespaces(namespaces()))
        self.jm, self.tm = JMemory(), TMemory()
        self.write(base_tuples() if tuples is None else tuples)
        self.jax = TPUCheckEngine(self.jm, self.jcfg)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu", **kw)
        self.oracle = TReference(self.tm, self.tcfg)

    def write(self, tuples):
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])

    def delete(self, tuples):
        self.jm.delete_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.delete_relation_tuples([TTuple.from_string(s) for s in tuples])

    def transact(self, inserts, deletes):
        self.jm.transact_relation_tuples([JTuple.from_string(s) for s in inserts],
                                         [JTuple.from_string(s) for s in deletes])
        self.tm.transact_relation_tuples([TTuple.from_string(s) for s in inserts],
                                         [TTuple.from_string(s) for s in deletes])

    def check(self, qs, max_depth=0):
        """Verdicts of both engines and the oracle, and both packed result
        vectors, launch stats included."""
        th = self.port.check_batch_submit([TTuple.from_string(q) for q in qs], max_depth)
        jh = self.jax.check_batch_submit([JTuple.from_string(q) for q in qs], max_depth)
        assert th[0] == jh[0] == "batch"
        np.testing.assert_array_equal(th[1].numpy(), np.asarray(jh[1]))
        got, want = self.port.check_batch_resolve(th), self.jax.check_batch_resolve(jh)
        for q, g, w in zip(qs, got, want):
            o = self.oracle.check_relation_tuple(TTuple.from_string(q), max_depth)
            assert (g.error is None) == (w.error is None) == (o.error is None), q
            if g.error is None:
                assert g.membership.value == w.membership.value == o.membership.value, q
        return got

    def same_counts(self):
        for key in COUNTS:
            want = self.jax.stats.get(key, {} if key == "host_cause" else 0)
            assert self.port.stats[key] == want, key
        assert self.port.stats["incremental_merges"] == self.jax.stats.get("incremental_merges", 0)

    def same_snapshot(self):
        ts, js = self.port._state.snapshot, self.jax._state.snapshot
        assert_snapshots_equal(ts, js)


def assert_snapshots_equal(ts, js):
    for k in SNAPSHOT_ARRAYS:
        np.testing.assert_array_equal(getattr(ts, k), np.asarray(getattr(js, k)), err_msg=k)
    for k in SNAPSHOT_SCALARS:
        assert getattr(ts, k) == getattr(js, k), k
    for k in ("ns_ids", "rel_ids", "obj_slots", "subj_ids"):
        assert dict(getattr(ts, k)) == dict(getattr(js, k)), k


# -- (a) the change feed ------------------------------------------------------------------


def _ops(log):
    return None if log is None else [(op, str(t)) for op, t in log]


def _triples(log):
    return None if log is None else [(v, op, str(t)) for v, op, t in log]


def _store_sequence(ms, queries_of, rng):
    """The same writes on every store of `ms`: single writes and deletes,
    idempotent repeats, a bulk write past the bulk-merge threshold with
    duplicates inside it, a delete by query and a transaction."""
    def each(fn, *args):
        for m, q in zip(ms, queries_of):
            getattr(m, fn)(*(a(q) for a in args))

    def tup(ss):
        return lambda mod: [mod.RelationTuple.from_string(s) for s in ss]

    each("write_relation_tuples", tup(["n:a#r@u1", "n:b#r@u2"]))
    each("write_relation_tuples", tup(["n:a#r@u1"]))  # idempotent: no version
    bulk = [f"n:o{rng.randrange(400)}#r@u{rng.randrange(40)}" for _ in range(600)]
    each("write_relation_tuples", tup(bulk + ["n:a#r@u1", "n:o7#r@u1", "n:o7#r@u1"]))
    each("delete_relation_tuples", tup(["n:b#r@u2", "n:zz#r@nobody"]))
    each("delete_relation_tuples", tup(["n:zz#r@nobody"]))  # a no-op
    each("delete_all_relation_tuples", lambda mod: mod.RelationQuery(namespace="n", object="o7"))
    each("transact_relation_tuples", tup(["n:t#r@(n:a#r)", "n:o3#r@u1"]),
         tup(["n:a#r@u1", "n:missing#r@x"]))
    each("delete_all_relation_tuples", lambda mod: mod.RelationQuery(namespace="ghost"))


class _Mods:
    """The package-level names the store sequence builds its inputs with."""

    def __init__(self, tuple_cls, query_cls):
        self.RelationTuple = tuple_cls

        def query(**kw):
            return query_cls(**kw)

        self.RelationQuery = query


MODS = (_Mods(JTuple, JQuery), _Mods(TTuple, TQuery))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_change_feed_equals_keto_tpu(seed):
    jm, tm = JMemory(), TMemory()
    _store_sequence((jm, tm), MODS, random.Random(seed))
    assert tm.version() == jm.version() == 5
    for v in range(-1, tm.version() + 2):
        assert _ops(tm.changes_since(v)) == _ops(jm.changes_since(v)), v
        assert _triples(tm.changelog_since(v)) == _triples(jm.changelog_since(v)), v
    assert _ops(tm.changes_since(0, nid="other")) == _ops(jm.changes_since(0, nid="other")) == []
    # every changed row is logged in keto_tpu's op order, with its version
    assert [v for v, _op, _t in tm.changelog_since(0)] == \
        sorted(v for v, _op, _t in tm.changelog_since(0))


def test_idempotent_ops_are_not_logged():
    m = TMemory()
    m.write_relation_tuples([TTuple.from_string("n:a#r@u")])
    v = m.version()
    m.write_relation_tuples([TTuple.from_string("n:a#r@u")])
    m.delete_relation_tuples([TTuple.from_string("n:b#r@u")])
    m.transact_relation_tuples([TTuple.from_string("n:a#r@u")], [TTuple.from_string("n:c#r@u")])
    m.delete_all_relation_tuples(TQuery(namespace="none"))
    assert m.version() == v and m.changes_since(v) == []
    assert _ops(m.changes_since(0)) == [("insert", "n:a#r@u")]


def test_bulk_write_logs_in_keto_tpu_order():
    rng = random.Random(4)
    rows = [f"n:o{rng.randrange(300)}#r@u{rng.randrange(30)}" for _ in range(3 * tmemory._BULK_MERGE_MIN)]
    jm, tm = JMemory(), TMemory()
    jm.write_relation_tuples([JTuple.from_string("n:o1#r@u1")])
    tm.write_relation_tuples([TTuple.from_string("n:o1#r@u1")])
    jm.write_relation_tuples([JTuple.from_string(s) for s in rows])
    tm.write_relation_tuples([TTuple.from_string(s) for s in rows])
    got, want = _ops(tm.changes_since(1)), _ops(jm.changes_since(1))
    assert got == want and len(got) == len(set(rows) - {"n:o1#r@u1"})
    # the bulk merge keeps the pagination order
    assert [str(t) for t in tm.all_relation_tuples()] == [str(t) for t in jm.all_relation_tuples()]


def test_truncated_log_returns_none():
    jm, tm = JMemory(), TMemory()
    for m, cls in ((jm, JTuple), (tm, TTuple)):
        m.write_relation_tuples([cls.from_string("n:seed#r@x")])
        net = m._networks["default"]
        net.log = collections.deque(net.log, maxlen=4)
        for i in range(6):
            m.write_relation_tuples([cls.from_string(f"n:o{i}#r@u{i}")])
    for v in range(0, 8):
        assert _ops(tm.changes_since(v)) == _ops(jm.changes_since(v)), v
    assert tm.changes_since(1) is None and tm.changes_since(tm.version() - 1) is not None


def test_listeners_fire_once_per_changing_call():
    fired = {"t": [], "j": []}
    jm, tm = JMemory(), TMemory()
    jm.add_write_listener(fired["j"].append)
    tm.add_write_listener(fired["t"].append)
    _store_sequence((jm, tm), MODS, random.Random(9))
    # the idempotent write and the no-op delete fire nothing
    assert fired["t"] == fired["j"] == ["default"] * 5
    tm.write_relation_tuples([TTuple.from_string("n:x#r@y")], nid="tenant")
    assert fired["t"][-1] == "tenant"


def test_listener_runs_outside_the_store_lock():
    tm = TMemory()
    seen = []

    def listener(nid):
        # another thread can read the store while the listener runs
        t = threading.Thread(target=lambda: seen.append(tm.version(nid=nid)))
        t.start()
        t.join(timeout=10)

    tm.add_write_listener(listener)
    tm.write_relation_tuples([TTuple.from_string("n:x#r@y")])
    assert seen == [1]


# -- (b) the delta overlay ----------------------------------------------------------------


def test_delta_refresh_equals_keto_tpu(layout):
    p = Pair(layout=layout)
    qs = queries()
    p.check(qs)
    ins, dels = small_writes()
    p.write(ins[:3])
    p.delete(dels[:1])
    p.transact(ins[3:], dels[1:])
    assert len(p.tm.changes_since(1)) <= DELTA_COMPACT_THRESHOLD
    p.check(qs)
    state = p.port._state
    assert state.has_delta and p.jax._state.has_delta
    assert state.base_version == 1 and state.covered_version == p.tm.version() == 4
    for k in DELTA_KEYS:
        np.testing.assert_array_equal(state.delta_np[k], p.jax._state.delta_np[k], err_msg=k)
    # the builders on the same ops give the same arrays again
    ops = p.jm.changes_since(1)
    jview = jdelta.SnapshotView(p.jax._state.snapshot,
                                jdelta.build_vocab_overlay(p.jax._state.snapshot, ops))
    want = jdelta.build_delta_tables(jview, ops)
    for k in DELTA_KEYS:
        np.testing.assert_array_equal(state.delta_np[k], want[k], err_msg=k)
    # the overlay grew the vocabulary: new names encode past the base's
    assert state.view.ns_id("extra") == len(state.snapshot.ns_ids)
    np.testing.assert_array_equal(state.tables["objslot_ns"].numpy(),
                                  np.asarray(p.jax._state.tables["objslot_ns"]))
    assert p.port.stats["host_cause"].get("dirty_row", 0) > 0
    assert p.port.stats["snapshot_builds"] == 1
    p.same_counts()


def test_no_write_keeps_the_state(layout):
    p = Pair(layout=layout)
    s0 = p.port.ensure_state()
    p.write(["videos:/f1#owner@user1"])  # already there: no version
    assert p.port.ensure_state() is s0 and not s0.has_delta
    p.write(["videos:/f1#owner@fresh"])
    s1 = p.port.ensure_state()
    assert s1 is not s0 and s1.snapshot is s0.snapshot and s1.has_delta
    # the base tables are shared, the overlay packs are new
    assert s1.tables["dh_pack"] is s0.tables["dh_pack"]
    assert s1.tables["dd_pack"] is not s0.tables["dd_pack"]


# -- (c) incremental compaction -----------------------------------------------------------


def test_incremental_compaction_equals_keto_tpu(layout):
    p = Pair(layout=layout)
    qs = queries()
    p.check(qs)
    ins, dels = small_writes()
    p.write(ins)
    p.delete(dels)
    p.check(qs)
    base_j = p.jax._state.snapshot
    base_t = p.port._state.snapshot
    p.write(compacting_writes())
    ops_j, ops_t = p.jm.changes_since(1), p.tm.changes_since(1)
    assert len(ops_t) > DELTA_COMPACT_THRESHOLD
    p.check(qs)
    assert p.port.stats["incremental_merges"] == p.jax.stats["incremental_merges"] == 1
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 1
    state = p.port._state
    assert not state.has_delta and state.base_version == state.covered_version == p.tm.version()
    assert state.snapshot.merge_garbage > 0
    p.same_snapshot()
    # the merge on its own, on the same base and ops
    want, enc_j, ins_j = jcompact.merge_ops_into_snapshot(base_j, ops_j, 7, with_encoded=True)
    got, enc_t, ins_t = tcompact.merge_ops_into_snapshot(base_t, ops_t, 7)
    assert_snapshots_equal(got, want)
    np.testing.assert_array_equal(enc_t, enc_j)
    np.testing.assert_array_equal(ins_t, ins_j)
    p.same_counts()
    # the next small write rides the overlay over the merged base
    p.write(["videos:/f4/v0#owner@late"])
    p.check(qs + ["videos:/f4/v0#view@late"])
    assert p.port._state.has_delta and p.port._state.snapshot is state.snapshot
    p.same_counts()


@pytest.mark.parametrize("gate", ["ops_fraction", "garbage", "truncated_log"])
def test_compaction_falls_back_to_a_rebuild(layout, gate, monkeypatch):
    if gate == "ops_fraction":
        for mod in (jcompact, tcompact):
            monkeypatch.setattr(mod, "MIN_OPS_CAP", 64)
    elif gate == "garbage":
        for mod in (jcompact, tcompact):
            monkeypatch.setattr(mod, "GARBAGE_FRACTION", 0.0)
            monkeypatch.setattr(mod, "GARBAGE_FLOOR", 0)
    p = Pair(layout=layout)
    qs = queries()
    p.check(qs)
    if gate == "truncated_log":
        for m in (p.jm, p.tm):
            net = m._networks["default"]
            net.log = collections.deque(net.log, maxlen=4)
        for i in range(6):
            p.write([f"videos:/f{i}/v0#owner@late{i}"])
    else:
        p.write(compacting_writes())
    p.check(qs)
    assert p.port.stats["incremental_merges"] == p.jax.stats.get("incremental_merges", 0) == 0
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 2
    assert not p.port._state.has_delta
    p.same_snapshot()
    p.same_counts()


# -- (d) the other legs after a write ----------------------------------------------------


def _expand(p, subjects, max_depth=0):
    got = p.port.expand_batch([TSubjectSet.from_string(s) for s in subjects], max_depth)
    want = p.jax.expand_batch([JSubjectSet.from_string(s) for s in subjects], max_depth)
    for s, g, w in zip(subjects, got, want):
        assert (g and g.to_dict()) == (w and w.to_dict()), s


def _lists(p, lo, ls, max_depth=0):
    got = p.port.list_objects_batch(lo, max_depth)
    assert got == p.jax.list_objects_batch(lo, max_depth)
    for (n, r, s), g in zip(lo, got):
        assert g == p.oracle.list_objects(n, r, s, max_depth), (n, r, s)
    got = p.port.list_subjects_batch(ls, max_depth)
    assert got == p.jax.list_subjects_batch(ls, max_depth)
    for (n, o, r), g in zip(ls, got):
        assert g == p.oracle.list_subjects(n, o, r, max_depth), (n, o, r)


def _filter(p, subject, objects, max_depth=0):
    got = p.port.filter_batch("videos", "view", subject, objects, max_depth)
    assert got == p.jax.filter_batch("videos", "view", subject, objects, max_depth)
    assert got == p.oracle.filter_objects("videos", "view", subject, objects, max_depth)


def _legs(p):
    subjects = ["videos:/f0#view", "videos:/f1/v2#parent", "groups:g0#member",
                "groups:g1#member", "videos:/f99#owner", "videos:/f3#view", "groups:g9#member"]
    _expand(p, subjects, 3)
    lo = [("videos", "view", u) for u in ("user0", "user1", "newbie", "member21", "writer3",
                                          "nobody")]
    ls = [("videos", f"/f{f}/v{v}", "view") for f, v in ((0, 1), (1, 2), (2, 0), (5, 3))]
    ls += [("groups", "g1", "member"), ("videos", "/f99/v0", "view")]
    _lists(p, lo, ls)
    objects = [f"/f{f}/v{v}" for f in range(N_FOLDERS) for v in range(FILES)] + ["/f99/v0"]
    for subject in ("user1", "newbie"):
        _filter(p, subject, objects)


def test_legs_after_a_write_equal_keto_tpu(layout):
    p = Pair(layout=layout)
    # every path's state over the clean base
    for ensure in ("expand", "reverse", "subjects"):
        getattr(p.port, f"ensure_{ensure}_state")()
        getattr(p.jax, f"_ensure_{ensure}_state")()
    ins, dels = small_writes()
    p.write(ins)
    p.delete(dels)
    _legs(p)
    assert p.port._state.has_delta
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 1
    p.same_counts()
    # a compaction patches the retained expand and transposed mirrors
    p.write(compacting_writes())
    p.port.ensure_state()
    p.jax._ensure_state()
    tst, jst = p.port._state, p.jax._state
    assert p.port.stats["incremental_merges"] == p.jax.stats["incremental_merges"] == 1
    assert tst.expand_np is not None and tst.reverse_np is not None
    assert set(tst.expand_np) == set(jst.expand_np)
    for k in tst.expand_np:
        np.testing.assert_array_equal(tst.expand_np[k], np.asarray(jst.expand_np[k]), err_msg=k)
    for k in tst.reverse_np:
        np.testing.assert_array_equal(tst.reverse_np[k], np.asarray(jst.reverse_np[k]),
                                      err_msg=k)
    _legs(p)
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 1
    p.same_counts()


# -- (e) interleaved churn ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_churn_equals_keto_tpu_and_oracle(layout, seed):
    rng = random.Random(seed)
    p = Pair(layout=layout)
    qs = queries()
    p.check(qs)
    live = set(base_tuples())
    objs = [f"/f{f}/v{v}" for f in range(N_FOLDERS) for v in range(FILES)]
    objs += [f"/c{i}" for i in range(900)]
    subs = [f"user{i}" for i in range(8)] + ["newbie", "churner"]
    # the third round overflows the overlay and compacts
    for n_ops in (40, 60, DELTA_COMPACT_THRESHOLD + 200, 50):
        for _ in range(n_ops):
            s = f"videos:{rng.choice(objs)}#owner@{rng.choice(subs)}"
            if rng.random() < 0.2:
                s = f"videos:{rng.choice(objs)}#parent@(videos:/f{rng.randrange(N_FOLDERS)}#...)"
            if s in live and rng.random() < 0.4:
                p.delete([s])
                live.discard(s)
            else:
                p.write([s])
                live.add(s)
        sample = rng.sample(sorted(live), 24)
        sample = [s.split("#")[0] + "#view@" + s.split("@")[1] if "#owner@" in s else s
                  for s in sample]
        p.check(qs + sample)
        p.same_counts()
    assert p.port.stats["incremental_merges"] == p.jax.stats["incremental_merges"] == 1
    assert p.port.stats["snapshot_builds"] == 1


# -- (f) the push refresh ----------------------------------------------------------------


def test_push_refresh_folds_a_write_without_a_request():
    p = Pair(layout="bucketized")
    s0 = p.port.ensure_state()
    p.tm.add_write_listener(lambda nid: p.port.notify_write())
    before = set(threading.enumerate())
    p.tm.write_relation_tuples([TTuple.from_string("videos:/f1#owner@pushed")])
    deadline = time.monotonic() + 30
    while p.port.stats["push_refreshes"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p.port.stats["push_refreshes"] >= 1
    state = p.port._state
    assert state is not s0 and state.has_delta and state.covered_version == p.tm.version()
    (thread,) = [t for t in set(threading.enumerate()) - before
                 if t.name == "keto-torch-push-refresh-default"]
    p.port.stop_push_refresh()
    thread.join(timeout=10)
    assert not thread.is_alive()
    p.port.notify_write()  # a stopped engine starts no thread
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


def test_push_refresh_under_concurrent_writes_and_checks():
    """Writer threads (each write wakes the refresh thread) and checker
    threads at once, more threads than cores, with a short switch
    interval: the refresh thread folds writes in while batches run, no
    thread fails, and at the end the mirror covers the store's last
    version and answers as the oracle."""
    import os
    import sys

    p = Pair(layout="bucketized")
    p.tm.add_write_listener(lambda nid: p.port.notify_write())
    errors = []
    n_threads = max(8, 2 * (os.cpu_count() or 1))

    def writer(k):
        try:
            for i in range(20):
                p.tm.write_relation_tuples([TTuple.from_string(f"videos:/f{i % N_FOLDERS}/v0#owner@t{k}")])
                if i % 3 == 0:
                    p.tm.delete_relation_tuples(
                        [TTuple.from_string(f"videos:/f{(i + 1) % N_FOLDERS}/v0#owner@t{k}")])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    mu = threading.Lock()  # as the REST service holds around the engine

    def checker(k):
        try:
            for _ in range(5):
                with mu:
                    p.port.check_batch([TTuple.from_string(q) for q in queries()[:16]])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer if k % 2 else checker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        p.port.stop_push_refresh()
    assert errors == []
    qs = [f"videos:/f{i}/v0#view@t{k}" for i in range(N_FOLDERS) for k in range(1, n_threads, 2)]
    got = p.port.check_batch([TTuple.from_string(q) for q in qs])
    assert p.port._state.covered_version == p.tm.version()
    for q, g in zip(qs, got):
        assert g.membership == p.oracle.check_relation_tuple(TTuple.from_string(q)).membership, q


# -- (g) the closure index over an overlay -------------------------------------------------


def test_closure_marks_a_delete_dirty_then_refreshes(layout):
    """A deleted grant: the check's inline catch-up marks the folder's
    ancestors dirty, so those queries fall back (dirty) and never read
    the pre-write index's answer, as keto_tpu's; closure_ensure_built()
    powers the dirty nodes again over the same base (a refresh) and the
    queries hit with the delete applied; a compaction powers a new base."""
    p = Pair(layout=layout, closure=True)
    engine = p.port
    grant = "videos:/f3#owner@user3"
    qs = [f"videos:/f3/v{v}#view@user3" for v in range(FILES)] + [grant.replace("owner", "view")]
    other = [f"videos:/f{f}#view@user{f % 5}" for f in (0, 1, 2)]

    def both(queries):
        got = engine.check_batch([TTuple.from_string(q) for q in queries])
        want = p.jax.check_batch([JTuple.from_string(q) for q in queries])
        for q, g, w in zip(queries, got, want):
            assert g.membership.value == w.membership.value, q
            assert g.membership == p.oracle.check_relation_tuple(TTuple.from_string(q)).membership
        assert engine.stats["closure_hits"] == p.jax.stats.get("closure_hits", 0)
        assert engine.stats["closure_fallback"] == p.jax.stats.get("closure_fallback", {})
        same_index(engine.closure_index(), p.jax.closure_index())
        return got

    assert engine.closure_ensure_built() and p.jax.closure_ensure_built()
    assert all(r.allowed for r in both(qs + other))
    hits, builds = engine.stats["closure_hits"], engine.closure_index().stats["builds"]
    assert hits == len(qs) + len(other)

    p.delete([grant])
    got = both(qs + other)
    assert not any(r.allowed for r in got[:len(qs)])  # never the pre-write index's answer
    assert all(r.allowed for r in got[len(qs):])
    assert engine.stats["closure_fallback"] == {"dirty": len(qs)}
    assert engine.stats["closure_hits"] == hits + len(other)
    assert engine.closure_index().describe()["dirty_nodes"] > 0
    assert engine.closure_ensure_built() and p.jax.closure_ensure_built()
    idx = engine.closure_index()
    assert idx.stats["builds"] == builds and idx.stats["refreshes"] == 1
    assert idx.describe()["dirty_nodes"] == 0
    hits = engine.stats["closure_hits"]
    again = both(qs)
    assert engine.stats["closure_hits"] == hits + len(qs)
    assert not any(r.allowed for r in again)

    p.write(compacting_writes())
    assert engine.closure_ensure_built() and p.jax.closure_ensure_built()
    assert engine.stats["incremental_merges"] == 1 and engine.stats["snapshot_builds"] == 1
    assert idx.stats["builds"] == builds + 1
    hits = engine.stats["closure_hits"]
    assert [r.allowed for r in both(qs)] == [r.allowed for r in again]
    assert engine.stats["closure_hits"] == hits + len(qs)


# -- (h) the REST write routes -----------------------------------------------------------


def _call(port, method, path, params=None, body=None, raw=None):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, payload, headers = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, payload, headers = e.code, e.read(), e.headers
    return (status, json.loads(payload) if payload else None, headers.get("Location"),
            headers.get("X-Keto-Snaptoken"))


@pytest.fixture(scope="module")
def daemons():
    tm = TMemory()
    tm.write_relation_tuples([TTuple.from_string(s) for s in base_tuples()])
    cfg = TConfig({"limit": {"max_read_depth": MAX_DEPTH}})
    cfg.set_namespaces(port_namespaces(namespaces()))
    # the registry's store listener pokes the engine's refresh thread
    t_registry = TRegistry(cfg, device="cpu", manager=tm)
    engine = t_registry.check_engine()
    batcher = make_batcher(t_registry)
    servers = [make_server(t_registry, "127.0.0.1", 0, batcher),
               make_write_server(t_registry, "127.0.0.1", 0)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    registry = Registry(JConfig({
        "dsn": "memory",
        "check": {"engine": "tpu"},
        "limit": {"max_read_depth": MAX_DEPTH},
        "serve": {"read": {"host": "127.0.0.1", "port": 0},
                  "write": {"host": "127.0.0.1", "port": 0},
                  "metrics": {"host": "127.0.0.1", "port": 0}},
        "namespaces": [ns.to_dict() for ns in namespaces()],
    }))
    registry.relation_tuple_manager().write_relation_tuples(
        [JTuple.from_string(s) for s in base_tuples()])
    daemon = Daemon(registry)
    daemon.start()
    yield ((servers[0].server_address[1], servers[1].server_address[1]),
           (daemon.read_port, daemon.write_port), engine)
    daemon.stop()
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    batcher.close()
    engine.stop_push_refresh()


T_NEW = {"namespace": "videos", "object": "/f7/v9", "relation": "owner", "subject_id": "rest"}
T_SET = {"namespace": "videos", "object": "/f8/v9", "relation": "parent",
         "subject_set": {"namespace": "videos", "object": "/f8", "relation": "..."}}
WRITES = [
    ("put", "PUT", {}, T_NEW, None),
    ("put_set", "PUT", {}, T_SET, None),
    ("put_again", "PUT", {}, T_NEW, None),
    ("put_unknown_ns", "PUT", {}, {**T_NEW, "namespace": "ghost"}, None),
    ("put_not_object", "PUT", {}, [T_NEW], None),
    ("put_no_subject", "PUT", {}, {k: v for k, v in T_NEW.items() if k != "subject_id"}, None),
    ("put_bad_json", "PUT", {}, None, b"{nope"),
    ("patch", "PATCH", {}, [
        {"action": "insert", "relation_tuple": {**T_NEW, "object": "/f7/v10"}},
        {"action": "delete", "relation_tuple": T_NEW},
        {"action": "delete", "relation_tuple": {**T_NEW, "object": "/nowhere"}}], None),
    ("patch_bad_action", "PATCH", {}, [{"action": "upsert", "relation_tuple": T_NEW}], None),
    ("patch_no_tuple", "PATCH", {}, [{"action": "insert"}], None),
    ("patch_not_array", "PATCH", {}, {"action": "insert", "relation_tuple": T_NEW}, None),
    ("patch_unknown_ns", "PATCH", {}, [
        {"action": "insert", "relation_tuple": {**T_NEW, "namespace": "ghost"}}], None),
    ("delete", "DELETE", {"namespace": "videos", "object": "/f7/v10", "relation": "owner",
                          "subject_id": "rest"}, None, None),
    ("delete_by_object", "DELETE", {"namespace": "videos", "object": "/f8/v9"}, None, None),
    ("delete_unknown_ns", "DELETE", {"namespace": "ghost"}, None, None),
    ("delete_two_subjects", "DELETE", {"namespace": "videos", "subject_id": "x",
                                       "subject_set.namespace": "videos"}, None, None),
    ("delete_incomplete_set", "DELETE", {"namespace": "videos",
                                         "subject_set.namespace": "videos"}, None, None),
    ("delete_subject_key", "DELETE", {"subject": "x"}, None, None),
    ("no_route", "POST", {}, T_NEW, None),
]


def test_write_routes_equal_keto_tpu_daemon(daemons):
    """Every request runs against both daemons in turn, so both stores go
    through the same sequence and every answer and token is compared."""
    (t_read, t_write), (j_read, j_write), engine = daemons
    for name, method, params, body, raw in WRITES:
        got = _call(t_write, method, "/admin/relation-tuples", params, body, raw)
        want = _call(j_write, method, "/admin/relation-tuples", params, body, raw)
        assert got == want, name
        status, _body, _loc, token = got
        if name in ("put", "put_set", "patch"):
            assert status in (201, 204) and token is not None
            # a check that carries the write's token sees the write
            t = {"put": T_NEW, "put_set": T_SET,
                 "patch": {**T_NEW, "object": "/f7/v10"}}[name]
            check = {k: v for k, v in t.items() if k != "subject_set"}
            if "subject_set" in t:
                check.update({f"subject_set.{k}": v for k, v in t["subject_set"].items()})
            seen = _call(t_read, "GET", "/relation-tuples/check", {**check, "snaptoken": token})
            assert seen == _call(j_read, "GET", "/relation-tuples/check",
                                 {**check, "snaptoken": token})
            assert seen[0] == 200 and seen[1] == {"allowed": True}, name
    assert engine.manager.version() == 6
    # the deletes took the written tuples away again
    gone = _call(t_read, "GET", "/relation-tuples/check",
                 {"namespace": "videos", "object": "/f7/v10", "relation": "view",
                  "subject_id": "rest", "snaptoken": encode_snaptoken(6, "default")})
    assert gone[:2] == (403, {"allowed": False})
