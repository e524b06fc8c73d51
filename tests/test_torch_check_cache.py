"""The port's check cache (keto_tpu_torch/api/check_cache.py) held against
keto_tpu's: the same sequence of stores, lookups, writes and invalidation
passes on both gives the same answers and the same hit, miss, stale and
invalidation counts, the namespace-config generation flushes both, and
`cached_check` through each package's registry and batcher keeps the
same entries when a write lands between enforcement and resolve. Then the
staleness differential under interleaved writes on the memory store:
readers checking through the port's daemon while a writer toggles a
membership, every answer equal to keto_tpu's host oracle at some store
version between its snaptoken and the reader's next one.

Every wait is bounded. Tolerance: exact equality.
"""

import bisect
import json
import random
import threading
import time
import urllib.parse
import urllib.request

import pytest

from keto_tpu.api.batcher import CheckBatcher as JBatcher
from keto_tpu.api.check_cache import CheckCache as JCache
from keto_tpu.api.check_cache import cached_check as j_cached_check
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.definitions import RESULT_IS_MEMBER as J_MEMBER
from keto_tpu.engine.definitions import RESULT_NOT_MEMBER as J_NOT_MEMBER
from keto_tpu.engine.definitions import CheckResult as JResult
from keto_tpu.engine.definitions import Membership as JMembership
from keto_tpu.engine.reference import ReferenceEngine as JReference
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.registry import Registry as JRegistry
from keto_tpu.storage import MemoryManager as JMemory

from keto_tpu_torch.api.batcher import CheckBatcher as TBatcher
from keto_tpu_torch.api.check_cache import CheckCache as TCache
from keto_tpu_torch.api.check_cache import cached_check as t_cached_check
from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.definitions import RESULT_IS_MEMBER as T_MEMBER
from keto_tpu_torch.engine.definitions import RESULT_NOT_MEMBER as T_NOT_MEMBER
from keto_tpu_torch.engine.definitions import CheckResult as TResult
from keto_tpu_torch.engine.definitions import Membership as TMembership
from keto_tpu_torch.engine.snaptoken import parse_snaptoken
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.namespace.definitions import Namespace as TNamespace
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage import MemoryManager as TMemory

NID = "default"
WAIT_S = 10


class Kit:
    """One package's cache, store, config and results."""

    def __init__(self, pkg):
        if pkg == "keto_tpu":
            self.Cache, self.Memory, self.Config = JCache, JMemory, JConfig
            self.parse, self.Namespace = JTuple.from_string, JNamespace
            self.member, self.not_member = J_MEMBER, J_NOT_MEMBER
            self.errored = JResult(JMembership.NOT_MEMBER, error=ValueError("boom"))
        else:
            self.Cache, self.Memory, self.Config = TCache, TMemory, TConfig
            self.parse, self.Namespace = TTuple.from_string, TNamespace
            self.member, self.not_member = T_MEMBER, T_NOT_MEMBER
            self.errored = TResult(TMembership.NOT_MEMBER, error=ValueError("boom"))

    def namespaces(self):
        return [self.Namespace(name="files"), self.Namespace(name="groups")]

    def cache(self, **kw):
        self.m = self.Memory()
        self.cfg = self.Config({"dsn": "memory"})
        self.cfg.set_namespaces(self.namespaces())
        self.c = self.Cache(self.m, self.cfg, **kw)
        return self.c

    def v(self):
        return self.m.version(nid=NID)

    def result(self, res):
        """A lookup's answer, comparable across packages."""
        if res is None:
            return None
        return "member" if res is self.member else "not_member" \
            if res is self.not_member else "other"

    def wait_entries(self, at_most):
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and self.c.stats()["entries"] > at_most:
            time.sleep(0.01)


def seq_version_exact_hit_and_stale(k):
    c, q = k.cache(), k.parse("files:doc#owner@alice")
    k.m.write_relation_tuples([q])
    v = k.v()
    c.store(NID, q, 0, k.member, v, v)
    out = [k.result(c.lookup(NID, q, 0, v))]
    k.m.write_relation_tuples([k.parse("files:doc2#owner@bob")])
    out.append(k.result(c.lookup(NID, q, 0, k.v())))  # stale, dropped
    out.append(k.result(c.lookup(NID, q, 0, v)))  # gone
    return out


def seq_negative_and_depth_in_key(k):
    c, q = k.cache(), k.parse("files:doc#owner@alice")
    v = k.v()
    c.store(NID, q, 0, k.not_member, v, v)
    return [k.result(c.lookup(NID, q, 0, v)), k.result(c.lookup(NID, q, 3, v))]


def seq_raced_write_skips_unpinned(k):
    c, q = k.cache(), k.parse("files:doc#owner@alice")
    v0 = k.v()
    k.m.write_relation_tuples([q])  # the store moved past v0
    c.store(NID, q, 0, k.member, None, v0)
    out = [c.stats()["entries"]]
    v1 = k.v()
    c.store(NID, q, 0, k.member, v1, v0)  # pinned: cacheable
    out += [k.result(c.lookup(NID, q, 0, v1)), k.result(c.lookup(NID, q, 0, v0))]
    return out


def seq_errors_never_cached(k):
    c, q = k.cache(), k.parse("files:doc#owner@alice")
    v = k.v()
    c.store(NID, q, 0, k.errored, v, v)
    return [c.stats()["entries"], k.result(c.lookup(NID, q, 0, v))]


def seq_lru_bound(k):
    c = k.cache(max_entries=4)
    v = k.v()
    for i in range(8):
        c.store(NID, k.parse(f"files:d{i}#owner@u"), 0, k.member, v, v)
    out = [c.stats()["entries"]]
    # d3 is touched, so d4 is the oldest when d8 comes in
    out += [k.result(c.lookup(NID, k.parse(f"files:d{i}#owner@u"), 0, v)) for i in (0, 3, 7)]
    c.store(NID, k.parse("files:d8#owner@u"), 0, k.member, v, v)
    out += [k.result(c.lookup(NID, k.parse(f"files:d{i}#owner@u"), 0, v)) for i in (3, 4, 8)]
    return out


def seq_ttl_expiry(k):
    c, q = k.cache(ttl_s=0.05), k.parse("files:doc#owner@alice")
    v = k.v()
    c.store(NID, q, 0, k.member, v, v)
    out = [k.result(c.lookup(NID, q, 0, v))]
    time.sleep(0.08)
    return out + [k.result(c.lookup(NID, q, 0, v)), c.stats()["entries"]]


def seq_generation_flush(k):
    c, q = k.cache(), k.parse("files:doc#owner@alice")
    v = k.v()
    c.store(NID, q, 0, k.member, v, v)
    out = [k.result(c.lookup(NID, q, 0, v))]
    k.cfg.set_namespaces(k.namespaces())  # same content, a new generation
    out.append(k.result(c.lookup(NID, q, 0, v)))
    # a namespace change racing an evaluation: not stored
    gen = c.generation()
    k.cfg.set_namespaces(k.namespaces())
    c.store(NID, q, 0, k.member, v, v, gen=gen)
    return out + [c.stats()["entries"]]


def seq_precise_invalidation(k):
    c = k.cache()
    v = k.v()
    node_q = k.parse("files:doc#view@carol")  # the changed (ns, obj, rel) row
    subj_q = k.parse("files:other#view@alice")  # the changed subject
    other_q = k.parse("files:third#view@carol2")  # untouched
    for q in (node_q, subj_q, other_q):
        c.store(NID, q, 0, k.not_member, v, v)
    # the first pass has no floor: it drops what the store moved past
    k.m.write_relation_tuples([k.parse("files:doc#view@alice")])
    c.notify_commit(NID)
    k.wait_entries(0)
    out = [c.stats()["entries"]]
    # the second pass reads the change log: only the flippable keys go
    v2 = k.v()
    for q in (node_q, subj_q, other_q):
        c.store(NID, q, 0, k.not_member, v2, v2)
    k.m.write_relation_tuples([k.parse("files:doc#view@alice2"),
                               k.parse("files:zzz#view@alice")])
    c.notify_commit(NID)
    k.wait_entries(1)
    out += [c.stats()["entries"], k.result(c.lookup(NID, other_q, 0, v2))]
    return out


def seq_whole_nid_drop(k):
    c = k.cache()
    v = k.v()
    c.store(NID, k.parse("files:doc#owner@alice"), 0, k.member, v, v)
    c._inval_versions[NID] = v  # a floor, then a log that no longer reaches it
    k.m.changelog_since = lambda version, nid=NID: None
    k.m.write_relation_tuples([k.parse("files:doc2#owner@bob")])
    c.notify_commit(NID)
    k.wait_entries(0)
    return [c.stats()["entries"]]


SEQUENCES = {name[4:]: fn for name, fn in globals().items() if name.startswith("seq_")}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_cache_sequence_as_keto_tpu(name):
    kits = [Kit("port"), Kit("keto_tpu")]
    outs = [SEQUENCES[name](k) for k in kits]
    try:
        assert outs[0] == outs[1]
        counts = [dict(k.c.stats()) for k in kits]
        assert counts[0] == counts[1]
    finally:
        for k in kits:
            k.c.close()
    if name == "version_exact_hit_and_stale":
        assert outs[0] == ["member", None, None] and counts[0]["stale"] == 1
    if name == "precise_invalidation":
        assert outs[0] == [0, 1, "not_member"] and counts[0]["invalidation"] == 5


class GatedWriteEngine:
    """Wraps an engine: a write lands after the submit's state is taken
    and before the resolve."""

    def __init__(self, engine, write):
        self.engine, self.write = engine, write

    def check_batch_submit(self, tuples, depth=0):
        handle = self.engine.check_batch_submit(tuples, depth)
        self.write()
        return handle

    def check_batch_resolve_v(self, handle):
        return self.engine.check_batch_resolve_v(handle)


def test_cached_check_write_between_enforcement_and_resolve():
    """The request enforces at v0, a write lands before its batch is
    submitted, another after: the answer is pinned to the submitted state's
    version, the entry stored there, a lookup at v0 misses and one at that
    version hits, on both packages."""
    cfg = {"dsn": "memory"}
    treg = TRegistry(TConfig(cfg), device="cpu")
    treg.config.set_namespaces([TNamespace(name="files"), TNamespace(name="groups")])
    jreg = JRegistry(JConfig({**cfg, "check": {"engine": "tpu"}}))
    jreg.config.set_namespaces([JNamespace(name="files"), JNamespace(name="groups")])
    outs = []
    for reg, parse, cached, Batcher in ((treg, TTuple.from_string, t_cached_check, TBatcher),
                                        (jreg, JTuple.from_string, j_cached_check, JBatcher)):
        m = reg.relation_tuple_manager()
        m.write_relation_tuples([parse("files:doc#view@(groups:g#member)")])
        engine = reg.check_engine()
        v0 = m.version(nid=NID)
        m.write_relation_tuples([parse("groups:g#member@u")])  # before the submit
        late = GatedWriteEngine(engine, lambda: m.write_relation_tuples(
            [parse("files:zzz#owner@late")]))
        batcher = Batcher(late, window_s=0.0)
        try:
            q = parse("files:doc#view@u")
            res = cached(reg, batcher, NID, q, 0, v0, None)
            cache = reg.check_cache()
            v_submit = v0 + 1
            outs.append((res.allowed, cache.lookup(NID, q, 0, v0) is None,
                         cache.lookup(NID, q, 0, v_submit) is not None,
                         m.version(nid=NID) - v0, dict(cache.stats())))
        finally:
            batcher.close()
            reg.close_check_cache()
    treg.check_engine().stop_push_refresh()
    assert outs[0] == outs[1]
    assert outs[0][:4] == (True, True, True, 2)


# -- the staleness differential ----------------------------------------------------


def _oracle_window_check(ops, observations, final_version, namespaces):
    """Every (query, answer, token version, next token version) must equal
    keto_tpu's host oracle at some store version in its window."""
    history = {0: frozenset()}
    current: set = set()
    last_v = 0
    for v, op, tup in ops:
        if v != last_v:
            history[last_v] = frozenset(current)
            last_v = v
        if op == "insert":
            current.add(str(tup))
        else:
            current.discard(str(tup))
    history[last_v] = frozenset(current)
    versions = sorted(history)
    cfg = JConfig({"dsn": "memory"})
    cfg.set_namespaces(namespaces)
    memo: dict = {}

    def oracle(v, q):
        state = history[versions[bisect.bisect_right(versions, v) - 1]]
        if (state, q) not in memo:
            scratch = JMemory()
            scratch.write_relation_tuples([JTuple.from_string(s) for s in state])
            memo[(state, q)] = bool(JReference(scratch, cfg).check_relation_tuple(
                JTuple.from_string(q), 0, NID).allowed)
        return memo[(state, q)]

    stale = [(q, allowed, v, hi) for q, allowed, v, hi in observations
             if not any(oracle(w, q) == allowed
                        for w in range(v, (final_version if hi is None else hi) + 1))]
    assert not stale, stale[:5]


def test_staleness_differential_under_interleaved_writes():
    cfg = TConfig({"dsn": "memory", "serve": {"read": {"host": "127.0.0.1", "port": 0},
                                              "write": {"host": "127.0.0.1", "port": 0}}})
    cfg.set_namespaces([TNamespace(name="files"), TNamespace(name="groups")])
    reg = TRegistry(cfg, device="cpu")
    reg.relation_tuple_manager().write_relation_tuples(
        [TTuple.from_string("files:doc#view@(groups:g0#member)")])
    daemon = TDaemon(reg)
    daemon.start()
    read = f"http://127.0.0.1:{daemon.read_port}/relation-tuples/check"
    write = f"http://127.0.0.1:{daemon.write_port}/admin/relation-tuples"
    try:
        # the checked doc#view flips when only the membership is written: a
        # change the cache's precise invalidation cannot reach, which the
        # version gate must catch
        queries = ["groups:g0#member@u0", "files:doc#view@u0"]
        stop_at = time.monotonic() + 2.0
        observations, errors = [], []

        def writer():
            toggle = {"namespace": "groups", "object": "g0", "relation": "member",
                      "subject_id": "u0"}
            present = False
            while time.monotonic() < stop_at:
                action = "delete" if present else "insert"
                req = urllib.request.Request(
                    write, method="PATCH",
                    data=json.dumps([{"action": action, "relation_tuple": toggle}]).encode())
                urllib.request.urlopen(req, timeout=WAIT_S).close()
                present = not present
                time.sleep(0.02)

        def reader(i):
            rng = random.Random(i)
            mine = []
            try:
                while time.monotonic() < stop_at:
                    q = queries[rng.randrange(len(queries))]
                    t = TTuple.from_string(q)
                    url = read + "?" + urllib.parse.urlencode(
                        {"namespace": t.namespace, "object": t.object, "relation": t.relation,
                         "subject_id": t.subject_id})
                    try:
                        with urllib.request.urlopen(url, timeout=WAIT_S) as r:
                            allowed, token = True, r.headers["X-Keto-Snaptoken"]
                    except urllib.error.HTTPError as e:
                        assert e.code == 403, e.code
                        allowed, token = False, e.headers["X-Keto-Snaptoken"]
                    mine.append((q, allowed, parse_snaptoken(token, NID)))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
            for j, (q, allowed, v) in enumerate(mine):
                hi = mine[j + 1][2] if j + 1 < len(mine) else None
                observations.append((q, allowed, v, hi))

        threads = [threading.Thread(target=writer, daemon=True)] + [
            threading.Thread(target=reader, args=(i,), daemon=True) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not errors, errors
        assert observations
        manager = reg.relation_tuple_manager()
        final_v = manager.version(nid=NID)
        assert final_v > 3  # the writer wrote
        _oracle_window_check(manager.changelog_since(0, nid=NID), observations, final_v,
                             [JNamespace(name="files"), JNamespace(name="groups")])
        counts = reg.check_cache().stats()
        assert counts["hit"] + counts["miss"] + counts["stale"] == len(observations)
        assert sum(daemon.batcher.stats["check_batch_failed"].values()) == 0
    finally:
        daemon.stop()
