"""The port's fault points (keto_tpu_torch/faults.py and its hooks) held
against keto_tpu's on the CPU.

  (a) `configure` on the same spec strings arms the same points with the
      same FaultSpec fields; `set_fault`, `inject`, `clear`, `get` and
      `armed_names` behave alike (max_hits, seeded probability, error
      messages taken verbatim, unknown points and modes refused);
      KETO_FAULTS is parsed at import in a fresh process;
  (b) the crash points in child processes of each package, on one write
      script over a SQLite file: store_commit_pre, store_commit_post and
      changelog_append in the store, cache_invalidation in the
      registry's push invalidation, watch_broadcast in the hub's tailer.
      Each child exits 137 and the file then holds the same rows, version
      and changelog under either package: no acked write lost, no
      phantom, a version equal to the commits present, the crashed write
      absent after _pre and changelog_append and present with its
      changelog row after _post;
  (c) store_read=error: the port's REST daemon answers the same status
      and body as a keto_tpu daemon whose store health guard is off (the
      one known difference: keto_tpu's default guard answers 503);
  (d) batch_corrupt: both engines give the same answers with every query
      replayed on the host oracle, and the same counts; device_launch
      stalls and fails a submit alike.

Every wait is bounded. Tolerance: exact equality.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

import keto_tpu.faults as jfaults
import keto_tpu.storage.sqlite as jsqlite
from keto_tpu.api.daemon import Daemon as JDaemon
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.registry import Registry as JRegistry
from keto_tpu.storage.memory import MemoryManager as JMemory

import keto_tpu_torch.faults as tfaults
import keto_tpu_torch.storage.sqlite as tsqlite
from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage.memory import MemoryManager as TMemory

from test_torch_daemon import LISTEN, call
from test_torch_snaptoken import NAMESPACES, TUPLES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
PKGS = {
    "keto_tpu": SimpleNamespace(faults=jfaults, sqlite=jsqlite, Tuple=JTuple),
    "keto_tpu_torch": SimpleNamespace(faults=tfaults, sqlite=tsqlite, Tuple=TTuple),
}
FIELDS = ("stall_s", "error", "crash", "probability", "max_hits", "hits")


@pytest.fixture(autouse=True)
def disarmed():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def armed(faults) -> dict:
    return {name: {f: getattr(faults.get(name), f) for f in FIELDS} | {
        "expires": faults.get(name).expires_at is not None} for name in faults.armed_names()}


# -- (a) the harness ------------------------------------------------------------------------


SPECS = [
    "device_launch=stall:0.25,store_read=error:disk gone",
    "batch_corrupt=on",
    "store_commit_pre=crash:137@0.25",
    "changelog_append=crash:137!1",
    "store_outage=stall:30~5",
    "mirror_corrupt=on!1",
    "device_launch=stall:0.25@0.2!3",
    "store_read=error:HTTP 429!@0.5~2",
    "watch_broadcast=crash:,cache_invalidation=crash:9",
    " checkpoint_pre_rename = crash:137 , checkpoint_post_rename=on@1 ",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_configure_arms_what_keto_tpu_arms(spec):
    jfaults.configure(spec)
    tfaults.configure(spec)
    assert tfaults.armed_names() == jfaults.armed_names()
    assert armed(tfaults) == armed(jfaults)


@pytest.mark.parametrize("spec", ["nowhere=on", "device_launch=explode:1", "store_read=stall:x"])
def test_configure_refuses_what_keto_tpu_refuses(spec):
    with pytest.raises(ValueError) as want:
        jfaults.configure(spec)
    with pytest.raises(ValueError) as got:
        tfaults.configure(spec)
    assert str(got.value) == str(want.value)


def test_inject_serves_hits_as_keto_tpu_does():
    def run(faults):
        out = []
        faults.set_fault("store_read", error="boom", max_hits=2)
        for _ in range(3):
            try:
                faults.inject("store_read")
                out.append("pass")
            except faults.FaultInjected as e:
                out.append(str(e))
        faults.set_fault("batch_corrupt", probability=0.5, seed=11)
        for _ in range(32):
            faults.inject("batch_corrupt")
        out.append(faults.get("batch_corrupt").hits)
        faults.inject("device_launch")  # disarmed: a miss
        faults.clear("store_read")
        out.append((faults.get("store_read"), faults.armed_names()))
        with pytest.raises(ValueError):
            faults.set_fault("nowhere")
        return out

    assert run(tfaults) == run(jfaults)
    assert tfaults.POINTS == jfaults.POINTS


ENV_PROBE = ("import sys, importlib\n"
             "f = importlib.import_module(sys.argv[1] + '.faults')\n"
             "print(sorted((n, f.get(n).crash, f.get(n).max_hits, f.get(n).error)"
             " for n in f.armed_names()))\n")


def test_keto_faults_parsed_at_import():
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "KETO_FAULTS": "changelog_append=crash:137!1,store_read=error:gone"}
    out = [subprocess.run([sys.executable, "-c", ENV_PROBE, pkg], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT_S).stdout
           for pkg in PKGS]
    assert out[0] == out[1] == \
        "[('changelog_append', 137, 1, None), ('store_read', None, None, 'gone')]\n"


# -- (b) the crash points ------------------------------------------------------------------


BEFORE = ["files:a#owner@alice", "files:b#owner@bob", "files:c#view@(files:a#owner)"]
INSERT, DELETE = "files:new#owner@eve", "files:a#owner@alice"

CHILD = """
import importlib, sys
pkg, path, point = sys.argv[1:4]
importlib.import_module(pkg + ".faults")  # armed from KETO_FAULTS at import
T = importlib.import_module(pkg + ".ketoapi").RelationTuple
insert, delete = [T.from_string(sys.argv[4])], [T.from_string(sys.argv[5])]
if point.startswith(("store_", "changelog_")):
    store = importlib.import_module(pkg + ".storage.sqlite").SQLitePersister(path)
    store.transact_relation_tuples(insert, delete)
else:
    Config = importlib.import_module(pkg + ".config").Config
    Registry = importlib.import_module(pkg + ".registry").Registry
    cfg = Config({"dsn": "sqlite://" + path, "check": {"engine": "host"},
                  "namespaces": [{"name": "files"}], "watch": {"poll_interval": 0.05}})
    reg = Registry(cfg, device="cpu") if pkg.endswith("_torch") else Registry(cfg)
    hub = reg.watch_hub()
    sub = hub.subscribe("default")
    reg.relation_tuple_manager().transact_relation_tuples(insert, delete)
    sub.get(timeout=30)  # the tailer's broadcast
print("survived")
"""


def postmortem(P, path):
    store = P.sqlite.SQLitePersister(path)
    try:
        present = sorted(str(t) for t in store.all_relation_tuples())
        log = [(v, op, str(t)) for v, op, t in store.changelog_since(0)]
        return {"present": present, "version": store.version(), "log": log}
    finally:
        store.close()


@pytest.mark.parametrize("point", ["store_commit_pre", "store_commit_post", "changelog_append",
                                   "cache_invalidation", "watch_broadcast"])
def test_crash_point_postmortem_equals_keto_tpu(point, tmp_path):
    got = {}
    for pkg, P in PKGS.items():
        path = str(tmp_path / f"{pkg}.sqlite")
        store = P.sqlite.SQLitePersister(path)
        for s in BEFORE:  # three acked commits
            store.write_relation_tuples([P.Tuple.from_string(s)])
        store.close()
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
               "KETO_FAULTS": f"{point}=crash:137!1"}
        proc = subprocess.run([sys.executable, "-c", CHILD, pkg, path, point, INSERT, DELETE],
                              env=env, cwd=REPO, capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S)
        assert proc.returncode == 137, (pkg, proc.stdout, proc.stderr[-2000:])
        assert "survived" not in proc.stdout
        # each package reads the other's file alike
        got[pkg] = [postmortem(R, path) for R in PKGS.values()]
        assert got[pkg][0] == got[pkg][1]
    assert got["keto_tpu_torch"] == got["keto_tpu"]
    pm = got["keto_tpu"][0]
    lost = [s for s in BEFORE[1:] if s not in pm["present"]]
    phantoms = [s for s in pm["present"] if s not in BEFORE + [INSERT]]
    assert lost == [] and phantoms == []
    committed = point not in ("store_commit_pre", "changelog_append")
    assert (INSERT in pm["present"], DELETE in pm["present"]) == (committed, not committed)
    assert pm["version"] == len(BEFORE) + committed == len({v for v, _, _ in pm["log"]})
    assert (pm["log"][-1][1:] == ("delete", DELETE)) == committed


# -- (c) store_read over REST ---------------------------------------------------------------


def test_store_read_error_rest_equals_keto_tpu_daemon():
    cfg = {"dsn": "memory", "check": {"engine": "tpu"}, "namespaces": NAMESPACES,
           "serve": LISTEN}
    treg = TRegistry(TConfig(cfg), device="cpu")
    jreg = JRegistry(JConfig({**cfg, "store": {"health": {"enabled": False}}}))
    guarded = JRegistry(JConfig(cfg))  # keto_tpu's default: the store health guard
    daemons = []
    for reg, Tuple, Daemon in ((treg, TTuple, TDaemon), (jreg, JTuple, JDaemon),
                               (guarded, JTuple, JDaemon)):
        reg.relation_tuple_manager().write_relation_tuples([Tuple.from_string(s)
                                                            for s in TUPLES])
        daemons.append(Daemon(reg))
        daemons[-1].start()
    try:
        tfaults.set_fault("store_read", error="disk gone")
        jfaults.set_fault("store_read", error="disk gone")
        params = {"namespace": "videos"}
        got = call(daemons[0].read_port, "GET", "/relation-tuples", params)
        want = call(daemons[1].read_port, "GET", "/relation-tuples", params)
        assert got == want
        assert got[:2] == (500, {"error": {"code": 500, "status": "internal_server_error",
                                           "message": "disk gone"}})
        assert call(daemons[2].read_port, "GET", "/relation-tuples", params)[0] == 503
        tfaults.clear()
        jfaults.clear()
        assert call(daemons[0].read_port, "GET", "/relation-tuples", params) == \
            call(daemons[1].read_port, "GET", "/relation-tuples", params)
    finally:
        for d in daemons:
            d.stop()


# -- (d) the engine's points ------------------------------------------------------------------


def engines():
    jcfg, tcfg = JConfig({"namespaces": NAMESPACES}), TConfig({"namespaces": NAMESPACES})
    jm, tm = JMemory(), TMemory()
    jm.write_relation_tuples([JTuple.from_string(s) for s in TUPLES])
    tm.write_relation_tuples([TTuple.from_string(s) for s in TUPLES])
    return TPUCheckEngine(jm, jcfg), TorchCheckEngine(tm, tcfg, device="cpu")


QUERIES = ["videos:/d1/v1#view@alice", "videos:/d1/v2#view@bob", "videos:/d2/v1#view@carol",
           "videos:/d2#view@alice", "groups:eng#member@carol", "videos:/d9#view@alice"]


def test_batch_corrupt_replays_every_query_as_keto_tpu_does():
    jeng, teng = engines()
    clean = [r.allowed for r in teng.check_batch([TTuple.from_string(q) for q in QUERIES])]
    assert clean == [r.allowed for r in jeng.check_batch([JTuple.from_string(q)
                                                           for q in QUERIES])]
    host0 = teng.stats["host_checks"]
    tfaults.configure("batch_corrupt=on")
    jfaults.configure("batch_corrupt=on")
    got = teng.check_batch([TTuple.from_string(q) for q in QUERIES])
    want = jeng.check_batch([JTuple.from_string(q) for q in QUERIES])
    assert [r.allowed for r in got] == [r.allowed for r in want] == clean
    assert tfaults.get("batch_corrupt").hits == jfaults.get("batch_corrupt").hits == 1
    for key in ("host_checks", "device_checks", "host_cause"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["host_checks"] - host0 == len(QUERIES)


def test_device_launch_fails_and_stalls_as_keto_tpu_does():
    jeng, teng = engines()
    tq, jq = [TTuple.from_string(QUERIES[0])], [JTuple.from_string(QUERIES[0])]
    tfaults.set_fault("device_launch", error="card gone", max_hits=1)
    jfaults.set_fault("device_launch", error="card gone", max_hits=1)
    with pytest.raises(tfaults.FaultInjected) as got:
        teng.check_batch(tq)
    with pytest.raises(jfaults.FaultInjected) as want:
        jeng.check_batch(jq)
    assert str(got.value) == str(want.value) == "card gone"
    assert teng.stats["snapshot_builds"] == 0  # before any state build
    assert teng.check_batch(tq)[0].allowed == jeng.check_batch(jq)[0].allowed  # one hit only
    tfaults.configure("device_launch=stall:0.2!1")
    t = time.monotonic()
    assert teng.check_batch(tq)[0].allowed
    assert time.monotonic() - t >= 0.2
    assert tfaults.get("device_launch").hits == 1
