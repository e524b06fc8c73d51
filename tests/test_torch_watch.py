"""The port's Watch API (keto_tpu_torch/watch and its transports) held
against keto_tpu's, on the CPU.

  (a) the hub: the same write scripts through a port WatchHub and a
      keto_tpu WatchHub over equal stores, memory and columnar, give equal
      event lists (kind, version, snaptoken, changes) and equal counts:
      every case of tests/test_watch.py's TestHubCore, one DEGRADED event
      per store outage (a stub store that raises StoreUnavailableError),
      heartbeats, and the RESET after a columnar bulk load;
  (b) the wire: a port Daemon and a keto_tpu Daemon over equal stores,
      the same requests on the threaded gRPC plane (the muxed read port),
      the aio plane (`serve.read.grpc.aio`) and SSE: equal response
      bytes, codes and details, equal HTTP status, headers (CORS among
      them) and event lines, leaving heartbeats out. A live tail, kill and
      resume, RESET on a truncated log, a token ahead, a malformed token,
      the namespace filter and the shared watcher cap;
  (c) ReadClient.watch, the port's and keto_tpu's, crossed over both
      daemons;
  (d) the registry's push invalidation through the hub pokes a built
      engine and the check cache, and builds no engine;
  (e) the closure maintainer's `_drain_events` against keto_tpu's on a
      recording index: the changes applied, a RESET marks it stale;
  (f) the durable store: tests/test_watch.py's TestRetentionTrim (the
      hub's trim guard on the SQLite changelog) and TestRestartResume (a
      cursor resumed after a restart over the same SQLite file, through
      the hub and through a daemon's SSE route), each equal to keto_tpu's.

Every wait is bounded and every stream closed. Tolerance: exact equality.
"""

import contextlib
import http.client
import json
import threading
import time
import urllib.parse

import grpc
import pytest

import keto_tpu.storage.columnar as jcol_mod
import keto_tpu.storage.memory as jmem_mod
from keto_tpu.api import client as jclient
from keto_tpu.api.daemon import Daemon as JDaemon
from keto_tpu.closure import ClosureMaintainer as JMaintainer
from keto_tpu.config import Config as JConfig
from keto_tpu.errors import StoreUnavailableError as JStoreDown
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.registry import Registry as JRegistry
from keto_tpu.storage.sqlite import SQLitePersister as JSQLite
from keto_tpu.watch import WatchHub as JHub

import keto_tpu_torch.storage.columnar as tcol_mod
import keto_tpu_torch.storage.memory as tmem_mod
from keto_tpu_torch.api import client as tclient
from keto_tpu_torch.api import descriptors as tdesc
from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.api.descriptors import pb
from keto_tpu_torch.closure import ClosureMaintainer as TMaintainer
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.snaptoken import encode_snaptoken, parse_snaptoken
from keto_tpu_torch.errors import StoreUnavailableError as TStoreDown
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage.sqlite import SQLitePersister as TSQLite
from keto_tpu_torch.watch import WatchHub as THub

from test_torch_grpc import LISTEN, small_pools

NID = "default"
WAIT_S = 10
WATCH_PATH = f"/{tdesc.WATCH_SERVICE}/Watch"
HEALTH_WATCH_PATH = f"/{tdesc.HEALTH_SERVICE}/Watch"
WATCH_ROUTE = "/relation-tuples/watch"
NAMESPACES = [
    {"name": "videos", "relations": [{"name": "owner"}]},
    {"name": "groups", "relations": [{"name": "member"}]},
]


def wait_for(cond, timeout=WAIT_S, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def vt(i, user="alice"):
    return f"videos:v{i}#owner@{user}"


def norm(e):
    return (e.kind, e.version, e.snaptoken, [(op, str(t)) for op, t in e.changes])


def drain(sub, n, timeout=WAIT_S):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        event = sub.get(timeout=max(deadline - time.monotonic(), 0.01))
        if event is not None:
            out.append(event)
    return [norm(e) for e in out]


# -- (a) the hub ----------------------------------------------------------------------


class _Metrics:
    """keto_tpu's hub counts into metric objects: these count as the
    port's hub does into `counts`."""

    def __init__(self):
        self.counts = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        counts = self.counts

        class _M:
            def inc(self, n=1):
                counts[name] = counts.get(name, 0) + n

            def dec(self, n=1):
                counts[name] = counts.get(name, 0) - n

            def set(self, v):
                pass

            def labels(self, *a):
                return self

        return _M()


class Side:
    """One package's store, hub and tuple type, for a script."""

    def __init__(self, store, hub_cls, tuple_cls, store_mod, down_error, jax, **hub_kw):
        self.m = store()
        self.T = lambda s: tuple_cls.from_string(s)
        self.store_mod = store_mod
        self.down_error = down_error
        self.jax = jax
        self.hub_cls = hub_cls
        self.metrics = _Metrics() if jax else None
        self.hub = self.make_hub(self.m, **hub_kw)

    def make_hub(self, m, **kw):
        kw.setdefault("poll_interval", 0.05)
        if self.jax:
            return self.hub_cls(m, metrics=self.metrics, **kw)
        return self.hub_cls(m, **kw)

    def write(self, *ss, nid=NID):
        self.m.write_relation_tuples([self.T(s) for s in ss], nid=nid)

    def delete(self, *ss):
        self.m.delete_relation_tuples([self.T(s) for s in ss])

    def transact(self, ins, dels):
        self.m.transact_relation_tuples([self.T(s) for s in ins], [self.T(s) for s in dels])

    def counts(self):
        c = self.metrics.counts if self.jax else self.hub.counts
        keys = ("watch_events_delivered_total", "watch_resets_total",
                "store_degraded_serves_total", "watch_streams_active")
        return {k: c.get(k, 0) for k in keys}


STORES = {
    "memory": ((tmem_mod.MemoryManager, tmem_mod), (jmem_mod.MemoryManager, jmem_mod)),
    "columnar": ((tcol_mod.ColumnarStore, tcol_mod), (jcol_mod.ColumnarStore, jcol_mod)),
}


def sides(store, **hub_kw):
    (ts, tmod), (js, jmod) = STORES[store]
    return (Side(ts, THub, TTuple, tmod, TStoreDown, False, **hub_kw),
            Side(js, JHub, JTuple, jmod, JStoreDown, True, **hub_kw))


def live_tail(s):
    sub = s.hub.subscribe(NID)
    s.write(vt(0))
    s.transact([vt(1), vt(2)], [vt(0)])
    out = drain(sub, 2)
    sub.close()
    return out


def resume_replays_exactly_once(s):
    for i in range(6):
        s.write(vt(i))
    sub = s.hub.subscribe(NID, min_version=2)
    s.write(vt(6))
    out = drain(sub, 5)
    sub.close()
    return out


def token_ahead_raises(s):
    s.write(vt(0))
    try:
        s.hub.subscribe(NID, min_version=99)
    except Exception as e:  # noqa: BLE001 - its type and text are the result
        return [type(e).__name__, e.status, str(e), e.to_dict()]
    return ["no error"]


def live_subscription_starts_at_current_version(s):
    s.write(vt(0))
    sub = s.hub.subscribe(NID)
    first = sub.get(timeout=0.2)
    s.write(vt(1))
    out = [first] + drain(sub, 1)
    sub.close()
    return out


def nid_isolation(s):
    sub = s.hub.subscribe(NID)
    s.write(vt(0), nid="tenant-b")
    s.write(vt(1))
    out = drain(sub, 1) + [sub.get(timeout=0.2)]
    sub.close()
    return out


def overflow_resets_then_resumes_live(s):
    sub = s.hub.subscribe(NID, buffer=2)
    for i in range(8):
        s.write(vt(i))
    assert wait_for(lambda: s.hub._states[NID].tail_version == 8)
    out = drain(sub, 1)
    s.write(vt(100))
    out += drain(sub, 1)
    sub.close()
    return out


def replay_larger_than_buffer_does_not_reset(s):
    for i in range(30):
        s.write(vt(i))
    sub = s.hub.subscribe(NID, min_version=0, buffer=4)
    out = drain(sub, 30)
    sub.close()
    return out


def truncated_changelog_resets_on_subscribe(s):
    for i in range(12):  # the 8-op log keeps versions 5-12
        s.write(vt(i))
    sub = s.hub.subscribe(NID, min_version=2)
    out = drain(sub, 1)
    sub.close()
    return out


def truncated_changelog_resets_live_tail(s):
    s.write(vt(0))
    sub = s.hub.subscribe(NID)
    # the tailer only polls now: the burst wraps the 8-op log between polls
    s.m._write_listeners.clear()
    for i in range(1, 12):
        s.write(vt(i))
    out = drain(sub, 1)
    sub.close()
    return out


def namespace_filter(s):
    sub = s.hub.subscribe(NID)
    s.write(vt(1))
    s.write("groups:g1#member@bob")
    events = []
    deadline = time.monotonic() + WAIT_S
    while len(events) < 2 and time.monotonic() < deadline:
        e = sub.get(timeout=0.5)
        if e is not None:
            events.append(e)
    kept = [e.filtered("groups") for e in events]
    reset = s.hub._reset_event(NID, 5)
    sub.close()
    return [None if k is None else norm(k) for k in kept] + [reset.filtered("groups") is reset]


def min_active_version_tracks_cursors(s):
    out = [s.hub.min_active_version(NID)]
    s.write(vt(0))
    sub = s.hub.subscribe(NID)
    out.append(s.hub.min_active_version(NID))
    s.write(vt(1))
    assert wait_for(lambda: s.hub._states[NID].tail_version == 2)
    out.append(s.hub.min_active_version(NID))
    out += drain(sub, 1)
    out.append(s.hub.min_active_version(NID))
    sub.close()
    out.append(s.hub.min_active_version(NID))
    return out


def stop_closes_subscribers(s):
    sub = s.hub.subscribe(NID)
    s.hub.stop()
    out = [sub.closed, sub.get(timeout=0.1)]
    try:
        s.hub.subscribe(NID)
    except RuntimeError as e:
        out.append(str(e))
    return out


class _FlakyStore:
    """A store whose version and change-log reads raise the package's
    StoreUnavailableError while `down`."""

    def __init__(self, m, err):
        self._m, self._err, self.down = m, err, False

    def version(self, nid=NID):
        if self.down:
            raise self._err("store down")
        return self._m.version(nid=nid)

    def changelog_since(self, version, nid=NID):
        if self.down:
            raise self._err("store down")
        return self._m.changelog_since(version, nid=nid)

    def add_write_listener(self, fn):
        self._m.add_write_listener(fn)


def degraded_once_per_outage(s):
    flaky = _FlakyStore(s.m, s.down_error)
    s.hub = s.make_hub(flaky)
    sub = s.hub.subscribe(NID)
    s.write(vt(0))
    out = drain(sub, 1)
    flaky.down = True
    out += drain(sub, 1)
    time.sleep(0.3)  # six more polls, still down: no second marker
    out.append(sub.get(timeout=0.05))
    flaky.down = False
    s.write(vt(1))
    out += drain(sub, 1)
    flaky.down = True  # a second episode, a second marker
    out += drain(sub, 1)
    flaky.down = False
    sub.close()
    return out


def heartbeats(s):
    s.hub = s.make_hub(s.m, heartbeat_s=0.1)
    s.write(vt(0))
    sub = s.hub.subscribe(NID)
    out = drain(sub, 1)  # an idle tail: a heartbeat at the current version
    s.write(vt(1))
    events = []
    deadline = time.monotonic() + WAIT_S
    while not any(e[0] == "change" for e in events) and time.monotonic() < deadline:
        events += drain(sub, 1)
    sub.close()
    # how many heartbeats precede the change is timing; what they carry is not
    return out + [e for e in events if e[0] == "change"]


def bulk_load_resets_live_tail(s):
    s.write(vt(0))
    sub = s.hub.subscribe(NID)
    cols = s.store_mod.TupleColumns.from_tuples([s.T(vt(i, "bulk")) for i in range(5)])
    s.m.bulk_load(cols)
    out = drain(sub, 1)
    s.write(vt(9))
    out += drain(sub, 1)
    sub.close()
    return out


SCRIPTS = {f.__name__: f for f in (
    live_tail, resume_replays_exactly_once, token_ahead_raises,
    live_subscription_starts_at_current_version, nid_isolation,
    overflow_resets_then_resumes_live, replay_larger_than_buffer_does_not_reset,
    truncated_changelog_resets_on_subscribe, truncated_changelog_resets_live_tail,
    namespace_filter, min_active_version_tracks_cursors, stop_closes_subscribers,
    degraded_once_per_outage, heartbeats,
)}
TRUNCATING = ("truncated_changelog_resets_on_subscribe", "truncated_changelog_resets_live_tail")


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_hub_events_equal_keto_tpu(store, script, monkeypatch):
    if script in TRUNCATING:
        for (_cls, mod) in STORES[store]:
            monkeypatch.setattr(mod, "CHANGE_LOG_CAP", 8)
    t, j = sides(store)
    try:
        got, want = SCRIPTS[script](t), SCRIPTS[script](j)
        assert got == want
        assert t.counts() == j.counts()
    finally:
        t.hub.stop()
        j.hub.stop()
    kinds = [e[0] for e in got if isinstance(e, tuple)]
    if script in TRUNCATING or script == "overflow_resets_then_resumes_live":
        assert kinds[0] == "reset"
    if script == "degraded_once_per_outage":
        assert kinds == ["change", "degraded", "change", "degraded"]
    if script == "heartbeats":
        assert kinds == ["heartbeat", "change"]


def test_columnar_bulk_load_resets_live_tail():
    t, j = sides("columnar")
    try:
        got, want = bulk_load_resets_live_tail(t), bulk_load_resets_live_tail(j)
    finally:
        t.hub.stop()
        j.hub.stop()
    assert got == want
    assert [e[0] for e in got] == ["reset", "change"]


# -- (b) the wire -------------------------------------------------------------------


def _cfg(serve=None, watch=None):
    read = {**LISTEN["read"], "grpc": {"host": "127.0.0.1", "port": 0, "aio": True}}
    serve = dict(serve or {})
    read.update(serve.pop("read", {}))
    return {"dsn": "memory", "check": {"engine": "host"}, "namespaces": NAMESPACES,
            "serve": {**LISTEN, "read": read, **serve},
            "watch": {"poll_interval": 0.05, **(watch or {})}}


class Pair:
    """A port and a keto_tpu daemon over equal stores; writes go to both
    stores, in one order."""

    def __init__(self, **kw):
        cfg = _cfg(**kw)
        self.treg, self.jreg = TRegistry(TConfig(cfg), device="cpu"), JRegistry(JConfig(cfg))
        self.tm, self.jm = self.treg.relation_tuple_manager(), self.jreg.relation_tuple_manager()
        self.t, self.j = TDaemon(self.treg), JDaemon(self.jreg)
        with small_pools():
            self.t.start()
            self.j.start()
        self.daemons = (self.t, self.j)

    def write(self, *ss):
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in ss])
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in ss])

    def delete(self, *ss):
        self.tm.delete_relation_tuples([TTuple.from_string(s) for s in ss])
        self.jm.delete_relation_tuples([JTuple.from_string(s) for s in ss])

    def version(self):
        v = self.tm.version(nid=NID)
        assert v == self.jm.version(nid=NID)
        return v

    def token(self, v=None):
        return encode_snaptoken(self.version() if v is None else v, NID)

    def subs(self):
        return [len(d.registry.watch_hub()._states[NID].subs)
                if NID in d.registry.watch_hub()._states else 0 for d in self.daemons]

    def stop(self):
        self.t.stop(grace=1.0)
        self.j.stop(grace=1.0)


@pytest.fixture(scope="module")
def pair():
    p = Pair(serve={"read": {"cors": {"enabled": True,
                                      "allowed_origins": ["https://app.example"]}}})
    yield p
    p.stop()


def grpc_port(daemon, plane):
    return daemon.read_port if plane == "grpc" else daemon.read_grpc_port


class Stream:
    """One raw Watch call: the response bytes, heartbeats left out."""

    def __init__(self, port, snaptoken="", namespace="", timeout=WAIT_S):
        self.ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        req = pb.WatchRequest(snaptoken=snaptoken, namespace=namespace)
        self.call = self.ch.unary_stream(WATCH_PATH)(req.SerializeToString(), timeout=timeout)

    def take(self, n):
        """(code, frames, details) after n frames or the end of the call."""
        frames = []
        try:
            while len(frames) < n:
                raw = next(self.call)
                if pb.WatchResponse.FromString(raw).event_type != "heartbeat":
                    frames.append(raw)
            return "OK", frames, ""
        except StopIteration:
            return "END", frames, ""
        except grpc.RpcError as e:
            return e.code().name, frames, e.details()

    def close(self):
        self.call.cancel()
        self.ch.close()


@contextlib.contextmanager
def streams(pair, plane, **kw):
    ss = [Stream(grpc_port(d, plane), **kw) for d in pair.daemons]
    try:
        yield ss
    finally:
        for s in ss:
            s.close()


class SSEOpen:
    """An SSE request whose headers arrived (so it has subscribed), read
    to its end later."""

    def __init__(self, port, params, headers=None):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        self.conn.request("GET", WATCH_ROUTE + "?" + urllib.parse.urlencode(params),
                          headers=headers or {})
        self.resp = self.conn.getresponse()

    def finish(self, timeout=WAIT_S):
        """(status, headers, lines) once the server ends the response:
        comments (the keep-alives), blank lines, Date and Server left out.
        A stream still open after `timeout` fails the test (the keep-alives
        would keep a plain read waiting for ever)."""
        deadline = time.monotonic() + timeout
        lines = []
        try:
            hdrs = {k.lower(): v for k, v in self.resp.getheaders()
                    if k.lower() not in ("date", "server")}
            while True:
                assert time.monotonic() < deadline, "the SSE stream did not end"
                line = self.resp.readline()
                if not line:
                    break
                line = line.decode().rstrip("\n")
                if line and not line.startswith(":"):
                    lines.append(line)
        finally:
            self.conn.close()
        return self.resp.status, hdrs, lines


def sse(port, params, headers=None):
    """One SSE request read to its end, as SSEOpen.finish."""
    return SSEOpen(port, params, headers).finish()


def changelog_frames(pair, since):
    """The port store's change log since `since`, as the WatchResponse
    bytes one event a version makes."""
    by_v: dict = {}
    for v, op, t in pair.tm.changelog_since(since, nid=NID):
        by_v.setdefault(v, []).append((op, t))
    out = []
    for v, changes in by_v.items():
        resp = pb.WatchResponse(event_type="change", snaptoken=encode_snaptoken(v, NID))
        for op, t in changes:
            c = resp.changes.add()
            c.action = op
            c.relation_tuple.namespace = t.namespace
            c.relation_tuple.object = t.object
            c.relation_tuple.relation = t.relation
            c.relation_tuple.subject.id = t.subject_id
        out.append(resp.SerializeToString())
    return out


GRPC_PLANES = ("grpc", "aio")


@pytest.mark.parametrize("plane", GRPC_PLANES)
def test_grpc_live_tail_equals_keto_tpu(pair, plane):
    v0 = pair.version()
    before = pair.subs()
    with streams(pair, plane) as (ts, js):
        assert wait_for(lambda: all(a > b for a, b in zip(pair.subs(), before)))
        user = f"live-{plane}"
        pair.write(vt(0, user))
        pair.write(vt(1, user), f"groups:g1#member@{user}")
        pair.delete(vt(0, user))
        got, want = ts.take(3), js.take(3)
    assert got == want and got[0] == "OK"
    assert got[1] == changelog_frames(pair, v0)


def test_sse_live_tail_equals_keto_tpu(pair):
    v0 = pair.version()
    origin = {"Origin": "https://app.example"}
    opened = [SSEOpen(d.read_port, {"max_events": 3}, origin) for d in pair.daemons]
    pair.write(vt(0, "sselive"))
    pair.write(vt(1, "sselive"), "groups:g2#member@sselive")
    pair.delete(vt(0, "sselive"))
    got, want = [o.finish() for o in opened]
    assert got == want
    status, hdrs, lines = got
    assert status == 200 and hdrs["content-type"] == "text/event-stream"
    assert hdrs["access-control-allow-origin"] == "https://app.example"
    assert [ln for ln in lines if ln.startswith("event: ")] == ["event: change"] * 3
    data = [json.loads(ln[len("data: "):]) for ln in lines if ln.startswith("data: ")]
    assert [parse_snaptoken(d["snaptoken"], NID) for d in data] == [v0 + 1, v0 + 2, v0 + 3]


@pytest.mark.parametrize("plane", GRPC_PLANES + ("sse",))
def test_kill_and_resume_equals_keto_tpu(pair, plane):
    """Sessions that each take a few events from the last token and leave:
    no gap, no duplicate, the store's change log, on both daemons."""
    v0 = pair.version()
    rng = __import__("random").Random(25)
    for k in range(12):
        if rng.random() < 0.3:
            pair.delete(vt(rng.randrange(6), "resume"))
        else:
            pair.write(vt(rng.randrange(6), "resume"))
    last = [v0, v0]
    frames = [[], []]
    while min(last) < pair.version():
        n = rng.randrange(1, 4)
        for side, d in enumerate(pair.daemons):
            if plane == "sse":
                status, _h, lines = sse(d.read_port, {
                    "snaptoken": encode_snaptoken(last[side], NID),
                    "max_events": min(n, pair.version() - last[side])})
                assert status == 200
                for ln in lines:
                    if ln.startswith("data: "):
                        frames[side].append(ln)
                        last[side] = parse_snaptoken(json.loads(ln[6:])["snaptoken"], NID)
            else:
                s = Stream(grpc_port(d, plane), snaptoken=encode_snaptoken(last[side], NID))
                try:
                    _code, got, _d = s.take(min(n, pair.version() - last[side]))
                finally:
                    s.close()  # killed mid-stream
                for raw in got:
                    frames[side].append(raw)
                    last[side] = parse_snaptoken(pb.WatchResponse.FromString(raw).snaptoken, NID)
        assert last[0] == last[1]
    assert frames[0] == frames[1]
    if plane != "sse":
        assert frames[0] == changelog_frames(pair, v0)
    assert len(frames[0]) == pair.version() - v0


def test_reset_on_truncated_log_equals_keto_tpu():
    p = Pair()
    try:
        p.write(vt(0, "trunc"))
        old = p.token()
        p.write(vt(1, "trunc"))
        p.delete(vt(0, "trunc"))
        current = p.version()
        # pad both logs at the current version: they no longer reach `old`
        for m in (p.tm, p.jm):
            net = m._networks[NID]
            with m._lock:
                net.log.extend((current, "pad", None) for _ in range(net.log.maxlen or 0))
        for plane in GRPC_PLANES:
            with streams(p, plane, snaptoken=old) as (ts, js):
                got, want = ts.take(1), js.take(1)
            assert got == want and got[0] == "OK", plane
            first = pb.WatchResponse.FromString(got[1][0])
            assert first.event_type == "reset" and not first.changes
            assert parse_snaptoken(first.snaptoken, NID) == current
        got, want = (sse(d.read_port, {"snaptoken": old, "max_events": 1}) for d in p.daemons)
        assert got == want and got[2][0] == "event: reset"
    finally:
        p.stop()


BAD_REQUESTS = {
    "token_ahead": {"snaptoken": encode_snaptoken(10**9, NID)},
    "malformed_token": {"snaptoken": "zzzz_not_a_token"},
    "other_network": {"snaptoken": encode_snaptoken(1, "tenant-b")},
    "unknown_namespace": {"namespace": "ghost"},
    "bad_max_events": {"max_events": "many"},
}


@pytest.mark.parametrize("plane,case", [
    (plane, case) for plane in GRPC_PLANES + ("sse",) for case in sorted(BAD_REQUESTS)
    if plane == "sse" or case != "bad_max_events"])  # max_events is SSE's alone
def test_bad_requests_equal_keto_tpu(pair, plane, case):
    params = BAD_REQUESTS[case]
    if plane == "sse":
        got, want = (sse(d.read_port, params) for d in pair.daemons)
        assert got == want
        expect = {"token_ahead": 409, "unknown_namespace": 404}.get(case, 400)
        assert got[0] == expect
        return
    with streams(pair, plane, **params) as (ts, js):
        got, want = ts.take(1), js.take(1)
    assert got == want
    expect = {"token_ahead": "FAILED_PRECONDITION", "unknown_namespace": "NOT_FOUND"}
    assert got[0] == expect.get(case, "INVALID_ARGUMENT")


@pytest.mark.parametrize("plane", GRPC_PLANES + ("sse",))
def test_namespace_filter_equals_keto_tpu(pair, plane):
    v0 = pair.version()
    user = f"filter-{plane}"
    pair.write(vt(50, user))
    pair.write(f"groups:g9#member@{user}", vt(51, user))
    pair.write(vt(52, user))
    pair.write(f"groups:g8#member@{user}")
    token = encode_snaptoken(v0, NID)
    if plane == "sse":
        got, want = (sse(d.read_port, {"snaptoken": token, "namespace": "groups",
                                       "max_events": 2}) for d in pair.daemons)
        assert got == want
        data = [json.loads(ln[6:]) for ln in got[2] if ln.startswith("data: ")]
        assert [[c["relation_tuple"]["object"] for c in d["changes"]] for d in data] == \
            [["g9"], ["g8"]]
        return
    with streams(pair, plane, snaptoken=token, namespace="groups") as (ts, js):
        got, want = ts.take(2), js.take(2)
    assert got == want and got[0] == "OK"
    objs = [[c.relation_tuple.object for c in pb.WatchResponse.FromString(r).changes]
            for r in got[1]]
    assert objs == [["g9"], ["g8"]]


def test_watcher_cap_equals_keto_tpu():
    """serve.read.grpc.max_watchers 1: a tuple Watch holds the gRPC
    server's one slot, so a second Watch and a Health Watch are refused;
    each REST listener has a pool of its own."""
    p = Pair(serve={"read": {"grpc": {"max_watchers": 1}}})
    try:
        for plane in GRPC_PLANES:
            # the last plane's streams leave once their handlers see it
            assert wait_for(lambda: p.subs() == [0, 0])
            with streams(p, plane) as first:
                assert wait_for(lambda: p.subs() == [1, 1])
                with streams(p, plane) as (ts, js):
                    got, want = ts.take(1), js.take(1)
                assert got == want == ("RESOURCE_EXHAUSTED", [], "too many concurrent watchers")
                health = []
                for d in p.daemons:
                    with grpc.insecure_channel(f"127.0.0.1:{grpc_port(d, plane)}") as ch:
                        call = ch.unary_stream(HEALTH_WATCH_PATH)(
                            pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
                        try:
                            next(call)
                            health.append("OK")
                        except grpc.RpcError as e:
                            health.append((e.code().name, e.details()))
                        finally:
                            call.cancel()
                assert health[0] == health[1] == \
                    ("RESOURCE_EXHAUSTED", "too many concurrent health watchers")
                assert len(first) == 2
        opened = [SSEOpen(d.read_port, {"max_events": 1}) for d in p.daemons]
        got, want = (sse(d.read_port, {"max_events": 1}) for d in p.daemons)
        assert got == want and got[0] == 429
        assert json.loads(got[2][0])["error"]["message"] == "too many concurrent watchers"
        p.write(vt(0, "cap"))
        a, b = [o.finish() for o in opened]
        assert a == b and a[0] == 200
    finally:
        p.stop()


def test_drain_ends_every_stream():
    """The daemon's stop ends the open streams of all three planes: the
    hub closes their subscriptions."""
    p = Pair()
    t_streams = [Stream(grpc_port(p.t, plane)) for plane in GRPC_PLANES]
    opened = SSEOpen(p.t.read_port, {})
    try:
        assert wait_for(lambda: p.subs()[0] == 3)
        start = time.monotonic()
        p.t.stop(grace=1.0)
        for s in t_streams:
            code, frames, _ = s.take(1)
            assert code in ("END", "CANCELLED", "UNAVAILABLE") and frames == []
        status, _h, lines = opened.finish()
        assert status == 200 and lines == []
        assert time.monotonic() - start < WAIT_S
    finally:
        for s in t_streams:
            s.close()
        p.j.stop(grace=1.0)


# -- (c) the clients ------------------------------------------------------------------


def _client_events(events):
    return [(e.event_type, e.snaptoken, [(op, str(t)) for op, t in e.changes])
            for e in events]


def test_read_client_watch_crossed(pair):
    v0 = pair.version()
    pair.write(vt(70, "client"), vt(71, "client"))
    pair.delete(vt(70, "client"))
    token = encode_snaptoken(v0, NID)
    results = []
    for client_mod in (tclient, jclient):
        for d in pair.daemons:
            c = client_mod.ReadClient(client_mod.open_channel(f"127.0.0.1:{d.read_port}"))
            try:
                results.append(_client_events(c.watch(snaptoken=token, max_events=2,
                                                      timeout=WAIT_S)))
            finally:
                c.close()
    assert all(r == results[0] for r in results)
    assert [(k, parse_snaptoken(tok, NID)) for k, tok, _c in results[0]] == \
        [("change", v0 + 1), ("change", v0 + 2)]
    assert results[0][0][2] == [("insert", vt(70, "client")), ("insert", vt(71, "client"))]


def test_read_client_watch_heartbeats():
    """With watch.heartbeat_s, an idle stream sends heartbeat frames: the
    client drops them, or yields them with no changes when asked; they
    never count toward max_events."""
    p = Pair(watch={"heartbeat_s": 0.2})
    try:
        out, heartbeats = [], 0
        for client_mod in (tclient, jclient):
            c = client_mod.ReadClient(client_mod.open_channel(f"127.0.0.1:{p.t.read_port}"))
            try:
                # from the token before the write: a stream that opens late
                # still replays it
                token = p.token()
                writer = threading.Timer(1.2, p.write, args=(vt(len(out), "hb"),))
                writer.start()
                events = list(c.watch(snaptoken=token, max_events=1, yield_heartbeats=True,
                                      timeout=WAIT_S))
                writer.join()
                kinds = [e.event_type for e in events]
                assert kinds[-1] == "change" and set(kinds[:-1]) <= {"heartbeat"}
                assert all(e.changes == [] for e in events[:-1])
                heartbeats += len(kinds) - 1
                out.append((kinds[-1], len(events[-1].changes)))
                token = p.token()
                writer = threading.Timer(0.5, p.write, args=(vt(10 + len(out), "hb"),))
                writer.start()
                quiet = list(c.watch(snaptoken=token, max_events=1, timeout=WAIT_S))
                writer.join()
                assert [e.event_type for e in quiet] == ["change"]
            finally:
                c.close()
        assert out[0] == out[1] and heartbeats >= 1
    finally:
        p.stop()


# -- (d) push invalidation --------------------------------------------------------------


def test_hub_commit_pokes_built_engine_and_cache():
    cfg = TConfig({"dsn": "memory", "check": {"engine": "torch"}, "namespaces": NAMESPACES})
    reg = TRegistry(cfg, device="cpu")
    m = reg.relation_tuple_manager()
    m.write_relation_tuples([TTuple.from_string(vt(0))])
    engine = reg.check_engine()
    v0 = engine.ensure_state().covered_version
    cache = reg.check_cache()
    try:
        m.write_relation_tuples([TTuple.from_string(vt(1))])
        m.write_relation_tuples([TTuple.from_string(vt(2))])
        # the mirror moves with no check: the hub's commit listener woke
        # the engine's refresh thread
        assert wait_for(lambda: engine._state.covered_version >= v0 + 2)
        assert engine.stats["push_refreshes"] >= 1
        assert wait_for(lambda: cache._inval_versions.get(NID) == m.version(nid=NID))
    finally:
        engine.stop_push_refresh()
        reg.close_check_cache()


def test_hub_commit_builds_no_engine():
    reg = TRegistry(TConfig({"dsn": "memory", "namespaces": NAMESPACES}), device="cpu")
    hub = reg.watch_hub()
    assert reg.relation_tuple_manager()._write_listeners == [hub.notify]
    reg.relation_tuple_manager().write_relation_tuples([TTuple.from_string(vt(0))])
    reg.relation_tuple_manager().write_relation_tuples([TTuple.from_string(vt(1))],
                                                       nid="tenant-z")
    time.sleep(0.1)
    assert reg.built_engines() == {} and reg._engine is None


# -- (e) the closure maintainer's drain ---------------------------------------------------


class _RecordingIndex:
    def __init__(self):
        self.calls = []

    def apply_changes(self, changes, version):
        self.calls.append(("apply", version, [(op, str(t)) for op, t in changes]))
        return True

    def mark_stale(self):
        self.calls.append(("stale",))


def test_maintainer_drain_equals_keto_tpu():
    cfg = {"dsn": "memory", "namespaces": NAMESPACES, "watch": {"buffer": 2,
                                                                  "poll_interval": 0.05}}
    treg, jreg = TRegistry(TConfig(cfg), device="cpu"), JRegistry(JConfig(cfg))
    regs = ((treg, TMaintainer, TTuple), (jreg, JMaintainer, JTuple))
    out = []
    for reg, maint_cls, T in regs:
        hub = reg.watch_hub()
        m = reg.relation_tuple_manager()
        maint, idx = maint_cls(reg), _RecordingIndex()
        try:
            applied = [maint._drain_events(NID, idx)]  # subscribes, live
            m.write_relation_tuples([T.from_string(vt(0)), T.from_string(vt(1))])
            m.delete_relation_tuples([T.from_string(vt(0))])
            assert wait_for(lambda: hub._states[NID].tail_version == m.version(nid=NID))
            applied.append(maint._drain_events(NID, idx))
            # past the 2-event ring: the next drain meets a RESET
            for i in range(5):
                m.write_relation_tuples([T.from_string(vt(10 + i))])
            assert wait_for(lambda: hub._states[NID].tail_version == m.version(nid=NID))
            applied.append(maint._drain_events(NID, idx))
            m.write_relation_tuples([T.from_string(vt(20))])
            assert wait_for(lambda: hub._states[NID].tail_version == m.version(nid=NID))
            applied.append(maint._drain_events(NID, idx))
            out.append((applied, idx.calls, dict(maint.stats)))
        finally:
            maint.stop()
            hub.stop()
    assert out[0] == out[1]
    applied, calls, stats = out[0]
    assert applied == [0, 3, 0, 1]
    assert [c[0] for c in calls] == ["apply", "apply", "stale", "apply"]
    assert stats["events"] == 4 and stats["resets"] == 1


# -- (f) the durable store: retention trim and restart resume ---------------------------


def _log_rows(p):
    return p._conn.execute("SELECT COUNT(*) FROM keto_change_log").fetchone()[0]


def _sqlite_side(jax):
    """A SQLite persister of one package, its hub class and tuple type."""
    if jax:
        return JSQLite("memory"), JHub, JTuple
    return TSQLite("memory"), THub, TTuple


def trim_active_cursor_pins_rows(jax):
    p, Hub, T = _sqlite_side(jax)
    p.CHANGE_LOG_CAP = 8
    hub = Hub(p, poll_interval=0.05)
    sub = hub.subscribe(NID)  # cursor at version 0
    try:
        for i in range(20):
            p.write_relation_tuples([T.from_string(vt(i))])
        out = [_log_rows(p), len(p.changelog_since(0, nid=NID))]
        assert out == [20, 20]  # the guard (cursor 0) holds every row
        out.append(drain(sub, 20))
        assert sub.cursor == 20
        p.write_relation_tuples([T.from_string(vt(100))])
        out.append(_log_rows(p))
        assert out[-1] <= p.CHANGE_LOG_CAP + 1
        return out
    finally:
        sub.close()
        hub.stop()


def trim_no_cursor_at_soft_cap(jax):
    p, Hub, T = _sqlite_side(jax)
    p.CHANGE_LOG_CAP = 8
    hub = Hub(p, poll_interval=0.05)  # the guard wired, nobody subscribed
    try:
        for i in range(20):
            p.write_relation_tuples([T.from_string(vt(i))])
        assert _log_rows(p) <= 9
        return _log_rows(p)
    finally:
        hub.stop()


def trim_stuck_cursor_bounded_by_hard_cap(jax):
    p, Hub, T = _sqlite_side(jax)
    p.CHANGE_LOG_CAP = 4
    hub = Hub(p, poll_interval=0.05)
    sub = hub.subscribe(NID)  # never reads: its cursor stays at 0
    try:
        for i in range(40):
            p.write_relation_tuples([T.from_string(vt(i))])
        rows = _log_rows(p)
        assert rows <= p.CHANGE_LOG_CAP * p.CHANGE_LOG_HARD_FACTOR + 1
        sub2 = hub.subscribe(NID, min_version=1)
        try:
            event = sub2.get(timeout=WAIT_S)
            assert event.is_reset
            return rows, norm(event)
        finally:
            sub2.close()
    finally:
        sub.close()
        hub.stop()


def trim_broken_guard_never_fails_writes(jax):
    p, _Hub, T = _sqlite_side(jax)
    p.set_trim_guard(lambda nid: 1 / 0)
    p.write_relation_tuples([T.from_string(vt(0))])
    assert p.version(nid=NID) == 1
    return p.version(nid=NID), _log_rows(p)


RETENTION = {f.__name__: f for f in (
    trim_active_cursor_pins_rows, trim_no_cursor_at_soft_cap,
    trim_stuck_cursor_bounded_by_hard_cap, trim_broken_guard_never_fails_writes)}


@pytest.mark.parametrize("script", sorted(RETENTION))
def test_retention_trim_equals_keto_tpu(script):
    """tests/test_watch.py's TestRetentionTrim on each package's SQLite
    store and hub: the hub's trim guard keeps what an open cursor needs,
    a stuck cursor is bounded by the hard cap and gets a RESET."""
    assert RETENTION[script](False) == RETENTION[script](True)


def _file_registry(jax, path):
    cfg = {"dsn": f"sqlite://{path}", "check": {"engine": "host"}, "namespaces": NAMESPACES,
           "serve": LISTEN, "watch": {"poll_interval": 0.05}}
    if jax:
        return JRegistry(JConfig(cfg)), JTuple
    return TRegistry(TConfig(cfg), device="cpu"), TTuple


def hub_resume_across_reopen(jax, path):
    # "process 1": write, watch, consume a prefix, die without handing
    # anything over; only the file remains
    reg1, T = _file_registry(jax, path)
    m1, hub1 = reg1.relation_tuple_manager(), reg1.watch_hub()
    sub = hub1.subscribe(NID)
    for i in range(4):  # versions 1..4
        m1.write_relation_tuples([T.from_string(vt(i))])
    m1.delete_relation_tuples([T.from_string(vt(1))])  # version 5
    consumed = drain(sub, 3)
    assert [e[1] for e in consumed] == [1, 2, 3]
    cursor = consumed[-1][1]
    m1.write_relation_tuples([T.from_string(vt(9, "late"))])  # version 6, never read
    hub1.stop()
    m1.close()
    # "process 2" over the same file resumes at the cursor
    reg2, T = _file_registry(jax, path)
    m2, hub2 = reg2.relation_tuple_manager(), reg2.watch_hub()
    try:
        sub2 = hub2.subscribe(NID, min_version=cursor)
        m2.write_relation_tuples([T.from_string(vt(10, "after-restart"))])  # version 7
        events = drain(sub2, 4)
        assert [e[0] for e in events] == ["change"] * 4
        assert [e[1] for e in events] == [4, 5, 6, 7]
        log = [(v, op, str(t)) for v, op, t in m2.changelog_since(cursor, nid=NID)]
        assert [(e[1], op, t) for e in events for op, t in e[3]] == log
        return consumed, events
    finally:
        hub2.stop()
        m2.close()


def daemon_sse_resume_across_restart(jax, path):
    def make():
        reg, T = _file_registry(jax, path)
        d = (JDaemon if jax else TDaemon)(reg)
        with small_pools():
            d.start()
        return d, T

    def read(port, token, n):
        _status, _h, lines = sse(port, {"snaptoken": token, "max_events": n})
        return [json.loads(ln[len("data: "):]) for ln in lines if ln.startswith("data: ")]

    d1, T = make()
    try:
        m = d1.registry.relation_tuple_manager()
        for i in range(3):  # versions 1..3
            m.write_relation_tuples([T.from_string(vt(i))])
        first = read(d1.read_port, encode_snaptoken(0, NID), 2)
        cursor_token = first[-1]["snaptoken"]
        assert parse_snaptoken(cursor_token, NID) == 2
    finally:
        d1.stop(grace=1.0)
    d1.registry.relation_tuple_manager().close()
    d2, T = make()  # a restart over the same file
    try:
        d2.registry.relation_tuple_manager().write_relation_tuples(
            [T.from_string(vt(7, "post-restart"))])
        events = read(d2.read_port, cursor_token, 2)
        assert [parse_snaptoken(e["snaptoken"], NID) for e in events] == [3, 4]
        assert all(e["event_type"] == "change" for e in events)
        return first, events
    finally:
        d2.stop(grace=1.0)


@pytest.mark.parametrize("script", [hub_resume_across_reopen, daemon_sse_resume_across_restart],
                         ids=lambda f: f.__name__)
def test_restart_resume_equals_keto_tpu(script, tmp_path):
    """tests/test_watch.py's TestRestartResume on each package over a
    SQLite file: the cursor resumed after the first process is gone sees
    every change after it once, in version order, and the events equal
    keto_tpu's."""
    got = script(False, str(tmp_path / "port.sqlite"))
    want = script(True, str(tmp_path / "jax.sqlite"))
    assert got == want
