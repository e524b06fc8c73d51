"""The port's Daemon (keto_tpu_torch/api/daemon.py) held against a keto_tpu
Daemon over the same store: for each request the status, the JSON body
and the headers (all but Server and Date) are equal. Covered: single
checks missing and then hitting the check cache, with snaptokens;
check/batch; GET /relation-tuples page by page; /version and the health
routes; a malformed x-request-timeout-ms; and on a gated stub engine a
429 with Retry-After at serve.check.max_queue 1, a 504 on
x-request-timeout-ms, and /health/ready turning to 503 during a drain
while an admitted check is still answered.

Every wait is bounded. Tolerance: exact equality.
"""

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from keto_tpu.api.daemon import Daemon as JDaemon
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.definitions import RESULT_IS_MEMBER as J_MEMBER
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.registry import Registry as JRegistry

from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.definitions import RESULT_IS_MEMBER as T_MEMBER
from keto_tpu_torch.engine.snaptoken import encode_snaptoken
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.registry import Registry as TRegistry

from test_torch_snaptoken import NAMESPACES, TUPLES

WAIT_S = 30
NID = "default"
LISTEN = {"read": {"host": "127.0.0.1", "port": 0}, "write": {"host": "127.0.0.1", "port": 0},
          "metrics": {"host": "127.0.0.1", "port": 0}}


def call(port, method, path, params=None, body=None, headers=None):
    """(status, JSON body, headers but Server and Date)."""
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            status, payload, hdrs = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, payload, hdrs = e.code, e.read(), e.headers
    kept = {k: v for k, v in hdrs.items() if k not in ("Server", "Date")}
    return status, json.loads(payload) if payload else None, kept


def make_pair(serve_check=None, engines=None, tuples=TUPLES):
    """A port and a keto_tpu daemon over equal stores; `engines` (port,
    keto_tpu) serve in place of each registry's own."""
    cfg = {"dsn": "memory", "check": {"engine": "tpu"}, "namespaces": NAMESPACES,
           "serve": {**LISTEN, **({"check": serve_check} if serve_check else {})}}
    treg = TRegistry(TConfig(cfg), device="cpu", engine=engines[0] if engines else None)
    jreg = JRegistry(JConfig(cfg))
    treg.relation_tuple_manager().write_relation_tuples(
        [TTuple.from_string(s) for s in tuples])
    jreg.relation_tuple_manager().write_relation_tuples(
        [JTuple.from_string(s) for s in tuples])
    if engines is not None:
        jreg._engine = engines[1]  # keto_tpu's Registry takes no engine
    tdaemon, jdaemon = TDaemon(treg), JDaemon(jreg)
    tdaemon.start()
    jdaemon.start()
    return tdaemon, jdaemon


@pytest.fixture(scope="module")
def daemons():
    tdaemon, jdaemon = make_pair()
    yield tdaemon, jdaemon
    tdaemon.stop()
    jdaemon.stop()


CHECK = {"namespace": "videos", "object": "/d1/v2", "relation": "view", "subject_id": "alice"}
TOKEN = encode_snaptoken(1, NID)
REQUESTS = {
    "check_miss_then_hit": [("GET", "/relation-tuples/check", CHECK, None)] * 2,
    "check_denied_twice": [("GET", "/relation-tuples/check",
                            {**CHECK, "subject_id": "bob"}, None)] * 2,
    "check_with_token": [("GET", "/relation-tuples/check",
                          {**CHECK, "object": "/d2/v1", "subject_id": "carol",
                           "snaptoken": TOKEN}, None)] * 2,
    "check_token_ahead": [("GET", "/relation-tuples/check",
                           {**CHECK, "snaptoken": encode_snaptoken(9, NID)}, None)],
    "check_post_and_openapi": [("POST", "/relation-tuples/check", None, CHECK),
                               ("GET", "/relation-tuples/check/openapi",
                                {**CHECK, "subject_id": "bob"}, None)],
    "check_unknown_namespace": [("GET", "/relation-tuples/check",
                                 {**CHECK, "namespace": "ghost"}, None)],
    "check_bad_timeout_header": [("GET", "/relation-tuples/check", CHECK, None,
                                  {"x-request-timeout-ms": "soon"})],
    "check_batch": [("POST", "/relation-tuples/check/batch", None, {"tuples": [
        CHECK, {**CHECK, "subject_id": "bob"}, {**CHECK, "namespace": "ghost"}],
        "snaptoken": TOKEN})],
    "list_tuples_all": [("GET", "/relation-tuples", {}, None)],
    "list_tuples_query": [("GET", "/relation-tuples",
                           {"namespace": "videos", "relation": "owner"}, None)],
    "list_tuples_unknown_namespace": [("GET", "/relation-tuples", {"namespace": "ghost"},
                                       None)],
    "list_tuples_bad_token": [("GET", "/relation-tuples",
                               {"namespace": "videos", "page_token": "junk"}, None)],
    "version": [("GET", "/version", None, None)],
    "health": [("GET", "/health/alive", None, None), ("GET", "/health/ready", None, None)],
    "no_route": [("GET", "/nowhere", None, None)],
}


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_read_routes_equal_keto_tpu_daemon(daemons, case):
    tdaemon, jdaemon = daemons
    for req in REQUESTS[case]:
        method, path, params, body, *headers = req
        headers = headers[0] if headers else None
        got = call(tdaemon.read_port, method, path, params, body, headers)
        want = call(jdaemon.read_port, method, path, params, body, headers)
        assert got == want, (case, req)
    if case == "check_miss_then_hit":
        assert got[:2] == (200, {"allowed": True})
        assert got[2]["X-Keto-Snaptoken"] == TOKEN


def test_check_cache_counts_equal(daemons):
    """After the cases above (the same requests on both), the caches
    counted alike, and the port's hits never reached its batcher."""
    tdaemon, jdaemon = daemons
    for _ in range(2):
        assert call(tdaemon.read_port, "GET", "/relation-tuples/check", CHECK) == \
            call(jdaemon.read_port, "GET", "/relation-tuples/check", CHECK)
    tcache, jcache = tdaemon.registry.check_cache(), jdaemon.registry.check_cache()
    for op in ("hit", "miss", "stale"):
        assert tcache.counts[op] == jcache.counts[op], op
    assert tcache.counts["hit"] >= 2
    stats = tdaemon.batcher.stats
    assert stats["batched_checks"] == tcache.counts["miss"]
    assert sum(stats["check_batch_failed"].values()) == sum(stats["shed"].values()) == 0


def test_list_tuples_pages_equal_keto_tpu_daemon(daemons):
    tdaemon, jdaemon = daemons
    pages, token = [], ""
    while True:
        params = {"namespace": "videos", "page_size": "3", **({"page_token": token}
                                                            if token else {})}
        got = call(tdaemon.read_port, "GET", "/relation-tuples", params)
        assert got == call(jdaemon.read_port, "GET", "/relation-tuples", params)
        assert got[0] == 200
        pages.append(got[1]["relation_tuples"])
        token = got[1]["next_page_token"]
        if not token:
            break
    assert [len(p) for p in pages] == [3, 3, 1]


# -- overload, deadlines and the drain, on a gated engine ---------------------------


class GatedEngine:
    """check_batch blocks until the gate opens."""

    def __init__(self, member):
        self.member = member
        self.gate = threading.Event()
        self.calls = 0

    def check_batch(self, tuples, max_depth=0):
        self.calls += 1
        assert self.gate.wait(timeout=WAIT_S)
        return [self.member for _ in tuples]


def wait_until(cond):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and not cond():
        time.sleep(0.005)
    assert cond()


def gated_pair(serve_check=None):
    engines = (GatedEngine(T_MEMBER), GatedEngine(J_MEMBER))
    return make_pair(serve_check, engines), engines


def in_flight(daemon, port):
    """A check on `port` on its own thread, admitted once the batcher
    counts it; its answer lands in the returned dict."""
    out = {}
    th = threading.Thread(target=lambda: out.update(
        r=call(port, "GET", "/relation-tuples/check", CHECK)), daemon=True)
    th.start()
    wait_until(lambda: not daemon.batcher.idle())
    return th, out


def test_shed_at_max_queue_with_retry_after():
    (tdaemon, jdaemon), engines = gated_pair({"max_queue": 1})
    try:
        answers, sheds = [], []
        for daemon, engine in zip((tdaemon, jdaemon), engines):
            th, out = in_flight(daemon, daemon.read_port)
            sheds.append(call(daemon.read_port, "GET", "/relation-tuples/check",
                              {**CHECK, "subject_id": "bob"}))
            engine.gate.set()
            th.join(timeout=WAIT_S)
            answers.append(out["r"])
        assert sheds[0] == sheds[1] and answers[0] == answers[1]
        assert sheds[0][0] == 429 and sheds[0][2]["Retry-After"] == "1"
        assert sheds[0][1]["error"]["message"] == "check queue is full"
        assert answers[0][:2] == (200, {"allowed": True})
        assert tdaemon.batcher.stats["shed"]["queue_full"] == 1
    finally:
        for engine in engines:
            engine.gate.set()
        tdaemon.stop()
        jdaemon.stop()


def test_deadline_504_on_request_timeout_header():
    (tdaemon, jdaemon), engines = gated_pair()
    try:
        got = [call(d.read_port, "GET", "/relation-tuples/check", CHECK,
                    headers={"x-request-timeout-ms": "100"}) for d in (tdaemon, jdaemon)]
        assert got[0] == got[1]
        assert got[0][0] == 504 and got[0][1]["error"]["status"] == "deadline_exceeded"
        assert "Retry-After" not in got[0][2]
        assert tdaemon.batcher.stats["deadline_exceeded"]["wait"] == 1
    finally:
        for engine in engines:
            engine.gate.set()
        tdaemon.stop()
        jdaemon.stop()


def test_ready_503_during_drain_while_admitted_check_answers():
    (tdaemon, jdaemon), engines = gated_pair()
    outcomes = []
    try:
        for daemon, engine in zip((tdaemon, jdaemon), engines):
            port = daemon.read_port
            th, out = in_flight(daemon, port)
            stopper = threading.Thread(target=daemon.stop, kwargs={"grace": WAIT_S},
                                       daemon=True)
            stopper.start()
            wait_until(lambda: daemon.registry.draining.is_set())
            ready = call(port, "GET", "/health/ready")
            shed = call(port, "GET", "/relation-tuples/check", {**CHECK, "subject_id": "bob"})
            engine.gate.set()
            th.join(timeout=WAIT_S)
            stopper.join(timeout=WAIT_S)
            assert not stopper.is_alive()
            outcomes.append((ready, shed, out["r"]))
        assert outcomes[0] == outcomes[1]
        ready, shed, admitted = outcomes[0]
        assert ready[:2] == (503, {"status": "unavailable"})
        assert shed[0] == 429 and shed[1]["error"]["message"] == "server is draining"
        assert shed[2]["Retry-After"] == "1"
        assert admitted[:2] == (200, {"allowed": True})
        assert tdaemon.registry.counters().snapshot()["shed"]["draining"] == 1
    finally:
        for engine in engines:
            engine.gate.set()


def test_host_engine_daemon_equals_keto_tpu():
    """`check.engine: host` on both: the exact host oracle behind the same
    routes, batcher and cache, with no device mirror."""
    cfg = {"dsn": "memory", "check": {"engine": "host"}, "namespaces": NAMESPACES,
           "serve": LISTEN}
    treg, jreg = TRegistry(TConfig(cfg), device="cpu"), JRegistry(JConfig(cfg))
    treg.relation_tuple_manager().write_relation_tuples([TTuple.from_string(s) for s in TUPLES])
    jreg.relation_tuple_manager().write_relation_tuples([JTuple.from_string(s) for s in TUPLES])
    tdaemon, jdaemon = TDaemon(treg), JDaemon(jreg)
    tdaemon.start()
    jdaemon.start()
    try:
        for case in ("check_miss_then_hit", "check_denied_twice", "check_batch",
                     "list_tuples_query"):
            for method, path, params, body in REQUESTS[case]:
                got = call(tdaemon.read_port, method, path, params, body)
                assert got == call(jdaemon.read_port, method, path, params, body), case
        assert treg.check_engine().stats["host_checks"] > 0
        assert sum(tdaemon.batcher.stats["check_batch_failed"].values()) == 0
    finally:
        tdaemon.stop()
        jdaemon.stop()
