"""The port's gRPC clients (keto_tpu_torch/api/client.py), its RetryPolicy
(resilience.py) and its OpenAPI document (api/openapi.py), held against
keto_tpu's.

  (g) the port's ReadClient and WriteClient against a keto_tpu daemon, and
      keto_tpu's clients against a port daemon over an equal store, give
      equal results, errors included (code and details); RetryPolicy's
      delays, hints and give-ups equal keto_tpu's on the same draws;
  (h) the OpenAPI document each port listener serves at
      /.well-known/openapi.json equals keto_tpu's whole, the change-log
      stream's route and schema included; every path and method in it is
      dispatched by the port's router, and live payloads validate against
      its schemas.

Tolerance: exact equality.
"""

import random

import grpc
import jsonschema
import pytest

from keto_tpu.api import client as jclient
from keto_tpu.api.openapi import build_spec as jbuild_spec
from keto_tpu.ketoapi import RelationQuery as JQuery
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
from keto_tpu.resilience import RetryPolicy as JRetryPolicy

from keto_tpu_torch.api import client as tclient
from keto_tpu_torch.api import rest_server
from keto_tpu_torch.api.openapi import build_spec
from keto_tpu_torch.engine.snaptoken import encode_snaptoken
from keto_tpu_torch.ketoapi import RelationQuery, RelationTuple, SubjectSet
from keto_tpu_torch.resilience import RetryPolicy

from test_torch_daemon import call
from test_torch_grpc import make_pair

TOKEN_V1, TOKEN_V2, TOKEN_AHEAD = (encode_snaptoken(v, "default") for v in (1, 2, 9))


@pytest.fixture(scope="module")
def daemons():
    tdaemon, jdaemon = make_pair()
    yield tdaemon, jdaemon
    tdaemon.stop()
    jdaemon.stop()


def _norm(x):
    """A client result as plain data, whichever package's types it holds."""
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (RelationTuple, JTuple)):
        return str(x)
    if hasattr(x, "to_dict"):
        return x.to_dict()
    return x


def _outcome(fn):
    try:
        return "ok", _norm(fn())
    except grpc.RpcError as e:
        return e.code().name, e.details()


# (name, the call on a read client, given its package's ketoapi module)
def _reads(api):
    T, S, Q = api
    return {
        "check": lambda c: c.check(T.from_string("videos:/d1/v2#view@alice")),
        "check_denied": lambda c: c.check(T.from_string("videos:/d1/v2#view@bob")),
        "check_with_token": lambda c: c.check_with_token(
            T.from_string("videos:/d2/v1#view@carol"), 4, snaptoken=TOKEN_V1),
        "check_token_ahead": lambda c: c.check_with_token(
            T.from_string("videos:/d2/v1#view@carol"), snaptoken=TOKEN_AHEAD),
        "check_unknown_namespace": lambda c: c.check(T.from_string("ghost:/d1#view@alice")),
        "check_batch": lambda c: c.check_batch([
            T.from_string(s) for s in ("videos:/d1/v2#view@alice", "videos:/d1/v2#view@bob",
                                       "ghost:/x#view@alice")]),
        "expand": lambda c: c.expand(S("videos", "/d1", "owner"), 3),
        "expand_rewrite": lambda c: c.expand(S("videos", "/d2", "view"), 4),
        "expand_subject_id": lambda c: c.expand("alice"),
        "list_objects": lambda c: c.list_objects("videos", "view", "alice"),
        "list_objects_page": lambda c: c.list_objects("videos", "view", "alice", page_size=2),
        "list_objects_subject_set": lambda c: c.list_objects(
            "videos", "view", S("groups", "eng", "member")),
        "list_subjects": lambda c: c.list_subjects("videos", "/d2/v1", "view"),
        "list_subjects_unknown": lambda c: c.list_subjects("ghost", "/d2/v1", "view"),
        "filter": lambda c: c.filter("videos", "view", "alice", ["/d1", "/d2", "/d2/v1", "/x"]),
        "list_relation_tuples": lambda c: c.list_relation_tuples(Q(namespace="videos")),
        "list_relation_tuples_page": lambda c: c.list_relation_tuples(
            Q(namespace="videos"), page_size=3),
        "list_relation_tuples_subject": lambda c: c.list_relation_tuples(
            Q(subject_id="alice")),
        "version": lambda c: c.get_version(),
        "health": lambda c: c.health(),
    }


PORT_API = (RelationTuple, SubjectSet, RelationQuery)
JAX_API = (JTuple, JSubjectSet, JQuery)
READ_CASES = sorted(_reads(PORT_API))


def _clients(daemons, kind):
    """(the port's client on keto_tpu's daemon, keto_tpu's on the port's,
    the port's on the port's)."""
    tdaemon, jdaemon = daemons
    port = f"{kind}_port"
    cls = "ReadClient" if kind == "read" else "WriteClient"
    return (getattr(tclient, cls)(tclient.open_channel(f"127.0.0.1:{getattr(jdaemon, port)}")),
            getattr(jclient, cls)(jclient.open_channel(f"127.0.0.1:{getattr(tdaemon, port)}")),
            getattr(tclient, cls)(tclient.open_channel(f"127.0.0.1:{getattr(tdaemon, port)}")))


@pytest.fixture(scope="module")
def read_clients(daemons):
    clients = _clients(daemons, "read")
    yield clients
    for c in clients:
        c.close()


@pytest.mark.parametrize("case", READ_CASES)
def test_read_clients_cross_equal(read_clients, case):
    port_on_jax, jax_on_port, port_on_port = read_clients
    mine, theirs = _reads(PORT_API)[case], _reads(JAX_API)[case]
    got = _outcome(lambda: mine(port_on_jax))
    assert got == _outcome(lambda: theirs(jax_on_port)) == _outcome(lambda: mine(port_on_port))
    if case in ("check", "check_batch", "version", "health", "list_objects"):
        assert got[0] == "ok", got


def test_list_objects_pages_chain(read_clients):
    """Following next_page_token to its end lists what one page does."""
    port_on_jax, jax_on_port, _ = read_clients
    pages = []
    for c in (port_on_jax, jax_on_port):
        out, token = [], ""
        while True:
            objects, token, _snap = c.list_objects("videos", "view", "alice", page_size=1,
                                                   page_token=token)
            out += objects
            if not token:
                break
        pages.append(out)
    assert pages[0] == pages[1] == port_on_jax.list_objects("videos", "view", "alice")[0]


def test_write_clients_cross_equal():
    """Each WriteClient writes into the other package's daemon; the answers
    (tokens), then the reads of both daemons, are equal."""
    tdaemon, jdaemon = make_pair()
    (t_on_j, j_on_t, _), readers = _clients((tdaemon, jdaemon), "write"), \
        _clients((tdaemon, jdaemon), "read")
    try:
        got = _outcome(lambda: t_on_j.transact(
            [RelationTuple.from_string("videos:/d3#owner@dave")],
            [RelationTuple.from_string("videos:/d1#owner@alice")]))
        assert got == _outcome(lambda: j_on_t.transact(
            [JTuple.from_string("videos:/d3#owner@dave")],
            [JTuple.from_string("videos:/d1#owner@alice")])) == ("ok", [TOKEN_V2])
        for case in ("check", "list_objects", "list_relation_tuples"):
            assert _outcome(lambda: _reads(PORT_API)[case](readers[0])) == \
                _outcome(lambda: _reads(JAX_API)[case](readers[1])), case
        got = _outcome(lambda: t_on_j.delete_all(RelationQuery(namespace="videos",
                                                               object="/d3")))
        assert got == _outcome(lambda: j_on_t.delete_all(JQuery(namespace="videos",
                                                                object="/d3")))
        bad = _outcome(lambda: t_on_j.transact([RelationTuple.from_string("ghost:/x#r@u")]))
        assert bad == _outcome(lambda: j_on_t.transact([JTuple.from_string("ghost:/x#r@u")]))
        assert bad[0] == "NOT_FOUND"
        assert tdaemon.registry.relation_tuple_manager().version() == \
            jdaemon.registry.relation_tuple_manager().version() == 3
    finally:
        for c in (t_on_j, j_on_t, *readers):
            c.close()
        tdaemon.stop()
        jdaemon.stop()


@pytest.mark.parametrize("flag,env,want", [
    ("10.0.0.1:1", "10.0.0.2:2", "10.0.0.1:1"), (None, "10.0.0.2:2", "10.0.0.2:2"),
    (None, None, tclient.DEFAULT_READ_REMOTE)])
def test_resolve_remote(monkeypatch, flag, env, want):
    if env is None:
        monkeypatch.delenv(tclient.READ_REMOTE_ENV, raising=False)
    else:
        monkeypatch.setenv(tclient.READ_REMOTE_ENV, env)
    assert tclient.resolve_remote(flag, tclient.READ_REMOTE_ENV, tclient.DEFAULT_READ_REMOTE) \
        == jclient.resolve_remote(flag, jclient.READ_REMOTE_ENV, jclient.DEFAULT_READ_REMOTE) \
        == want


@pytest.mark.parametrize("remote", ["127.0.0.1:4466", "localhost:1", "[::1]:4466",
                                    "keto.example:443", "10.1.2.3:4466"])
def test_open_channel_is_plaintext_only_locally(remote):
    assert tclient._is_local(remote) == jclient._is_local(remote)
    tclient.open_channel(remote).close()


# -- RetryPolicy ------------------------------------------------------------------------


class _Shed(Exception):
    """An RpcError-like failure: a code and trailing metadata."""

    def __init__(self, code="UNAVAILABLE", retry_after=None):
        super().__init__(code)
        self._code = getattr(grpc.StatusCode, code)
        self._md = (("retry-after", retry_after),) if retry_after is not None else ()

    def code(self):
        return self._code

    def trailing_metadata(self):
        return self._md


SCRIPTS = {
    "recovers": [_Shed(), _Shed("RESOURCE_EXHAUSTED"), "ok"],
    "hint_floors_delay": [_Shed(retry_after="1"), "ok"],
    "exhausted": [_Shed(), _Shed(), _Shed(), _Shed()],
    "not_retryable": [_Shed("INTERNAL"), "ok"],
    "budget_gives_up": [_Shed(retry_after="30"), "ok"],
    "zero_hint_ignored": [_Shed(retry_after="0"), "ok"],
}


def _run_policy(cls, script, budget):
    sleeps = []
    policy = cls(max_attempts=3, sleep=sleeps.append, rng=random.Random(5))
    steps = iter(script)

    def fn(_remaining):
        step = next(steps)
        if isinstance(step, Exception):
            raise step
        return step

    try:
        out = policy.call(fn, budget)
    except _Shed as e:
        out = ("raised", e.code().name)
    return out, [round(s, 12) for s in sleeps], policy.stats


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_retry_policy_equals_keto_tpu(case):
    budget = 5.0 if case == "budget_gives_up" else None
    got = _run_policy(RetryPolicy, SCRIPTS[case], budget)
    assert got == _run_policy(JRetryPolicy, SCRIPTS[case], budget)
    if case == "hint_floors_delay":
        assert got[1] == [1.0]


def test_read_client_retries_a_drain_with_the_hint(daemons):
    """A draining daemon sheds with a retry hint of 1 s: the ReadClient's
    policy sleeps at least that before each retry, then raises the shed."""
    sleeps = []
    tdaemon, _ = daemons
    client = tclient.ReadClient(tclient.open_channel(f"127.0.0.1:{tdaemon.read_port}"),
                                retry_policy=RetryPolicy(max_attempts=3, sleep=sleeps.append))
    tdaemon.registry.draining.set()
    try:
        with pytest.raises(grpc.RpcError) as e:
            client.check(RelationTuple.from_string("videos:/d1/v2#view@alice"))
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert len(sleeps) == 2 and min(sleeps) >= 1.0
        # a read that sheds nothing passes straight through
        assert client.get_version() == tdaemon.registry.version
    finally:
        tdaemon.registry.draining.clear()
        client.close()


# -- (h) the OpenAPI document ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["read", "write"])
def test_served_spec_equals_keto_tpu_less_unserved_routes(daemons, kind):
    tdaemon, jdaemon = daemons
    port = f"{kind}_port"
    got = call(getattr(tdaemon, port), "GET", rest_server.SPEC_ROUTE)
    want = call(getattr(jdaemon, port), "GET", rest_server.SPEC_ROUTE)
    assert got[0] == want[0] == 200
    # the whole document: the watch route and its schema included
    assert got[1] == want[1]
    assert got[1] == build_spec(tdaemon.registry.version, kind=kind)
    if kind == "read":
        assert "/relation-tuples/watch" in got[1]["paths"]


def test_whole_spec_equals_keto_tpu_less_unserved_routes():
    assert build_spec("v") == jbuild_spec("v")
    assert "watchEvent" in build_spec("v")["components"]["schemas"]


@pytest.mark.parametrize("kind,handler", [("read", rest_server.ReadHandler),
                                          ("write", rest_server.WriteHandler)])
def test_every_spec_route_is_dispatched(kind, handler):
    shared = {rest_server.ALIVE_ROUTE, rest_server.READY_ROUTE, rest_server.VERSION_ROUTE}
    spec = build_spec("v", kind=kind)
    for path, ops in spec["paths"].items():
        for method in ops:
            assert path in shared and method == "get" or \
                (method.upper(), path) in handler._routes, (kind, method, path)
    served = {path for _m, path in handler._routes} | shared
    assert served == set(spec["paths"])
    assert {p: k for p, k in rest_server.ROUTE_KINDS.items() if k in (kind, "shared")
            and p != rest_server.SPEC_ROUTE}.keys() == set(spec["paths"])


def _schema_for(spec, path, method, code):
    resp = spec["paths"][path][method]["responses"][str(code)]
    schema = dict(resp["content"]["application/json"]["schema"])
    schema["components"] = spec["components"]
    return schema


@pytest.mark.parametrize("path,method,code,params,body", [
    ("/relation-tuples/check/openapi", "get", 200,
     {"namespace": "videos", "object": "/d1/v2", "relation": "view", "subject_id": "alice"},
     None),
    ("/relation-tuples/check", "get", 403,
     {"namespace": "videos", "object": "/d1/v2", "relation": "view", "subject_id": "bob"},
     None),
    ("/relation-tuples", "get", 200, {"namespace": "videos"}, None),
    ("/relation-tuples", "get", 404, {"namespace": "ghost"}, None),
    ("/relation-tuples/expand", "get", 200,
     {"namespace": "videos", "object": "/d1", "relation": "owner", "max-depth": "3"}, None),
    ("/relation-tuples/list-objects", "get", 200,
     {"namespace": "videos", "relation": "view", "subject_id": "alice"}, None),
    ("/relation-tuples/list-subjects", "get", 200,
     {"namespace": "videos", "object": "/d2/v1", "relation": "view"}, None),
    ("/relation-tuples/check/batch", "post", 200, None,
     {"tuples": [{"namespace": "videos", "object": "/d1", "relation": "view",
                  "subject_id": "alice"}]}),
    ("/relation-tuples/filter", "post", 200, None,
     {"namespace": "videos", "relation": "view", "subject_id": "alice",
      "objects": ["/d1", "/d2"]}),
    ("/version", "get", 200, None, None),
    ("/health/alive", "get", 200, None, None),
    ("/health/ready", "get", 200, None, None),
], ids=lambda v: v if isinstance(v, (str, int)) else None)
def test_live_payloads_validate(daemons, path, method, code, params, body):
    tdaemon, _ = daemons
    spec = call(tdaemon.read_port, "GET", rest_server.SPEC_ROUTE)[1]
    status, payload, _ = call(tdaemon.read_port, method.upper(), path, params, body)
    assert status == code
    jsonschema.Draft7Validator(_schema_for(spec, path, method, code)).validate(payload)
