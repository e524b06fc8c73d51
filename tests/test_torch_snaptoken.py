"""Snaptoken enforcement on the port's REST read routes, held against a
keto_tpu REST daemon over the same store: for each route that takes a
token and each kind of token, the status, the JSON body and the
X-Keto-Snaptoken header are equal."""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest

from keto_tpu.api.daemon import Daemon
from keto_tpu.config import Config as JConfig
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.registry import Registry

from keto_tpu_torch.api.rest_server import make_server
from keto_tpu_torch.config import Config
from keto_tpu_torch.engine import snaptoken
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.errors import SnaptokenMalformedError, SnaptokenUnsatisfiableError
from keto_tpu_torch.ketoapi import RelationTuple
from keto_tpu_torch.storage import MemoryManager


def _computed(rel):
    return {"type": "computed_subject_set", "relation": rel}


NAMESPACES = [
    {"name": "videos", "relations": [
        {"name": "owner"}, {"name": "parent"},
        {"name": "view", "rewrite": {"operator": "or", "children": [
            _computed("owner"),
            {"type": "tuple_to_subject_set", "relation": "parent",
             "computed_subject_set_relation": "view"},
        ]}},
    ]},
    {"name": "groups", "relations": [{"name": "member"}]},
]
TUPLES = [
    "videos:/d1#owner@alice", "videos:/d1/v1#parent@(videos:/d1#...)",
    "videos:/d1/v2#parent@(videos:/d1#...)", "videos:/d2#owner@bob",
    "videos:/d2/v1#parent@(videos:/d2#...)", "videos:/d2/v1#owner@alice",
    "videos:/d2#view@(groups:eng#member)", "groups:eng#member@carol",
]
NID = "default"
# the store takes its tuples in one write: version 1
VERSION = 1
TOKENS = {
    "empty": "",
    "legacy_stub": "not yet implemented",
    "malformed": "junk",
    "other_network": snaptoken.encode_snaptoken(VERSION, "other-network"),
    "satisfied": snaptoken.encode_snaptoken(VERSION, NID),
    "ahead_of_store": snaptoken.encode_snaptoken(VERSION + 1, NID),
}
CHECK = {"namespace": "videos", "object": "/d1/v2", "relation": "view", "subject_id": "alice"}
BATCH = [CHECK, {**CHECK, "object": "/d2/v1", "subject_id": "carol"},
         {**CHECK, "namespace": "ghost"}]
FILTER = {"namespace": "videos", "relation": "view", "subject_id": "alice",
          "objects": ["/d1", "/d2", "/d2/v1", "/d1/v1", "/nope"]}


def _route_request(route, token):
    """(method, path, query params, JSON body) of one route's request
    carrying `token` where that route reads it."""
    q = {"snaptoken": token}
    if route == "check_get":
        return "GET", "/relation-tuples/check", {**CHECK, **q}, None
    if route == "check_post":
        return "POST", "/relation-tuples/check", q, CHECK
    if route == "check_openapi":
        return "GET", "/relation-tuples/check/openapi", {**CHECK, **q}, None
    if route == "batch_param":
        return "POST", "/relation-tuples/check/batch", q, {"tuples": BATCH}
    if route == "batch_body":
        return "POST", "/relation-tuples/check/batch", {}, {"tuples": BATCH, **q}
    if route == "list_objects":
        return "GET", "/relation-tuples/list-objects", {
            "namespace": "videos", "relation": "view", "subject_id": "alice", **q}, None
    if route == "list_subjects":
        return "GET", "/relation-tuples/list-subjects", {
            "namespace": "videos", "object": "/d2/v1", "relation": "view", **q}, None
    if route == "filter_body":
        return "POST", "/relation-tuples/filter", {}, {**FILTER, **q}
    if route == "filter_param":
        return "POST", "/relation-tuples/filter", q, FILTER
    raise AssertionError(route)


ROUTES = ("check_get", "check_post", "check_openapi", "batch_param", "batch_body",
          "list_objects", "list_subjects", "filter_body", "filter_param")


def _call(port, method, path, params, body):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers.get("X-Keto-Snaptoken")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("X-Keto-Snaptoken")


@pytest.fixture(scope="module")
def servers():
    m = MemoryManager()
    m.write_relation_tuples([RelationTuple.from_string(s) for s in TUPLES])
    cfg = Config({"namespaces": NAMESPACES})
    server = make_server(TorchCheckEngine(m, cfg, device="cpu"), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    registry = Registry(JConfig({
        "dsn": "memory",
        "check": {"engine": "tpu"},
        "serve": {"read": {"host": "127.0.0.1", "port": 0},
                  "write": {"host": "127.0.0.1", "port": 0},
                  "metrics": {"host": "127.0.0.1", "port": 0}},
        "namespaces": NAMESPACES,
    }))
    registry.relation_tuple_manager().write_relation_tuples(
        [JTuple.from_string(s) for s in TUPLES])
    daemon = Daemon(registry)
    daemon.start()
    assert registry.nid == NID
    assert m.version(nid=NID) == registry.relation_tuple_manager().version(nid=NID) == VERSION
    yield server.server_address[1], daemon.read_port
    daemon.stop()
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("token", sorted(TOKENS))
@pytest.mark.parametrize("route", ROUTES)
def test_route_enforces_token_as_keto_tpu(servers, route, token):
    port, jax_port = servers
    req = _route_request(route, TOKENS[token])
    got = _call(port, *req)
    want = _call(jax_port, *req)
    assert got == want, (route, token)
    status, body, header = got
    if token == "malformed" or token == "other_network":
        assert status == 400 and body["error"]["status"] == "bad_request"
    elif token == "ahead_of_store":
        assert status == 409 and body["error"]["status"] == "conflict"
    else:
        assert status in (200, 403)
        minted = snaptoken.encode_snaptoken(VERSION, NID)
        if route.startswith(("batch", "filter")):
            assert body["snaptoken"] == minted and header is None
        else:
            assert header == minted


def test_unknown_namespace_check_carries_the_token(servers):
    """A check in an unknown namespace answers allowed: false with the
    enforced version's token, after the token was enforced."""
    port, jax_port = servers
    ghost = {**CHECK, "namespace": "ghost"}
    for token in ("", TOKENS["ahead_of_store"]):
        req = ("GET", "/relation-tuples/check", {**ghost, "snaptoken": token}, None)
        assert _call(port, *req) == _call(jax_port, *req)
    assert _call(port, "GET", "/relation-tuples/check", ghost, None) == (
        403, {"allowed": False}, snaptoken.encode_snaptoken(VERSION, NID))


@pytest.mark.parametrize("token,want", [
    ("", None), ("not yet implemented", None), ("ktv1_00000000", SnaptokenMalformedError),
    ("xx_" + snaptoken._nid_digest(NID) + "_1", SnaptokenMalformedError),
    (snaptoken.encode_snaptoken(3, "other"), SnaptokenMalformedError),
    ("ktv1_" + snaptoken._nid_digest(NID) + "_x", SnaptokenMalformedError),
    ("ktv1_" + snaptoken._nid_digest(NID) + "_-2", SnaptokenMalformedError),
    (snaptoken.encode_snaptoken(7, NID), 7),
])
def test_parse_snaptoken(token, want):
    if isinstance(want, type):
        with pytest.raises(want):
            snaptoken.parse_snaptoken(token, NID)
    else:
        assert snaptoken.parse_snaptoken(token, NID) == want


def test_enforce_snaptoken_reads_the_store():
    m = MemoryManager()
    assert snaptoken.enforce_snaptoken(m, "", NID) == 0
    m.write_relation_tuples([RelationTuple.from_string(TUPLES[0])])
    m.write_relation_tuples([RelationTuple.from_string(TUPLES[1])])
    assert snaptoken.enforce_snaptoken(m, snaptoken.encode_snaptoken(2, NID), NID) == 2
    with pytest.raises(SnaptokenUnsatisfiableError) as e:
        snaptoken.enforce_snaptoken(m, snaptoken.encode_snaptoken(3, NID), NID)
    assert e.value.status == 409 and e.value.to_dict()["error"]["status"] == "conflict"
