"""The port's gRPC plane (keto_tpu_torch/api: descriptors, messages,
grpc_server, the PortMux of daemon.py) held against keto_tpu's.

  (a) the port's `.proto` files and descriptor set are keto_tpu's byte for
      byte (sha256), and every message class's descriptor is equal;
  (b) the conversions of api/messages.py round trip, and the port's
      deterministic bytes for the same tuples, queries and trees are
      keto_tpu's;
  (c) every method of every read and write service, the same request
      bytes sent raw to a port Daemon's and a keto_tpu Daemon's muxed
      ports over equal stores: equal response bytes, status code, details
      and trailing metadata (the `retry-after` hint); a Health Watch
      stream across a drain;
  (d) admission over gRPC: RESOURCE_EXHAUSTED with `retry-after` at
      serve.check.max_queue, DEADLINE_EXCEEDED for an RPC deadline shorter
      than a gated batch, the drain;
  (e) a failing device over gRPC: INTERNAL, then UNAVAILABLE with
      `retry-after` while the breaker is open, the twins of REST's 500 and
      503 on the same port, never a host answer;
  (f) one port serves REST and gRPC (the mux splices an HTTP/2
      connection to the gRPC server and hands any other to the REST
      server), and the direct `serve.<kind>.grpc` listener answers as the
      mux does;
  (g) the tuple WatchService: a replay, the namespace filter and every
      kind of snaptoken, equal response bytes, codes and details
      (tests/test_torch_watch.py holds the live tail, the resume and the
      other planes);
  and explain: keto_tpu's gRPC Check and REST route answer a trace, the
  port's UNIMPLEMENTED and a typed 501.

The JAX side runs on the CPU, as the conftest forces. Every server runs
on a small worker pool; every wait is bounded. Tolerance: exact equality.
"""

import contextlib
import functools
import hashlib
import threading
import time

import grpc
import pytest

import keto_tpu.api.daemon as jdaemon_mod
import keto_tpu_torch.api.daemon as tdaemon_mod
from keto_tpu.api import descriptors as jdesc
from keto_tpu.api import messages as jmsg
from keto_tpu.api.daemon import Daemon as JDaemon
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.definitions import RESULT_IS_MEMBER as J_MEMBER
from keto_tpu.ketoapi import RelationQuery as JQuery
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import Tree as JTree
from keto_tpu.registry import Registry as JRegistry

from keto_tpu_torch.api import descriptors as tdesc
from keto_tpu_torch.api import messages as tmsg
from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.api.descriptors import pb
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.definitions import RESULT_IS_MEMBER as T_MEMBER
from keto_tpu_torch.engine.snaptoken import encode_snaptoken
from keto_tpu_torch.ketoapi import RelationQuery, RelationTuple, SubjectSet, Tree, TreeNodeType
from keto_tpu_torch.registry import Registry as TRegistry

from test_torch_daemon import CHECK, GatedEngine, call, wait_until
from test_torch_resilience import _FailingDeviceEngine
from test_torch_snaptoken import NAMESPACES, TOKENS, TUPLES

WAIT_S = 30
NID = "default"
WORKERS = 8
LISTEN = {"read": {"host": "127.0.0.1", "port": 0}, "write": {"host": "127.0.0.1", "port": 0},
          "metrics": {"host": "127.0.0.1", "port": 0}}


def make_pair(serve=None, engines=None, tuples=TUPLES, check=None):
    """A port and a keto_tpu daemon over equal stores, each gRPC server on
    WORKERS threads; `engines` (port, keto_tpu) serve in place of each
    registry's own, `serve` and `check` are merged into the config."""
    cfg = {"dsn": "memory", "check": {"engine": "tpu", **(check or {})},
           "namespaces": NAMESPACES, "serve": {**LISTEN, **(serve or {})}}
    treg = TRegistry(TConfig(cfg), device="cpu", engine=engines[0] if engines else None)
    jreg = JRegistry(JConfig(cfg))
    treg.relation_tuple_manager().write_relation_tuples(
        [RelationTuple.from_string(s) for s in tuples])
    jreg.relation_tuple_manager().write_relation_tuples(
        [JTuple.from_string(s) for s in tuples])
    if engines is not None:
        jreg._engine = engines[1]  # keto_tpu's Registry takes no engine
    tdaemon, jdaemon = TDaemon(treg), JDaemon(jreg)
    with small_pools():
        tdaemon.start()
        jdaemon.start()
    return tdaemon, jdaemon


@contextlib.contextmanager
def small_pools():
    """Daemons started inside build their gRPC servers on WORKERS threads."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tdaemon_mod, jdaemon_mod):
            mp.setattr(mod, "build_grpc_server",
                       functools.partial(mod.build_grpc_server, max_workers=WORKERS))
        yield


_channels: dict = {}


def raw(port, path, request: bytes, timeout=WAIT_S):
    """One unary call with no serializer: (code, response bytes, details,
    trailing metadata)."""
    ch = _channels.get(port)
    if ch is None:
        ch = _channels[port] = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        resp, c = ch.unary_unary(path).with_call(request, timeout=timeout)
        return "OK", resp, "", tuple(c.trailing_metadata() or ())
    except grpc.RpcError as e:
        return e.code().name, None, e.details(), tuple(e.trailing_metadata() or ())


def both(tdaemon, jdaemon, path, msg, port="read_port", timeout=WAIT_S):
    data = msg.SerializeToString()
    return (raw(getattr(tdaemon, port), path, data, timeout),
            raw(getattr(jdaemon, port), path, data, timeout))


@pytest.fixture(scope="module")
def daemons():
    tdaemon, jdaemon = make_pair()
    yield tdaemon, jdaemon
    tdaemon.stop()
    jdaemon.stop()


# -- (a) descriptors ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(p.name for p in tdesc.PROTO_DIR.iterdir()))
def test_proto_files_equal_keto_tpu(name):
    mine = (tdesc.PROTO_DIR / name).read_bytes()
    theirs = (jdesc._DESCRIPTOR_FILE.parent / name).read_bytes()
    assert hashlib.sha256(mine).hexdigest() == hashlib.sha256(theirs).hexdigest()


def test_proto_file_set_equal_keto_tpu():
    assert sorted(p.name for p in tdesc.PROTO_DIR.iterdir()) == \
        sorted(p.name for p in jdesc._DESCRIPTOR_FILE.parent.iterdir() if p.is_file())


@pytest.mark.parametrize("name", sorted(vars(tdesc.pb)))
def test_message_descriptor_equal_keto_tpu(name):
    from google.protobuf import descriptor_pb2

    mine, theirs = descriptor_pb2.DescriptorProto(), descriptor_pb2.DescriptorProto()
    getattr(tdesc.pb, name).DESCRIPTOR.CopyToProto(mine)
    getattr(jdesc.pb, name).DESCRIPTOR.CopyToProto(theirs)
    assert mine.SerializeToString(deterministic=True) == \
        theirs.SerializeToString(deterministic=True)
    assert getattr(tdesc.pb, name).DESCRIPTOR.full_name == \
        getattr(jdesc.pb, name).DESCRIPTOR.full_name


def test_service_names_and_enums_equal_keto_tpu():
    for name in ("CHECK_SERVICE", "EXPAND_SERVICE", "READ_SERVICE", "WRITE_SERVICE",
                 "VERSION_SERVICE", "HEALTH_SERVICE", "BATCH_CHECK_SERVICE",
                 "REVERSE_READ_SERVICE", "FILTER_SERVICE", "WATCH_SERVICE"):
        assert getattr(tdesc, name) == getattr(jdesc, name), name
    for enum in ("NODE_TYPE", "ACTION", "SERVING_STATUS"):
        assert [(v.name, v.number) for v in getattr(tdesc, enum).values] == \
            [(v.name, v.number) for v in getattr(jdesc, enum).values], enum


# -- (b) messages ---------------------------------------------------------------------

MSG_TUPLES = TUPLES + ["videos:/d1#owner@", "groups:eng#member@(videos:/d1#owner)",
                       "a:b#c@(d:e#f)", "ns:obj with space#rel@sub:with:colons"]


@pytest.mark.parametrize("s", MSG_TUPLES)
def test_tuple_bytes_and_round_trip(s):
    t = RelationTuple.from_string(s)
    mine = tmsg.tuple_to_proto(t)
    assert mine.SerializeToString(deterministic=True) == \
        jmsg.tuple_to_proto(JTuple.from_string(s)).SerializeToString(deterministic=True)
    assert tmsg.tuple_from_proto(mine) == t
    assert tmsg.subject_from_proto(tmsg.subject_to_proto(t.subject)) == t.subject


def test_nil_subject_tuple_raises():
    from keto_tpu_torch.errors import NilSubjectError

    with pytest.raises(NilSubjectError):
        tmsg.tuple_from_proto(pb.RelationTuple(namespace="n", object="o", relation="r"))
    assert tmsg.subject_from_proto(pb.Subject()) is None


QUERIES = [
    {}, {"namespace": "videos"}, {"namespace": "videos", "object": "/d1"},
    {"relation": "owner", "subject_id": "alice"},
    {"namespace": "videos", "subject_set": ("videos", "/d1", "...")},
    {"namespace": "", "object": "", "relation": "", "subject_id": ""},
]


def _query(cls, set_cls, d):
    q = cls(namespace=d.get("namespace"), object=d.get("object"), relation=d.get("relation"))
    if "subject_id" in d:
        q.subject_id = d["subject_id"]
    if "subject_set" in d:
        q.subject_set = set_cls(*d["subject_set"])
    return q


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_query_bytes_and_round_trip(i):
    from keto_tpu.ketoapi import SubjectSet as JSubjectSet

    q = _query(RelationQuery, SubjectSet, QUERIES[i])
    mine = tmsg.query_to_proto(q)
    assert mine.SerializeToString(deterministic=True) == jmsg.query_to_proto(
        _query(JQuery, JSubjectSet, QUERIES[i])).SerializeToString(deterministic=True)
    back = tmsg.query_from_proto(mine)
    assert (back.namespace, back.object, back.relation, back.subject) == \
        (q.namespace, q.object, q.relation, q.subject)
    # the deprecated all-string query: empty strings are unset
    legacy = pb.ListRelationTuplesRequest.Query(
        namespace=q.namespace or "", object=q.object or "", relation=q.relation or "")
    if q.subject is not None:
        legacy.subject.CopyFrom(tmsg.subject_to_proto(q.subject))
    mine_l, theirs_l = tmsg.query_from_legacy_proto(legacy), jmsg.query_from_legacy_proto(
        jdesc.pb.ListRelationTuplesRequest.Query.FromString(legacy.SerializeToString()))
    assert (mine_l.namespace, mine_l.object, mine_l.relation, str(mine_l.subject)) == \
        (theirs_l.namespace, theirs_l.object, theirs_l.relation, str(theirs_l.subject))


def _tree(kind):
    leaf = Tree(type=TreeNodeType.LEAF, tuple=RelationTuple.from_string("videos:/d1#owner@alice"))
    node = Tree(type=kind, tuple=RelationTuple.from_string("videos:/d1#view@(videos:/d1#owner)"),
                children=[leaf, Tree(type=TreeNodeType.LEAF, tuple=RelationTuple.from_string(
                    "videos:/d1#owner@(groups:eng#member)"))])
    return Tree(type=TreeNodeType.UNION, tuple=None, children=[node, leaf])


@pytest.mark.parametrize("kind", list(TreeNodeType))
def test_tree_bytes_and_round_trip(kind):
    t = _tree(kind)
    mine = tmsg.tree_to_proto(t)
    theirs = jmsg.tree_to_proto(JTree.from_dict(t.to_dict()))
    assert mine.SerializeToString(deterministic=True) == theirs.SerializeToString(
        deterministic=True)
    back = tmsg.tree_from_proto(mine)
    mapped = kind if kind in (TreeNodeType.LEAF, TreeNodeType.UNION, TreeNodeType.EXCLUSION,
                              TreeNodeType.INTERSECTION) else TreeNodeType.UNSPECIFIED
    assert back.children[0].type == mapped
    assert back.to_dict() == jmsg.tree_from_proto(theirs).to_dict()
    # a node with only the deprecated subject field decodes as keto_tpu's
    legacy = pb.SubjectTree(node_type=4)
    legacy.subject.CopyFrom(tmsg.subject_to_proto("alice"))
    assert tmsg.tree_from_proto(legacy).to_dict() == jmsg.tree_from_proto(
        jdesc.pb.SubjectTree.FromString(legacy.SerializeToString())).to_dict()


# -- (c) every method, raw bytes against keto_tpu --------------------------------------


def _tuple_pb(s):
    return tmsg.tuple_to_proto(RelationTuple.from_string(s))


def _check(s=None, token="", depth=0, flat=False, **fields):
    req = pb.CheckRequest(snaptoken=token, max_depth=depth, **fields)
    if s is not None:
        t = _tuple_pb(s)
        if flat:  # the deprecated flat fields
            req.namespace, req.object, req.relation = t.namespace, t.object, t.relation
            req.subject.CopyFrom(t.subject)
        else:
            req.tuple.CopyFrom(t)
    return req


def _subject_pb(sub):
    return tmsg.subject_to_proto(SubjectSet.from_string(sub) if ":" in sub else sub)


def _list_objects(sub="alice", token="", **kw):
    req = pb.ListObjectsRequest(namespace=kw.pop("namespace", "videos"),
                                relation=kw.pop("relation", "view"), snaptoken=token, **kw)
    if sub is not None:
        req.subject.CopyFrom(_subject_pb(sub))
    return req


def _filter(sub="alice", objects=("/d1", "/d2", "/d2/v1", "/d1/v1", "/nope", "/d1"), token="",
            **kw):
    req = pb.FilterRequest(namespace=kw.pop("namespace", "videos"),
                           relation=kw.pop("relation", "view"), snaptoken=token, **kw)
    req.objects.extend(objects)
    if sub is not None:
        req.subject.CopyFrom(_subject_pb(sub))
    return req


def _expand(sub, depth=0, token=""):
    req = pb.ExpandRequest(max_depth=depth, snaptoken=token)
    if sub is not None:
        req.subject.CopyFrom(_subject_pb(sub))
    return req


def _batch(items, token="", depth=0):
    req = pb.BatchCheckRequest(snaptoken=token, max_depth=depth)
    for s in items:
        req.tuples.append(_tuple_pb(s) if s is not None else
                          pb.RelationTuple(namespace="videos", object="/d1", relation="view"))
    return req


def _list_tuples(query=None, legacy=None, token="", **kw):
    req = pb.ListRelationTuplesRequest(snaptoken=token, **kw)
    if query is not None:
        req.relation_query.CopyFrom(tmsg.query_to_proto(_query(RelationQuery, SubjectSet,
                                                               query)))
    if legacy is not None:
        req.query.CopyFrom(pb.ListRelationTuplesRequest.Query(**legacy))
    return req


CHECK_PATH = f"/{tdesc.CHECK_SERVICE}/Check"
BATCH_PATH = f"/{tdesc.BATCH_CHECK_SERVICE}/BatchCheck"
EXPAND_PATH = f"/{tdesc.EXPAND_SERVICE}/Expand"
LIST_TUPLES_PATH = f"/{tdesc.READ_SERVICE}/ListRelationTuples"
LIST_OBJECTS_PATH = f"/{tdesc.REVERSE_READ_SERVICE}/ListObjects"
LIST_SUBJECTS_PATH = f"/{tdesc.REVERSE_READ_SERVICE}/ListSubjects"
FILTER_PATH = f"/{tdesc.FILTER_SERVICE}/Filter"
VERSION_PATH = f"/{tdesc.VERSION_SERVICE}/GetVersion"
HEALTH_PATH = f"/{tdesc.HEALTH_SERVICE}/Check"
HEALTH_WATCH_PATH = f"/{tdesc.HEALTH_SERVICE}/Watch"
TRANSACT_PATH = f"/{tdesc.WRITE_SERVICE}/TransactRelationTuples"
DELETE_PATH = f"/{tdesc.WRITE_SERVICE}/DeleteRelationTuples"

READS = {
    "check_allowed": (CHECK_PATH, _check("videos:/d1/v2#view@alice")),
    "check_denied": (CHECK_PATH, _check("videos:/d1/v2#view@bob")),
    "check_group": (CHECK_PATH, _check("videos:/d2/v1#view@carol", depth=4)),
    "check_subject_set": (CHECK_PATH, _check("videos:/d2#view@(groups:eng#member)")),
    "check_flat_fields": (CHECK_PATH, _check("videos:/d1/v2#view@alice", flat=True)),
    "check_flat_denied": (CHECK_PATH, _check("videos:/d2#owner@alice", flat=True)),
    "check_nil_subject": (CHECK_PATH, pb.CheckRequest(
        tuple=pb.RelationTuple(namespace="videos", object="/d1", relation="view"))),
    "check_empty": (CHECK_PATH, pb.CheckRequest()),
    "check_unknown_namespace": (CHECK_PATH, _check("ghost:/d1#view@alice")),
    "check_unknown_relation": (CHECK_PATH, _check("videos:/d1#nope@alice")),
    "batch": (BATCH_PATH, _batch(["videos:/d1/v2#view@alice", "videos:/d1/v2#view@bob", None,
                                  "ghost:/x#view@alice", "videos:/d2/v1#view@carol"])),
    "batch_empty": (BATCH_PATH, _batch([])),
    "expand_subject_set": (EXPAND_PATH, _expand("videos:/d1#owner", depth=3)),
    "expand_rewrite": (EXPAND_PATH, _expand("videos:/d2#view", depth=4)),
    "expand_subject_id_leaf": (EXPAND_PATH, _expand("alice")),
    "expand_nil_subject": (EXPAND_PATH, _expand(None)),
    "expand_no_tuples": (EXPAND_PATH, _expand("videos:/nothing#owner")),
    "expand_unknown_namespace": (EXPAND_PATH, _expand("ghost:/d1#owner")),
    "list_objects": (LIST_OBJECTS_PATH, _list_objects()),
    "list_objects_subject_set": (LIST_OBJECTS_PATH, _list_objects("groups:eng#member")),
    "list_objects_nil_subject": (LIST_OBJECTS_PATH, _list_objects(None)),
    "list_objects_unknown_namespace": (LIST_OBJECTS_PATH, _list_objects(namespace="ghost")),
    "list_objects_bad_page_token": (LIST_OBJECTS_PATH, _list_objects(page_token="junk")),
    "list_subjects": (LIST_SUBJECTS_PATH, pb.ListSubjectsRequest(
        namespace="videos", object="/d2/v1", relation="view")),
    "list_subjects_unknown_namespace": (LIST_SUBJECTS_PATH, pb.ListSubjectsRequest(
        namespace="ghost", object="/d2/v1", relation="view")),
    "filter": (FILTER_PATH, _filter()),
    "filter_subject_set": (FILTER_PATH, _filter("groups:eng#member")),
    "filter_nil_subject": (FILTER_PATH, _filter(None)),
    "filter_unknown_namespace": (FILTER_PATH, _filter(namespace="ghost")),
    "list_tuples_query": (LIST_TUPLES_PATH, _list_tuples({"namespace": "videos",
                                                          "relation": "owner"})),
    "list_tuples_subject": (LIST_TUPLES_PATH, _list_tuples({"subject_id": "alice"})),
    "list_tuples_legacy": (LIST_TUPLES_PATH, _list_tuples(legacy={"namespace": "videos",
                                                                  "relation": "parent"})),
    "list_tuples_no_query": (LIST_TUPLES_PATH, _list_tuples()),
    "list_tuples_unknown_namespace": (LIST_TUPLES_PATH, _list_tuples({"namespace": "ghost"})),
    "list_tuples_bad_page_token": (LIST_TUPLES_PATH, _list_tuples({"namespace": "videos"},
                                                                   page_token="junk")),
    "version": (VERSION_PATH, pb.GetVersionRequest()),
    "health": (HEALTH_PATH, pb.HealthCheckRequest()),
    "write_service_not_on_read_port": (TRANSACT_PATH, pb.TransactRelationTuplesRequest()),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_read_methods_equal_keto_tpu(daemons, case):
    path, msg = READS[case]
    got, want = both(*daemons, path, msg)
    assert got == want, case
    if case == "check_allowed":
        assert pb.CheckResponse.FromString(got[1]) == pb.CheckResponse(
            allowed=True, snaptoken=encode_snaptoken(1, NID))
    if case == "check_unknown_namespace":
        assert got[0] == "NOT_FOUND"
    if case == "batch":
        assert [(r.allowed, r.error) for r in pb.BatchCheckResponse.FromString(got[1]).results][
            :3] == [(True, ""), (False, ""), (False, "subject is not allowed to be nil")]
    if case == "expand_subject_id_leaf":
        tree = pb.ExpandResponse.FromString(got[1]).tree
        assert tree.node_type == 4 and tree.subject.id == "alice" and not tree.HasField("tuple")


WATCH_PATH = f"/{tdesc.WATCH_SERVICE}/Watch"


def watch_raw(port, req, n=1, timeout=WAIT_S, heartbeats=False):
    """One Watch call's first `n` frames (heartbeats left out unless
    asked for): (code, frames, details)."""
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_stream(WATCH_PATH)(req.SerializeToString(), timeout=timeout)
    frames = []
    try:
        for raw in call:
            if heartbeats or pb.WatchResponse.FromString(raw).event_type != "heartbeat":
                frames.append(raw)
            if len(frames) >= n:
                break
        return "OK", frames, ""
    except grpc.RpcError as e:
        return e.code().name, frames, e.details()
    finally:
        call.cancel()
        ch.close()


@pytest.mark.parametrize("namespace", ["", "groups"])
def test_watch_replay_equals_keto_tpu(daemons, namespace):
    """The tuple WatchService from v0: the store's one commit (version 1,
    every tuple) as one event, byte for byte keto_tpu's; the namespace
    filter keeps the changes of its namespace."""
    req = pb.WatchRequest(snaptoken=encode_snaptoken(0, NID), namespace=namespace)
    got, want = (watch_raw(d.read_port, req) for d in daemons)
    assert got == want and got[0] == "OK"
    event = pb.WatchResponse.FromString(got[1][0])
    assert event.event_type == "change" and event.snaptoken == encode_snaptoken(1, NID)
    kept = [t for t in TUPLES if not namespace or t.startswith(namespace + ":")]
    assert [c.action for c in event.changes] == ["insert"] * len(kept)


@pytest.mark.parametrize("token", sorted(TOKENS))
def test_watch_snaptokens_equal_keto_tpu(daemons, token):
    """A bad token ends the stream with keto_tpu's code and details; a
    token the store satisfies opens a live tail that stays quiet until
    the client's deadline."""
    req = pb.WatchRequest(snaptoken=TOKENS[token])
    got, want = (watch_raw(d.read_port, req, timeout=0.5) for d in daemons)
    assert got == want, token
    code = {"malformed": "INVALID_ARGUMENT", "other_network": "INVALID_ARGUMENT",
            "ahead_of_store": "FAILED_PRECONDITION"}.get(token, "DEADLINE_EXCEEDED")
    assert got[0] == code and got[1] == [], token


TOKEN_METHODS = {
    "check": lambda tok: (CHECK_PATH, _check("videos:/d1/v2#view@alice", token=tok)),
    "batch": lambda tok: (BATCH_PATH, _batch(["videos:/d1/v2#view@alice"], token=tok)),
    "expand": lambda tok: (EXPAND_PATH, _expand("videos:/d1#owner", token=tok)),
    "list_objects": lambda tok: (LIST_OBJECTS_PATH, _list_objects(token=tok)),
    "list_subjects": lambda tok: (LIST_SUBJECTS_PATH, pb.ListSubjectsRequest(
        namespace="videos", object="/d2/v1", relation="view", snaptoken=tok)),
    "filter": lambda tok: (FILTER_PATH, _filter(token=tok)),
    "list_tuples": lambda tok: (LIST_TUPLES_PATH, _list_tuples({"namespace": "videos"},
                                                               token=tok)),
}


@pytest.mark.parametrize("token", sorted(TOKENS))
@pytest.mark.parametrize("method", sorted(TOKEN_METHODS))
def test_snaptokens_equal_keto_tpu(daemons, method, token):
    path, msg = TOKEN_METHODS[method](TOKENS[token])
    got, want = both(*daemons, path, msg)
    assert got == want, (method, token)
    code = {"malformed": "INVALID_ARGUMENT", "other_network": "INVALID_ARGUMENT",
            "ahead_of_store": "FAILED_PRECONDITION"}.get(token, "OK")
    assert got[0] == code


@pytest.mark.parametrize("path,make,field", [
    (LIST_OBJECTS_PATH, lambda tok: _list_objects(page_size=2, page_token=tok), "objects"),
    (LIST_SUBJECTS_PATH, lambda tok: pb.ListSubjectsRequest(
        namespace="videos", object="/d2/v1", relation="view", page_size=1, page_token=tok),
     "subject_ids"),
    (LIST_TUPLES_PATH, lambda tok: _list_tuples({"namespace": "videos"}, page_size=3,
                                                page_token=tok), "relation_tuples"),
], ids=["list_objects", "list_subjects", "list_tuples"])
def test_pages_equal_keto_tpu(daemons, path, make, field):
    cls = {LIST_OBJECTS_PATH: pb.ListObjectsResponse, LIST_SUBJECTS_PATH: pb.ListSubjectsResponse,
           LIST_TUPLES_PATH: pb.ListRelationTuplesResponse}[path]
    token, sizes = "", []
    while True:
        got, want = both(*daemons, path, make(token))
        assert got == want and got[0] == "OK", token
        resp = cls.FromString(got[1])
        sizes.append(len(getattr(resp, field)))
        token = resp.next_page_token
        if not token:
            break
    assert len(sizes) > 1 and sum(sizes) > 2


def test_health_watch_across_a_drain():
    """A Health Watch stream on each daemon sees SERVING, then NOT_SERVING
    when the drain starts."""
    seen = []
    for daemon in make_pair():
        ch = grpc.insecure_channel(f"127.0.0.1:{daemon.read_port}")
        stream = ch.unary_stream(HEALTH_WATCH_PATH)(
            pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
        stopper = threading.Thread(target=daemon.stop, kwargs={"grace": 1.0}, daemon=True)
        try:
            statuses = [pb.HealthCheckResponse.FromString(next(stream)).status]
            stopper.start()
            statuses.append(pb.HealthCheckResponse.FromString(next(stream)).status)
        finally:
            stream.cancel()
            ch.close()
            if stopper.ident is None:  # failed before the drain began
                daemon.stop(grace=1.0)
            stopper.join(timeout=WAIT_S)
        assert not stopper.is_alive()
        seen.append(statuses)
    assert seen[0] == seen[1] == [1, 2]  # SERVING, then NOT_SERVING


def test_health_watch_cap():
    """Past serve.read.grpc.max_watchers streams a Watch is
    RESOURCE_EXHAUSTED on both."""
    tdaemon, jdaemon = make_pair(serve={"read": {**LISTEN["read"],
                                                 "grpc": {"max_watchers": 1}}})
    try:
        out = []
        for daemon in (tdaemon, jdaemon):
            ch = grpc.insecure_channel(f"127.0.0.1:{daemon.read_port}")
            watch = ch.unary_stream(HEALTH_WATCH_PATH)
            first = watch(pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
            next(first)
            second = watch(pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
            with pytest.raises(grpc.RpcError) as e:
                next(second)
            out.append((e.value.code().name, e.value.details()))
            first.cancel()
            ch.close()
        assert out[0] == out[1] == ("RESOURCE_EXHAUSTED", "too many concurrent health watchers")
    finally:
        tdaemon.stop(grace=1.0)
        jdaemon.stop(grace=1.0)


def test_writes_equal_keto_tpu():
    """Transact (inserts, deletes, an ignored ACTION_UNSPECIFIED), a Check
    at each returned token, delete by query and by the legacy query, and
    the write errors: equal bytes, codes and details, the reads after each
    write equal too."""
    tdaemon, jdaemon = make_pair()
    try:
        def transact(ins=(), dels=(), unspecified=()):
            req = pb.TransactRelationTuplesRequest()
            for action, items in ((1, ins), (2, dels), (0, unspecified)):
                for s in items:
                    d = req.relation_tuple_deltas.add()
                    d.action = action
                    d.relation_tuple.CopyFrom(_tuple_pb(s) if s else pb.RelationTuple(
                        namespace="videos", object="/x", relation="owner"))
            return both(tdaemon, jdaemon, TRANSACT_PATH, req, port="write_port")

        def reads(token):
            for s in ("videos:/d3/v1#view@dave", "videos:/d1/v2#view@alice",
                      "videos:/d2#view@carol"):
                got, want = both(tdaemon, jdaemon, CHECK_PATH, _check(s, token=token))
                assert got == want, s
            got, want = both(tdaemon, jdaemon, LIST_OBJECTS_PATH, _list_objects("dave",
                                                                                token=token))
            assert got == want

        got, want = transact(ins=["videos:/d3#owner@dave", "videos:/d3/v1#parent@(videos:/d3#...)"],
                             dels=["videos:/d1#owner@alice"], unspecified=["videos:/d1#owner@bob"])
        assert got == want and got[0] == "OK"
        tokens = list(pb.TransactRelationTuplesResponse.FromString(got[1]).snaptokens)
        assert tokens == [encode_snaptoken(2, NID)] * 2
        reads(tokens[0])
        got, want = both(tdaemon, jdaemon, CHECK_PATH,
                         _check("videos:/d3/v1#view@dave", token=tokens[0]))
        assert pb.CheckResponse.FromString(got[1]).allowed
        for bad in ([None], ["ghost:/x#owner@a"]):
            assert transact(ins=bad)[0] == transact(ins=bad)[1]
        assert transact(ins=[None])[0][0] == "INVALID_ARGUMENT"
        # delete by query, then by the legacy query, then with neither
        q = pb.DeleteRelationTuplesRequest()
        q.relation_query.CopyFrom(tmsg.query_to_proto(RelationQuery(namespace="videos",
                                                                    object="/d3")))
        got, want = both(tdaemon, jdaemon, DELETE_PATH, q, port="write_port")
        assert got == want and got[0] == "OK"
        reads(encode_snaptoken(3, NID))
        legacy = pb.DeleteRelationTuplesRequest(query=pb.DeleteRelationTuplesRequest.Query(
            namespace="groups", relation="member"))
        got, want = both(tdaemon, jdaemon, DELETE_PATH, legacy, port="write_port")
        assert got == want and got[0] == "OK"
        reads("")
        for req in (pb.DeleteRelationTuplesRequest(), pb.DeleteRelationTuplesRequest(
                relation_query=pb.RelationQuery(namespace="ghost"))):
            got, want = both(tdaemon, jdaemon, DELETE_PATH, req, port="write_port")
            assert got == want and got[0] != "OK"
        for path, msg in ((VERSION_PATH, pb.GetVersionRequest()),
                          (HEALTH_PATH, pb.HealthCheckRequest()),
                          (CHECK_PATH, _check("videos:/d1#owner@alice"))):
            got, want = both(tdaemon, jdaemon, path, msg, port="write_port")
            assert got == want, path
        assert tdaemon.registry.relation_tuple_manager().version(nid=NID) == \
            jdaemon.registry.relation_tuple_manager().version(nid=NID) == 4
    finally:
        tdaemon.stop()
        jdaemon.stop()


# -- (d) admission, deadlines and the drain over gRPC, on a gated engine -----------------


def gated_pair(serve_check=None):
    engines = (GatedEngine(T_MEMBER), GatedEngine(J_MEMBER))
    return make_pair({"check": serve_check} if serve_check else None, engines), engines


def grpc_in_flight(daemon, req):
    """A gRPC check on its own thread, admitted once the batcher counts
    it; its answer lands in the returned dict."""
    out = {}
    th = threading.Thread(target=lambda: out.update(r=raw(
        daemon.read_port, CHECK_PATH, req.SerializeToString())), daemon=True)
    th.start()
    wait_until(lambda: not daemon.batcher.idle())
    return th, out


def test_shed_at_max_queue_with_retry_after():
    (tdaemon, jdaemon), engines = gated_pair({"max_queue": 1})
    try:
        answers, sheds = [], []
        for daemon, engine in zip((tdaemon, jdaemon), engines):
            th, out = grpc_in_flight(daemon, _check("videos:/d1/v2#view@alice"))
            sheds.append(raw(daemon.read_port, CHECK_PATH,
                             _check("videos:/d1/v2#view@bob").SerializeToString()))
            engine.gate.set()
            th.join(timeout=WAIT_S)
            answers.append(out["r"])
        assert sheds[0] == sheds[1] and answers[0] == answers[1]
        assert sheds[0] == ("RESOURCE_EXHAUSTED", None, "check queue is full",
                            (("retry-after", "1"),))
        assert pb.CheckResponse.FromString(answers[0][1]).allowed
        assert tdaemon.batcher.stats["shed"]["queue_full"] == 1
    finally:
        for engine in engines:
            engine.gate.set()
        tdaemon.stop()
        jdaemon.stop()


def test_rpc_deadline_shorter_than_a_gated_batch():
    (tdaemon, jdaemon), engines = gated_pair()
    try:
        got = [raw(d.read_port, CHECK_PATH, _check("videos:/d1/v2#view@alice").SerializeToString(),
                   timeout=0.3) for d in (tdaemon, jdaemon)]
        assert [g[0] for g in got] == ["DEADLINE_EXCEEDED"] * 2
        assert not any(g[3] for g in got)  # no retry hint
        # the port's server took the RPC's deadline as its own
        wait_until(lambda: tdaemon.batcher.stats["deadline_exceeded"]["wait"] == 1)
    finally:
        for engine in engines:
            engine.gate.set()
        tdaemon.stop()
        jdaemon.stop()


def test_drain_sheds_grpc_checks_while_admitted_one_answers():
    (tdaemon, jdaemon), engines = gated_pair()
    outcomes = []
    try:
        for daemon, engine in zip((tdaemon, jdaemon), engines):
            th, out = grpc_in_flight(daemon, _check("videos:/d1/v2#view@alice"))
            stopper = threading.Thread(target=daemon.stop, kwargs={"grace": WAIT_S}, daemon=True)
            stopper.start()
            wait_until(lambda: daemon.registry.draining.is_set())
            health = raw(daemon.read_port, HEALTH_PATH, pb.HealthCheckRequest().SerializeToString())
            shed = raw(daemon.read_port, CHECK_PATH,
                       _check("videos:/d1/v2#view@bob").SerializeToString())
            rest_shed = call(daemon.read_port, "GET", "/relation-tuples/check",
                             {**CHECK, "subject_id": "carol"})
            engine.gate.set()
            th.join(timeout=WAIT_S)
            stopper.join(timeout=WAIT_S)
            assert not stopper.is_alive()
            outcomes.append((health, shed, out["r"], rest_shed[:2]))
        assert outcomes[0] == outcomes[1]
        health, shed, admitted, rest_shed = outcomes[0]
        assert pb.HealthCheckResponse.FromString(health[1]).status == 2  # NOT_SERVING
        assert shed == ("RESOURCE_EXHAUSTED", None, "server is draining", (("retry-after", "1"),))
        assert rest_shed[0] == 429 and rest_shed[1]["error"]["message"] == shed[2]
        assert admitted[0] == "OK" and pb.CheckResponse.FromString(admitted[1]).allowed
        assert tdaemon.registry.counters().snapshot()["shed"]["draining"] == 2
    finally:
        for engine in engines:
            engine.gate.set()


# -- (e) a failing device over gRPC --------------------------------------------------------


def test_device_failure_is_internal_then_unavailable():
    """Two failed device batches answer INTERNAL, then the open breaker
    UNAVAILABLE with a retry hint, each the twin of REST's answer on the
    same port; the engine's host path is never asked."""
    engine = _FailingDeviceEngine(T_MEMBER)
    cfg = {"dsn": "memory", "namespaces": NAMESPACES, "check": {"cache": {"enabled": False}},
           "serve": {**LISTEN, "check": {"breaker": {"threshold": 2, "cooldown_s": 60}}}}
    reg = TRegistry(TConfig(cfg), device="cpu", engine=engine)
    reg.relation_tuple_manager().write_relation_tuples(
        [RelationTuple.from_string(s) for s in TUPLES])
    daemon = TDaemon(reg)
    with small_pools():
        daemon.start()
    try:
        got = []
        for i in range(2):
            got.append(raw(daemon.read_port, CHECK_PATH,
                           _check(f"videos:/d1/v{i}#view@alice").SerializeToString()))
        assert [g[0] for g in got] == ["INTERNAL"] * 2 and not any(g[3] for g in got)
        rest = call(daemon.read_port, "GET", "/relation-tuples/check", CHECK)
        grpc_open = raw(daemon.read_port, CHECK_PATH, _check("videos:/d2#view@bob")
                        .SerializeToString())
        assert rest[0] == 503 and grpc_open[0] == "UNAVAILABLE"
        assert grpc_open[2] == rest[1]["error"]["message"]
        assert grpc_open[3] == (("retry-after", rest[2]["Retry-After"]),)
        assert int(rest[2]["Retry-After"]) > 1
        stats = daemon.batcher.stats
        assert stats["check_batch_failed"]["device"] == 2
        assert stats["shed"]["breaker_open"] == 2
        assert engine.host_batches == 0 and engine.submits == 2
    finally:
        daemon.stop()


# -- (f) one port, both protocols; the direct listener ----------------------------------------


def test_mux_and_direct_listener():
    direct = {"grpc": {"host": "127.0.0.1", "port": 0}}
    tdaemon, jdaemon = make_pair(serve={"read": {**LISTEN["read"], **direct},
                                        "write": {**LISTEN["write"], **direct}})
    try:
        assert tdaemon.read_grpc_port and tdaemon.write_grpc_port
        for case in ("check_allowed", "batch", "expand_subject_set", "list_objects", "filter",
                     "check_unknown_namespace", "health"):
            path, msg = READS[case]
            muxed = raw(tdaemon.read_port, path, msg.SerializeToString())
            assert raw(tdaemon.read_grpc_port, path, msg.SerializeToString()) == muxed, case
            assert raw(jdaemon.read_grpc_port, path, msg.SerializeToString()) == muxed, case
        req = pb.DeleteRelationTuplesRequest()
        assert raw(tdaemon.write_grpc_port, DELETE_PATH, req.SerializeToString()) == \
            raw(tdaemon.write_port, DELETE_PATH, req.SerializeToString())
        # REST on the same ports
        for port_name in ("read_port", "write_port"):
            got = call(getattr(tdaemon, port_name), "GET", "/version")
            assert got == call(getattr(jdaemon, port_name), "GET", "/version")
        got = call(tdaemon.read_port, "GET", "/relation-tuples/check", CHECK)
        assert got == call(jdaemon.read_port, "GET", "/relation-tuples/check", CHECK)
        assert got[:2] == (200, {"allowed": True})
        # the direct port speaks gRPC only
        with pytest.raises(Exception):
            call(tdaemon.read_grpc_port, "GET", "/version")
    finally:
        tdaemon.stop()
        jdaemon.stop()


def test_mux_routes_each_connection_by_its_first_bytes():
    """A client that sends the HTTP/2 preface a byte at a time still reaches
    the gRPC backend, and a REST request line is handed to the HTTP
    server's process_request with its bytes unread."""
    import socket

    from keto_tpu_torch.api.daemon import PortMux

    grpc_backend = socket.create_server(("127.0.0.1", 0))

    def serve_grpc():
        conn, _ = grpc_backend.accept()
        # the whole 24-byte preface, so that the close cannot land while
        # the client still sends it
        data = b""
        while len(data) < 24:
            chunk = conn.recv(64)
            if not chunk:
                break
            data += chunk
        conn.sendall(b"grpc:" + data)
        conn.close()

    class HTTPServer:
        def process_request(self, conn, addr):
            conn.sendall(b"rest:" + conn.recv(64))
            conn.close()

    threading.Thread(target=serve_grpc, daemon=True).start()
    mux = PortMux("127.0.0.1", 0, grpc_backend.getsockname(), HTTPServer())
    mux.start()
    try:
        out = []
        for payload, slow in ((b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n", True),
                              (b"GET /version HTTP/1.1\r\n\r\n", False)):
            c = socket.create_connection(("127.0.0.1", mux.port), timeout=WAIT_S)
            if slow:
                for i in range(len(payload)):
                    c.sendall(payload[i:i + 1])
                    time.sleep(0.002)
            else:
                c.sendall(payload)
            data = b""
            while True:
                chunk = c.recv(256)
                if not chunk:
                    break
                data += chunk
            c.close()
            out.append(data)
        assert out[0].startswith(b"grpc:PRI * HTTP/2.0") and out[1].startswith(b"rest:GET /")
    finally:
        mux.stop()
        grpc_backend.close()


# -- explain -----------------------------------------------------------------------------


def test_explain_is_unimplemented_on_the_port(daemons):
    """keto_tpu answers a DecisionTrace beside the verdict; the port, which
    has not ported engine/explain.py, answers UNIMPLEMENTED over gRPC and a
    typed 501 over REST (query parameter or body field), never a bare
    verdict."""
    tdaemon, jdaemon = daemons
    req = _check("videos:/d1/v2#view@alice", explain=True)
    got, want = both(tdaemon, jdaemon, CHECK_PATH, req)
    assert want[0] == "OK" and pb.CheckResponse.FromString(want[1]).decision_trace
    assert got[0] == "UNIMPLEMENTED" and "explain" in got[2]
    params = {**CHECK, "explain": "true"}
    want = call(jdaemon.read_port, "GET", "/relation-tuples/check", params)
    assert want[0] == 200 and "decision_trace" in want[1]
    grpc_details = got[2]
    for method, p, body in (("GET", params, None), ("POST", {}, {**CHECK, "explain": True}),
                            ("GET", {**params, "explain": "1"}, None)):
        got = call(tdaemon.read_port, method, "/relation-tuples/check", p, body)
        assert got[0] == 501 and got[1]["error"]["status"] == "not_implemented", (method, p)
        assert got[1]["error"]["message"] == grpc_details


def test_rest_check_url_unchanged_without_explain(daemons):
    """explain=false still checks."""
    tdaemon, jdaemon = daemons
    params = {**CHECK, "explain": "false"}
    got = call(tdaemon.read_port, "GET", "/relation-tuples/check", params)
    assert got == call(jdaemon.read_port, "GET", "/relation-tuples/check", params)
    assert got[:2] == (200, {"allowed": True})
