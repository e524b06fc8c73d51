"""The port's REST Check, Expand and Filter routes over a CPU engine: the
serve entry point as a subprocess, and the routes in process, held
against the JAX package's host oracle and engine on the same tuples."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest

from keto_tpu.config import Config as JConfig
from keto_tpu.engine import ReferenceEngine as JReference
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
from keto_tpu.storage import MemoryManager as JMemory

from keto_tpu_torch.api.daemon import make_batcher
from keto_tpu_torch.api.rest_server import make_server
from keto_tpu_torch.engine.snaptoken import encode_snaptoken
from keto_tpu_torch.config import Config
from keto_tpu_torch.ketoapi import RelationTuple
from keto_tpu_torch.registry import Registry
from keto_tpu_torch.storage import MemoryManager

from test_torch_filter import TUPLES as FILTER_TUPLES
from test_torch_filter import namespaces as filter_namespaces
from test_torch_kernel import SCENARIOS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(base, path, params=None):
    url = base + path + ("?" + urllib.parse.urlencode(params) if params else "")
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _params(s):
    t = RelationTuple.from_string(s)
    p = {"namespace": t.namespace, "object": t.object, "relation": t.relation}
    if t.subject_set is not None:
        p.update({
            "subject_set.namespace": t.subject_set.namespace,
            "subject_set.object": t.subject_set.object,
            "subject_set.relation": t.subject_set.relation,
        })
    else:
        p["subject_id"] = t.subject_id
    return p


@pytest.fixture(scope="module")
def rewrite_server():
    namespaces, tuples, queries, max_depth = SCENARIOS["rewrite_fixtures"]()
    cfg = Config({"limit": {"max_read_depth": max_depth},
                  "namespaces": [ns.to_dict() for ns in namespaces]})
    m = MemoryManager()
    m.write_relation_tuples([RelationTuple.from_string(s) for s in tuples])
    registry = Registry(cfg, device="cpu", manager=m)
    batcher = make_batcher(registry)
    server = make_server(registry, "127.0.0.1", 0, batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    jcfg = JConfig({"limit": {"max_read_depth": max_depth}})
    jcfg.set_namespaces(namespaces)
    jm = JMemory()
    jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
    yield f"http://127.0.0.1:{server.server_address[1]}", queries, JReference(jm, jcfg)
    server.shutdown()
    server.server_close()
    batcher.close()


def test_check_routes_match_oracle(rewrite_server):
    base, queries, oracle = rewrite_server
    for q in queries:
        want = oracle.check_relation_tuple(JTuple.from_string(q)).allowed
        code, body, headers = _get(base, "/relation-tuples/check", _params(q))
        assert (code, body) == ((200, {"allowed": True}) if want else (403, {"allowed": False})), q
        assert headers["X-Keto-Snaptoken"] == encode_snaptoken(1, "default")
        code, body, _ = _get(base, "/relation-tuples/check/openapi", _params(q))
        assert (code, body) == (200, {"allowed": want}), q


def test_batch_route_matches_oracle(rewrite_server):
    base, queries, oracle = rewrite_server
    items = [RelationTuple.from_string(q).to_dict() for q in queries]
    items.append({"namespace": "ghost", "object": "o", "relation": "r", "subject_id": "u"})
    items.append({"namespace": "doc"})
    code, body = _post(base, "/relation-tuples/check/batch", {"tuples": items})
    assert code == 200
    want = [{"allowed": oracle.check_relation_tuple(JTuple.from_string(q)).allowed}
            for q in queries]
    assert body["results"][: len(queries)] == want
    assert body["results"][-2]["allowed"] is False and "ghost" in body["results"][-2]["error"]
    assert body["results"][-1]["allowed"] is False and body["results"][-1]["error"]
    assert body["snaptoken"] == encode_snaptoken(1, "default")


def test_errors_and_unknown_namespace(rewrite_server):
    base, _queries, _oracle = rewrite_server
    code, body, _ = _get(base, "/relation-tuples/check",
                         {"namespace": "ghost", "object": "o", "relation": "r", "subject_id": "u"})
    assert (code, body) == (403, {"allowed": False})
    code, body, _ = _get(base, "/relation-tuples/check", {"namespace": "doc"})
    assert code == 400 and body["error"]["code"] == 400
    code, body = _post(base, "/relation-tuples/check/batch", {"tuples": "nope"})
    assert code == 400
    code, body, _ = _get(base, "/nowhere")
    assert code == 404
    code, body = _post(base, "/relation-tuples/check", [1])
    assert code == 400 and body["error"]["status"] == "bad_request"
    t = RelationTuple.from_string("doc:document#owner@user").to_dict()
    assert _post(base, "/relation-tuples/check", t) == (200, {"allowed": True})


@pytest.fixture(scope="module")
def videos_server():
    namespaces, tuples, _queries, max_depth = SCENARIOS["cat_videos"]()
    cfg = Config({"limit": {"max_read_depth": max_depth},
                  "namespaces": [ns.to_dict() for ns in namespaces]})
    m = MemoryManager()
    m.write_relation_tuples([RelationTuple.from_string(s) for s in tuples])
    registry = Registry(cfg, device="cpu", manager=m)
    batcher = make_batcher(registry)
    server = make_server(registry, "127.0.0.1", 0, batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    jcfg = JConfig({"limit": {"max_read_depth": max_depth}})
    jcfg.set_namespaces(namespaces)
    jm = JMemory()
    jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
    yield f"http://127.0.0.1:{server.server_address[1]}", TPUCheckEngine(jm, jcfg)
    server.shutdown()
    server.server_close()
    batcher.close()


def _expand_params(subject_set, depth=None):
    ns, rest = subject_set.split(":", 1)
    obj, rel = rest.split("#")
    p = {"namespace": ns, "object": obj, "relation": rel}
    if depth is not None:
        p["max-depth"] = str(depth)
    return p


@pytest.mark.parametrize("depth", [None, 1, 2, 3])
def test_expand_route_matches_jax_engine(videos_server, depth):
    base, jax_engine = videos_server
    for s in ("videos:/cats/1.mp4#view", "videos:/cats/2.mp4#view", "videos:/cats#owner",
              "videos:/cats/1.mp4#owner"):
        want = jax_engine.expand(JSubjectSet.from_string(s), depth or 0)
        code, body, _ = _get(base, "/relation-tuples/expand", _expand_params(s, depth))
        assert (code, body) == (200, want.to_dict()), (s, depth)
    if depth == 1:
        assert body == {"type": "leaf", "tuple": body["tuple"]}


def test_expand_route_errors(videos_server):
    base, _jax = videos_server
    code, body, _ = _get(base, "/relation-tuples/expand",
                         _expand_params("videos:/cats/9.mp4#view"))
    assert code == 404 and body["error"]["message"] == "no relation tuples found"
    code, body, _ = _get(base, "/relation-tuples/expand", _expand_params("ghost:o#r"))
    assert code == 404 and "ghost" in body["error"]["message"]
    code, body, _ = _get(base, "/relation-tuples/expand",
                         {"namespace": "videos", "object": "/cats"})
    assert code == 400 and body["error"]["code"] == 400
    code, body, _ = _get(base, "/relation-tuples/expand",
                         {**_expand_params("videos:/cats#owner"), "max-depth": "x"})
    assert code == 400


@pytest.fixture(scope="module")
def filter_server():
    namespaces, tuples = filter_namespaces(), FILTER_TUPLES
    cfg = {"limit": {"max_read_depth": 12}, "closure": {"enabled": True},
           "filter": {"max_objects": 8}}
    tcfg = Config({**cfg, "namespaces": [ns.to_dict() for ns in namespaces]})
    m = MemoryManager()
    m.write_relation_tuples([RelationTuple.from_string(s) for s in tuples])
    registry = Registry(tcfg, device="cpu", manager=m)
    engine = registry.check_engine()
    assert engine.closure_ensure_built()
    batcher = make_batcher(registry)
    server = make_server(registry, "127.0.0.1", 0, batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    jcfg = JConfig(cfg)
    jcfg.set_namespaces(namespaces)
    jm = JMemory()
    jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
    yield f"http://127.0.0.1:{server.server_address[1]}", TPUCheckEngine(jm, jcfg), engine
    server.shutdown()
    server.server_close()
    batcher.close()


FILTER_ROUTE = "/relation-tuples/filter"
FILTER_OK = {
    "subject_id": ({"namespace": "videos", "relation": "view", "subject_id": "v_alice",
                    "objects": ["/d1", "/d2", "/d2/v1", "/nope"]}, "v_alice"),
    "duplicates_kept_in_order": ({"namespace": "videos", "relation": "view",
                                  "subject_id": "v_alice",
                                  "objects": ["/d2/v1", "/d1/v1", "/d2/v1", "/d2"]}, "v_alice"),
    "subject_set": ({"namespace": "videos", "relation": "view",
                     "subject_set": {"namespace": "groups", "object": "eng",
                                     "relation": "member"},
                     "objects": ["/d1", "/d1/v2", "/d2"]}, "groups:eng#member"),
    "max_depth": ({"namespace": "chain", "relation": "member", "subject_id": "d_alice",
                   "objects": ["g0", "g4", "g5", "g6"], "max_depth": 2}, "d_alice"),
    "unknown_subject": ({"namespace": "videos", "relation": "view", "subject_id": "ghost",
                         "objects": ["/d1"]}, "ghost"),
    "empty_column": ({"namespace": "files", "relation": "owner", "subject_id": "f_alice",
                      "objects": []}, "f_alice"),
}


@pytest.mark.parametrize("case", sorted(FILTER_OK))
def test_filter_route_matches_jax_engine(filter_server, case):
    base, jax_engine, _engine = filter_server
    body, subject = FILTER_OK[case]
    sub = JSubjectSet.from_string(subject) if "#" in subject else subject
    want = jax_engine.filter_objects(body["namespace"], body["relation"], sub, body["objects"],
                                     body.get("max_depth", 0))
    assert _post(base, FILTER_ROUTE, body) == (
        200, {"allowed_objects": want, "snaptoken": encode_snaptoken(1, "default")})
    if case == "duplicates_kept_in_order":
        assert want == ["/d2/v1", "/d1/v1", "/d2/v1"]


def test_filter_route_rides_the_closure(filter_server):
    base, _jax, engine = filter_server
    before = engine.stats["filter_closure"]
    code, body = _post(base, FILTER_ROUTE, {"namespace": "chain", "relation": "member",
                                            "subject_id": "d_alice", "objects": ["g1", "g6"]})
    assert (code, body) == (200, {"allowed_objects": ["g1", "g6"],
                                  "snaptoken": encode_snaptoken(1, "default")})
    assert engine.stats["filter_closure"] == before + 2


@pytest.mark.parametrize("body,status", [
    ({"namespace": "videos", "relation": "view", "subject_id": "a", "objects": "/d1"}, 400),
    ({"namespace": "videos", "relation": "view", "subject_id": "a", "objects": ["/d1", 3]}, 400),
    ({"relation": "view", "subject_id": "a", "objects": ["/d1"]}, 400),
    ({"namespace": "videos", "subject_id": "a", "objects": ["/d1"]}, 400),
    ({"namespace": "videos", "relation": "view", "objects": ["/d1"]}, 400),
    ({"namespace": "videos", "relation": "view", "subject_id": "a",
      "subject_set": {"namespace": "groups", "object": "eng", "relation": "member"},
      "objects": ["/d1"]}, 400),
    ({"namespace": "videos", "relation": "view", "subject_id": "a", "objects": ["/d1"] * 9},
     400),
    ({"namespace": "videos", "relation": "view", "subject_id": "a", "objects": ["/d1"],
      "max_depth": "x"}, 400),
    ([1, 2], 400),
    ({"namespace": "ghost", "relation": "view", "subject_id": "a", "objects": ["/d1"]}, 404),
])
def test_filter_route_errors(filter_server, body, status):
    base, _jax, _engine = filter_server
    code, got = _post(base, FILTER_ROUTE, body)
    assert code == status and got["error"]["code"] == status
    if isinstance(body, dict) and len(body.get("objects", [])) == 9:
        assert "filter.max_objects" in got["error"]["message"]


def test_serve_entry_point(tmp_path):
    """`python -m keto_tpu_torch serve` on the CPU with the closure on: a
    200, a 403, a batch, an expand and a filter over a small store, a PUT
    on the write listener that a check carrying its snaptoken sees, then a
    clean stop on SIGTERM."""
    namespaces, tuples, _queries, _depth = SCENARIOS["cat_videos"]()
    cfg = {
        "namespaces": [ns.to_dict() for ns in namespaces],
        "serve": {"read": {"host": "127.0.0.1", "port": 0},
                  "write": {"host": "127.0.0.1", "port": 0}},
        "closure": {"enabled": True},
    }
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "tuples.txt").write_text("\n".join(tuples) + "\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "keto_tpu_torch", "serve", "--config", str(tmp_path / "cfg.json"),
         "--tuples", str(tmp_path / "tuples.txt"), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving read="), line + proc.stderr.read()
        base = "http://" + line.split("=", 1)[1].strip()
        line = proc.stdout.readline()
        assert line.startswith("serving write="), line + proc.stderr.read()
        write_base = "http://" + line.split("=", 1)[1].strip()
        code, body, _ = _get(base, "/relation-tuples/check",
                             _params("videos:/cats/1.mp4#view@cat lady"))
        assert (code, body) == (200, {"allowed": True})
        code, body, _ = _get(base, "/relation-tuples/check",
                             _params("videos:/cats/2.mp4#view@john"))
        assert (code, body) == (403, {"allowed": False})
        code, body = _post(base, "/relation-tuples/check/batch", [
            RelationTuple.from_string(s).to_dict()
            for s in ("videos:/cats/2.mp4#view@cat lady", "videos:/cats#owner@john")
        ])
        assert code == 200 and body["results"] == [{"allowed": True}, {"allowed": False}]
        code, body, _ = _get(base, "/relation-tuples/expand",
                             _expand_params("videos:/cats/1.mp4#view"))
        assert code == 200 and body["type"] == "union" and len(body["children"]) == 2
        code, body = _post(base, FILTER_ROUTE, {
            "namespace": "videos", "relation": "view", "subject_id": "cat lady",
            "objects": ["/cats/2.mp4", "/cats/9.mp4", "/cats/1.mp4"]})
        assert (code, body) == (200, {"allowed_objects": ["/cats/2.mp4", "/cats/1.mp4"],
                                      "snaptoken": encode_snaptoken(1, "default")})
        grant = RelationTuple.from_string("videos:/cats/2.mp4#view@john")
        req = urllib.request.Request(
            write_base + "/admin/relation-tuples", data=json.dumps(grant.to_dict()).encode(),
            method="PUT", headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201 and json.loads(r.read()) == grant.to_dict()
            token = r.headers["X-Keto-Snaptoken"]
        assert token == encode_snaptoken(2, "default")
        code, body, _ = _get(base, "/relation-tuples/check",
                             {**_params("videos:/cats/2.mp4#view@john"), "snaptoken": token})
        assert (code, body) == (200, {"allowed": True})
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
        proc.stdout.close()
        proc.stderr.close()


def test_serve_on_cuda_without_a_card_fails(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (tmp_path / "cfg.json").write_text(json.dumps({"namespaces": []}))
    proc = subprocess.run(
        [sys.executable, "-m", "keto_tpu_torch", "serve", "--config", str(tmp_path / "cfg.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
