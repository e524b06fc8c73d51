"""REST Check, Expand, List and Filter routes and the write routes on
stdlib threaded HTTP servers, in front of a TorchCheckEngine and its
store.

The read listener (make_server):

  GET  /relation-tuples/check          -> 200 {"allowed": true} / 403 {"allowed": false}
  POST /relation-tuples/check          -> the same, tuple as a JSON body
  GET  /relation-tuples/check/openapi  -> always 200 {"allowed": ...}
  POST /relation-tuples/check/batch    -> {"results": [{"allowed": bool} |
                                          {"allowed": false, "error": str}],
                                          "snaptoken": str}; the request
                                          token as a query param or a
                                          "snaptoken" body field
  GET  /relation-tuples/expand         -> 200 the tree's JSON, 404 when no
                                          tuple matches the subject set
                                          (params namespace, object,
                                          relation, optional max-depth)
  GET  /relation-tuples/list-objects   -> {"objects": [...], "next_page_token": str}
                                          (params namespace, relation, subject_id
                                          or subject_set.namespace/object/relation)
  GET  /relation-tuples/list-subjects  -> {"subject_ids": [...], "next_page_token": str}
                                          (params namespace, object, relation)
                                          both list routes also take max-depth,
                                          page_size and page_token
  POST /relation-tuples/filter         -> {"allowed_objects": [...],
                                          "snaptoken": str}, the candidates
                                          the subject can see in request
                                          order, duplicates kept (body
                                          namespace, relation, subject_id or
                                          subject_set, objects, optional
                                          max_depth and snaptoken)
  GET  /health/alive, /health/ready    -> 200 {"status": "ok"}

The write listener (make_write_server), Keto's admin routes:

  PUT    /admin/relation-tuples        -> 201, the tuple echoed, a Location
                                          of its read query and the
                                          X-Keto-Snaptoken of the write
  DELETE /admin/relation-tuples        -> 204; every tuple the URL query
                                          matches is deleted
  PATCH  /admin/relation-tuples        -> 204 and X-Keto-Snaptoken; a body
                                          [{"action": "insert" | "delete",
                                          "relation_tuple": {...}}] applied
                                          as one commit

Keto's semantics: an unknown namespace on a single check answers
{"allowed": false} rather than an error; the batch route reports it per
item; Expand and the list routes answer it with 404. A missing parameter
or a malformed page token is a 400; an unknown object, relation or
subject lists nothing. A filter body whose objects are not a list of
strings, that lacks a namespace, a relation or a subject, or that carries
more objects than `filter.max_objects` is a 400. Errors use the herodot shape {"error": {code,
status, message}}.
Every route but Expand takes a `snaptoken` (engine/snaptoken.py) and
enforces it before it validates names: a malformed token, or one of
another network, is a 400, one ahead of the store a 409. The answer
carries the store version read at enforcement, in the X-Keto-Snaptoken
header (check and list routes) or a "snaptoken" body field (batch and
filter). The engine is not thread-safe, so requests take one lock around
it. The write routes go to the store, which has its own lock; a write
names only configured namespaces (else 404), and the engine folds it
into its mirror at its next read or, wired to the store's write
listener, on its refresh thread.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..errors import (
    FilterTooLargeError,
    KetoError,
    MalformedInputError,
    NamespaceNotFoundError,
    NilSubjectError,
    NotFoundError,
)
from ..engine.snaptoken import encode_snaptoken, enforce_snaptoken
from ..ketoapi import (
    PatchAction,
    PatchDelta,
    RelationQuery,
    RelationTuple,
    SubjectSet,
    _subject_fields_from_dict,
)

CHECK_ROUTE = "/relation-tuples/check"
CHECK_OPENAPI_ROUTE = "/relation-tuples/check/openapi"
CHECK_BATCH_ROUTE = "/relation-tuples/check/batch"
EXPAND_ROUTE = "/relation-tuples/expand"
LIST_OBJECTS_ROUTE = "/relation-tuples/list-objects"
LIST_SUBJECTS_ROUTE = "/relation-tuples/list-subjects"
FILTER_ROUTE = "/relation-tuples/filter"
HEALTH_ROUTES = ("/health/alive", "/health/ready")
READ_ROUTE_BASE = "/relation-tuples"
WRITE_ROUTE = "/admin/relation-tuples"


def _max_depth(params: dict) -> int:
    raw = params.get("max-depth", "")
    if not raw:
        return 0
    try:
        return int(raw, 0)
    except ValueError:
        raise MalformedInputError(debug=f"invalid max-depth {raw!r}")


def _page_size(params: dict, default: int) -> int:
    raw = params.get("page_size", "")
    if not raw:
        return default
    try:
        return int(raw) or default
    except ValueError:
        raise MalformedInputError(debug=f"invalid page_size {raw!r}")


def _subject(params: dict):
    """subject_id, or subject_set.{namespace,object,relation}."""
    if "subject_id" in params:
        return params["subject_id"]
    try:
        return SubjectSet(
            namespace=params["subject_set.namespace"], object=params["subject_set.object"],
            relation=params["subject_set.relation"],
        )
    except KeyError:
        raise MalformedInputError(debug="a subject_id or subject_set.* subject is required")


class CheckService:
    """The Check, Expand, List and Filter surface over one engine:
    snaptoken enforcement, namespace validation and one lock around the
    engine."""

    def __init__(self, engine):
        self.engine = engine
        self._mu = threading.Lock()

    def validate_namespaces(self, *objs) -> None:
        """Every namespace a tuple or query names must be configured."""
        nm = self.engine.config.namespace_manager()
        for o in objs:
            if o.namespace is not None:
                nm.get_namespace_by_name(o.namespace)
            if o.subject_set is not None:
                nm.get_namespace_by_name(o.subject_set.namespace)

    def write_token(self) -> str:
        """The token of the store version a write left."""
        nid = self.engine.nid
        return encode_snaptoken(self.engine.manager.version(nid=nid), nid)

    def snaptoken(self, token: str) -> str:
        """Enforce a request's token; the response token, at the store
        version read here."""
        nid = self.engine.nid
        return encode_snaptoken(enforce_snaptoken(self.engine.manager, token, nid), nid)

    def check_batch(self, tuples, max_depth: int):
        with self._mu:
            return self.engine.check_batch(tuples, max_depth)

    def expand(self, subject_set: SubjectSet, max_depth: int):
        with self._mu:
            return self.engine.expand(subject_set, max_depth)

    def list_objects(self, *args, **kw):
        with self._mu:
            return self.engine.list_objects(*args, **kw)

    def list_subjects(self, *args, **kw):
        with self._mu:
            return self.engine.list_subjects(*args, **kw)

    def filter_objects(self, *args, **kw):
        with self._mu:
            return self.engine.filter_objects(*args, **kw)


class _JSONHandler(BaseHTTPRequestHandler):
    """What the read and the write listeners' handlers share: JSON bodies
    in and out."""

    protocol_version = "HTTP/1.1"
    server_version = "keto_tpu_torch"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, body, headers=()) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _empty(self, code: int, headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", "0")
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()

    def _params(self) -> tuple[str, dict]:
        url = urllib.parse.urlsplit(self.path)
        return url.path, dict(urllib.parse.parse_qsl(url.query, keep_blank_values=True))

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        try:
            return json.loads(self.rfile.read(n) or b"null")
        except json.JSONDecodeError as e:
            raise MalformedInputError(f"could not unmarshal json: {e}")


def make_write_handler(service: CheckService):
    """The write listener's request handler: Keto's admin tuple routes on
    the engine's store."""

    class WriteHandler(_JSONHandler):
        def _route(self, method: str) -> None:
            path = urllib.parse.urlsplit(self.path).path.rstrip("/") or "/"
            try:
                if path == WRITE_ROUTE and method == "PUT":
                    self._create_relation()
                elif path == WRITE_ROUTE and method == "DELETE":
                    self._delete_relations()
                elif path == WRITE_ROUTE and method == "PATCH":
                    self._patch_relations()
                else:
                    raise NotFoundError("route not found")
            except KetoError as e:
                self._json(e.status, e.to_dict())
            except Exception as e:  # noqa: BLE001 - the HTTP boundary answers 500
                self._json(500, KetoError(str(e)).to_dict())

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_PUT(self):
            self._route("PUT")

        def do_DELETE(self):
            self._route("DELETE")

        def do_PATCH(self):
            self._route("PATCH")

        def _create_relation(self) -> None:
            body = self._body()
            if not isinstance(body, dict):
                raise MalformedInputError("could not unmarshal json: expected object")
            t = RelationTuple.from_dict(body)
            service.validate_namespaces(t)
            service.engine.manager.write_relation_tuples([t], nid=service.engine.nid)
            location = READ_ROUTE_BASE + "?" + urllib.parse.urlencode(t.to_url_query())
            self._json(201, t.to_dict(), [("Location", location),
                                          ("X-Keto-Snaptoken", service.write_token())])

        def _delete_relations(self) -> None:
            # blank values drop out, as in Keto's query decoding
            qs = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
            query = RelationQuery.from_url_query({k: v[0] for k, v in qs.items()})
            service.validate_namespaces(query)
            service.engine.manager.delete_all_relation_tuples(query, nid=service.engine.nid)
            self._empty(204)

        def _patch_relations(self) -> None:
            body = self._body()
            if not isinstance(body, list):
                raise MalformedInputError("could not unmarshal json: expected array")
            deltas = [PatchDelta.from_dict(d) for d in body]
            inserts = [d.relation_tuple for d in deltas if d.action == PatchAction.INSERT]
            deletes = [d.relation_tuple for d in deltas if d.action == PatchAction.DELETE]
            service.validate_namespaces(*inserts, *deletes)
            service.engine.manager.transact_relation_tuples(inserts, deletes,
                                                            nid=service.engine.nid)
            self._empty(204, [("X-Keto-Snaptoken", service.write_token())])

    return WriteHandler


def make_handler(service: CheckService):
    """The read listener's request handler: check, expand, list, filter
    and health."""

    class Handler(_JSONHandler):
        def _route(self, method: str) -> None:
            path, params = self._params()
            try:
                if path in HEALTH_ROUTES and method == "GET":
                    self._json(200, {"status": "ok"})
                elif path == CHECK_BATCH_ROUTE and method == "POST":
                    self._check_batch(params)
                elif path == EXPAND_ROUTE and method == "GET":
                    self._expand(params)
                elif path == LIST_OBJECTS_ROUTE and method == "GET":
                    self._list_objects(params)
                elif path == LIST_SUBJECTS_ROUTE and method == "GET":
                    self._list_subjects(params)
                elif path == FILTER_ROUTE and method == "POST":
                    self._filter(params)
                elif path in (CHECK_ROUTE, CHECK_OPENAPI_ROUTE):
                    self._check(method, params, mirror_status=path == CHECK_ROUTE)
                else:
                    raise NotFoundError(f"no route {method} {path}")
            except KetoError as e:
                self._json(e.status, e.to_dict())

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def _check(self, method: str, params: dict, mirror_status: bool) -> None:
            if method != "GET":
                body = self._body()
                if not isinstance(body, dict):
                    raise MalformedInputError("could not unmarshal json: expected object")
            max_depth = _max_depth(params)
            t = RelationTuple.from_url_query(params) if method == "GET" else \
                RelationTuple.from_dict(body)
            token = [("X-Keto-Snaptoken", service.snaptoken(params.get("snaptoken", "")))]
            try:
                service.validate_namespaces(t)
            except NamespaceNotFoundError:
                self._json(403 if mirror_status else 200, {"allowed": False}, token)
                return
            (res,) = service.check_batch([t], max_depth)
            if res.error is not None:
                err = res.error
                if isinstance(err, KetoError):
                    raise err
                raise KetoError(str(err))
            code = 403 if (mirror_status and not res.allowed) else 200
            self._json(code, {"allowed": res.allowed}, token)

        def _expand(self, params: dict) -> None:
            max_depth = _max_depth(params)
            try:
                subject_set = SubjectSet(
                    namespace=params["namespace"], object=params["object"],
                    relation=params["relation"],
                )
            except KeyError:
                raise MalformedInputError(
                    debug="expand requires namespace, object, and relation"
                )
            service.engine.config.namespace_manager().get_namespace_by_name(
                subject_set.namespace
            )
            tree = service.expand(subject_set, max_depth)
            if tree is None:
                self._json(404, NotFoundError("no relation tuples found").to_dict())
                return
            self._json(200, tree.to_dict())

        def _list_objects(self, params: dict) -> None:
            max_depth = _max_depth(params)
            namespace, relation = params.get("namespace"), params.get("relation")
            if not namespace or not relation:
                raise MalformedInputError(debug="list-objects requires namespace and relation")
            subject = _subject(params)
            token = service.snaptoken(params.get("snaptoken", ""))
            nm = service.engine.config.namespace_manager()
            nm.get_namespace_by_name(namespace)
            if isinstance(subject, SubjectSet):
                nm.get_namespace_by_name(subject.namespace)
            objects, next_page = service.list_objects(
                namespace, relation, subject, max_depth,
                page_size=_page_size(params, service.engine.config.page_size()),
                page_token=params.get("page_token", ""),
            )
            self._json(200, {"objects": objects, "next_page_token": next_page},
                       [("X-Keto-Snaptoken", token)])

        def _list_subjects(self, params: dict) -> None:
            max_depth = _max_depth(params)
            try:
                namespace, obj = params["namespace"], params["object"]
                relation = params["relation"]
            except KeyError:
                raise MalformedInputError(
                    debug="list-subjects requires namespace, object, and relation"
                )
            token = service.snaptoken(params.get("snaptoken", ""))
            service.engine.config.namespace_manager().get_namespace_by_name(namespace)
            subjects, next_page = service.list_subjects(
                namespace, obj, relation, max_depth,
                page_size=_page_size(params, service.engine.config.page_size()),
                page_token=params.get("page_token", ""),
            )
            self._json(200, {"subject_ids": subjects, "next_page_token": next_page},
                       [("X-Keto-Snaptoken", token)])

        def _filter(self, params: dict) -> None:
            """The subset of the candidate column the subject can see, in
            request order."""
            body = self._body()
            if not isinstance(body, dict):
                raise MalformedInputError("could not unmarshal json: expected object")
            objects = body.get("objects")
            if not isinstance(objects, list) or not all(isinstance(o, str) for o in objects):
                raise MalformedInputError('filter requires "objects": an array of object names')
            max_objects = service.engine.config.filter_max_objects()
            if len(objects) > max_objects:
                raise FilterTooLargeError(
                    f"filter candidate list has {len(objects)} objects; filter.max_objects "
                    f"allows {max_objects}: split the list"
                )
            namespace, relation = body.get("namespace"), body.get("relation")
            if not namespace or not relation:
                raise MalformedInputError(debug="filter requires namespace and relation")
            subject_id, subject_set = _subject_fields_from_dict(body)
            if subject_id is None and subject_set is None:
                raise NilSubjectError()
            if body.get("max_depth") is None:
                max_depth = _max_depth(params)
            else:
                try:
                    max_depth = int(body["max_depth"])
                except (TypeError, ValueError):
                    raise MalformedInputError("max_depth must be an integer")
            token = service.snaptoken(body.get("snaptoken") or params.get("snaptoken", ""))
            nm = service.engine.config.namespace_manager()
            nm.get_namespace_by_name(namespace)
            if subject_set is not None:
                nm.get_namespace_by_name(subject_set.namespace)
            allowed = service.filter_objects(
                namespace, relation, subject_set if subject_set is not None else subject_id,
                objects, max_depth,
            )
            self._json(200, {"allowed_objects": allowed, "snaptoken": token})

        def _check_batch(self, params: dict) -> None:
            body = self._body()
            if isinstance(body, dict):
                raw = body.get("tuples")
                if body.get("max_depth") is None:
                    max_depth = _max_depth(params)
                else:
                    try:
                        max_depth = int(body["max_depth"])
                    except (TypeError, ValueError):
                        raise MalformedInputError("max_depth must be an integer")
            else:
                raw = body
                max_depth = _max_depth(params)
            if not isinstance(raw, list):
                raise MalformedInputError(
                    "could not unmarshal json: expected array of relation tuples"
                )
            req_token = params.get("snaptoken", "")
            if isinstance(body, dict):
                req_token = body.get("snaptoken") or req_token
            token = service.snaptoken(req_token)
            out: list = [None] * len(raw)
            idx, tuples = [], []
            for i, d in enumerate(raw):
                try:
                    if not isinstance(d, dict):
                        raise MalformedInputError("could not unmarshal json: expected object")
                    t = RelationTuple.from_dict(d)
                    service.validate_namespaces(t)
                except KetoError as e:
                    out[i] = {"allowed": False, "error": e.message}
                    continue
                idx.append(i)
                tuples.append(t)
            results = service.check_batch(tuples, max_depth)
            for i, res in zip(idx, results):
                if res.error is not None:
                    out[i] = {"allowed": False, "error": str(res.error)}
                else:
                    out[i] = {"allowed": res.allowed}
            self._json(200, {"results": out, "snaptoken": token})

    return Handler


def make_server(engine, host: str, port: int) -> ThreadingHTTPServer:
    """A threaded HTTP server serving the Check, Expand, List and Filter
    routes over `engine`."""
    server = ThreadingHTTPServer((host, port), make_handler(CheckService(engine)))
    server.daemon_threads = True
    return server


def make_write_server(engine, host: str, port: int) -> ThreadingHTTPServer:
    """A threaded HTTP server serving the write routes on `engine`'s
    store."""
    server = ThreadingHTTPServer((host, port), make_write_handler(CheckService(engine)))
    server.daemon_threads = True
    return server
