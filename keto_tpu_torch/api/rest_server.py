"""REST Check, Expand, List and Filter routes and the write routes on
stdlib threaded HTTP servers, in front of a Registry (its store, engine
and check cache) and the daemon's CheckBatcher.

The read listener (make_server):

  GET  /relation-tuples                -> {"relation_tuples": [...],
                                          "next_page_token": str}, the
                                          tuples a URL query matches, a
                                          page at a time (page_size,
                                          page_token)
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
  GET  /relation-tuples/watch          -> 200 text/event-stream: the store's
                                          change log as Server-Sent Events
                                          (params snaptoken, namespace,
                                          max_events); see ReadHandler._watch

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

Both listeners: GET /health/alive (200), /health/ready (200, or 503
{"status": "unavailable"} while the daemon is not ready, e.g. draining),
/version ({"version": str}) and /.well-known/openapi.json (api/openapi.py:
the OpenAPI 3.0 document of the routes that listener serves). With the
listener's `cors` config enabled (serve.<kind>.cors: enabled,
allowed_origins, allowed_methods, allowed_headers), every answer to a
request from an allowed Origin carries the Access-Control-Allow-* headers
and `Vary: Origin`, and OPTIONS on any path is a preflight: 204 with
those headers.

A single check runs the admission gate (resilience.admit_check: a 429
while draining or at serve.check.max_queue, a 504 for an expired
deadline), then the check cache, and on a miss rides the batcher
(api/check_cache.py cached_check), which coalesces concurrent checks
into device batches. `explain=true` (a query parameter, or an `explain`
body field) answers a typed 501: the DecisionTrace is not ported. The
`x-request-timeout-ms` header (or
serve.check.default_deadline_ms) sets the deadline of a check, a batch
check or a filter. An error that carries a retry hint answers with a
Retry-After header.

Keto's semantics: an unknown namespace on a single check answers
{"allowed": false} rather than an error; the batch route reports it per
item; Expand and the list routes answer it with 404. A missing parameter
or a malformed page token is a 400; an unknown object, relation or
subject lists nothing. A filter body whose objects are not a list of
strings, that lacks a namespace, a relation or a subject, or that carries
more objects than `filter.max_objects` is a 400. Errors use the herodot
shape {"error": {code, status, message}}. Every route but Expand and
GET /relation-tuples takes a `snaptoken` (engine/snaptoken.py) and
enforces it before it validates names: a malformed token, or one of
another network, is a 400, one ahead of the store a 409. The answer
carries the store version read at enforcement, in the X-Keto-Snaptoken
header (check and list routes) or a "snaptoken" body field (batch and
filter). The engine serves request threads concurrently; no lock is held
around it here. A write names only configured namespaces (else 404), and
the engine folds it into its mirror at its next read or, through the
registry's commit listener on the Watch hub, on its refresh thread.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine.snaptoken import encode_snaptoken, enforce_snaptoken, parse_snaptoken
from ..errors import (
    KetoError,
    MalformedInputError,
    NamespaceNotFoundError,
    NilSubjectError,
    NotFoundError,
    NotImplementedYetError,
)
from ..ketoapi import (
    GetResponse,
    PatchAction,
    PatchDelta,
    RelationQuery,
    RelationTuple,
    SubjectSet,
    _subject_fields_from_dict,
)
from ..resilience import (
    RequestTrace,
    admit_check,
    admit_filter,
    ingest_deadline,
    parse_timeout_ms,
    retry_after_header_value,
)
from .check_cache import cached_check

READ_ROUTE_BASE = "/relation-tuples"
CHECK_ROUTE = "/relation-tuples/check"
CHECK_OPENAPI_ROUTE = "/relation-tuples/check/openapi"
CHECK_BATCH_ROUTE = "/relation-tuples/check/batch"
EXPAND_ROUTE = "/relation-tuples/expand"
LIST_OBJECTS_ROUTE = "/relation-tuples/list-objects"
LIST_SUBJECTS_ROUTE = "/relation-tuples/list-subjects"
FILTER_ROUTE = "/relation-tuples/filter"
WATCH_ROUTE = "/relation-tuples/watch"
ALIVE_ROUTE = "/health/alive"
READY_ROUTE = "/health/ready"
VERSION_ROUTE = "/version"
SPEC_ROUTE = "/.well-known/openapi.json"
WRITE_ROUTE = "/admin/relation-tuples"
# which listener answers each route ("shared": both)
ROUTE_KINDS = {
    READ_ROUTE_BASE: "read",
    CHECK_ROUTE: "read",
    CHECK_OPENAPI_ROUTE: "read",
    CHECK_BATCH_ROUTE: "read",
    EXPAND_ROUTE: "read",
    LIST_OBJECTS_ROUTE: "read",
    LIST_SUBJECTS_ROUTE: "read",
    FILTER_ROUTE: "read",
    WATCH_ROUTE: "read",
    WRITE_ROUTE: "write",
    ALIVE_ROUTE: "shared",
    READY_ROUTE: "shared",
    VERSION_ROUTE: "shared",
    SPEC_ROUTE: "shared",
}
EXPLAIN_UNIMPLEMENTED = (
    "explain=true is not served yet: the DecisionTrace (engine/explain.py) is not ported")


def _max_depth(params: dict) -> int:
    raw = params.get("max-depth", "")
    if not raw:
        return 0
    try:
        return int(raw, 0)
    except ValueError:
        raise MalformedInputError(debug=f"invalid max-depth {raw!r}")


def _body_max_depth(body, params: dict) -> int:
    """A body's max_depth (its absence, not a 0, defers to ?max-depth)."""
    if not isinstance(body, dict) or body.get("max_depth") is None:
        return _max_depth(params)
    try:
        return int(body["max_depth"])
    except (TypeError, ValueError):
        raise MalformedInputError("max_depth must be an integer")


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


class _Handler(BaseHTTPRequestHandler):
    """What both listeners share: JSON in and out, typed errors, the
    health, version and OpenAPI routes. Subclasses set `registry`, `kind`
    and `_routes`."""

    protocol_version = "HTTP/1.1"
    server_version = "keto_tpu_torch"
    registry = None
    kind = None
    cors = None  # the listener's serve.<kind>.cors, or None

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _cors_headers(self) -> list[tuple[str, str]]:
        """The CORS headers of `serve.<kind>.cors` for a request whose
        Origin it allows (allowed_origins, default every one), else none;
        allowed_methods and allowed_headers default as Keto's."""
        cfg = self.cors
        if not cfg or not cfg.get("enabled"):
            return []
        origin = self.headers.get("Origin")
        if not origin:
            return []
        allowed = cfg.get("allowed_origins") or ["*"]
        if "*" not in allowed and origin not in allowed:
            return []
        methods = cfg.get("allowed_methods") or ["GET", "POST", "PUT", "PATCH", "DELETE",
                                                 "OPTIONS"]
        headers = cfg.get("allowed_headers") or ["Authorization", "Content-Type"]
        return [
            ("Access-Control-Allow-Origin", "*" if "*" in allowed else origin),
            ("Access-Control-Allow-Methods", ", ".join(methods)),
            ("Access-Control-Allow-Headers", ", ".join(headers)),
            ("Vary", "Origin"),
        ]

    def _json(self, code: int, body, headers=()) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in [*headers, *self._cors_headers()]:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _empty(self, code: int, headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", "0")
        for k, v in [*headers, *self._cors_headers()]:
            self.send_header(k, v)
        self.end_headers()

    def _error(self, err: KetoError) -> None:
        ra = getattr(err, "retry_after_s", None)
        headers = [("Retry-After", retry_after_header_value(ra))] if ra is not None else ()
        self._json(err.status, err.to_dict(), headers)

    def _params(self) -> tuple[str, dict]:
        url = urllib.parse.urlsplit(self.path)
        return url.path, dict(urllib.parse.parse_qsl(url.query, keep_blank_values=True))

    def _query(self) -> dict:
        """The URL query with blank values dropped, as Keto decodes a
        tuple query."""
        qs = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        return {k: v[0] for k, v in qs.items()}

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        try:
            return json.loads(self.rfile.read(n) or b"null")
        except json.JSONDecodeError as e:
            raise MalformedInputError(f"could not unmarshal json: {e}")

    def _route(self, method: str) -> None:
        path, params = self._params()
        path = path.rstrip("/") or "/"
        try:
            if method == "GET" and path == ALIVE_ROUTE:
                self._json(200, {"status": "ok"})
            elif method == "GET" and path == READY_ROUTE:
                ok = self.registry.ready.is_set()
                self._json(200 if ok else 503, {"status": "ok" if ok else "unavailable"})
            elif method == "GET" and path == VERSION_ROUTE:
                self._json(200, {"version": self.registry.version})
            elif method == "GET" and path == SPEC_ROUTE:
                from .openapi import build_spec

                self._json(200, build_spec(self.registry.version, kind=self.kind))
            else:
                handler = self._routes.get((method, path))
                if handler is None:
                    raise NotFoundError("route not found")
                handler(self, params)
        except KetoError as e:
            self._error(e)
        except (BrokenPipeError, ConnectionResetError):
            raise
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

    def do_OPTIONS(self):
        # a CORS preflight: 204 and the allow headers, whatever the path
        self.send_response(204)
        for k, v in self._cors_headers():
            self.send_header(k, v)
        self.send_header("Content-Length", "0")
        self.end_headers()

    # -- what the read routes share ---------------------------------------------

    def _snaptoken(self, token: str) -> str:
        """Enforce a request's token; the response token, at the store
        version read here."""
        reg = self.registry
        return encode_snaptoken(
            enforce_snaptoken(reg.relation_tuple_manager(), token, reg.nid), reg.nid)

    def _request_trace(self) -> RequestTrace:
        """The request's deadline, from x-request-timeout-ms or
        serve.check.default_deadline_ms (a malformed header is a 400)."""
        return RequestTrace(ingest_deadline(
            self.registry.config,
            request_ms=parse_timeout_ms(self.headers.get("x-request-timeout-ms"))))


class ReadHandler(_Handler):
    """The read listener's routes; `batcher` coalesces single checks and
    `watch_slots` bounds the listener's watch streams."""

    batcher = None
    watch_slots = None
    kind = "read"
    # the SSE keep-alive period when watch.heartbeat_s is unset; it also
    # bounds how long a vanished client holds its subscription, since
    # only a failed write tells
    WATCH_HEARTBEAT_S = 5.0

    def _get_relations(self, params: dict) -> None:
        params = self._query()
        reg = self.registry
        query = RelationQuery.from_url_query(params)
        reg.validate_namespaces(query)
        page_size = int(params.get("page_size") or 0) or reg.config.page_size()
        tuples, next_token = reg.relation_tuple_manager().get_relation_tuples(
            query, page_token=params.get("page_token", ""), page_size=page_size, nid=reg.nid)
        self._json(200, GetResponse(tuples, next_token).to_dict())

    def _check(self, params: dict, method: str, mirror_status: bool) -> None:
        reg = self.registry
        # deadline and admission before any work, body parsing included
        rt = self._request_trace()
        if params.get("explain", "").lower() in ("1", "true"):
            raise NotImplementedYetError(EXPLAIN_UNIMPLEMENTED)
        admit_check(reg, self.batcher, rt)
        if method != "GET":
            body = self._body()
            if not isinstance(body, dict):
                raise MalformedInputError("could not unmarshal json: expected object")
            if body.get("explain"):
                raise NotImplementedYetError(EXPLAIN_UNIMPLEMENTED)
        max_depth = _max_depth(params)
        t = RelationTuple.from_url_query(params) if method == "GET" else \
            RelationTuple.from_dict(body)
        nid = reg.nid
        version = enforce_snaptoken(reg.relation_tuple_manager(), params.get("snaptoken", ""),
                                    nid)
        token = [("X-Keto-Snaptoken", encode_snaptoken(version, nid))]
        try:
            reg.validate_namespaces(t)
        except NamespaceNotFoundError:
            self._json(403 if mirror_status else 200, {"allowed": False}, token)
            return
        res = cached_check(reg, self.batcher, nid, t, max_depth, version, rt)
        if res.error is not None:
            err = res.error
            raise err if isinstance(err, KetoError) else KetoError(str(err))
        self._json(403 if (mirror_status and not res.allowed) else 200,
                   {"allowed": res.allowed}, token)

    def _check_get(self, params: dict) -> None:
        self._check(params, "GET", mirror_status=True)

    def _check_post(self, params: dict) -> None:
        self._check(params, "POST", mirror_status=True)

    def _check_openapi_get(self, params: dict) -> None:
        self._check(params, "GET", mirror_status=False)

    def _check_openapi_post(self, params: dict) -> None:
        self._check(params, "POST", mirror_status=False)

    def _check_batch(self, params: dict) -> None:
        """The whole batch rides one engine.check_batch, not the batcher's
        queue: the gate checks draining and the deadline only."""
        reg = self.registry
        admit_check(reg, None, self._request_trace())
        body = self._body()
        raw = body.get("tuples") if isinstance(body, dict) else body
        max_depth = _body_max_depth(body, params)
        if not isinstance(raw, list):
            raise MalformedInputError(
                "could not unmarshal json: expected array of relation tuples")
        req_token = params.get("snaptoken", "")
        if isinstance(body, dict):
            req_token = body.get("snaptoken") or req_token
        token = self._snaptoken(req_token)
        out: list = [None] * len(raw)
        idx, tuples = [], []
        for i, d in enumerate(raw):
            try:
                if not isinstance(d, dict):
                    raise MalformedInputError("could not unmarshal json: expected object")
                t = RelationTuple.from_dict(d)
                reg.validate_namespaces(t)
            except KetoError as e:
                out[i] = {"allowed": False, "error": e.message}
                continue
            idx.append(i)
            tuples.append(t)
        results = reg.check_engine().check_batch(tuples, max_depth)
        for i, res in zip(idx, results):
            if res.error is not None:
                out[i] = {"allowed": False, "error": str(res.error)}
            else:
                out[i] = {"allowed": res.allowed}
        self._json(200, {"results": out, "snaptoken": token})

    def _expand(self, params: dict) -> None:
        max_depth = _max_depth(params)
        try:
            subject_set = SubjectSet(
                namespace=params["namespace"], object=params["object"],
                relation=params["relation"],
            )
        except KeyError:
            raise MalformedInputError(debug="expand requires namespace, object, and relation")
        self.registry.validate_namespaces(subject_set)
        tree = self.registry.expand_engine().expand(subject_set, max_depth)
        if tree is None:
            self._json(404, NotFoundError("no relation tuples found").to_dict())
            return
        self._json(200, tree.to_dict())

    def _list_objects(self, params: dict) -> None:
        reg = self.registry
        max_depth = _max_depth(params)
        namespace, relation = params.get("namespace"), params.get("relation")
        if not namespace or not relation:
            raise MalformedInputError(debug="list-objects requires namespace and relation")
        subject = _subject(params)
        token = self._snaptoken(params.get("snaptoken", ""))
        reg.validate_namespaces(RelationQuery(namespace=namespace),
                                subject if isinstance(subject, SubjectSet) else None)
        objects, next_page = reg.check_engine().list_objects(
            namespace, relation, subject, max_depth,
            page_size=_page_size(params, reg.config.page_size()),
            page_token=params.get("page_token", ""),
        )
        self._json(200, {"objects": objects, "next_page_token": next_page},
                   [("X-Keto-Snaptoken", token)])

    def _list_subjects(self, params: dict) -> None:
        reg = self.registry
        max_depth = _max_depth(params)
        try:
            namespace, obj = params["namespace"], params["object"]
            relation = params["relation"]
        except KeyError:
            raise MalformedInputError(
                debug="list-subjects requires namespace, object, and relation")
        token = self._snaptoken(params.get("snaptoken", ""))
        reg.validate_namespaces(RelationQuery(namespace=namespace))
        subjects, next_page = reg.check_engine().list_subjects(
            namespace, obj, relation, max_depth,
            page_size=_page_size(params, reg.config.page_size()),
            page_token=params.get("page_token", ""),
        )
        self._json(200, {"subject_ids": subjects, "next_page_token": next_page},
                   [("X-Keto-Snaptoken", token)])

    def _filter(self, params: dict) -> None:
        """The subset of the candidate column the subject can see, in
        request order."""
        reg = self.registry
        rt = self._request_trace()
        body = self._body()
        if not isinstance(body, dict):
            raise MalformedInputError("could not unmarshal json: expected object")
        objects = body.get("objects")
        if not isinstance(objects, list) or not all(isinstance(o, str) for o in objects):
            raise MalformedInputError('filter requires "objects": an array of object names')
        admit_filter(reg, len(objects), rt)
        namespace, relation = body.get("namespace"), body.get("relation")
        if not namespace or not relation:
            raise MalformedInputError(debug="filter requires namespace and relation")
        subject_id, subject_set = _subject_fields_from_dict(body)
        if subject_id is None and subject_set is None:
            raise NilSubjectError()
        max_depth = _body_max_depth(body, params)
        token = self._snaptoken(body.get("snaptoken") or params.get("snaptoken", ""))
        reg.validate_namespaces(RelationQuery(namespace=namespace), subject_set)
        allowed = reg.check_engine().filter_objects(
            namespace, relation, subject_set if subject_set is not None else subject_id,
            objects, max_depth, deadline=rt.deadline,
        )
        self._json(200, {"allowed_objects": allowed, "snaptoken": token})

    def _watch(self, params: dict) -> None:
        """The store's change log as Server-Sent Events. `snaptoken`
        resumes the cursor: every change strictly after it, exactly once,
        in version order (400 malformed, 409 ahead of the store, an
        explicit `reset` event where the log no longer reaches it);
        `namespace` filters; `max_events` ends the stream after N events.
        Each message is one committed store version:

            event: change | reset | degraded
            data: {"event_type", "snaptoken", "changes": [
                      {"action": "insert" | "delete", "relation_tuple": {...}}]}

        An error before the stream opens is a JSON error; past the
        listener's serve.read.grpc.max_watchers streams, a 429."""
        params = self._query()
        reg = self.registry
        namespace = params.get("namespace", "")
        if namespace:
            reg.validate_namespaces(RelationQuery(namespace=namespace))
        max_events = None
        if params.get("max_events"):
            try:
                max_events = int(params["max_events"])
            except ValueError:
                raise MalformedInputError(debug=f"invalid max_events {params['max_events']!r}")
        min_version = parse_snaptoken(params.get("snaptoken", ""), reg.nid)
        # a stream holds a server thread, as a gRPC watch holds a worker:
        # the slots are the listener's own, the limit the shared key's
        if not self.watch_slots.acquire(blocking=False):
            self._json(429, {"error": {"code": 429, "status": "Too Many Requests",
                                       "message": "too many concurrent watchers"}})
            return
        try:
            self._watch_stream(namespace, min_version, max_events)
        finally:
            self.watch_slots.release()

    def _watch_stream(self, namespace, min_version, max_events) -> None:
        reg = self.registry
        sub = reg.watch_hub().subscribe(reg.nid, min_version)
        self.close_connection = True  # the stream is the response body
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            for k, v in self._cors_headers():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(b": stream open\n\n")
            self.wfile.flush()
            heartbeat_s = float(reg.config.get("watch.heartbeat_s", self.WATCH_HEARTBEAT_S))
            delivered = 0
            last_write = time.monotonic()
            while max_events is None or delivered < max_events:
                # a keep-alive is due by the clock, not by idle reads: a
                # stream whose events the filter drops is busy and silent
                if time.monotonic() - last_write >= heartbeat_s:
                    last_write = time.monotonic()
                    self.wfile.write(b": keep-alive\n\n")
                    self.wfile.flush()
                event = sub.get(timeout=max(0.05, heartbeat_s - (time.monotonic() - last_write)))
                if event is None:
                    if sub.closed:  # the daemon's drain ends the stream
                        break
                    continue
                event = event.filtered(namespace)
                if event is None:
                    continue
                payload = json.dumps(event.to_dict())
                self.wfile.write(f"event: {event.kind}\ndata: {payload}\n\n".encode())
                self.wfile.flush()
                last_write = time.monotonic()
                delivered += 1
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client left: a watch stream's normal end
        finally:
            sub.close()

    _routes = {
        ("GET", READ_ROUTE_BASE): _get_relations,
        ("GET", CHECK_ROUTE): _check_get,
        ("POST", CHECK_ROUTE): _check_post,
        ("GET", CHECK_OPENAPI_ROUTE): _check_openapi_get,
        ("POST", CHECK_OPENAPI_ROUTE): _check_openapi_post,
        ("POST", CHECK_BATCH_ROUTE): _check_batch,
        ("GET", EXPAND_ROUTE): _expand,
        ("GET", LIST_OBJECTS_ROUTE): _list_objects,
        ("GET", LIST_SUBJECTS_ROUTE): _list_subjects,
        ("POST", FILTER_ROUTE): _filter,
        ("GET", WATCH_ROUTE): _watch,
    }


class WriteHandler(_Handler):
    """The write listener's routes: Keto's admin tuple routes on the
    registry's store."""

    kind = "write"

    def _write_token(self) -> str:
        """The token of the store version a write left."""
        reg = self.registry
        return encode_snaptoken(reg.relation_tuple_manager().version(nid=reg.nid), reg.nid)

    def _create_relation(self, params: dict) -> None:
        reg = self.registry
        body = self._body()
        if not isinstance(body, dict):
            raise MalformedInputError("could not unmarshal json: expected object")
        t = RelationTuple.from_dict(body)
        reg.validate_namespaces(t)
        reg.relation_tuple_manager().write_relation_tuples([t], nid=reg.nid)
        location = READ_ROUTE_BASE + "?" + urllib.parse.urlencode(t.to_url_query())
        self._json(201, t.to_dict(), [("Location", location),
                                      ("X-Keto-Snaptoken", self._write_token())])

    def _delete_relations(self, params: dict) -> None:
        reg = self.registry
        query = RelationQuery.from_url_query(self._query())
        reg.validate_namespaces(query)
        reg.relation_tuple_manager().delete_all_relation_tuples(query, nid=reg.nid)
        self._empty(204)

    def _patch_relations(self, params: dict) -> None:
        reg = self.registry
        body = self._body()
        if not isinstance(body, list):
            raise MalformedInputError("could not unmarshal json: expected array")
        deltas = [PatchDelta.from_dict(d) for d in body]
        inserts = [d.relation_tuple for d in deltas if d.action == PatchAction.INSERT]
        deletes = [d.relation_tuple for d in deltas if d.action == PatchAction.DELETE]
        reg.validate_namespaces(*inserts, *deletes)
        reg.relation_tuple_manager().transact_relation_tuples(inserts, deletes, nid=reg.nid)
        self._empty(204, [("X-Keto-Snaptoken", self._write_token())])

    _routes = {
        ("PUT", WRITE_ROUTE): _create_relation,
        ("DELETE", WRITE_ROUTE): _delete_relations,
        ("PATCH", WRITE_ROUTE): _patch_relations,
    }


class _Server(ThreadingHTTPServer):
    # the JAX package's listener backlog (its mux listens with 128):
    # socketserver's default of 5 drops the SYNs of a burst of new
    # connections, which then wait out TCP's retransmit timer (1 s, 3 s, ...)
    request_queue_size = 128
    daemon_threads = True


def _server(handler: type, registry, host: str, port: int, bind: bool,
            **members) -> ThreadingHTTPServer:
    cls = type(handler.__name__, (handler,), {"registry": registry, **members})
    return _Server((host, port), cls, bind_and_activate=bind)


def make_server(registry, host: str, port: int, batcher, bind: bool = True,
                cors=None) -> ThreadingHTTPServer:
    """A threaded HTTP server of the read routes over `registry`; single
    checks ride `batcher` (api/daemon.py make_batcher builds one from the
    registry's config). `bind=False`: a server that listens nowhere and
    serves the connections handed to its `process_request` (the daemon's
    PortMux). `cors`: the listener's CORS config (serve.read.cors)."""
    # one pool of watcher slots a listener, shared by its connections
    slots = threading.BoundedSemaphore(
        int(registry.config.get("serve.read.grpc.max_watchers", 16)))
    return _server(ReadHandler, registry, host, port, bind, batcher=batcher, cors=cors,
                   watch_slots=slots)


def make_write_server(registry, host: str, port: int, bind: bool = True,
                      cors=None) -> ThreadingHTTPServer:
    """A threaded HTTP server of the write routes on `registry`'s store;
    `bind` and `cors` (serve.write.cors) as make_server's."""
    return _server(WriteHandler, registry, host, port, bind, cors=cors)
