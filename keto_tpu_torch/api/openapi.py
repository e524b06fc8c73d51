"""The OpenAPI 3.0 document of the REST routes, built from the route
constants api/rest_server.py dispatches on, so the document cannot drift
from the router; each listener serves the routes it answers at
GET /.well-known/openapi.json. The document is the JAX package's whole,
the change-log stream (GET /relation-tuples/watch) and its `watchEvent`
schema included.
"""

from __future__ import annotations

from .rest_server import (
    ALIVE_ROUTE,
    CHECK_BATCH_ROUTE,
    CHECK_OPENAPI_ROUTE,
    CHECK_ROUTE,
    EXPAND_ROUTE,
    FILTER_ROUTE,
    LIST_OBJECTS_ROUTE,
    LIST_SUBJECTS_ROUTE,
    READ_ROUTE_BASE,
    READY_ROUTE,
    ROUTE_KINDS,
    VERSION_ROUTE,
    WATCH_ROUTE,
    WRITE_ROUTE,
)


_SUBJECT_QUERY_PARAMS = [
    {"name": "namespace", "in": "query", "schema": {"type": "string"}},
    {"name": "object", "in": "query", "schema": {"type": "string"}},
    {"name": "relation", "in": "query", "schema": {"type": "string"}},
    {"name": "subject_id", "in": "query", "schema": {"type": "string"}},
    {
        "name": "subject_set.namespace",
        "in": "query",
        "schema": {"type": "string"},
    },
    {"name": "subject_set.object", "in": "query", "schema": {"type": "string"}},
    {
        "name": "subject_set.relation",
        "in": "query",
        "schema": {"type": "string"},
    },
]

_MAX_DEPTH_PARAM = {
    "name": "max-depth",
    "in": "query",
    "schema": {"type": "integer"},
    "description": "Maximum traversal depth (0 = server default)",
}


def _schemas() -> dict:
    subject_set = {
        "type": "object",
        "required": ["namespace", "object", "relation"],
        "properties": {
            "namespace": {"type": "string"},
            "object": {"type": "string"},
            "relation": {"type": "string"},
        },
    }
    relation_tuple = {
        "type": "object",
        "required": ["namespace", "object", "relation"],
        "properties": {
            "namespace": {"type": "string"},
            "object": {"type": "string"},
            "relation": {"type": "string"},
            "subject_id": {"type": "string"},
            "subject_set": {"$ref": "#/components/schemas/subjectSet"},
        },
    }
    return {
        "subjectSet": subject_set,
        "relationTuple": relation_tuple,
        "checkResponse": {
            "type": "object",
            "required": ["allowed"],
            "properties": {
                "allowed": {"type": "boolean"},
                "decision_trace": {
                    "$ref": "#/components/schemas/decisionTrace"
                },
            },
        },
        "decisionTrace": {
            "type": "object",
            "description": "why a Check answered what it did (keto_tpu "
                           "§5m explain plane; present only when the "
                           "request set explain=true): the answering "
                           "tier + cause, a host-re-walked witness path "
                           "for ALLOW (differential-checked against the "
                           "authoritative device verdict), an "
                           "exhaustion summary for DENY, per-stage ms, "
                           "and flight-recorder launch ids",
            "properties": {
                "allowed": {"type": "boolean"},
                "tier": {
                    "type": "string",
                    "description": "which tier answered: closure "
                                   "(Leopard one-step probe) | device "
                                   "(BFS kernel) | host (exact oracle "
                                   "replay) | vocab (name outside the "
                                   "configured vocabulary)",
                },
                "cause": {"type": ["string", "null"]},
                "closure_fallback": {"type": ["string", "null"]},
                "version": {"type": "integer"},
                "enforce_version": {"type": "integer"},
                "snaptoken": {"type": "string"},
                "max_depth": {"type": ["integer", "null"]},
                "witness": {
                    "type": "array",
                    "description": "the edge/rewrite chain proving "
                                   "ALLOW, query -> direct tuple, one "
                                   "hop per traversal rule with the "
                                   "tuple it rode and the rest-depth",
                    "items": {"type": "object"},
                },
                "exhaustion": {
                    "type": ["object", "null"],
                    "description": "DENY only: depth guards hit, nodes "
                                   "visited, tuples scanned, AND/NOT "
                                   "islands consulted",
                },
                "witness_verdict": {"type": "boolean"},
                "witness_consistent": {"type": "boolean"},
                "witness_racy": {"type": "boolean"},
                "cache_bypassed": {"type": "boolean"},
                "stages_ms": {"type": "object"},
                "launch_ids": {
                    "type": "array", "items": {"type": "integer"},
                },
            },
        },
        "batchCheckRequest": {
            "type": "object",
            "required": ["tuples"],
            "properties": {
                "tuples": {
                    "type": "array",
                    "items": {"$ref": "#/components/schemas/relationTuple"},
                },
                "max_depth": {"type": "integer"},
                "snaptoken": {"type": "string"},
            },
        },
        "batchCheckResponse": {
            "type": "object",
            "required": ["results"],
            "properties": {
                "snaptoken": {"type": "string"},
                "results": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["allowed"],
                        "properties": {
                            "allowed": {"type": "boolean"},
                            "error": {"type": "string"},
                        },
                    },
                },
            },
        },
        "filterRequest": {
            "type": "object",
            "required": ["namespace", "relation", "objects"],
            "properties": {
                "namespace": {"type": "string"},
                "relation": {"type": "string"},
                "subject_id": {"type": "string"},
                "subject_set": {
                    "$ref": "#/components/schemas/subjectSet"
                },
                "objects": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "candidate object names — the whole "
                                   "column rides one device evaluation "
                                   "(bounded by filter.max_objects)",
                },
                "max_depth": {"type": "integer"},
                "snaptoken": {"type": "string"},
            },
        },
        "filterResponse": {
            "type": "object",
            "required": ["allowed_objects"],
            "properties": {
                "allowed_objects": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "candidates the subject can see, in "
                                   "request order",
                },
                "snaptoken": {"type": "string"},
            },
        },
        "listObjectsResponse": {
            "type": "object",
            "required": ["objects"],
            "properties": {
                "objects": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "sorted object names the subject "
                                   "reaches (deterministic pagination)",
                },
                "next_page_token": {"type": "string"},
            },
        },
        "listSubjectsResponse": {
            "type": "object",
            "required": ["subject_ids"],
            "properties": {
                "subject_ids": {
                    "type": "array",
                    "items": {"type": "string"},
                    "description": "sorted plain subject ids that reach "
                                   "the object",
                },
                "next_page_token": {"type": "string"},
            },
        },
        "getResponse": {
            "type": "object",
            "required": ["relation_tuples"],
            "properties": {
                "relation_tuples": {
                    "type": "array",
                    "items": {"$ref": "#/components/schemas/relationTuple"},
                },
                "next_page_token": {"type": "string"},
            },
        },
        "expandTree": {
            "type": "object",
            "required": ["type"],
            "properties": {
                "type": {
                    "type": "string",
                    "enum": ["union", "exclusion", "intersection",
                             "leaf", "unspecified"],
                },
                "tuple": {"$ref": "#/components/schemas/relationTuple"},
                "children": {
                    "type": "array",
                    "items": {"$ref": "#/components/schemas/expandTree"},
                },
            },
        },
        "patchDelta": {
            "type": "object",
            "required": ["action", "relation_tuple"],
            "properties": {
                "action": {"type": "string", "enum": ["insert", "delete"]},
                "relation_tuple": {
                    "$ref": "#/components/schemas/relationTuple"
                },
            },
        },
        "version": {
            "type": "object",
            "required": ["version"],
            "properties": {"version": {"type": "string"}},
        },
        "healthStatus": {
            "type": "object",
            "properties": {"status": {"type": "string"}},
        },
        "watchEvent": {
            "type": "object",
            "required": ["event_type", "snaptoken", "changes"],
            "properties": {
                "event_type": {
                    "type": "string",
                    "enum": ["change", "reset"],
                    "description": "change = one committed store version; "
                                   "reset = unrecoverable gap (overflow, "
                                   "trimmed changelog) — re-read state and "
                                   "resume from the carried snaptoken",
                },
                "snaptoken": {
                    "type": "string",
                    "description": "the committed version's token — the "
                                   "resumable cursor",
                },
                "changes": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["action", "relation_tuple"],
                        "properties": {
                            "action": {
                                "type": "string",
                                "enum": ["insert", "delete"],
                            },
                            "relation_tuple": {
                                "$ref": "#/components/schemas/relationTuple"
                            },
                        },
                    },
                },
            },
        },
        "errorGeneric": {
            "type": "object",
            "required": ["error"],
            "properties": {
                "error": {
                    "type": "object",
                    "properties": {
                        "code": {"type": "integer"},
                        "status": {"type": "string"},
                        "message": {"type": "string"},
                    },
                },
            },
        },
    }


def _json_response(desc: str, ref: str | None = None) -> dict:
    out: dict = {"description": desc}
    if ref is not None:
        out["content"] = {
            "application/json": {
                "schema": {"$ref": f"#/components/schemas/{ref}"}
            }
        }
    return out


def build_spec(version: str = "", kind: str | None = None) -> dict:
    """The OpenAPI 3.0 document for the REST surface. Route strings AND
    route→port ownership come from rest_server (ROUTE_KINDS), so `kind`
    ("read" | "write" | None) filters to the paths THAT router answers —
    each port's served spec must not advertise routes the port 404s."""
    snaptoken_param = {
        "name": "snaptoken", "in": "query",
        "schema": {"type": "string"},
        "description": "pin the read to at least this snapshot "
                       "(keto_tpu extension; from a write response)",
    }
    snaptoken_header = {
        "X-Keto-Snaptoken": {
            "schema": {"type": "string"},
            "description": "token of the snapshot this response was "
                           "evaluated against (keto_tpu extension)",
        }
    }
    explain_param = {
        "name": "explain", "in": "query",
        "schema": {"type": "boolean"},
        "description": "return a DecisionTrace beside the verdict "
                       "(keto_tpu §5m extension): answering tier, "
                       "witness path / exhaustion summary, stage ms, "
                       "launch ids. Bypasses the check cache; "
                       "rate-bounded by explain.max_per_s (429 over "
                       "the bound). POST also accepts an `explain` "
                       "body field",
    }
    check_op = {
        "parameters": _SUBJECT_QUERY_PARAMS + [_MAX_DEPTH_PARAM,
                                               snaptoken_param,
                                               explain_param],
        "responses": {
            "200": {
                **_json_response("membership verdict", "checkResponse"),
                "headers": snaptoken_header,
            },
            "400": _json_response("malformed input", "errorGeneric"),
            "409": _json_response(
                "snaptoken demands a newer snapshot", "errorGeneric"
            ),
        },
    }
    check_bare = {
        **check_op,
        "responses": {
            **check_op["responses"],
            "403": _json_response("denied (bare route mirrors the verdict "
                                  "as the status code)", "checkResponse"),
        },
    }
    # POST check takes the subject tuple from the JSON body ONLY (the
    # handler ignores subject query params on POST, like the reference's
    # postCheck vs getCheck split, rest_server._Handler._check)
    # — so the POST operations carry a required body and just max-depth
    check_body = {
        "required": True,
        "content": {"application/json": {"schema": {
            "$ref": "#/components/schemas/relationTuple"
        }}},
    }
    check_op_post = {
        **check_op, "requestBody": check_body,
        "parameters": [_MAX_DEPTH_PARAM, snaptoken_param, explain_param],
    }
    check_bare_post = {
        **check_bare, "requestBody": check_body,
        "parameters": [_MAX_DEPTH_PARAM, snaptoken_param, explain_param],
    }
    paths = {
        READ_ROUTE_BASE: {
            "get": {
                "summary": "List relation tuples matching a query",
                "parameters": _SUBJECT_QUERY_PARAMS + [
                    {"name": "page_token", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "page_size", "in": "query",
                     "schema": {"type": "integer"}},
                ],
                "responses": {
                    "200": _json_response("matching tuples", "getResponse"),
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                },
            }
        },
        CHECK_ROUTE: {"get": check_bare, "post": check_bare_post},
        CHECK_OPENAPI_ROUTE: {"get": check_op, "post": check_op_post},
        CHECK_BATCH_ROUTE: {
            "post": {
                "summary": "Check a batch of relation tuples in one "
                           "round-trip (keto_tpu extension)",
                "parameters": [_MAX_DEPTH_PARAM],
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": {
                        "$ref": "#/components/schemas/batchCheckRequest"
                    }}},
                },
                "responses": {
                    "200": _json_response(
                        "per-tuple verdicts in request order",
                        "batchCheckResponse",
                    ),
                    "400": _json_response("malformed input", "errorGeneric"),
                },
            }
        },
        EXPAND_ROUTE: {
            "get": {
                "summary": "Expand a subject set into its membership tree",
                "parameters": [
                    {"name": "namespace", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "object", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "relation", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    _MAX_DEPTH_PARAM,
                ],
                "responses": {
                    "200": _json_response("expansion tree", "expandTree"),
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("no such subject set",
                                          "errorGeneric"),
                },
            }
        },
        FILTER_ROUTE: {
            "post": {
                "summary": "Filter a candidate object list down to what "
                           "the subject can see (keto_tpu bulk-ACL-"
                           "filter extension — one request, many "
                           "objects, one device ride)",
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": {
                        "$ref": "#/components/schemas/filterRequest"
                    }}},
                },
                "responses": {
                    "200": _json_response(
                        "candidates the subject can see, in request "
                        "order",
                        "filterResponse",
                    ),
                    "400": _json_response(
                        "malformed input or candidate list over "
                        "filter.max_objects",
                        "errorGeneric",
                    ),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                    "409": _json_response(
                        "snaptoken demands a newer snapshot", "errorGeneric"
                    ),
                    "429": _json_response(
                        "server overloaded or draining", "errorGeneric"
                    ),
                    "504": _json_response(
                        "deadline expired mid-evaluation", "errorGeneric"
                    ),
                },
            }
        },
        LIST_OBJECTS_ROUTE: {
            "get": {
                "summary": "List the objects a subject reaches via a "
                           "relation (keto_tpu reverse-reachability "
                           "extension)",
                "parameters": _SUBJECT_QUERY_PARAMS + [
                    _MAX_DEPTH_PARAM, snaptoken_param,
                    {"name": "page_size", "in": "query",
                     "schema": {"type": "integer"}},
                    {"name": "page_token", "in": "query",
                     "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": {
                        **_json_response(
                            "objects the subject reaches",
                            "listObjectsResponse",
                        ),
                        "headers": snaptoken_header,
                    },
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                    "409": _json_response(
                        "snaptoken demands a newer snapshot", "errorGeneric"
                    ),
                },
            }
        },
        LIST_SUBJECTS_ROUTE: {
            "get": {
                "summary": "List the subject ids that reach an object "
                           "(keto_tpu reverse-reachability extension)",
                "parameters": [
                    {"name": "namespace", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "object", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "relation", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    _MAX_DEPTH_PARAM, snaptoken_param,
                    {"name": "page_size", "in": "query",
                     "schema": {"type": "integer"}},
                    {"name": "page_token", "in": "query",
                     "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": {
                        **_json_response(
                            "subject ids that reach the object",
                            "listSubjectsResponse",
                        ),
                        "headers": snaptoken_header,
                    },
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                    "409": _json_response(
                        "snaptoken demands a newer snapshot", "errorGeneric"
                    ),
                },
            }
        },
        WATCH_ROUTE: {
            "get": {
                "summary": "Stream the tuple changelog as Server-Sent "
                           "Events (keto_tpu watch extension; Zanzibar's "
                           "Watch API)",
                "parameters": [
                    snaptoken_param,
                    {"name": "namespace", "in": "query",
                     "schema": {"type": "string"},
                     "description": "only stream changes in this "
                                    "namespace (reset events always "
                                    "pass the filter)"},
                    {"name": "max_events", "in": "query",
                     "schema": {"type": "integer"},
                     "description": "close the stream after N events "
                                    "(scripting/testing aid)"},
                ],
                "responses": {
                    "200": {
                        "description": "SSE stream; each message is one "
                                       "committed store version (event: "
                                       "change|reset, data: watchEvent)",
                        "content": {
                            "text/event-stream": {
                                "schema": {
                                    "$ref": "#/components/schemas/watchEvent"
                                }
                            }
                        },
                    },
                    "400": _json_response("malformed snaptoken",
                                          "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                    "409": _json_response(
                        "snaptoken demands a newer snapshot", "errorGeneric"
                    ),
                },
            }
        },
        WRITE_ROUTE: {
            "put": {
                "summary": "Create one relation tuple",
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": {
                        "$ref": "#/components/schemas/relationTuple"
                    }}},
                },
                "responses": {
                    "201": _json_response("created", "relationTuple"),
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                },
            },
            "delete": {
                "summary": "Delete all relation tuples matching the query",
                "parameters": _SUBJECT_QUERY_PARAMS,
                "responses": {
                    "204": {"description": "deleted"},
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                },
            },
            "patch": {
                "summary": "Apply insert/delete deltas transactionally",
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": {
                        "type": "array",
                        "items": {"$ref": "#/components/schemas/patchDelta"},
                    }}},
                },
                "responses": {
                    "204": {"description": "applied"},
                    "400": _json_response("malformed input", "errorGeneric"),
                    "404": _json_response("unknown namespace", "errorGeneric"),
                },
            },
        },
        ALIVE_ROUTE: {"get": {"responses": {
            "200": _json_response("process is alive", "healthStatus")}}},
        READY_ROUTE: {"get": {"responses": {
            "200": _json_response("ready to serve", "healthStatus"),
            "503": _json_response("not ready", "errorGeneric")}}},
        VERSION_ROUTE: {"get": {"responses": {
            "200": _json_response("build version", "version")}}},
    }
    op_ids = {
        (READ_ROUTE_BASE, "get"): "listRelationTuples",
        (CHECK_ROUTE, "get"): "getCheckMirrorStatus",
        (CHECK_ROUTE, "post"): "postCheckMirrorStatus",
        (CHECK_OPENAPI_ROUTE, "get"): "getCheck",
        (CHECK_OPENAPI_ROUTE, "post"): "postCheck",
        (CHECK_BATCH_ROUTE, "post"): "postBatchCheck",
        (EXPAND_ROUTE, "get"): "getExpand",
        (FILTER_ROUTE, "post"): "postFilter",
        (LIST_OBJECTS_ROUTE, "get"): "getListObjects",
        (LIST_SUBJECTS_ROUTE, "get"): "getListSubjects",
        (WATCH_ROUTE, "get"): "getWatch",
        (WRITE_ROUTE, "put"): "createRelationTuple",
        (WRITE_ROUTE, "delete"): "deleteRelationTuples",
        (WRITE_ROUTE, "patch"): "patchRelationTuples",
        (ALIVE_ROUTE, "get"): "isAlive",
        (READY_ROUTE, "get"): "isReady",
        (VERSION_ROUTE, "get"): "getVersion",
    }
    # the per-method dicts are shared between routes (check_op/check_bare),
    # so operationIds go on per-use copies, keyed like the reference's
    # swagger operationIds (httpclient-next method names derive from these)
    paths = {
        p: {m: {**op, "operationId": op_ids[(p, m)]} for m, op in ops.items()}
        for p, ops in paths.items()
    }
    if kind in ("read", "write"):
        # ROUTE_KINDS[p] (not .get): a path missing from the ownership
        # table must raise here — failing open to "shared" would put the
        # route in BOTH ports' specs, the drift this filter exists to stop
        paths = {
            p: ops
            for p, ops in paths.items()
            if ROUTE_KINDS[p] in (kind, "shared")
        }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "keto_tpu read/write API",
            "version": version or "dev",
            "description": (
                "Wire-compatible REST surface of the keto_tpu daemon "
                "(reference parity: spec/swagger.json)"
            ),
        },
        "paths": paths,
        "components": {"schemas": _schemas()},
    }
