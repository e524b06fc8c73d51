"""The gRPC services of the read and write APIs, over a Registry and the
daemon's CheckBatcher.

Handlers are registered with `grpc.method_handlers_generic_handler`
against the runtime message classes of descriptors.py, so no generated
stubs are needed; the routes and message bytes are Keto's v1alpha2 and
the keto_tpu extensions'.

The read server: CheckService, BatchCheckService, ExpandService,
ReadService (ListRelationTuples), ReverseReadService (ListObjects,
ListSubjects), FilterService and the tuple WatchService (Watch, a stream
of the store's change log from the Watch hub: every change after the
request's snaptoken, exactly once and in version order, then the live
tail; a RESET where the ring overflowed or the log no longer reaches
the cursor; a `heartbeat` frame every `watch.heartbeat_s` seconds, 5 by
default). The write server: WriteService
(TransactRelationTuples, DeleteRelationTuples). Both: VersionService and
grpc.health.v1 Health (Check, and Watch, a stream of the serving status
that wakes on every readiness change). A tuple Watch and a Health Watch
draw on one pool of `serve.read.grpc.max_watchers` slots (16 by
default), since each holds a worker thread for its life.

Semantics, as the JAX package's servers:
  - Check takes the `tuple` field before the deprecated flat fields; an
    unknown namespace is an error here (only REST answers it with
    allowed=false); it runs the admission gate before any work, enforces
    the request's snaptoken, then rides the check cache and the batcher.
    `explain=true` answers UNIMPLEMENTED: the DecisionTrace is not
    ported.
  - BatchCheck goes straight to one `engine.check_batch`; a nil subject,
    an unknown namespace or an engine error answers that item alone.
  - Expand of a subject id is a leaf carrying only the deprecated
    subject field; of a subject set with no tuple, an empty response.
  - ListRelationTuples and DeleteRelationTuples take `relation_query`
    before the deprecated `query`; neither is INVALID_ARGUMENT.
  - TransactRelationTuples answers one snaptoken per INSERT delta, each
    the store version after the write.
  - A KetoError answers the gRPC code of its HTTP status with its
    message, and its retry hint as `retry-after` trailing metadata (the
    twin of REST's Retry-After); any other exception is INTERNAL. A
    failed device batch is therefore INTERNAL and an open breaker
    UNAVAILABLE: neither is answered from the host.
  - The RPC's own deadline (`context.time_remaining()`) becomes the
    request's Deadline (resilience.ingest_deadline), capped and defaulted
    by serve.check.*_deadline_ms.

Not served yet, each a typed status: explain (UNIMPLEMENTED), replica workers,
metrics and tracing, and per-request network ids. api/aio_server.py
serves these same bodies on the asyncio plane.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures

import grpc

from ..engine.snaptoken import encode_snaptoken, enforce_snaptoken, parse_snaptoken
from ..errors import KetoError, MalformedInputError, NilSubjectError, NotImplementedYetError
from ..ketoapi import RelationQuery, RelationTuple, SubjectSet
from ..resilience import (
    RequestTrace,
    admit_check,
    admit_filter,
    ingest_deadline,
    retry_after_header_value,
)
from .check_cache import cached_check
from .descriptors import (
    BATCH_CHECK_SERVICE,
    CHECK_SERVICE,
    EXPAND_SERVICE,
    FILTER_SERVICE,
    HEALTH_SERVICE,
    READ_SERVICE,
    REVERSE_READ_SERVICE,
    VERSION_SERVICE,
    WATCH_SERVICE,
    WRITE_SERVICE,
    pb,
)
from .messages import (
    query_from_legacy_proto,
    query_from_proto,
    subject_from_proto,
    subject_to_proto,
    tree_to_proto,
    tuple_from_proto,
    tuple_to_proto,
)
from .rest_server import EXPLAIN_UNIMPLEMENTED

_CODE_BY_STATUS = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    403: grpc.StatusCode.PERMISSION_DENIED,
    404: grpc.StatusCode.NOT_FOUND,
    409: grpc.StatusCode.FAILED_PRECONDITION,  # a snaptoken ahead of the store
    429: grpc.StatusCode.RESOURCE_EXHAUSTED,  # shed by admission
    500: grpc.StatusCode.INTERNAL,
    501: grpc.StatusCode.UNIMPLEMENTED,
    503: grpc.StatusCode.UNAVAILABLE,
    504: grpc.StatusCode.DEADLINE_EXCEEDED,
}


def _grpc_code(err: Exception) -> grpc.StatusCode:
    if isinstance(err, KetoError):
        return _CODE_BY_STATUS.get(err.status, grpc.StatusCode.INTERNAL)
    return grpc.StatusCode.INTERNAL


def _attach_retry_after(context, err) -> None:
    """An error's retry hint as `retry-after` trailing metadata, in the
    whole seconds of REST's Retry-After header."""
    ra = getattr(err, "retry_after_s", None)
    if ra is not None:
        context.set_trailing_metadata((("retry-after", retry_after_header_value(ra)),))


class _Services:
    """The handlers behind both servers."""

    def __init__(self, registry, batcher=None):
        self.registry = registry
        self.batcher = batcher
        # a Watch stream, tuple or Health, holds one server worker thread
        # for its life: the cap keeps watchers from taking the whole pool
        self.max_watchers = int(registry.config.get("serve.read.grpc.max_watchers", 16))
        self._watch_slots = threading.BoundedSemaphore(self.max_watchers)

    # -- helpers --------------------------------------------------------------

    def _request_trace(self, context) -> RequestTrace:
        return RequestTrace(ingest_deadline(self.registry.config,
                                            native_s=context.time_remaining()))

    def _observed(self, context, fn, request):
        """Run one unary handler: a KetoError answers its mapped code and
        message (with its retry hint), anything else INTERNAL."""
        rt = self._request_trace(context)
        try:
            return fn(request, context, rt)
        except KetoError as e:
            _attach_retry_after(context, e)
            context.abort(_grpc_code(e), e.message)
        except Exception as e:  # noqa: BLE001 - the RPC boundary answers INTERNAL
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def _enforce(self, token: str) -> int:
        reg = self.registry
        return enforce_snaptoken(reg.relation_tuple_manager(), token, reg.nid)

    def _token(self, version: int) -> str:
        return encode_snaptoken(version, self.registry.nid)

    @staticmethod
    def _subject(m):
        sub = subject_from_proto(m)
        if sub is None:
            raise NilSubjectError()
        return sub

    def _query_from(self, req, missing: str) -> RelationQuery:
        if req.HasField("relation_query"):
            return query_from_proto(req.relation_query)
        if req.HasField("query"):
            return query_from_legacy_proto(req.query)
        raise MalformedInputError(missing)

    # -- CheckService, BatchCheckService ----------------------------------------

    def check_tuple(self, req) -> RelationTuple:
        """A CheckRequest's tuple, the `tuple` field before the deprecated
        flat fields, its namespaces validated."""
        src = req.tuple if req.HasField("tuple") else req
        t = RelationTuple.make(src.namespace, src.object, src.relation,
                               self._subject(src.subject))
        self.registry.validate_namespaces(t)
        return t

    def check(self, req, context, rt):
        reg = self.registry
        if req.explain:
            raise NotImplementedYetError(EXPLAIN_UNIMPLEMENTED)
        admit_check(reg, self.batcher, rt)
        t = self.check_tuple(req)
        version = self._enforce(req.snaptoken)
        res = cached_check(reg, self.batcher, reg.nid, t, int(req.max_depth), version, rt)
        if res.error is not None:
            raise res.error
        return pb.CheckResponse(allowed=res.allowed, snaptoken=self._token(version))

    def batch_check(self, req, context, rt):
        """The whole batch rides one engine.check_batch, not the batcher's
        queue: the gate checks draining and the deadline only."""
        reg = self.registry
        admit_check(reg, None, rt)
        version = self._enforce(req.snaptoken)
        out = [None] * len(req.tuples)
        idx, tuples = [], []
        for i, pt in enumerate(req.tuples):
            sub = subject_from_proto(pt.subject)
            if sub is None:
                out[i] = pb.BatchCheckResult(allowed=False, error=NilSubjectError().message)
                continue
            t = RelationTuple.make(pt.namespace, pt.object, pt.relation, sub)
            try:
                reg.validate_namespaces(t)
            except KetoError as e:
                out[i] = pb.BatchCheckResult(allowed=False, error=e.message)
                continue
            idx.append(i)
            tuples.append(t)
        results = reg.check_engine().check_batch(tuples, int(req.max_depth))
        for i, r in zip(idx, results):
            out[i] = pb.BatchCheckResult(allowed=False, error=str(r.error)) \
                if r.error is not None else pb.BatchCheckResult(allowed=r.allowed)
        resp = pb.BatchCheckResponse(snaptoken=self._token(version))
        resp.results.extend(out)
        return resp

    # -- ExpandService ------------------------------------------------------------

    def expand(self, req, context, rt):
        self._enforce(req.snaptoken)
        sub = subject_from_proto(req.subject)
        resp = pb.ExpandResponse()
        if not isinstance(sub, SubjectSet):
            resp.tree.node_type = 4  # NODE_TYPE_LEAF
            if sub is not None:
                resp.tree.subject.CopyFrom(subject_to_proto(sub))
            return resp
        self.registry.validate_namespaces(sub)
        tree = self.registry.expand_engine().expand(sub, int(req.max_depth))
        if tree is not None:
            resp.tree.CopyFrom(tree_to_proto(tree))
        return resp

    # -- ReverseReadService, FilterService ------------------------------------

    def list_objects(self, req, context, rt):
        reg = self.registry
        sub = self._subject(req.subject)
        reg.validate_namespaces(RelationQuery(namespace=req.namespace),
                                sub if isinstance(sub, SubjectSet) else None)
        version = self._enforce(req.snaptoken)
        objects, next_token = reg.check_engine().list_objects(
            req.namespace, req.relation, sub, int(req.max_depth),
            page_size=int(req.page_size) or reg.config.page_size(),
            page_token=req.page_token)
        resp = pb.ListObjectsResponse(next_page_token=next_token,
                                      snaptoken=self._token(version))
        resp.objects.extend(objects)
        return resp

    def list_subjects(self, req, context, rt):
        reg = self.registry
        reg.validate_namespaces(RelationQuery(namespace=req.namespace))
        version = self._enforce(req.snaptoken)
        subjects, next_token = reg.check_engine().list_subjects(
            req.namespace, req.object, req.relation, int(req.max_depth),
            page_size=int(req.page_size) or reg.config.page_size(),
            page_token=req.page_token)
        resp = pb.ListSubjectsResponse(next_page_token=next_token,
                                       snaptoken=self._token(version))
        resp.subject_ids.extend(subjects)
        return resp

    def filter(self, req, context, rt):
        """The candidates the subject can see, in request order: admission
        and filter.max_objects before any work, the deadline re-checked
        between the engine's chunks."""
        reg = self.registry
        admit_filter(reg, len(req.objects), rt)
        sub = self._subject(req.subject)
        reg.validate_namespaces(RelationQuery(namespace=req.namespace),
                                sub if isinstance(sub, SubjectSet) else None)
        version = self._enforce(req.snaptoken)
        allowed = reg.check_engine().filter_objects(
            req.namespace, req.relation, sub, list(req.objects), int(req.max_depth),
            deadline=rt.deadline)
        resp = pb.FilterResponse(snaptoken=self._token(version))
        resp.allowed_objects.extend(allowed)
        return resp

    # -- ReadService ----------------------------------------------------------

    def list_relation_tuples(self, req, context, rt):
        reg = self.registry
        self._enforce(req.snaptoken)
        q = self._query_from(req, "you must provide a query")
        reg.validate_namespaces(q)
        tuples, next_token = reg.relation_tuple_manager().get_relation_tuples(
            q, page_token=req.page_token,
            page_size=int(req.page_size) or reg.config.page_size(), nid=reg.nid)
        resp = pb.ListRelationTuplesResponse(next_page_token=next_token)
        resp.relation_tuples.extend(tuple_to_proto(t) for t in tuples)
        return resp

    # -- WriteService ---------------------------------------------------------

    def transact_relation_tuples(self, req, context, rt):
        reg = self.registry
        inserts, deletes = [], []
        for d in req.relation_tuple_deltas:
            if d.action == 1:  # ACTION_INSERT
                inserts.append(tuple_from_proto(d.relation_tuple))
            elif d.action == 2:  # ACTION_DELETE
                deletes.append(tuple_from_proto(d.relation_tuple))
            # ACTION_UNSPECIFIED deltas are ignored, as Keto does
        reg.validate_namespaces(*inserts, *deletes)
        manager = reg.relation_tuple_manager()
        manager.transact_relation_tuples(inserts, deletes, nid=reg.nid)
        token = self._token(manager.version(nid=reg.nid))
        return pb.TransactRelationTuplesResponse(snaptokens=[token] * len(inserts))

    def delete_relation_tuples(self, req, context, rt):
        reg = self.registry
        q = self._query_from(req, "invalid request")
        reg.validate_namespaces(q)
        reg.relation_tuple_manager().delete_all_relation_tuples(q, nid=reg.nid)
        return pb.DeleteRelationTuplesResponse()

    # -- VersionService, Health -------------------------------------------------

    def get_version(self, req, context, rt):
        return pb.GetVersionResponse(version=self.registry.version)

    def health_check(self, req, context, rt):
        # SERVING (1) or NOT_SERVING (2)
        return pb.HealthCheckResponse(status=1 if self.registry.ready.is_set() else 2)

    # -- WatchService -----------------------------------------------------------

    @staticmethod
    def watch_event_to_proto(event):
        """A WatchEvent (watch/hub.py) as a WatchResponse."""
        resp = pb.WatchResponse(event_type=event.kind, snaptoken=event.snaptoken)
        for op, t in event.changes:
            c = resp.changes.add()
            c.action = op
            c.relation_tuple.CopyFrom(tuple_to_proto(t))
        return resp

    def watch_subscribe(self, req, context):
        """What both planes' streams open with: the namespace filter
        validated, the resume cursor parsed, the hub subscription opened.
        Raises a KetoError (snaptoken 400 or 409, namespace 404)."""
        reg = self.registry
        if req.namespace:
            reg.validate_namespaces(RelationQuery(namespace=req.namespace))
        min_version = parse_snaptoken(req.snaptoken, reg.nid)
        return reg.watch_hub().subscribe(reg.nid, min_version)

    def watch_tuples(self, req, context):
        """The change-log stream: the replay from the request's snaptoken,
        then the live tail; an overflow is an in-band RESET, never a
        silent gap. An idle stream writes a `heartbeat` frame (the
        cursor's snaptoken) every watch.heartbeat_s seconds, so that a
        half-open connection fails a write and frees its subscription."""
        if not self._watch_slots.acquire(blocking=False):
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "too many concurrent watchers")
        try:
            try:
                sub = self.watch_subscribe(req, context)
            except KetoError as e:
                context.abort(_grpc_code(e), e.message)
            heartbeat_s = float(self.registry.config.get("watch.heartbeat_s", 5.0))
            last_write = time.monotonic()
            try:
                while context.is_active():
                    # every round, not only an idle one: a stream whose
                    # events the namespace filter drops is busy and silent
                    if time.monotonic() - last_write >= heartbeat_s:
                        last_write = time.monotonic()
                        yield pb.WatchResponse(event_type="heartbeat",
                                               snaptoken=encode_snaptoken(sub.cursor, sub.nid))
                    try:
                        event = sub.get(timeout=0.5)
                    except KetoError as e:
                        # an overflow's resume against a failing store
                        context.abort(_grpc_code(e), e.message)
                    if event is None:
                        if sub.closed:  # the daemon's drain ends the stream
                            break
                        continue
                    event = event.filtered(req.namespace)
                    if event is None:
                        continue
                    yield self.watch_event_to_proto(event)
                    last_write = time.monotonic()
            finally:
                sub.close()
        finally:
            self._watch_slots.release()

    def health_watch(self, req, context):
        """The current status, then each change until the client leaves
        (grpc.health.v1 Watch): the stream parks on the registry's
        readiness and wakes on its transitions; every 5 s it looks whether
        the client is still there."""
        if not self._watch_slots.acquire(blocking=False):
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          "too many concurrent health watchers")
        try:
            flag, gen = self.registry.ready.state()
            last = None
            while context.is_active():
                current = 1 if flag else 2
                if current != last:
                    last = current
                    yield pb.HealthCheckResponse(status=current)
                flag, gen = self.registry.ready.wait_change(gen, timeout=5.0)
        finally:
            self._watch_slots.release()


def _unary(services: _Services, fn, req_cls):
    return grpc.unary_unary_rpc_method_handler(
        lambda request, context: services._observed(context, fn, request),
        request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString(),
    )


def _service_handlers(services: _Services, write: bool) -> list:
    """The generic handlers of one server; Version and Health on both."""
    s = services
    handlers = {
        VERSION_SERVICE: {"GetVersion": _unary(s, s.get_version, pb.GetVersionRequest)},
        HEALTH_SERVICE: {
            "Check": _unary(s, s.health_check, pb.HealthCheckRequest),
            "Watch": grpc.unary_stream_rpc_method_handler(
                s.health_watch,
                request_deserializer=pb.HealthCheckRequest.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
        },
    }
    if write:
        handlers[WRITE_SERVICE] = {
            "TransactRelationTuples": _unary(s, s.transact_relation_tuples,
                                             pb.TransactRelationTuplesRequest),
            "DeleteRelationTuples": _unary(s, s.delete_relation_tuples,
                                           pb.DeleteRelationTuplesRequest),
        }
    else:
        handlers.update({
            CHECK_SERVICE: {"Check": _unary(s, s.check, pb.CheckRequest)},
            BATCH_CHECK_SERVICE: {"BatchCheck": _unary(s, s.batch_check,
                                                       pb.BatchCheckRequest)},
            EXPAND_SERVICE: {"Expand": _unary(s, s.expand, pb.ExpandRequest)},
            READ_SERVICE: {"ListRelationTuples": _unary(s, s.list_relation_tuples,
                                                        pb.ListRelationTuplesRequest)},
            REVERSE_READ_SERVICE: {
                "ListObjects": _unary(s, s.list_objects, pb.ListObjectsRequest),
                "ListSubjects": _unary(s, s.list_subjects, pb.ListSubjectsRequest),
            },
            FILTER_SERVICE: {"Filter": _unary(s, s.filter, pb.FilterRequest)},
            WATCH_SERVICE: {"Watch": grpc.unary_stream_rpc_method_handler(
                s.watch_tuples,
                request_deserializer=pb.WatchRequest.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )},
        })
    return [grpc.method_handlers_generic_handler(name, methods)
            for name, methods in handlers.items()]


def build_grpc_server(registry, *, write: bool, batcher=None,
                      max_workers: int = 32) -> grpc.Server:
    """One gRPC server of the read (`write=False`; single checks ride
    `batcher`) or the write API on a pool of `max_workers` threads. The
    caller binds its ports, starts and stops it (api/daemon.py)."""
    server = grpc.server(futures.ThreadPoolExecutor(
        max_workers=max_workers,
        thread_name_prefix="keto-torch-grpc-write" if write else "keto-torch-grpc-read"))
    server.add_generic_rpc_handlers(tuple(_service_handlers(
        _Services(registry, batcher=batcher), write=write)))
    return server
