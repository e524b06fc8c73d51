"""gRPC clients of the read and write services.

`resolve_remote` takes an address from a flag, else the environment
(KETO_READ_REMOTE, KETO_WRITE_REMOTE), else the default port;
`open_channel` is plaintext to a local address and TLS elsewhere. The
clients speak Keto's v1alpha2 wire format and the keto_tpu extensions, so
they work against the port's daemon, the JAX package's, or Keto's own
(which answers the extensions UNIMPLEMENTED).

`ReadClient.watch` iterates the change-log stream (the keto_tpu watch
extension). Not here yet: `check_explain`, whose server is not ported.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, NamedTuple, Optional

import grpc

from ..ketoapi import GetResponse, RelationQuery, RelationTuple, Subject, Tree
from .descriptors import (
    BATCH_CHECK_SERVICE,
    CHECK_SERVICE,
    EXPAND_SERVICE,
    FILTER_SERVICE,
    HEALTH_SERVICE,
    READ_SERVICE,
    REVERSE_READ_SERVICE,
    SERVING_STATUS,
    VERSION_SERVICE,
    WATCH_SERVICE,
    WRITE_SERVICE,
    pb,
)
from .messages import query_to_proto, subject_to_proto, tree_from_proto, tuple_from_proto, \
    tuple_to_proto

READ_REMOTE_ENV = "KETO_READ_REMOTE"
WRITE_REMOTE_ENV = "KETO_WRITE_REMOTE"
DEFAULT_READ_REMOTE = "127.0.0.1:4466"
DEFAULT_WRITE_REMOTE = "127.0.0.1:4467"


def resolve_remote(flag_value: Optional[str], env: str, default: str) -> str:
    return flag_value or os.environ.get(env) or default


def _is_local(remote: str) -> bool:
    return remote.rsplit(":", 1)[0] in ("localhost", "127.0.0.1", "[::1]", "::1")


def open_channel(remote: str, insecure: Optional[bool] = None) -> grpc.Channel:
    """A channel to `remote`: plaintext for a local address unless
    `insecure` says otherwise, TLS elsewhere."""
    if insecure is None:
        insecure = _is_local(remote)
    if insecure:
        return grpc.insecure_channel(remote)
    return grpc.secure_channel(remote, grpc.ssl_channel_credentials())


class _BaseClient:
    def __init__(self, channel: grpc.Channel, retry_policy=None):
        self.channel = channel
        self._callables: dict = {}
        self._retry = retry_policy

    def _rpc(self, service: str, method: str, req, resp_cls, timeout=None):
        # one multicallable a method: making one costs a channel-level
        # call handle, too much to pay a request
        key = (service, method)
        call = self._callables.get(key)
        if call is None:
            call = self._callables[key] = self.channel.unary_unary(
                f"/{service}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )
        if self._retry is None:
            return call(req, timeout=timeout)
        # `timeout` is the budget of all attempts: each gets what is left
        return self._retry.call(lambda remaining: call(req, timeout=remaining), timeout)

    def get_version(self, timeout=None) -> str:
        return self._rpc(VERSION_SERVICE, "GetVersion", pb.GetVersionRequest(),
                         pb.GetVersionResponse, timeout).version

    def health(self, timeout=None) -> str:
        """The serving status's name ("SERVING", "NOT_SERVING", ...)."""
        resp = self._rpc(HEALTH_SERVICE, "Check", pb.HealthCheckRequest(),
                         pb.HealthCheckResponse, timeout)
        return SERVING_STATUS.values_by_number[resp.status].name

    def close(self) -> None:
        self.channel.close()


class WatchStreamEvent(NamedTuple):
    """One event of ReadClient.watch(): a committed store version
    ("change"), a gap ("reset"), a store outage ("degraded"), or, when
    asked for, a heartbeat."""

    event_type: str
    snaptoken: str  # the resumable cursor
    changes: list  # [("insert" | "delete", RelationTuple), ...]


class ReadClient(_BaseClient):
    """The read services' client. `retry_policy` (resilience.RetryPolicy)
    retries every call of this client, all idempotent reads, on the codes
    the server sheds with, inside the caller's `timeout`."""

    def check(self, t: RelationTuple, max_depth: int = 0, timeout=None,
              snaptoken: str = "") -> bool:
        return self.check_with_token(t, max_depth, timeout=timeout, snaptoken=snaptoken)[0]

    def check_with_token(self, t: RelationTuple, max_depth: int = 0, timeout=None,
                         snaptoken: str = "") -> tuple[bool, str]:
        """(allowed, the response's snaptoken). A `snaptoken` from a write
        pins the read to at least the version it names."""
        req = pb.CheckRequest(max_depth=max_depth, snaptoken=snaptoken)
        req.tuple.CopyFrom(tuple_to_proto(t))
        resp = self._rpc(CHECK_SERVICE, "Check", req, pb.CheckResponse, timeout)
        return resp.allowed, resp.snaptoken

    def check_batch(self, tuples: Iterable[RelationTuple], max_depth: int = 0, timeout=None,
                    snaptoken: str = "") -> list[tuple[bool, str]]:
        """One BatchCheck RPC: [(allowed, error message)] in request order,
        "" for a clean verdict."""
        req = pb.BatchCheckRequest(max_depth=max_depth, snaptoken=snaptoken)
        req.tuples.extend(tuple_to_proto(t) for t in tuples)
        resp = self._rpc(BATCH_CHECK_SERVICE, "BatchCheck", req, pb.BatchCheckResponse,
                         timeout)
        return [(r.allowed, r.error) for r in resp.results]

    def expand(self, subject: Subject, max_depth: int = 0, timeout=None) -> Tree:
        req = pb.ExpandRequest(max_depth=max_depth)
        req.subject.CopyFrom(subject_to_proto(subject))
        return tree_from_proto(
            self._rpc(EXPAND_SERVICE, "Expand", req, pb.ExpandResponse, timeout).tree)

    def list_objects(self, namespace: str, relation: str, subject: Subject,
                     max_depth: int = 0, page_size: int = 0, page_token: str = "",
                     timeout=None, snaptoken: str = "") -> tuple[list[str], str, str]:
        """(sorted object names, next page token, response snaptoken)."""
        req = pb.ListObjectsRequest(namespace=namespace, relation=relation,
                                    max_depth=max_depth, page_size=page_size,
                                    page_token=page_token, snaptoken=snaptoken)
        req.subject.CopyFrom(subject_to_proto(subject))
        resp = self._rpc(REVERSE_READ_SERVICE, "ListObjects", req, pb.ListObjectsResponse,
                         timeout)
        return list(resp.objects), resp.next_page_token, resp.snaptoken

    def list_subjects(self, namespace: str, obj: str, relation: str, max_depth: int = 0,
                      page_size: int = 0, page_token: str = "", timeout=None,
                      snaptoken: str = "") -> tuple[list[str], str, str]:
        """(sorted subject ids, next page token, response snaptoken)."""
        req = pb.ListSubjectsRequest(namespace=namespace, object=obj, relation=relation,
                                     max_depth=max_depth, page_size=page_size,
                                     page_token=page_token, snaptoken=snaptoken)
        resp = self._rpc(REVERSE_READ_SERVICE, "ListSubjects", req, pb.ListSubjectsResponse,
                         timeout)
        return list(resp.subject_ids), resp.next_page_token, resp.snaptoken

    def filter(self, namespace: str, relation: str, subject: Subject, objects: list[str],
               max_depth: int = 0, timeout=None, snaptoken: str = "") -> tuple[list[str], str]:
        """(the candidates the subject can see, in request order, response
        snaptoken): one RPC for the whole candidate list."""
        req = pb.FilterRequest(namespace=namespace, relation=relation, max_depth=max_depth,
                               snaptoken=snaptoken)
        req.subject.CopyFrom(subject_to_proto(subject))
        req.objects.extend(objects)
        resp = self._rpc(FILTER_SERVICE, "Filter", req, pb.FilterResponse, timeout)
        return list(resp.allowed_objects), resp.snaptoken

    def watch(self, snaptoken: str = "", namespace: str = "", timeout=None,
              max_events: Optional[int] = None,
              yield_heartbeats: bool = False) -> Iterator[WatchStreamEvent]:
        """The server's change-log stream (WatchService), an event a
        committed store version; keep the last event's snaptoken and pass
        it to resume after a disconnect. A "reset" event is a gap the
        stream cannot fill (re-read your state, then go on), "degraded" a
        store outage on the server. Heartbeat frames are dropped unless
        `yield_heartbeats` (then yielded with no changes) and never count
        toward `max_events`, after which the stream ends; `timeout`
        bounds the whole stream. Leaving the iterator cancels the call."""
        req = pb.WatchRequest(snaptoken=snaptoken, namespace=namespace)
        key = (WATCH_SERVICE, "Watch")
        stream = self._callables.get(key)
        if stream is None:
            stream = self._callables[key] = self.channel.unary_stream(
                f"/{WATCH_SERVICE}/Watch",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.WatchResponse.FromString,
            )
        call = stream(req, timeout=timeout)
        yielded = 0
        try:
            for resp in call:
                if resp.event_type == "heartbeat":
                    if yield_heartbeats:
                        yield WatchStreamEvent(resp.event_type, resp.snaptoken, [])
                    continue
                yield WatchStreamEvent(
                    resp.event_type, resp.snaptoken,
                    [(c.action, tuple_from_proto(c.relation_tuple)) for c in resp.changes])
                yielded += 1
                if max_events is not None and yielded >= max_events:
                    return
        finally:
            call.cancel()

    def list_relation_tuples(self, query: RelationQuery, page_size: int = 0,
                             page_token: str = "", timeout=None) -> GetResponse:
        req = pb.ListRelationTuplesRequest(page_size=page_size, page_token=page_token)
        req.relation_query.CopyFrom(query_to_proto(query))
        resp = self._rpc(READ_SERVICE, "ListRelationTuples", req,
                         pb.ListRelationTuplesResponse, timeout)
        return GetResponse(relation_tuples=[tuple_from_proto(m) for m in resp.relation_tuples],
                           next_page_token=resp.next_page_token)


class WriteClient(_BaseClient):
    """The write service's client; never retried (a retried transact could
    apply twice)."""

    def __init__(self, channel: grpc.Channel):
        super().__init__(channel)

    def transact(self, insert: Iterable[RelationTuple] = (),
                 delete: Iterable[RelationTuple] = (), timeout=None) -> list[str]:
        """Apply the deltas as one commit; one snaptoken per insert, each
        the store version after the write."""
        req = pb.TransactRelationTuplesRequest()
        for action, tuples in ((1, insert), (2, delete)):  # ACTION_INSERT, ACTION_DELETE
            for t in tuples:
                d = req.relation_tuple_deltas.add()
                d.action = action
                d.relation_tuple.CopyFrom(tuple_to_proto(t))
        resp = self._rpc(WRITE_SERVICE, "TransactRelationTuples", req,
                         pb.TransactRelationTuplesResponse, timeout)
        return list(resp.snaptokens)

    def delete_all(self, query: RelationQuery, timeout=None) -> None:
        req = pb.DeleteRelationTuplesRequest()
        req.relation_query.CopyFrom(query_to_proto(query))
        self._rpc(WRITE_SERVICE, "DeleteRelationTuples", req,
                  pb.DeleteRelationTuplesResponse, timeout)
