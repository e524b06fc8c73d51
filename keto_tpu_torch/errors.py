"""Error values of the Check path, mirroring Keto's public error surface.

Each error carries the HTTP status the REST layer answers with, in the
herodot JSON shape {"error": {code, status, message[, debug]}}.
"""

from __future__ import annotations


class KetoError(Exception):
    """Base error. `status` is the HTTP status code the REST layer returns."""

    status = 500
    code = "internal_server_error"
    default_message = "internal server error"

    def __init__(self, message: str | None = None, *, debug: str | None = None):
        super().__init__(message or self.__class__.default_message)
        self.message = message or self.__class__.default_message
        self.debug = debug

    def to_dict(self) -> dict:
        body = {"code": self.status, "status": self.code, "message": self.message}
        if self.debug:
            body["debug"] = self.debug
        return {"error": body}


class MalformedInputError(KetoError):
    status = 400
    code = "bad_request"
    default_message = "malformed string input"


class DroppedSubjectKeyError(KetoError):
    status = 400
    code = "bad_request"
    default_message = (
        'provide "subject_id" or "subject_set.*"; support for "subject" was dropped'
    )


class DuplicateSubjectError(KetoError):
    status = 400
    code = "bad_request"
    default_message = "exactly one of subject_set or subject_id has to be provided"


class IncompleteSubjectError(KetoError):
    status = 400
    code = "bad_request"
    default_message = (
        'incomplete subject, provide "subject_id" or a complete "subject_set.*"'
    )


class NilSubjectError(KetoError):
    status = 400
    code = "bad_request"
    default_message = "subject is not allowed to be nil"


class IncompleteTupleError(KetoError):
    status = 400
    code = "bad_request"
    default_message = (
        'incomplete tuple, provide "namespace", "object", "relation", and a subject'
    )


class NotFoundError(KetoError):
    status = 404
    code = "not_found"
    default_message = "resource not found"


class NamespaceNotFoundError(NotFoundError):
    default_message = "namespace not found"

    def __init__(self, namespace: str):
        super().__init__(f"namespace {namespace!r} not found")
        self.namespace = namespace


class RelationNotFoundError(KetoError):
    # a namespace has a relation config but not this relation
    # (Keto internal/check/engine.go:228 `relation %q not found`)
    status = 400
    code = "bad_request"
    default_message = "relation not found"

    def __init__(self, relation: str):
        super().__init__(f"relation {relation!r} not found")
        self.relation = relation


class InvalidPageTokenError(KetoError):
    status = 400
    code = "bad_request"
    default_message = "invalid page token"


class NotImplementedYetError(KetoError):
    # a request for a feature the port does not serve yet, answered with
    # this typed 501 (gRPC UNIMPLEMENTED) rather than a silent substitute
    status = 501
    code = "not_implemented"
    default_message = "not yet implemented"


class FilterTooLargeError(KetoError):
    # the filter candidate list exceeds `filter.max_objects`: refused
    # before any work
    status = 400
    code = "bad_request"
    default_message = "filter candidate list exceeds filter.max_objects"


class SnaptokenMalformedError(KetoError):
    # a token that does not parse, or one minted for another network
    status = 400
    code = "bad_request"
    default_message = "malformed snaptoken"


class SnaptokenUnsatisfiableError(KetoError):
    # the token demands a store version this store has not reached
    status = 409
    code = "conflict"
    default_message = "snaptoken requires a newer snapshot than this store has"


class DeadlineExceededError(KetoError):
    # the request's end-to-end deadline (x-request-timeout-ms or
    # serve.check.default_deadline_ms) expired before an answer was
    # produced: the request fails fast instead of holding a batch slot
    status = 504
    code = "deadline_exceeded"
    default_message = "request deadline exceeded"


class OverloadedError(KetoError):
    # refused before any work: the batcher's queue is at
    # serve.check.max_queue, or the daemon drains. The REST layer sends
    # `retry_after_s` as a Retry-After header
    status = 429
    code = "too_many_requests"
    default_message = "server is overloaded, retry later"

    def __init__(self, message: str | None = None, *, debug: str | None = None,
                 retry_after_s: float | None = None):
        super().__init__(message, debug=debug)
        self.retry_after_s = retry_after_s


class BatcherClosedError(OverloadedError, RuntimeError):
    # a check racing the batcher's close: a 429 like the drain's shed,
    # and a RuntimeError for callers that catch that around
    # CheckBatcher.check
    default_message = "check batcher is closed"


class CheckBatchFailedError(KetoError, RuntimeError):
    # an engine batch failed with an untyped exception: every rider gets
    # this typed error instead of the raw one (api/batcher.py
    # classify_engine_error)
    status = 500
    code = "internal_server_error"
    default_message = "check batch evaluation failed"


class StoreUnavailableError(KetoError):
    # the check path cannot answer: the batcher raises it while the device
    # breaker is open (breaker_open, with a Retry-After of the remaining
    # cooldown), and the check cache's answer floor (api/check_cache.py)
    # for an answer pinned below the request's token, which only a store
    # that fails mid-request can cause
    status = 503
    code = "store_unavailable"
    default_message = "the tuple store is unavailable, retry later"

    def __init__(self, message: str | None = None, *, debug: str | None = None,
                 retry_after_s: float | None = None, breaker_open: bool = False):
        super().__init__(message, debug=debug)
        self.retry_after_s = retry_after_s
        self.breaker_open = breaker_open


class StoreBusyError(StoreUnavailableError):
    # SQLITE_BUSY / "database is locked" past the connection's busy
    # timeout (storage/sqlite.py _PrepConn): contention a client backs off
    # from and retries, 503 / UNAVAILABLE like its parent
    default_message = "the tuple store is busy (locked), retry"
