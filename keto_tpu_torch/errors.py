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


class FilterTooLargeError(KetoError):
    # the filter candidate list exceeds `filter.max_objects`: refused
    # before any work
    status = 400
    code = "bad_request"
    default_message = "filter candidate list exceeds filter.max_objects"
