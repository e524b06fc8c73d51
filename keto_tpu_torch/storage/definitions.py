"""Relation-tuple storage constants and keyset-pagination helpers.

Every operation is scoped by a network id (nid). Pagination is
keyset-based: rows are ordered by a deterministic per-tuple shard id and
the page token is the last-seen shard id, with an N+1 probe for the
next-page indicator (Keto internal/persistence/sql/relationtuples.go).
"""

from __future__ import annotations

import uuid

from ..errors import InvalidPageTokenError
from ..ketoapi import RelationTuple

DEFAULT_PAGE_SIZE = 100
DEFAULT_NETWORK = "default"

# UUIDv5 namespace of the shard ids: the same constant as the JAX
# package's store, so both stores order tuples identically
_SHARD_NS = uuid.UUID("5a4e8f9e-0c2d-4b3a-9f21-6d1f2a7c8e11")


def shard_id(nid: str, t: RelationTuple) -> str:
    """Deterministic row id from the structured fields (not the display
    string, which is not injective)."""
    if t.subject_set is not None:
        s = t.subject_set
        subject = f"set\x1f{s.namespace}\x1f{s.object}\x1f{s.relation}"
    else:
        subject = f"id\x1f{t.subject_id}"
    key = "\x1f".join((nid, t.namespace, t.object, t.relation, subject))
    return str(uuid.uuid5(_SHARD_NS, key))


def validate_page_token(token: str) -> str:
    """Page tokens are shard ids (UUID strings); '' means first page."""
    if not token:
        return ""
    try:
        return str(uuid.UUID(token))
    except ValueError:
        raise InvalidPageTokenError(debug=f"invalid pagination token {token!r}")


class WriteHookMixin:
    """Post-commit write notification. A store initializes
    ``self._write_listeners = []`` and calls ``self._notify_write(nid,
    changed)`` after it releases its lock: a listener that takes its own
    locks (an engine refreshing its mirror, which reads the store) would
    otherwise deadlock against the store."""

    _write_listeners: list

    def add_write_listener(self, fn) -> None:
        """`fn(nid)` runs after every write call that changed the store
        (idempotent no-ops do not fire), outside the store's lock."""
        self._write_listeners.append(fn)

    def _notify_write(self, nid: str, changed: bool) -> None:
        if changed:
            for fn in tuple(self._write_listeners):
                fn(nid)
