"""Dictionary encoding: the string <-> UUID mapping of the SQL store.

As Keto's MappingManager (internal/persistence/sql/uuid_mapping.go): a
deterministic UUIDv5 derived from the network id and the string, so that
writing a mapping is idempotent, and batched lookups both ways; and the
batch `Mapper` (internal/relationtuple/uuid_mapping.go) that translates
public string tuples to the UUID-encoded internal form in one mapping
call. The device engine keeps its own dense int32 vocabulary
(engine/snapshot.py); the SQLite persister's schema is keyed by these
UUIDs.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

from ..errors import NotFoundError
from ..ketoapi import RelationTuple, SubjectSet
from .definitions import DEFAULT_NETWORK


def map_string_to_uuid(nid: str, s: str) -> uuid.UUID:
    """Deterministic UUIDv5, namespaced by the network id.
    ref: internal/persistence/sql/uuid_mapping.go:31-44."""
    network_ns = uuid.uuid5(uuid.NAMESPACE_OID, f"keto-nid:{nid}")
    return uuid.uuid5(network_ns, s)


class MappingManager(Protocol):
    """ref: internal/relationtuple/uuid_mapping.go:24-27"""

    def map_strings_to_uuids(
        self, strings: Sequence[str], nid: str = DEFAULT_NETWORK
    ) -> list[uuid.UUID]: ...

    def map_uuids_to_strings(
        self, uuids: Sequence[uuid.UUID], nid: str = DEFAULT_NETWORK
    ) -> list[str]: ...


class UUIDMappingManager:
    """In-memory mapping store; the SQLite persister keeps a durable one
    in its keto_uuid_mappings table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_uuid: dict[tuple[str, uuid.UUID], str] = {}

    def map_strings_to_uuids(
        self, strings: Sequence[str], nid: str = DEFAULT_NETWORK
    ) -> list[uuid.UUID]:
        # as Keto's, every string seen is recorded, reads included
        out = []
        with self._lock:
            for s in strings:
                u = map_string_to_uuid(nid, s)
                self._by_uuid[(nid, u)] = s
                out.append(u)
        return out

    def map_uuids_to_strings(
        self, uuids: Sequence[uuid.UUID], nid: str = DEFAULT_NETWORK
    ) -> list[str]:
        out = []
        with self._lock:
            for u in uuids:
                try:
                    out.append(self._by_uuid[(nid, u)])
                except KeyError:
                    raise NotFoundError(f"no mapping for uuid {u}")
        return out


# -- internal (UUID-encoded) tuple form --------------------------------------


@dataclass(frozen=True)
class InternalSubjectSet:
    namespace: uuid.UUID
    object: uuid.UUID
    relation: uuid.UUID


@dataclass(frozen=True)
class InternalRelationTuple:
    """UUID-encoded tuple: every part dictionary-encoded, a fixed-width
    row (Keto encodes only the objects and keeps the namespace and the
    relation as strings)."""

    namespace: uuid.UUID
    object: uuid.UUID
    relation: uuid.UUID
    subject_id: Optional[uuid.UUID] = None
    subject_set: Optional[InternalSubjectSet] = None


class Mapper:
    """Batch translator between the public (string) and internal (UUID)
    forms: collect every string, one batched map call, then assemble."""

    def __init__(self, mapping: MappingManager):
        self.mapping = mapping

    def from_tuples(
        self, tuples: Sequence[RelationTuple], nid: str = DEFAULT_NETWORK
    ) -> list[InternalRelationTuple]:
        strings: list[str] = []
        for t in tuples:
            strings.extend((t.namespace, t.object, t.relation))
            if t.subject_set is not None:
                s = t.subject_set
                strings.extend((s.namespace, s.object, s.relation))
            else:
                strings.append(t.subject_id or "")
        uuids = self.mapping.map_strings_to_uuids(strings, nid=nid)
        out: list[InternalRelationTuple] = []
        i = 0
        for t in tuples:
            ns, obj, rel = uuids[i : i + 3]
            i += 3
            if t.subject_set is not None:
                sns, sobj, srel = uuids[i : i + 3]
                i += 3
                out.append(
                    InternalRelationTuple(
                        ns, obj, rel,
                        subject_set=InternalSubjectSet(sns, sobj, srel),
                    )
                )
            else:
                sid = uuids[i]
                i += 1
                out.append(InternalRelationTuple(ns, obj, rel, subject_id=sid))
        return out

    def to_tuples(
        self, internal: Sequence[InternalRelationTuple], nid: str = DEFAULT_NETWORK
    ) -> list[RelationTuple]:
        uuids: list[uuid.UUID] = []
        for t in internal:
            uuids.extend((t.namespace, t.object, t.relation))
            if t.subject_set is not None:
                uuids.extend(
                    (t.subject_set.namespace, t.subject_set.object, t.subject_set.relation)
                )
            else:
                uuids.append(t.subject_id)  # type: ignore[arg-type]
        strings = self.mapping.map_uuids_to_strings(uuids, nid=nid)
        out: list[RelationTuple] = []
        i = 0
        for t in internal:
            ns, obj, rel = strings[i : i + 3]
            i += 3
            if t.subject_set is not None:
                sns, sobj, srel = strings[i : i + 3]
                i += 3
                out.append(
                    RelationTuple(
                        ns, obj, rel, subject_set=SubjectSet(sns, sobj, srel)
                    )
                )
            else:
                sid = strings[i]
                i += 1
                out.append(RelationTuple(ns, obj, rel, subject_id=sid))
        return out
