"""Public (string-based) API types of the Check path.

Parity with Keto's `ketoapi` package: RelationTuple, SubjectSet,
RelationQuery, PatchDelta, the canonical string form "ns:obj#rel@sub" /
"ns:obj#rel@(ns:obj#rel)", the URL-query form, the JSON form, and the
proof Tree the host oracle builds.

Subjects are polymorphic: a plain subject id (str) or a SubjectSet;
exactly one is set on a tuple.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Mapping, Optional, Union

from .errors import (
    DroppedSubjectKeyError,
    DuplicateSubjectError,
    IncompleteSubjectError,
    IncompleteTupleError,
    MalformedInputError,
    NilSubjectError,
)

SUBJECT_ID_KEY = "subject_id"
SUBJECT_SET_NAMESPACE_KEY = "subject_set.namespace"
SUBJECT_SET_OBJECT_KEY = "subject_set.object"
SUBJECT_SET_RELATION_KEY = "subject_set.relation"


@dataclass(frozen=True)
class SubjectSet:
    """All subjects that have `relation` on `object` in `namespace`."""

    namespace: str
    object: str
    relation: str

    def __str__(self) -> str:
        return f"{self.namespace}:{self.object}#{self.relation}"

    @classmethod
    def from_string(cls, s: str) -> "SubjectSet":
        namespace_and_object, sep, relation = s.partition("#")
        if not sep:
            raise MalformedInputError(debug="expected subject set to contain '#'")
        namespace, sep, obj = namespace_and_object.partition(":")
        if not sep:
            raise MalformedInputError(debug="expected subject set to contain ':'")
        return cls(namespace=namespace, object=obj, relation=relation)

    def to_dict(self) -> dict:
        return {
            "namespace": self.namespace,
            "object": self.object,
            "relation": self.relation,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "SubjectSet":
        try:
            return cls(
                namespace=d["namespace"], object=d["object"], relation=d["relation"]
            )
        except KeyError:
            raise IncompleteSubjectError()


Subject = Union[str, SubjectSet]


def subject_from_string(s: str) -> Subject:
    """Anything containing '#' is a subject set; surrounding parens are
    stripped."""
    s = s.strip("()")
    if "#" in s:
        return SubjectSet.from_string(s)
    return s


def _subject_fields_from_dict(d: Mapping) -> tuple[Optional[str], Optional[SubjectSet]]:
    if "subject" in d:
        raise DroppedSubjectKeyError()
    subject_id = d.get("subject_id")
    raw_set = d.get("subject_set")
    if subject_id is not None and raw_set is not None:
        raise DuplicateSubjectError()
    subject_set = SubjectSet.from_dict(raw_set) if raw_set is not None else None
    return subject_id, subject_set


@dataclass
class RelationTuple:
    """Subject has `relation` on `object` in `namespace`; exactly one of
    subject_id / subject_set is set."""

    namespace: str
    object: str
    relation: str
    subject_id: Optional[str] = None
    subject_set: Optional[SubjectSet] = None

    def __post_init__(self):
        if self.subject_id is not None and self.subject_set is not None:
            raise DuplicateSubjectError()

    @property
    def subject(self) -> Subject:
        if self.subject_id is not None:
            return self.subject_id
        if self.subject_set is not None:
            return self.subject_set
        raise NilSubjectError()

    def with_subject(self, sub: Subject) -> "RelationTuple":
        t = RelationTuple(self.namespace, self.object, self.relation)
        if isinstance(sub, SubjectSet):
            t.subject_set = sub
        else:
            t.subject_id = sub
        return t

    @classmethod
    def make(
        cls, namespace: str, object: str, relation: str, subject: Subject
    ) -> "RelationTuple":
        return cls(namespace=namespace, object=object, relation=relation).with_subject(
            subject
        )

    def __str__(self) -> str:
        if self.subject_id is not None:
            sub = self.subject_id
        elif self.subject_set is not None:
            sub = f"({self.subject_set})"
        else:
            sub = "<ERROR: no subject>"
        return f"{self.namespace}:{self.object}#{self.relation}@{sub}"

    @classmethod
    def from_string(cls, s: str) -> "RelationTuple":
        namespace, sep, rest = s.partition(":")
        if not sep:
            raise MalformedInputError(debug="expected input to contain ':'")
        obj, sep, rest = rest.partition("#")
        if not sep:
            raise MalformedInputError(debug="expected input to contain '#'")
        relation, sep, subject = rest.partition("@")
        if not sep:
            raise MalformedInputError(debug="expected input to contain '@'")
        t = cls(namespace=namespace, object=obj, relation=relation)
        return t.with_subject(subject_from_string(subject))

    def to_dict(self) -> dict:
        d = {
            "namespace": self.namespace,
            "object": self.object,
            "relation": self.relation,
        }
        if self.subject_id is not None:
            d["subject_id"] = self.subject_id
        elif self.subject_set is not None:
            d["subject_set"] = self.subject_set.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "RelationTuple":
        subject_id, subject_set = _subject_fields_from_dict(d)
        if subject_id is None and subject_set is None:
            raise NilSubjectError()
        if "namespace" not in d or "object" not in d or "relation" not in d:
            raise IncompleteTupleError()
        return cls(
            namespace=d["namespace"],
            object=d["object"],
            relation=d["relation"],
            subject_id=subject_id,
            subject_set=subject_set,
        )

    def to_url_query(self) -> dict[str, str]:
        """The URL-query form, keys in Keto's order."""
        v = {"namespace": self.namespace, "relation": self.relation, "object": self.object}
        if self.subject_id is not None:
            v[SUBJECT_ID_KEY] = self.subject_id
        elif self.subject_set is not None:
            v[SUBJECT_SET_NAMESPACE_KEY] = self.subject_set.namespace
            v[SUBJECT_SET_OBJECT_KEY] = self.subject_set.object
            v[SUBJECT_SET_RELATION_KEY] = self.subject_set.relation
        return v

    @classmethod
    def from_url_query(cls, query: Mapping[str, str]) -> "RelationTuple":
        q = RelationQuery.from_url_query(query)
        if q.subject_id is None and q.subject_set is None:
            raise NilSubjectError()
        if q.namespace is None or q.object is None or q.relation is None:
            raise IncompleteTupleError()
        return cls(
            namespace=q.namespace,
            object=q.object,
            relation=q.relation,
            subject_id=q.subject_id,
            subject_set=q.subject_set,
        )

    def _key(self) -> tuple:
        return (
            self.namespace, self.object, self.relation,
            self.subject_id, self.subject_set,
        )

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, RelationTuple) and self._key() == other._key()


@dataclass
class RelationQuery:
    """Query over tuples; None fields are wildcards."""

    namespace: Optional[str] = None
    object: Optional[str] = None
    relation: Optional[str] = None
    subject_id: Optional[str] = None
    subject_set: Optional[SubjectSet] = None

    def __post_init__(self):
        if self.subject_id is not None and self.subject_set is not None:
            raise DuplicateSubjectError()

    @property
    def subject(self) -> Optional[Subject]:
        if self.subject_id is not None:
            return self.subject_id
        return self.subject_set

    @classmethod
    def from_url_query(cls, query: Mapping[str, str]) -> "RelationQuery":
        if "subject" in query:
            raise DroppedSubjectKeyError()
        q = cls()
        has_sid = SUBJECT_ID_KEY in query
        ss_keys = (
            SUBJECT_SET_NAMESPACE_KEY, SUBJECT_SET_OBJECT_KEY, SUBJECT_SET_RELATION_KEY
        )
        has_ss = any(k in query for k in ss_keys)
        if has_sid and has_ss:
            raise DuplicateSubjectError(
                debug=f"please provide either {SUBJECT_ID_KEY} or all of "
                f"{SUBJECT_SET_NAMESPACE_KEY}, {SUBJECT_SET_OBJECT_KEY}, "
                f"and {SUBJECT_SET_RELATION_KEY}"
            )
        if has_sid:
            q.subject_id = query[SUBJECT_ID_KEY]
        elif has_ss:
            if not all(k in query for k in ss_keys):
                raise IncompleteSubjectError()
            q.subject_set = SubjectSet(
                namespace=query[SUBJECT_SET_NAMESPACE_KEY],
                object=query[SUBJECT_SET_OBJECT_KEY],
                relation=query[SUBJECT_SET_RELATION_KEY],
            )
        for key in ("namespace", "object", "relation"):
            if key in query:
                setattr(q, key, query[key])
        return q

    def matches(self, t: RelationTuple) -> bool:
        """Does tuple t satisfy this query? (host-store filtering)"""
        if self.namespace is not None and t.namespace != self.namespace:
            return False
        if self.object is not None and t.object != self.object:
            return False
        if self.relation is not None and t.relation != self.relation:
            return False
        if self.subject_id is not None and t.subject_id != self.subject_id:
            return False
        if self.subject_set is not None and t.subject_set != self.subject_set:
            return False
        return True


class PatchAction(str, Enum):
    INSERT = "insert"
    DELETE = "delete"


@dataclass
class PatchDelta:
    """One item of a PATCH /admin/relation-tuples body."""

    action: PatchAction
    relation_tuple: RelationTuple

    def to_dict(self) -> dict:
        return {"action": self.action.value, "relation_tuple": self.relation_tuple.to_dict()}

    @classmethod
    def from_dict(cls, d: Mapping) -> "PatchDelta":
        try:
            action = PatchAction(d["action"])
        except (KeyError, ValueError):
            raise MalformedInputError(debug="unknown patch action")
        raw_tuple = d.get("relation_tuple")
        if not isinstance(raw_tuple, Mapping):
            raise MalformedInputError(debug='missing "relation_tuple"')
        return cls(action=action, relation_tuple=RelationTuple.from_dict(raw_tuple))


class TreeNodeType(str, Enum):
    UNION = "union"
    EXCLUSION = "exclusion"
    INTERSECTION = "intersection"
    LEAF = "leaf"
    TUPLE_TO_SUBJECT_SET = "tuple_to_subject_set"
    COMPUTED_SUBJECT_SET = "computed_subject_set"
    NOT = "not"
    UNSPECIFIED = "unspecified"


@dataclass
class Tree:
    """A proof tree node; `tuple` is the relation tuple it represents."""

    type: TreeNodeType
    tuple: Optional[RelationTuple] = None
    children: list["Tree"] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict = {"type": self.type.value}
        d["tuple"] = self.tuple.to_dict() if self.tuple is not None else None
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


@dataclass
class GetResponse:
    """A page of GET /relation-tuples (Keto ketoapi/public_api_definitions.go)."""

    relation_tuples: list[RelationTuple]
    next_page_token: str = ""

    def to_dict(self) -> dict:
        return {
            "relation_tuples": [t.to_dict() for t in self.relation_tuples],
            "next_page_token": self.next_page_token,
        }
