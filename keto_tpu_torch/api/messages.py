"""Proto <-> ketoapi conversions: subjects (the `ref` oneof), tuples,
queries (the v1alpha2 RelationQuery and the deprecated all-string
query of ListRelationTuples and DeleteRelationTuples), and trees.

A tree node's type maps only leaf, union, exclusion and intersection;
every other type goes out as NODE_TYPE_UNSPECIFIED, as Keto's encoder
does. An encoded node with a tuple also carries its subject in the
deprecated `subject` field, and a decoded node with only that field
gets a tuple of empty names around it.
"""

from __future__ import annotations

from typing import Optional

from ..errors import NilSubjectError
from ..ketoapi import RelationQuery, RelationTuple, Subject, SubjectSet, Tree, TreeNodeType
from .descriptors import pb

_TO_PROTO_NODE_TYPE = {
    TreeNodeType.LEAF: 4,
    TreeNodeType.UNION: 1,
    TreeNodeType.EXCLUSION: 2,
    TreeNodeType.INTERSECTION: 3,
}
_FROM_PROTO_NODE_TYPE = {v: k for k, v in _TO_PROTO_NODE_TYPE.items()}


def subject_to_proto(sub: Subject):
    m = pb.Subject()
    if isinstance(sub, SubjectSet):
        m.set.namespace = sub.namespace
        m.set.object = sub.object
        m.set.relation = sub.relation
    else:
        m.id = sub
    return m


def subject_from_proto(m) -> Optional[Subject]:
    which = m.WhichOneof("ref")
    if which == "id":
        return m.id
    if which == "set":
        return SubjectSet(namespace=m.set.namespace, object=m.set.object,
                          relation=m.set.relation)
    return None


def tuple_to_proto(t: RelationTuple):
    m = pb.RelationTuple(namespace=t.namespace, object=t.object, relation=t.relation)
    m.subject.CopyFrom(subject_to_proto(t.subject))
    return m


def tuple_from_proto(m) -> RelationTuple:
    sub = subject_from_proto(m.subject)
    if sub is None:
        raise NilSubjectError()
    return RelationTuple.make(m.namespace, m.object, m.relation, sub)


def query_to_proto(q: RelationQuery):
    m = pb.RelationQuery()
    if q.namespace is not None:
        m.namespace = q.namespace
    if q.object is not None:
        m.object = q.object
    if q.relation is not None:
        m.relation = q.relation
    if q.subject is not None:
        m.subject.CopyFrom(subject_to_proto(q.subject))
    return m


def _with_subject(q: RelationQuery, m) -> RelationQuery:
    if m.HasField("subject"):
        sub = subject_from_proto(m.subject)
        if isinstance(sub, SubjectSet):
            q.subject_set = sub
        elif sub is not None:
            q.subject_id = sub
    return q


def query_from_proto(m) -> RelationQuery:
    return _with_subject(RelationQuery(
        namespace=m.namespace if m.HasField("namespace") else None,
        object=m.object if m.HasField("object") else None,
        relation=m.relation if m.HasField("relation") else None,
    ), m)


def query_from_legacy_proto(m) -> RelationQuery:
    """The deprecated nested query: every field a string, empty = unset."""
    return _with_subject(RelationQuery(namespace=m.namespace or None,
                                       object=m.object or None,
                                       relation=m.relation or None), m)


def tree_to_proto(t: Tree):
    m = pb.SubjectTree()
    m.node_type = _TO_PROTO_NODE_TYPE.get(t.type, 0)
    if t.tuple is not None:
        m.tuple.CopyFrom(tuple_to_proto(t.tuple))
        m.subject.CopyFrom(m.tuple.subject)  # the deprecated mirror field
    for c in t.children:
        m.children.append(tree_to_proto(c))
    return m


def tree_from_proto(m) -> Tree:
    t = Tree(type=_FROM_PROTO_NODE_TYPE.get(m.node_type, TreeNodeType.UNSPECIFIED))
    if m.HasField("tuple"):
        t.tuple = tuple_from_proto(m.tuple)
    elif m.HasField("subject"):
        sub = subject_from_proto(m.subject)
        if sub is not None:
            t.tuple = RelationTuple.make("", "", "", sub)
    t.children = [tree_from_proto(c) for c in m.children]
    return t
