"""Userset-rewrite AST.

Parity with the reference's internal/namespace/ast/ast_definitions.go:
Relation (:6-10), RelationType (:12-15), SubjectSetRewrite (:17-20),
ComputedSubjectSet (:31-33), TupleToSubjectSet (:35-38), InvertResult
(:40-43), Operator or/and (:46-52), and the AsRewrite normalization (:59-68).

The AST is both the config surface (JSON namespaces, OPL output) and the
input to the TPU rewrite-program compiler (engine/snapshot.py), which
flattens it into numeric instruction tables usable inside jitted code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Mapping, Optional, Union


class Operator(str, Enum):
    OR = "or"
    AND = "and"


@dataclass
class ComputedSubjectSet:
    """Substitute the tuple's relation: check n:obj#<relation>@subject."""

    relation: str

    def as_rewrite(self) -> "SubjectSetRewrite":
        return SubjectSetRewrite(operation=Operator.OR, children=[self])

    def to_dict(self) -> dict:
        return {"relation": self.relation}


@dataclass
class TupleToSubjectSet:
    """Query n:obj#<relation>@*, then for each subject-set subject check
    <set.ns>:<set.obj>#<computed_subject_set_relation>@subject."""

    relation: str
    computed_subject_set_relation: str

    def as_rewrite(self) -> "SubjectSetRewrite":
        return SubjectSetRewrite(operation=Operator.OR, children=[self])

    def to_dict(self) -> dict:
        return {
            "relation": self.relation,
            "computed_subject_set_relation": self.computed_subject_set_relation,
        }


@dataclass
class InvertResult:
    """Invert the check result of the child (IsMember <-> NotMember,
    Unknown stays Unknown)."""

    child: "Child"

    def as_rewrite(self) -> "SubjectSetRewrite":
        return SubjectSetRewrite(operation=Operator.OR, children=[self])

    def to_dict(self) -> dict:
        return {"inverted": child_to_dict(self.child)}


@dataclass
class SubjectSetRewrite:
    operation: Operator = Operator.OR
    children: list["Child"] = field(default_factory=list)

    def as_rewrite(self) -> "SubjectSetRewrite":
        return self

    def to_dict(self) -> dict:
        return {
            "operator": self.operation.value,
            "children": [child_to_dict(c) for c in self.children],
        }


Child = Union[SubjectSetRewrite, ComputedSubjectSet, TupleToSubjectSet, InvertResult]


@dataclass
class RelationType:
    """Allowed subject type of a relation: a namespace, or a subject set
    SubjectSet<namespace, relation>."""

    namespace: str
    relation: str = ""  # optional

    def to_dict(self) -> dict:
        d = {"namespace": self.namespace}
        if self.relation:
            d["relation"] = self.relation
        return d


@dataclass
class Relation:
    name: str
    types: list[RelationType] = field(default_factory=list)
    subject_set_rewrite: Optional[SubjectSetRewrite] = None

    def to_dict(self) -> dict:
        d: dict = {"name": self.name}
        if self.types:
            d["types"] = [t.to_dict() for t in self.types]
        if self.subject_set_rewrite is not None:
            d["rewrite"] = self.subject_set_rewrite.to_dict()
        return d


def child_to_dict(c: Child) -> dict:
    d = c.to_dict()
    d["type"] = {
        SubjectSetRewrite: "rewrite",
        ComputedSubjectSet: "computed_subject_set",
        TupleToSubjectSet: "tuple_to_subject_set",
        InvertResult: "invert",
    }[type(c)]
    return d


def child_from_dict(d: Mapping) -> Child:
    kind = d.get("type")
    if kind == "rewrite" or ("operator" in d and "children" in d):
        return rewrite_from_dict(d)
    if kind == "tuple_to_subject_set" or "computed_subject_set_relation" in d:
        return TupleToSubjectSet(
            relation=d["relation"],
            computed_subject_set_relation=d["computed_subject_set_relation"],
        )
    if kind == "invert" or "inverted" in d:
        return InvertResult(child=child_from_dict(d["inverted"]))
    return ComputedSubjectSet(relation=d["relation"])


def rewrite_from_dict(d: Mapping) -> SubjectSetRewrite:
    return SubjectSetRewrite(
        operation=Operator(d.get("operator", "or")),
        children=[child_from_dict(c) for c in d.get("children", [])],
    )


def relation_from_dict(d: Mapping) -> Relation:
    return Relation(
        name=d["name"],
        types=[
            RelationType(namespace=t["namespace"], relation=t.get("relation", ""))
            for t in d.get("types", [])
        ],
        subject_set_rewrite=(
            rewrite_from_dict(d["rewrite"]) if d.get("rewrite") else None
        ),
    )
