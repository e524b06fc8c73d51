from .ast import (
    ComputedSubjectSet,
    InvertResult,
    Operator,
    Relation,
    RelationType,
    SubjectSetRewrite,
    TupleToSubjectSet,
)
from .definitions import Namespace

__all__ = [
    "Namespace",
    "Relation",
    "RelationType",
    "SubjectSetRewrite",
    "ComputedSubjectSet",
    "TupleToSubjectSet",
    "InvertResult",
    "Operator",
]
