"""Engine result types: the three-valued membership lattice and check
results with proof trees (Keto internal/check/checkgroup/definitions.go:
Membership in {Unknown, IsMember, NotMember}, Result{Membership, Tree,
Err})."""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

from ..ketoapi import RelationTuple, SubjectSet, Tree, TreeNodeType

# subject sets whose relation is the wildcard are never expanded via
# expand-subject (Keto internal/check/engine.go:40); shared by the host
# oracle and the snapshot compiler
WILDCARD_RELATION = "..."


def subject_visited_key(sub) -> str:
    """Injective visited-set key (a display-string key would let a plain
    subject id that reads like a subject set collide with it)."""
    if isinstance(sub, SubjectSet):
        return f"set:{sub}"
    return f"id:{sub}"


def paginate_names(names: list, page_size: int, page_token: str) -> tuple[list, str]:
    """Offset pagination over a sorted enumeration (ListObjects and
    ListSubjects): the token is the next start offset, "" when exhausted.
    A malformed or negative token is a MalformedInputError."""
    start = 0
    if page_token:
        try:
            start = int(page_token)
        except ValueError:
            start = -1
        if start < 0:
            from ..errors import MalformedInputError

            raise MalformedInputError(f"invalid page token {page_token!r}")
    size = page_size if page_size > 0 else len(names)
    next_token = str(start + size) if start + size < len(names) else ""
    return names[start : start + size], next_token


class Membership(IntEnum):
    UNKNOWN = 0
    IS_MEMBER = 1
    NOT_MEMBER = 2


@dataclass
class CheckResult:
    membership: Membership
    tree: Optional[Tree] = None
    error: Optional[Exception] = None

    @property
    def allowed(self) -> bool:
        """Unknown at the top is reported as not-a-member."""
        return self.membership == Membership.IS_MEMBER


RESULT_IS_MEMBER = CheckResult(Membership.IS_MEMBER)
RESULT_NOT_MEMBER = CheckResult(Membership.NOT_MEMBER)
RESULT_UNKNOWN = CheckResult(Membership.UNKNOWN)


def leaf(t: RelationTuple) -> Tree:
    return Tree(type=TreeNodeType.LEAF, tuple=t)


def with_edge(
    edge_type: TreeNodeType, edge_tuple: RelationTuple, result: CheckResult
) -> CheckResult:
    """Wrap a child result's tree in an edge node (checkgroup.WithEdge)."""
    if result.tree is None:
        tree = leaf(edge_tuple)
    else:
        tree = Tree(type=edge_type, tuple=edge_tuple, children=[result.tree])
    return CheckResult(result.membership, tree, result.error)
