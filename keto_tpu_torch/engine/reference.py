"""Host reference engine: exact Keto Check and Expand semantics,
evaluated sequentially. It is the oracle the device path is held
against, and the evaluator for the queries the kernels flag for host
replay.

Semantics (Keto internal/check):
  - checkIsAllowed = OR{checkDirect(d-1), checkExpandSubject(d),
    rewrite(d)}, short-circuiting on IsMember or error; Unknown is
    swallowed to NotMember by the OR
  - every entry point answers Unknown when restDepth < 0; direct gets
    d-1, expand-subject recurses with d-1, a computed subject set keeps
    d, a tuple-to-subject-set recurses with d-1
  - a visited set threaded through the whole check prunes re-visited
    subjects on the expand-subject path
  - wildcard-relation subject sets are never expanded by expand-subject
    but are traversed by tuple-to-subject-set
  - and: first non-IsMember -> NotMember; or: first IsMember wins;
    not: flips IsMember/NotMember and keeps Unknown
  - unknown namespace: no rewrite, no error; a namespace with relations
    but without the queried relation: error

Expand (Keto internal/expand/engine.go:35-104) follows stored tuples
only, no rewrites: a depth-first tree whose visited set cuts cycles
(a revisited subject set is nil, rendered by its parent as a leaf), a
node with no tuples is nil, a node at restDepth <= 1 is a leaf, and a
plain subject id is always a leaf.

ListObjects and ListSubjects are defined by enumeration:
  list_objects(ns, rel, S) = sorted { obj : Check(ns:obj#rel@S) is member }
  list_subjects(ns, obj, rel) = sorted { id : Check(ns:obj#rel@id) is member }
over every object of the namespace, or every plain subject id, in the
store (a member must bottom out in a direct edge, so no other candidate
can be one). A candidate whose check errors is left out. Membership is
evaluated without visited-set pruning, which can miss members first
reached at an exhausted depth: the device walks explore completely, and
the lists are defined by the complete walk on every graph. BatchFilter
is the same admission rule over an explicit candidate column:
filter_objects(ns, rel, S, objects)[i] = Check(ns:objects[i]#rel@S) is
member, by the complete walk, an erroring candidate being False.
"""

from __future__ import annotations

from typing import Optional

from ..config import Config
from ..errors import NamespaceNotFoundError, RelationNotFoundError
from ..ketoapi import RelationQuery, RelationTuple, Subject, SubjectSet, Tree, TreeNodeType
from ..namespace import ast
from ..storage.definitions import DEFAULT_NETWORK
from .definitions import (
    RESULT_NOT_MEMBER,
    RESULT_UNKNOWN,
    WILDCARD_RELATION,
    CheckResult,
    Membership,
    leaf,
    subject_visited_key,
    with_edge,
)


class ReferenceEngine:
    """Check over a tuple store with exact reference semantics."""

    def __init__(self, manager, config: Config, *, visited_pruning: bool = True):
        self.manager = manager
        self.config = config
        # False disables the visited-set pruning, which can miss members
        # first reached at an exhausted depth; the device kernel explores
        # completely, so cyclic-graph differentials compare against this
        self.visited_pruning = visited_pruning

    def check_relation_tuple(
        self, r: RelationTuple, max_depth: int = 0, nid: str = DEFAULT_NETWORK
    ) -> CheckResult:
        rest_depth = self._clamp_depth(max_depth)
        try:
            return self._check_is_allowed(r, rest_depth, set(), nid)
        except Exception as e:  # error as value at the top
            return CheckResult(Membership.UNKNOWN, error=e)

    def check_is_member(
        self, r: RelationTuple, max_depth: int = 0, nid: str = DEFAULT_NETWORK
    ) -> bool:
        res = self.check_relation_tuple(r, max_depth, nid)
        if res.error is not None:
            raise res.error
        return res.membership == Membership.IS_MEMBER

    def expand(
        self, subject: Subject, max_depth: int = 0, nid: str = DEFAULT_NETWORK
    ) -> Optional[Tree]:
        return self._build_tree(subject, self._clamp_depth(max_depth), set(), nid)

    # -- ListObjects / ListSubjects ------------------------------------------------

    def _complete_checker(self) -> "ReferenceEngine":
        if not self.visited_pruning:
            return self
        return ReferenceEngine(self.manager, self.config, visited_pruning=False)

    def _all_tuples(self, nid: str, query: Optional[RelationQuery] = None):
        query = query or RelationQuery()
        page_token = ""
        while True:
            tuples, page_token = self.manager.get_relation_tuples(
                query, page_token=page_token, nid=nid
            )
            yield from tuples
            if not page_token:
                return

    def list_objects(
        self, namespace: str, relation: str, subject: Subject, max_depth: int = 0,
        nid: str = DEFAULT_NETWORK,
    ) -> list[str]:
        """Sorted objects of `namespace` the subject reaches via `relation`."""
        candidates = {t.object for t in self._all_tuples(nid, RelationQuery(namespace=namespace))}
        checker = self._complete_checker()
        out: list[str] = []
        for obj in sorted(candidates):
            r = RelationTuple(namespace=namespace, object=obj, relation=relation)
            if isinstance(subject, SubjectSet):
                r.subject_set = subject
            else:
                r.subject_id = subject
            res = checker.check_relation_tuple(r, max_depth, nid)
            if res.error is None and res.membership == Membership.IS_MEMBER:
                out.append(obj)
        return out

    def filter_objects(
        self, namespace: str, relation: str, subject: Subject, objects: list[str],
        max_depth: int = 0, nid: str = DEFAULT_NETWORK,
    ) -> list[bool]:
        """verdicts[i]: Check(namespace:objects[i]#relation@subject) is a
        member, one complete check per candidate; a candidate whose check
        errors is not visible (False)."""
        checker = self._complete_checker()
        out: list[bool] = []
        for obj in objects:
            r = RelationTuple(namespace=namespace, object=obj, relation=relation)
            if isinstance(subject, SubjectSet):
                r.subject_set = subject
            else:
                r.subject_id = subject
            res = checker.check_relation_tuple(r, max_depth, nid)
            out.append(res.error is None and res.membership == Membership.IS_MEMBER)
        return out

    def list_subjects(
        self, namespace: str, obj: str, relation: str, max_depth: int = 0,
        nid: str = DEFAULT_NETWORK,
    ) -> list[str]:
        """Sorted plain subject ids that reach namespace:obj#relation
        (subject sets are the expand tree's business)."""
        candidates = {t.subject_id for t in self._all_tuples(nid) if t.subject_id is not None}
        checker = self._complete_checker()
        out: list[str] = []
        for sid in sorted(candidates):
            r = RelationTuple(namespace=namespace, object=obj, relation=relation, subject_id=sid)
            res = checker.check_relation_tuple(r, max_depth, nid)
            if res.error is None and res.membership == Membership.IS_MEMBER:
                out.append(sid)
        return out

    def _clamp_depth(self, requested: int) -> int:
        global_max = self.config.max_read_depth()
        if requested <= 0 or global_max < requested:
            return global_max
        return requested

    def _check_is_allowed(
        self, r: RelationTuple, rest_depth: int, visited: set[str], nid: str
    ) -> CheckResult:
        if rest_depth < 0:
            return RESULT_UNKNOWN
        res = self._check_direct(r, rest_depth - 1, nid)
        if res.membership == Membership.IS_MEMBER:
            return res
        res = self._check_expand_subject(r, rest_depth, visited, nid)
        if res.membership == Membership.IS_MEMBER:
            return res
        relation = self._ast_relation_for(r)
        if relation is not None and relation.subject_set_rewrite is not None:
            res = self._check_subject_set_rewrite(
                r, relation.subject_set_rewrite, rest_depth, visited, nid
            )
            if res.error is not None:
                raise res.error
            if res.membership == Membership.IS_MEMBER:
                return res
        return RESULT_NOT_MEMBER

    def _check_direct(self, r: RelationTuple, rest_depth: int, nid: str) -> CheckResult:
        if rest_depth < 0:
            return RESULT_UNKNOWN
        if self.manager.relation_tuple_exists(r, nid=nid):
            return CheckResult(Membership.IS_MEMBER, tree=leaf(r))
        return RESULT_NOT_MEMBER

    def _subject_sets(self, namespace: str, obj: str, relation: str, nid: str):
        """Every tuple of (namespace, object, relation), page by page."""
        query = RelationQuery(namespace=namespace, object=obj, relation=relation)
        page_token = ""
        while True:
            tuples, page_token = self.manager.get_relation_tuples(
                query, page_token=page_token, nid=nid
            )
            yield from tuples
            if not page_token:
                return

    def _check_expand_subject(
        self, r: RelationTuple, rest_depth: int, visited: set[str], nid: str
    ) -> CheckResult:
        if rest_depth < 0:
            return RESULT_UNKNOWN
        for s in self._subject_sets(r.namespace, r.object, r.relation, nid):
            uid = subject_visited_key(s.subject)
            if self.visited_pruning:
                if uid in visited:
                    continue
                visited.add(uid)
            sset = s.subject_set
            if sset is None or sset.relation == WILDCARD_RELATION:
                continue
            res = self._check_is_allowed(
                RelationTuple(
                    namespace=sset.namespace, object=sset.object,
                    relation=sset.relation,
                    subject_id=r.subject_id, subject_set=r.subject_set,
                ),
                rest_depth - 1, visited, nid,
            )
            if res.membership == Membership.IS_MEMBER:
                return res
        return RESULT_NOT_MEMBER

    def _ast_relation_for(self, r: RelationTuple) -> Optional[ast.Relation]:
        try:
            ns = self.config.namespace_manager().get_namespace_by_name(r.namespace)
        except NamespaceNotFoundError:
            return None
        if not ns.relations:
            return None
        rel = ns.relation(r.relation)
        if rel is None:
            raise RelationNotFoundError(r.relation)
        return rel

    def _check_subject_set_rewrite(
        self, r, rewrite: ast.SubjectSetRewrite, rest_depth: int, visited, nid
    ) -> CheckResult:
        if rest_depth < 0:
            return RESULT_UNKNOWN
        checks = [
            lambda c=child: self._check_rewrite_child(r, c, rest_depth, visited, nid)
            for child in rewrite.children
        ]
        if rewrite.operation == ast.Operator.AND:
            return self._and(checks)
        return self._or(checks)

    def _check_rewrite_child(self, r, child, rest_depth: int, visited, nid) -> CheckResult:
        if isinstance(child, ast.TupleToSubjectSet):
            return with_edge(
                TreeNodeType.TUPLE_TO_SUBJECT_SET, r,
                self._check_ttu(r, child, rest_depth, visited, nid),
            )
        if isinstance(child, ast.ComputedSubjectSet):
            return with_edge(
                TreeNodeType.COMPUTED_SUBJECT_SET, r,
                self._check_computed(r, child, rest_depth, visited, nid),
            )
        if isinstance(child, ast.SubjectSetRewrite):
            edge = (
                TreeNodeType.INTERSECTION
                if child.operation == ast.Operator.AND
                else TreeNodeType.UNION
            )
            return with_edge(
                edge, r,
                self._check_subject_set_rewrite(r, child, rest_depth, visited, nid),
            )
        if isinstance(child, ast.InvertResult):
            return with_edge(
                TreeNodeType.NOT, r,
                self._check_inverted(r, child, rest_depth, visited, nid),
            )
        raise NotImplementedError(f"unknown rewrite child {type(child)}")

    def _check_inverted(self, r, inverted: ast.InvertResult, rest_depth, visited, nid):
        if rest_depth < 0:
            return RESULT_UNKNOWN
        res = self._check_rewrite_child(r, inverted.child, rest_depth, visited, nid)
        if res.membership == Membership.IS_MEMBER:
            return CheckResult(Membership.NOT_MEMBER, res.tree, res.error)
        if res.membership == Membership.NOT_MEMBER:
            return CheckResult(Membership.IS_MEMBER, res.tree, res.error)
        return res

    def _check_computed(self, r, computed: ast.ComputedSubjectSet, rest_depth, visited, nid):
        if rest_depth < 0:
            return RESULT_UNKNOWN
        return self._check_is_allowed(
            RelationTuple(
                namespace=r.namespace, object=r.object, relation=computed.relation,
                subject_id=r.subject_id, subject_set=r.subject_set,
            ),
            rest_depth, visited, nid,
        )

    def _check_ttu(self, r, ttu: ast.TupleToSubjectSet, rest_depth, visited, nid):
        # plain subject ids are skipped; wildcard-relation sets ARE
        # traversed here (unlike expand-subject)
        if rest_depth < 0:
            return RESULT_UNKNOWN
        for t in self._subject_sets(r.namespace, r.object, ttu.relation, nid):
            sset = t.subject_set
            if sset is None:
                continue
            res = self._check_is_allowed(
                RelationTuple(
                    namespace=sset.namespace, object=sset.object,
                    relation=ttu.computed_subject_set_relation,
                    subject_id=r.subject_id, subject_set=r.subject_set,
                ),
                rest_depth - 1, visited, nid,
            )
            if res.membership == Membership.IS_MEMBER:
                return res
        return RESULT_NOT_MEMBER

    def _or(self, checks) -> CheckResult:
        for check in checks:
            res = check()
            if res.error is not None or res.membership == Membership.IS_MEMBER:
                return res
        return RESULT_NOT_MEMBER

    def _and(self, checks) -> CheckResult:
        if not checks:
            return RESULT_NOT_MEMBER
        tree = Tree(type=TreeNodeType.INTERSECTION, children=[])
        for check in checks:
            res = check()
            if res.error is not None or res.membership != Membership.IS_MEMBER:
                return CheckResult(Membership.NOT_MEMBER, error=res.error)
            tree.children.append(res.tree)
        return CheckResult(Membership.IS_MEMBER, tree=tree)

    # -- expand ------------------------------------------------------------------

    def _build_tree(
        self, subject: Subject, rest_depth: int, visited: set[str], nid: str
    ) -> Optional[Tree]:
        if not isinstance(subject, SubjectSet):
            return Tree(
                type=TreeNodeType.LEAF,
                tuple=RelationTuple(namespace="", object="", relation="", subject_id=subject),
            )
        uid = subject_visited_key(subject)
        if uid in visited:
            return None
        visited.add(uid)
        sub_tree = Tree(
            type=TreeNodeType.UNION,
            tuple=RelationTuple(namespace="", object="", relation="", subject_set=subject),
        )
        query = RelationQuery(
            namespace=subject.namespace, object=subject.object, relation=subject.relation
        )
        page_token = ""
        first_page = True
        while True:
            rels, page_token = self.manager.get_relation_tuples(
                query, page_token=page_token, nid=nid
            )
            if first_page and not rels:
                return None  # no matching tuples: nil
            first_page = False
            if rest_depth <= 1:
                sub_tree.type = TreeNodeType.LEAF
                return sub_tree
            for rel in rels:
                child = self._build_tree(rel.subject, rest_depth - 1, visited, nid)
                if child is None:
                    child = Tree(
                        type=TreeNodeType.LEAF,
                        tuple=RelationTuple(
                            namespace="", object="", relation="",
                            subject_id=rel.subject_id, subject_set=rel.subject_set,
                        ),
                    )
                sub_tree.children.append(child)
            if not page_token:
                return sub_tree
