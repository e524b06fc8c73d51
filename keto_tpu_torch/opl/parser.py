"""Recursive-descent parser for the Ory Permission Language.

Grammar and semantics per this repo's normative docs/opl_spec.md
(source-compatible with the reference's
docs/ory_permission_language_spec.md; behavior matches
internal/schema/parser.go):
  - class X implements Namespace { related: {...} permits = {...} }
  - relation types: T[], (A | B)[], SubjectSet<NS, "rel">[]
  - permissions: name: (ctx [: Context]) [: boolean] => expr
  - expressions: this.related.R.includes(ctx.subject)  -> ComputedSubjectSet
                 this.related.R.traverse(p => p.related.S.includes(ctx.subject))
                 this.related.R.traverse(p => p.permits.S(ctx)) -> TupleToSubjectSet
                 !expr / !(expr...), && / || with precedence-free left fold,
                 parenthesized groups, nesting capped at 10 (parser.go limits.go)
  - n-ary simplification of same-operator nests (parser.go:463-483)
  - deferred type checks (typechecks.go:52-127) with source positions

Error message texts match the reference so snapshot-style tests carry over.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..namespace.ast import (
    Child,
    ComputedSubjectSet,
    InvertResult,
    Operator,
    Relation,
    RelationType,
    SubjectSetRewrite,
    TupleToSubjectSet,
)
from ..namespace.definitions import Namespace
from .errors import ParseError
from .lexer import Token, TokenType, tokenize

# ref: internal/schema/limits.go
TUPLE_TO_SUBJECT_SET_TYPECHECK_MAX_DEPTH = 10
EXPRESSION_NESTING_MAX_DEPTH = 10


def parse(input: str) -> tuple[list[Namespace], list[ParseError]]:
    """Parse an OPL document into namespaces. Returns (namespaces, errors);
    errors is empty on success. ref: internal/schema/parser.go:24-29."""
    p = _Parser(input)
    return p.parse()


class _Parser:
    def __init__(self, input: str):
        self.input = input
        self._tokens = [t for t in tokenize(input) if t.typ != TokenType.COMMENT]
        self._pos = 0
        self.namespaces: list[Namespace] = []
        self.namespace: Optional[Namespace] = None
        self.errors: list[ParseError] = []
        self.fatal = False
        self.checks: list[Callable[[], None]] = []

    # -- token plumbing -------------------------------------------------------

    def next(self) -> Token:
        t = self._tokens[self._pos]
        if self._pos < len(self._tokens) - 1:
            self._pos += 1
        return t

    def peek(self) -> Token:
        return self._tokens[self._pos]

    def add_fatal(self, token: Token, msg: str) -> None:
        self.add_err(token, msg)
        self.fatal = True

    def add_err(self, token: Token, msg: str) -> None:
        self.errors.append(ParseError(msg, token, self.input))

    # match() accepts: str (exact token text), TokenType (exact type),
    # "IDENT_OUT" capture via list, or a callable matcher. Returns False and
    # sets fatal on mismatch. ref: parser.go:115-144
    def match(self, *tokens) -> bool:
        if self.fatal:
            return False
        for want in tokens:
            if callable(want):
                if not want(self):
                    return False
                continue
            if isinstance(want, list):
                # capture an identifier or string literal into want[0]
                t = self.next()
                if t.typ not in (TokenType.IDENT, TokenType.STRING):
                    self.add_fatal(t, f"expected identifier, got {t.val!r}")
                    return False
                want.append(t)
                continue
            t = self.next()
            if t.val != want:
                self.add_fatal(t, f"expected {want!r}, got {t.val!r}")
                return False
        return True

    def optional(self, *tokens: str):
        """If the first token matches, consume it and require the rest.
        ref: parser.go:88-106"""

        def matcher(p: "_Parser") -> bool:
            if not tokens:
                return True
            if p.peek().val == tokens[0]:
                p.next()
                for tok in tokens[1:]:
                    t = p.next()
                    if t.val != tok:
                        p.add_fatal(t, f"expected {tok!r}, got {t.val!r}")
                        return False
            return True

        return matcher

    # -- grammar --------------------------------------------------------------

    def parse(self) -> tuple[list[Namespace], list[ParseError]]:
        while not self.fatal:
            t = self.next()
            if t.typ == TokenType.EOF:
                break
            elif t.typ == TokenType.ERROR:
                self.add_fatal(t, f"fatal: {t.val}")
            elif t.val == "class":
                self.parse_class()
            # other top-level tokens (e.g. import statements) are skipped
        self.run_type_checks()
        return self.namespaces, self.errors

    def parse_class(self) -> None:
        name: list[Token] = []
        self.match(name, "implements", "Namespace", "{")
        if self.fatal:
            return
        self.namespace = Namespace(name=name[0].val)
        while not self.fatal:
            t = self.next()
            if t.typ == TokenType.BRACE_R:
                self.namespaces.append(self.namespace)
                return
            elif t.val == "related":
                self.parse_related()
            elif t.val == "permits":
                self.parse_permits()
            else:
                self.add_fatal(t, f"expected 'permits' or 'related', got {t.val!r}")
                return

    def parse_related(self) -> None:
        self.match(":", "{")
        while not self.fatal:
            t = self.next()
            if t.typ == TokenType.BRACE_R:
                return
            elif t.typ == TokenType.IDENT:
                relation = t.val
                types: list[RelationType] = []
                self.match(":")
                t2 = self.next()
                if t2.typ == TokenType.IDENT:
                    if t2.val == "SubjectSet":
                        types.append(self.match_subject_set())
                    else:
                        types.append(RelationType(namespace=t2.val))
                        self.add_check_namespace_exists(t2)
                elif t2.typ == TokenType.PAREN_L:
                    types.extend(self.parse_type_union())
                self.match("[", "]")
                self.optional(",")(self)
                if self.namespace is not None:
                    self.namespace.relations.append(
                        Relation(name=relation, types=types)
                    )
            else:
                self.add_fatal(t, f"expected identifier or '}}', got {t.val!r}")
                return

    def match_subject_set(self) -> RelationType:
        ns: list[Token] = []
        rel: list[Token] = []
        self.match("<", ns, ",", rel, ">")
        if self.fatal:
            return RelationType(namespace="")
        self.add_check_namespace_has_relation(ns[0], rel[0])
        return RelationType(namespace=ns[0].val, relation=rel[0].val)

    def parse_type_union(self) -> list[RelationType]:
        types: list[RelationType] = []
        while not self.fatal:
            ident: list[Token] = []
            if not self.match(ident):
                return types
            if ident[0].val == "SubjectSet":
                types.append(self.match_subject_set())
            else:
                types.append(RelationType(namespace=ident[0].val))
                self.add_check_namespace_exists(ident[0])
            t = self.next()
            if t.typ == TokenType.PAREN_R:
                return types
            elif t.typ == TokenType.TYPE_UNION:
                continue
            else:
                self.add_fatal(t, f"expected '|', got {t.val!r}")
        return types

    def parse_permits(self) -> None:
        self.match("=", "{")
        while not self.fatal:
            t = self.next()
            if t.typ == TokenType.BRACE_R:
                return
            elif t.typ == TokenType.IDENT:
                permission = t.val
                self.match(
                    ":", "(", "ctx", self.optional(":", "Context"), ")",
                    self.optional(":", "boolean"), "=>",
                )
                rewrite = simplify_expression(
                    self.parse_permission_expressions(
                        TokenType.COMMA, EXPRESSION_NESTING_MAX_DEPTH
                    )
                )
                if rewrite is None:
                    return
                if self.namespace is not None:
                    self.namespace.relations.append(
                        Relation(name=permission, subject_set_rewrite=rewrite)
                    )
            else:
                self.add_fatal(t, f"expected identifier or '}}', got {t.val!r}")
                return

    def parse_permission_expressions(
        self, final_token: TokenType, depth: int
    ) -> Optional[SubjectSetRewrite]:
        # ref: parser.go:280-353
        if depth <= 0:
            self.add_fatal(
                self.peek(),
                "expression nested too deeply; maximal nesting depth is "
                f"{EXPRESSION_NESTING_MAX_DEPTH}",
            )
            return None
        root: Optional[SubjectSetRewrite] = None
        expect_expression = True

        while not self.fatal:
            t = self.peek()
            if t.typ == TokenType.PAREN_L:
                self.next()
                child = self.parse_permission_expressions(TokenType.PAREN_R, depth - 1)
                if child is None:
                    return None
                root = add_child(root, child)
                expect_expression = False
            elif t.typ == final_token:
                self.next()
                return root
            elif t.typ == TokenType.BRACE_R:
                # leave '}' for parse_permits to consume
                return root
            elif t.typ in (TokenType.AND, TokenType.OR):
                self.next()
                op = Operator.AND if t.typ == TokenType.AND else Operator.OR
                root = SubjectSetRewrite(operation=op, children=[root])
                expect_expression = True
            elif t.typ == TokenType.NOT:
                self.next()
                child = self.parse_not_expression(depth - 1)
                if child is None:
                    return None
                root = add_child(root, child)
                expect_expression = False
            else:
                if not expect_expression:
                    self.add_fatal(t, "did not expect another expression")
                    return None
                child = self.parse_permission_expression()
                if child is None:
                    return None
                root = add_child(root, child)
                expect_expression = True
        return None

    def parse_not_expression(self, depth: int) -> Optional[Child]:
        if depth <= 0:
            self.add_fatal(
                self.peek(),
                "expression nested too deeply; maximal nesting depth is "
                f"{EXPRESSION_NESTING_MAX_DEPTH}",
            )
            return None
        if self.peek().typ == TokenType.PAREN_L:
            self.next()
            child: Optional[Child] = self.parse_permission_expressions(
                TokenType.PAREN_R, depth - 1
            )
        else:
            child = self.parse_permission_expression()
        if child is None:
            return None
        return InvertResult(child=child)

    def parse_permission_expression(self) -> Optional[Child]:
        name: list[Token] = []
        if not self.match("this", ".", "related", ".", name, "."):
            return None
        t = self.next()
        if t.val == "traverse":
            return self.parse_tuple_to_subject_set(name[0])
        elif t.val == "includes":
            return self.parse_computed_subject_set(name[0])
        else:
            self.add_fatal(t, f"expected 'traverse' or 'includes', got {t.val!r}")
            return None

    def parse_tuple_to_subject_set(self, relation: Token) -> Optional[Child]:
        # ref: parser.go:413-453
        if not self.match("("):
            return None
        arg: list[Token] = []
        if self.peek().typ == TokenType.PAREN_L:
            if not self.match("(", arg, ")"):
                return None
        elif not self.match(arg):
            return None
        verb: list[Token] = []
        self.match("=>", arg[0].val, ".", verb)
        if self.fatal:
            return None
        subject_set_rel: list[Token] = []
        if verb[0].val == "related":
            self.match(
                ".", subject_set_rel, ".", "includes", "(", "ctx", ".", "subject",
                self.optional(","), ")", self.optional(","), ")",
            )
        elif verb[0].val == "permits":
            self.match(".", subject_set_rel, "(", "ctx", ")", ")")
        else:
            self.add_fatal(
                verb[0], f"expected 'related' or 'permits', got {verb[0].val!r}"
            )
            return None
        if self.fatal:
            return None
        self.add_check_all_relation_types_have_relation(
            relation, subject_set_rel[0].val
        )
        self.add_check_current_namespace_has_relation(relation)
        return TupleToSubjectSet(
            relation=relation.val,
            computed_subject_set_relation=subject_set_rel[0].val,
        )

    def parse_computed_subject_set(self, relation: Token) -> Optional[Child]:
        if not self.match("(", "ctx", ".", "subject", ")"):
            return None
        self.add_check_current_namespace_has_relation(relation)
        return ComputedSubjectSet(relation=relation.val)

    # -- deferred type checks (ref: internal/schema/typechecks.go) ------------

    def _find_namespace(self, name: str) -> Optional[Namespace]:
        for n in self.namespaces:
            if n.name == name:
                return n
        return None

    def _find_relation(self, ns_name: str, rel_name: str) -> Optional[Relation]:
        n = self._find_namespace(ns_name)
        return n.relation(rel_name) if n else None

    def add_check_namespace_exists(self, ns_token: Token) -> None:
        def check():
            if self._find_namespace(ns_token.val) is None:
                self.add_err(
                    ns_token, f"namespace {ns_token.val!r} was not declared"
                )

        self.checks.append(check)

    def add_check_namespace_has_relation(self, ns_token: Token, rel_token: Token):
        def check():
            n = self._find_namespace(ns_token.val)
            if n is None:
                self.add_err(
                    ns_token, f"namespace {ns_token.val!r} was not declared"
                )
            elif n.relation(rel_token.val) is None:
                self.add_err(
                    rel_token,
                    f"namespace {ns_token.val!r} did not declare relation "
                    f"{rel_token.val!r}",
                )

        self.checks.append(check)

    def add_check_current_namespace_has_relation(self, rel_token: Token) -> None:
        assert self.namespace is not None
        ns_name = self.namespace.name

        def check():
            n = self._find_namespace(ns_name)
            if n is None:
                self.add_err(rel_token, f"namespace {ns_name!r} was not declared")
            elif n.relation(rel_token.val) is None:
                self.add_err(
                    rel_token,
                    f"namespace {ns_name!r} did not declare relation "
                    f"{rel_token.val!r}",
                )

        self.checks.append(check)

    def add_check_all_relation_types_have_relation(
        self, relation_type_token: Token, relation: str
    ) -> None:
        assert self.namespace is not None
        ns_name = self.namespace.name

        def check():
            self._recursive_check_types_have_relation(
                relation_type_token,
                ns_name,
                relation_type_token.val,
                relation,
                TUPLE_TO_SUBJECT_SET_TYPECHECK_MAX_DEPTH,
            )

        self.checks.append(check)

    def _recursive_check_types_have_relation(
        self, token: Token, ns: str, relation_type: str, relation: str, depth: int
    ) -> None:
        if depth < 0:
            self.add_err(token, "could not typecheck deeply nested SubjectSet further")
            return
        r = self._find_relation(ns, relation_type)
        if r is None:
            self.add_err(
                token,
                f"relation {relation_type!r} was not declared in namespace {ns!r}",
            )
            return
        for t in r.types:
            if t.relation == "":
                if self._find_relation(t.namespace, relation) is None:
                    self.add_err(
                        token,
                        f"relation {relation!r} was not declared in namespace "
                        f"{t.namespace!r}",
                    )
            else:
                self._recursive_check_types_have_relation(
                    token, t.namespace, t.relation, relation, depth - 1
                )

    def run_type_checks(self) -> None:
        for check in self.checks:
            check()


def add_child(root: Optional[SubjectSetRewrite], child) -> SubjectSetRewrite:
    # ref: parser.go:376-383
    if root is None:
        return child.as_rewrite()
    root.children.append(child)
    return root


def simplify_expression(
    root: Optional[SubjectSetRewrite],
) -> Optional[SubjectSetRewrite]:
    """Flatten same-operator nests into n-ary children. ref: parser.go:463-483"""
    if root is None:
        return None
    new_children = []
    for child in root.children:
        if isinstance(child, SubjectSetRewrite) and child.operation == root.operation:
            simplify_expression(child)
            new_children.extend(child.children)
        elif child is not None:
            new_children.append(child)
    root.children = new_children
    return root
