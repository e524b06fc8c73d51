"""Lexer for the Ory Permission Language (a TypeScript subset).

Token classes follow the reference's internal/schema/lexer.go (keywords
class/implements/this/ctx, operators && || ! = => . : , | < >, brackets,
string literals as quoted identifiers, line and block comments). The
implementation is a table-driven scanner rather than the reference's
Rob-Pike channel/state-function lexer — same token stream, idiomatic
Python.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum, auto


class TokenType(Enum):
    ERROR = auto()
    EOF = auto()
    COMMENT = auto()
    IDENT = auto()
    STRING = auto()  # quoted identifier; value excludes the quotes
    # operators / punctuation (each its own type so the parser can switch)
    AND = auto()  # &&
    OR = auto()  # ||
    NOT = auto()  # !
    ARROW = auto()  # =>
    ASSIGN = auto()  # =
    DOT = auto()  # .
    COLON = auto()  # :
    COMMA = auto()  # ,
    SEMICOLON = auto()  # ;
    PAREN_L = auto()  # (
    PAREN_R = auto()  # )
    BRACE_L = auto()  # {
    BRACE_R = auto()  # }
    BRACKET_L = auto()  # [
    BRACKET_R = auto()  # ]
    ANGLE_L = auto()  # <
    ANGLE_R = auto()  # >
    TYPE_UNION = auto()  # |
    STAR = auto()  # *


@dataclass(frozen=True)
class Token:
    typ: TokenType
    val: str
    start: int  # byte offset in input
    end: int

    def __str__(self):
        return self.val if self.typ != TokenType.EOF else "<eof>"


_PUNCT = [
    ("&&", TokenType.AND),
    ("||", TokenType.OR),
    ("=>", TokenType.ARROW),
    ("!", TokenType.NOT),
    ("=", TokenType.ASSIGN),
    (".", TokenType.DOT),
    (":", TokenType.COLON),
    (",", TokenType.COMMA),
    (";", TokenType.SEMICOLON),
    ("(", TokenType.PAREN_L),
    (")", TokenType.PAREN_R),
    ("{", TokenType.BRACE_L),
    ("}", TokenType.BRACE_R),
    ("[", TokenType.BRACKET_L),
    ("]", TokenType.BRACKET_R),
    ("<", TokenType.ANGLE_L),
    (">", TokenType.ANGLE_R),
    ("|", TokenType.TYPE_UNION),
    ("*", TokenType.STAR),
]

_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_WS_RE = re.compile(r"\s+")


def tokenize(input: str) -> list[Token]:
    """Produce the full token list (comments included, like the reference's
    lexer; the parser skips COMMENT tokens). Always ends with EOF or ERROR."""
    tokens: list[Token] = []
    pos = 0
    n = len(input)
    while pos < n:
        m = _WS_RE.match(input, pos)
        if m:
            pos = m.end()
            continue
        c = input[pos]
        # comments
        if input.startswith("//", pos):
            end = input.find("\n", pos)
            end = n if end == -1 else end
            tokens.append(Token(TokenType.COMMENT, input[pos:end], pos, end))
            pos = end
            continue
        if input.startswith("/*", pos):
            end = input.find("*/", pos + 2)
            if end == -1:
                tokens.append(
                    Token(TokenType.ERROR, "unclosed comment", pos, n)
                )
                return tokens
            tokens.append(Token(TokenType.COMMENT, input[pos : end + 2], pos, end + 2))
            pos = end + 2
            continue
        # string literals: quoted identifiers
        if c in "'\"":
            end = input.find(c, pos + 1)
            if end == -1:
                tokens.append(
                    Token(TokenType.ERROR, "unclosed string literal", pos, n)
                )
                return tokens
            tokens.append(Token(TokenType.STRING, input[pos + 1 : end], pos, end + 1))
            pos = end + 1
            continue
        # identifiers
        m = _IDENT_RE.match(input, pos)
        if m:
            tokens.append(Token(TokenType.IDENT, m.group(), pos, m.end()))
            pos = m.end()
            continue
        # punctuation (longest match first)
        for lit, typ in _PUNCT:
            if input.startswith(lit, pos):
                tokens.append(Token(typ, lit, pos, pos + len(lit)))
                pos += len(lit)
                break
        else:
            tokens.append(
                Token(TokenType.ERROR, f"unexpected character {c!r}", pos, pos + 1)
            )
            return tokens
    tokens.append(Token(TokenType.EOF, "", n, n))
    return tokens
