"""OPL parse errors with source-position rendering.

Mirrors internal/schema/parse_errors.go: "error from L:C to L:C: msg",
two lines of leading context, caret/tilde underline, one trailing line.
"""

from __future__ import annotations

from dataclasses import dataclass

from .lexer import Token


@dataclass
class SourcePosition:
    line: int
    col: int


class ParseError(Exception):
    def __init__(self, msg: str, token: Token, input: str):
        self.msg = msg
        self.token = token
        self.input = input
        super().__init__(self.render())

    def _to_src_pos(self, pos: int) -> SourcePosition:
        # ref: parse_errors.go:71-85 (1-based line, col counts runes)
        line, col = 1, 0
        for c in self.input:
            col += 1
            pos -= 1
            if pos == 0:
                return SourcePosition(line, col)
            if c == "\n":
                line += 1
                col = 0
        return SourcePosition(0, 0)

    def render(self) -> str:
        start = self._to_src_pos(self.token.start)
        end = self._to_src_pos(self.token.end)
        rows = self.input.split("\n")
        start_line_idx = max(start.line - 2, 0)
        error_line_idx = max(start.line - 1, 0)

        out = [
            f"error from {start.line}:{start.col} to {end.line}:{end.col}: {self.msg}",
            "",
        ]
        if len(rows) < start.line:
            out.append("meta error: could not find source position in input")
            return "\n".join(out) + "\n"

        for line in range(start_line_idx, error_line_idx + 1):
            out.append(f"{line:4d} | {rows[line]}")
        underline = "       "
        for i, r in enumerate(rows[error_line_idx]):
            if start.col == i:
                underline += "^"
            elif start.col <= i <= end.col - 1:
                underline += "~"
            elif r.isspace():
                underline += r
            else:
                underline += " "
        out.append(underline)
        if error_line_idx + 1 < len(rows):
            out.append(f"{error_line_idx:4d} | {rows[error_line_idx + 1]}")
            out.append("")
        return "\n".join(out) + "\n"

    def __str__(self):
        return self.render()
