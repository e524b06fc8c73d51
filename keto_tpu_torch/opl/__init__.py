"""The Ory Permission Language: the lexer and the recursive-descent
parser that turn a `.ts` namespace file into the port's Namespace objects
(namespace/definitions.py), with the reference's error texts and source
positions. A copy of the JAX package's keto_tpu/opl, which imports no JAX;
the port keeps its own so that it imports nothing of that package."""

from .errors import ParseError
from .lexer import Token, TokenType, tokenize
from .parser import parse

__all__ = ["parse", "tokenize", "Token", "TokenType", "ParseError"]
