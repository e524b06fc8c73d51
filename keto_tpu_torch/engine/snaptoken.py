"""Snapshot tokens: read-your-writes handles on the store version.

A token encodes (network id, store version) as
"ktv1_<fnv1a-32 of the nid, 8 hex>_<version>", the JAX package's form, so
a token one package mints the other accepts. A read route enforces a
request's token before it answers: an empty token or the reference's
stub literal "not yet implemented" asks for nothing; garbage, or a token
of another network, is a 400; a token ahead of the store is a 409. The
response token is the store version read at enforcement: the engine
evaluates at that version or later, since it syncs to the store's
monotone counter on every call.

Not ported: the store-outage half of enforcement (serving at the
mirror's covered version while the store is down), which needs a store
health breaker the port does not have yet.
"""

from __future__ import annotations

from ..errors import SnaptokenMalformedError, SnaptokenUnsatisfiableError

_PREFIX = "ktv1"
# the reference's stub literal: accepted, and asks for nothing
_LEGACY_STUB = "not yet implemented"


def _nid_digest(nid: str) -> str:
    h = 0x811C9DC5
    for b in nid.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return f"{h:08x}"


def encode_snaptoken(version: int, nid: str) -> str:
    return f"{_PREFIX}_{_nid_digest(nid)}_{int(version)}"


def parse_snaptoken(token: str, nid: str) -> int | None:
    """The least store version the token demands; None for the empty
    token and the legacy stub. Raises SnaptokenMalformedError on garbage
    or on a token minted for another network."""
    if not token or token == _LEGACY_STUB:
        return None
    parts = token.split("_")
    if len(parts) != 3 or parts[0] != _PREFIX:
        raise SnaptokenMalformedError(debug=f"bad format: {token!r}")
    if parts[1] != _nid_digest(nid):
        raise SnaptokenMalformedError(debug="snaptoken was issued for a different network")
    try:
        v = int(parts[2])
    except ValueError:
        raise SnaptokenMalformedError(debug=f"bad version: {parts[2]!r}")
    if v < 0:
        raise SnaptokenMalformedError(debug="negative version")
    return v


def require_version(covered: int, min_version: int | None) -> None:
    """Raise unless a state at `covered` satisfies the token."""
    if min_version is not None and covered < min_version:
        raise SnaptokenUnsatisfiableError(
            debug=f"snapshot covers v{covered}, token demands v{min_version}"
        )


def enforce_snaptoken(manager, token: str, nid: str) -> int:
    """Parse `token` and hold it against the store's current version;
    returns that version, which the response token carries."""
    min_v = parse_snaptoken(token, nid)
    current = manager.version(nid=nid)
    require_version(current, min_v)
    return current
