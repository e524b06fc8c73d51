"""Namespace model and the in-memory namespace manager.

Parity with Keto's internal/namespace/definitions.go: Namespace{id
(deprecated), name, relations} and GetNamespaceByName / Namespaces.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional

from ..errors import NamespaceNotFoundError
from .ast import Relation, relation_from_dict

# every distinct namespace set a manager serves draws a new generation: a
# namespace change alters check answers without a store version bump, so
# a cache of verdicts (api/check_cache.py) flushes when it moves
_config_generation = itertools.count(1)


def next_config_generation() -> int:
    return next(_config_generation)


@dataclass
class Namespace:
    name: str
    id: Optional[int] = None  # deprecated numeric id, kept for config parity
    relations: list[Relation] = field(default_factory=list)

    def relation(self, name: str) -> Optional[Relation]:
        for r in self.relations:
            if r.name == name:
                return r
        return None

    def to_dict(self) -> dict:
        d: dict = {"name": self.name}
        if self.id is not None:
            d["id"] = self.id
        if self.relations:
            d["relations"] = [r.to_dict() for r in self.relations]
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "Namespace":
        return cls(
            name=d["name"],
            id=d.get("id"),
            relations=[relation_from_dict(r) for r in d.get("relations", [])],
        )


class MemoryNamespaceManager:
    """In-memory namespace set built from inline config."""

    def __init__(self, namespaces: Iterable[Namespace] = ()):
        self._by_name: dict[str, Namespace] = {ns.name: ns for ns in namespaces}
        self.config_generation = next_config_generation()

    def get_namespace_by_name(self, name: str) -> Namespace:
        try:
            return self._by_name[name]
        except KeyError:
            raise NamespaceNotFoundError(name)

    def namespaces(self) -> list[Namespace]:
        return list(self._by_name.values())
