"""Closure maintenance: the background loop that keeps every engine's
Leopard index (engine/closure.py) fresh. See maintainer.ClosureMaintainer."""

from .maintainer import ClosureMaintainer, EngineRegistry

__all__ = ["ClosureMaintainer", "EngineRegistry"]
