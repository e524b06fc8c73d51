"""Closure maintenance: the background loop that keeps every engine's
Leopard index (engine/closure.py) fresh. See maintainer.ClosureMaintainer."""

from .maintainer import ClosureMaintainer

__all__ = ["ClosureMaintainer"]
