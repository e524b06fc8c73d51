from .definitions import DEFAULT_NETWORK, DEFAULT_PAGE_SIZE
from .memory import MemoryManager

__all__ = ["MemoryManager", "DEFAULT_NETWORK", "DEFAULT_PAGE_SIZE"]
