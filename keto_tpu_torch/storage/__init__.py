from .definitions import DEFAULT_NETWORK, DEFAULT_PAGE_SIZE
from .columnar import ColumnarStore
from .memory import MemoryManager

__all__ = ["ColumnarStore", "MemoryManager", "DEFAULT_NETWORK", "DEFAULT_PAGE_SIZE"]
