from .definitions import DEFAULT_NETWORK, DEFAULT_PAGE_SIZE
from .columnar import ColumnarStore
from .dialect import DIALECTS, Dialect, StoreDriverMissing, dialect_for_dsn
from .mapping import Mapper, UUIDMappingManager
from .memory import MemoryManager
from .sqlite import SQLitePersister, SQLPersister, render_migrations

__all__ = [
    "ColumnarStore",
    "MemoryManager",
    "SQLPersister",
    "SQLitePersister",
    "UUIDMappingManager",
    "Mapper",
    "DEFAULT_NETWORK",
    "DEFAULT_PAGE_SIZE",
    "DIALECTS",
    "Dialect",
    "StoreDriverMissing",
    "dialect_for_dsn",
    "render_migrations",
]
