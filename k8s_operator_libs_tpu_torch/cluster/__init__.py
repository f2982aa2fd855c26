"""A minimal node store for the workload side of the drain handshake."""

from .inmem import InMemoryNodeStore, NotFoundError, merge_patch

__all__ = ["InMemoryNodeStore", "NotFoundError", "merge_patch"]
