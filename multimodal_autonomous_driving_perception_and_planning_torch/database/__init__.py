"""The tag database (sqlite3), a copy of the JAX package's."""

from .tag_db import QueryResult, TagDatabase

__all__ = ["TagDatabase", "QueryResult"]
