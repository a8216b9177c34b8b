"""Serving drivers of the port: the LM ``BatchServer`` and the multi-tenant
``QueryServer``."""
from .serve import (BatchServer, QueryRequest, QueryServer, RelationStats,
                    Request, ServerStopped, ServeStats, plan_family)

__all__ = ["BatchServer", "QueryRequest", "QueryServer", "RelationStats",
           "Request", "ServerStopped", "ServeStats", "plan_family"]
