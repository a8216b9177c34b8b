"""Serving drivers of the port: the multi-tenant ``QueryServer``."""
from .serve import (QueryRequest, QueryServer, RelationStats, ServerStopped,
                    ServeStats, plan_family)

__all__ = ["QueryRequest", "QueryServer", "RelationStats", "ServerStopped",
           "ServeStats", "plan_family"]
