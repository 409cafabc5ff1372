"""The engine interface types (request context, annotated responses and
response streams) exported here; the distributed runtime lives in the
package's modules: ``component`` (runtime, namespaces, endpoints,
routers), ``transports/`` (hub, request plane, codec), ``config``,
``faults``, ``tracing``, ``utils`` and ``metrics``."""

from .engine import Annotated, AsyncEngine, Context, ResponseStream

__all__ = ["Annotated", "AsyncEngine", "Context", "ResponseStream"]
