"""The engine interface types: request context, annotated responses and
response streams."""

from .engine import Annotated, AsyncEngine, Context, ResponseStream

__all__ = ["Annotated", "AsyncEngine", "Context", "ResponseStream"]
