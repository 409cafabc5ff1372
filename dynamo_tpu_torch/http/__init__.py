"""The OpenAI HTTP front end: an asyncio HTTP/1.1 server and the service
routing chat and completions to a pipeline over the PyTorch engine."""

from .server import HttpServer, Request, Response
from .service import HttpService, ModelManager

__all__ = ["HttpServer", "HttpService", "ModelManager", "Request", "Response"]
