"""Transports: control hub (KV/leases/watch/pubsub/queues) + TCP data plane."""

from .client import HubClient, StaticHub, Subscription, WatchHandle
from .hub import HubServer, HubState, WatchEvent
from .request_plane import DataPlaneClient, DataPlaneServer, RemoteError

__all__ = [
    "DataPlaneClient",
    "DataPlaneServer",
    "HubClient",
    "HubServer",
    "HubState",
    "RemoteError",
    "StaticHub",
    "Subscription",
    "WatchEvent",
    "WatchHandle",
]
