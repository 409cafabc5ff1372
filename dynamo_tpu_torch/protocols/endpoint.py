"""``dyn://`` endpoint identifiers (reference lib/runtime protocols.rs:35).

An endpoint id names one served endpoint in the cluster:
``dyn://{namespace}.{component}.{endpoint}``, optionally suffixed with a
lease-scoped instance (``:{lease_hex}``) to address one worker directly --
the string form of the hub keyspace ``instances/{ns}/{comp}/{ep}:{hex}``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

SCHEME = "dyn://"
_RE = re.compile(
    r"^dyn://([A-Za-z0-9_-]+)\.([A-Za-z0-9_-]+)\.([A-Za-z0-9_-]+)"
    r"(?::([0-9a-fA-F]+))?$"
)


@dataclass(frozen=True)
class EndpointId:
    namespace: str
    component: str
    endpoint: str
    instance: Optional[int] = None  # lease id when addressing one worker

    @classmethod
    def parse(cls, s: str) -> "EndpointId":
        m = _RE.match(s)
        if not m:
            raise ValueError(
                f"invalid endpoint id {s!r}: expected "
                f"dyn://namespace.component.endpoint[:instance_hex]"
            )
        ns, comp, ep, inst = m.groups()
        return cls(ns, comp, ep, int(inst, 16) if inst else None)

    def __str__(self) -> str:
        base = f"{SCHEME}{self.namespace}.{self.component}.{self.endpoint}"
        if self.instance is not None:
            return f"{base}:{self.instance:x}"
        return base

    @property
    def subject(self) -> str:
        """The request-plane subject this id serves on."""
        return f"{self.namespace}.{self.component}.{self.endpoint}"

    def instance_key(self) -> str:
        """Hub keyspace entry for a concrete instance (requires one)."""
        if self.instance is None:
            raise ValueError(f"{self} has no instance id")
        return (
            f"instances/{self.namespace}/{self.component}/"
            f"{self.endpoint}:{self.instance:x}"
        )


def parse_endpoint_id(s: str) -> Tuple[str, str, str]:
    """Back-compat tuple form of :meth:`EndpointId.parse` (no instance)."""
    e = EndpointId.parse(s)
    return e.namespace, e.component, e.endpoint
