"""The planner: SLO-driven autoscaling of the decode and prefill pools
(``planner.py``), the connectors it actuates through (``connector.py``)
and the pre-deployment SLA profiler (``profile_sla.py``)."""

from .connector import Connector, KubernetesConnector, LocalConnector
from .planner import DECODE, PREFILL, Adjustment, Planner, PlannerConfig

__all__ = [
    "Adjustment",
    "Connector",
    "DECODE",
    "KubernetesConnector",
    "LocalConnector",
    "PREFILL",
    "Planner",
    "PlannerConfig",
]
