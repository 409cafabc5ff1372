"""Fleet-wide observability: cluster-global telemetry ingest and models.

Workers publish :class:`~dynamo_tpu_torch.runtime.telemetry.TelemetrySnapshot`
payloads over the hub; the :class:`~.observatory.FleetObservatory` here
ingests them into per-worker time-series rings, derives the
``dynamo_fleet_*`` cluster gauges, fits the per-(src, dst) KV-transfer
link model, and flags and quarantines stragglers.
"""

from .observatory import FleetObservatory, LinkModel, SeriesRing

__all__ = ["FleetObservatory", "LinkModel", "SeriesRing"]
