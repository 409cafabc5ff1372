"""Scaling connectors: how the planner actually adds/removes workers.

A copy of the JAX package's ``planner/connector.py`` (which loads no
JAX).  Reference parity: ``dynamo.planner`` connectors -- LocalConnector
drives circus watchers
(components/planner/src/dynamo/planner/local_connector.py),
KubernetesConnector patches deployment replicas
(components/planner/src/dynamo/planner/kubernetes_connector.py:75,
kube.py:164).  Here the local connector drives in-process worker handles
through user-supplied factories (production wires factories that spawn
real engine processes or build ``TorchEngine`` workers; tests wire mocker
engines), and the k8s connector scales the Deployments named
``{graph}-{kind}`` (the JAX package's ``deploy.py`` renders them: "kubectl
apply is the reconciler" -- the planner actuates by patching
``.spec.replicas``).
"""

from __future__ import annotations

import asyncio
import json
import logging
from abc import ABC, abstractmethod
from typing import Any, Awaitable, Callable, Dict, List, Optional

logger = logging.getLogger("dynamo.planner")


class Connector(ABC):
    """The planner's actuation surface."""

    @abstractmethod
    async def add_worker(self, kind: str) -> None: ...

    @abstractmethod
    async def remove_worker(self, kind: str) -> None: ...

    @abstractmethod
    def worker_count(self, kind: str) -> int: ...


class LocalConnector(Connector):
    """Spawn/retire worker handles via per-kind async factories.

    ``factories[kind]()`` returns a live handle; ``stopper(handle)`` (or the
    handle's own ``stop()``) retires it.

    Safe actuation:

    * **Victim selection** -- removal asks ``victim_source(kind, handles)``
      (wire it to the fleet observatory: least-loaded, never quarantined)
      for which handle to retire; without one, removal is LIFO (the
      youngest worker's cache is coldest).
    * **Drain before stop** -- a handle exposing ``drain(timeout_s)`` is
      drained first (the in-process twin of the supervisor's SIGTERM
      grace); on drain timeout the handle is *refunded* to the pool
      instead of force-killed -- a planner scale-down must never drop
      in-flight requests, so the would-be forced kill is logged, counted
      in ``forced_kills``, and retried by a later round.
    * **Standby pool** -- ``prewarm(kind, n)`` keeps warm spares;
      ``add_worker`` promotes a spare (instant capacity, no cold start)
      and replenishes the pool in the background.
    """

    def __init__(
        self,
        factories: Dict[str, Callable[[], Awaitable[Any]]],
        stopper: Optional[Callable[[Any], Awaitable[None]]] = None,
        *,
        drain_timeout_s: float = 5.0,
        victim_source: Optional[Callable[[str, List[Any]], Any]] = None,
        standby_spares: int = 0,
    ) -> None:
        self.factories = factories
        self.stopper = stopper
        self.drain_timeout_s = drain_timeout_s
        self.victim_source = victim_source
        self.standby_spares = standby_spares
        self.workers: Dict[str, List[Any]] = {k: [] for k in factories}
        self.spares: Dict[str, List[Any]] = {k: [] for k in factories}
        # refused forced kills: drains that timed out and refunded the
        # replica (mirrors supervisor.Watcher.forced_kills semantics)
        self.forced_kills = 0

    async def prewarm(self, kind: str, n: Optional[int] = None) -> None:
        """Fill the standby pool for ``kind`` up to ``n`` (default
        ``standby_spares``) warm handles."""
        target = self.standby_spares if n is None else n
        pool = self.spares.setdefault(kind, [])
        while len(pool) < target:
            pool.append(await self.factories[kind]())

    async def add_worker(self, kind: str) -> None:
        spares = self.spares.get(kind) or []
        if spares:
            # promote a pre-warmed spare: capacity lands this round, the
            # cold start already happened off the critical path
            handle = spares.pop(0)
            promoted = True
        else:
            handle = await self.factories[kind]()
            promoted = False
        self.workers.setdefault(kind, []).append(handle)
        logger.info(
            "local connector: added %s worker%s (now %d)",
            kind, " from standby" if promoted else "",
            len(self.workers[kind]),
        )
        if promoted and self.standby_spares > 0:
            await self.prewarm(kind)

    async def remove_worker(self, kind: str) -> None:
        pool = self.workers.get(kind) or []
        if not pool:
            return
        handle = None
        if self.victim_source is not None:
            try:
                handle = self.victim_source(kind, list(pool))
            except Exception:
                logger.exception("victim source failed; falling back to LIFO")
        if handle is None or handle not in pool:
            handle = pool[-1]
        pool.remove(handle)
        drain = getattr(handle, "drain", None)
        if drain is not None:
            try:
                drained = await asyncio.wait_for(
                    drain(self.drain_timeout_s), self.drain_timeout_s + 1.0
                )
            except asyncio.TimeoutError:
                drained = False
            if not drained:
                # refund: never force-kill in-flight work on a planner
                # scale-down; a later round retries once the worker drains
                pool.append(handle)
                self.forced_kills += 1
                logger.warning(
                    "local connector: %s worker refused to drain in %.1fs; "
                    "refunding replica (forced_kills=%d)",
                    kind, self.drain_timeout_s, self.forced_kills,
                )
                return
        if self.stopper is not None:
            await self.stopper(handle)
        elif hasattr(handle, "stop"):
            await handle.stop()
        logger.info("local connector: removed %s worker (now %d)", kind, len(pool))

    def worker_count(self, kind: str) -> int:
        return len(self.workers.get(kind) or [])


class KubernetesConnector(Connector):
    """Scale the Deployments the JAX package's ``deploy.py`` renders by
    patching ``.spec.replicas`` through kubectl.

    Reference kubernetes_connector.py:75 resolves the component's deployment
    and kube.py:164 sends the replicas patch; the equivalent here targets
    ``{graph}-{kind}`` (deploy.py's ``_meta`` naming rule).  Counts are
    cached from the last ``refresh()`` -- the planner refreshes once per
    adjustment round, so decisions and actuation see one consistent
    snapshot.  kubectl is injectable for tests (fake binary) and
    deliberately the only dependency: no python k8s client to vendor, and
    the operator story stays "kubectl apply is the reconciler".
    """

    def __init__(
        self,
        graph_name: str,
        namespace: str = "default",
        kinds: tuple = ("decode", "prefill"),
        kubectl: str = "kubectl",
    ) -> None:
        self.graph_name = graph_name
        self.namespace = namespace
        self.kubectl = kubectl
        self._counts: Dict[str, int] = {k: 0 for k in kinds}

    def deployment(self, kind: str) -> str:
        return f"{self.graph_name}-{kind}"

    async def _run(self, *args: str) -> str:
        proc = await asyncio.create_subprocess_exec(
            self.kubectl, *args,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        out, err = await proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"kubectl {' '.join(args)} failed (rc={proc.returncode}): "
                f"{err.decode().strip()}"
            )
        return out.decode()

    async def refresh(self) -> None:
        """Pull current replica counts (planner calls this once per round)."""
        for kind in list(self._counts):
            out = await self._run(
                "get", "deployment", self.deployment(kind),
                "-n", self.namespace,
                "-o", "jsonpath={.spec.replicas}",
            )
            self._counts[kind] = int(out.strip() or 0)

    async def _scale(self, kind: str, replicas: int) -> None:
        patch = json.dumps({"spec": {"replicas": replicas}})
        await self._run(
            "patch", "deployment", self.deployment(kind),
            "-n", self.namespace, "-p", patch,
        )
        self._counts[kind] = replicas
        logger.info(
            "k8s connector: %s -> %d replicas", self.deployment(kind), replicas
        )

    async def add_worker(self, kind: str) -> None:
        await self._scale(kind, self._counts.get(kind, 0) + 1)

    async def remove_worker(self, kind: str) -> None:
        n = self._counts.get(kind, 0)
        if n > 0:
            await self._scale(kind, n - 1)

    def worker_count(self, kind: str) -> int:
        return self._counts.get(kind, 0)
