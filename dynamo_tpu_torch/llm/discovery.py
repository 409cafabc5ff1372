"""ModelWatcher: discovery-driven model registration for the HTTP frontend.

Reference parity: lib/llm/src/discovery/watcher.rs:34-130 (watch the etcd
``models/`` prefix), handle_put :162-250 (download the MDC, build the
per-model pipeline -- Backend type means preprocessor + detokenizer +
PushRouter to the worker endpoint), handle_delete (remove the model when its
last instance is gone).

The watcher owns nothing about HTTP: it mutates a
:class:`~..http.service.ModelManager`, which the HttpService reads
per request -- models appear and disappear without frontend restarts.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Callable, Dict, Optional, Set

from ..http.service import ModelManager
from ..runtime.component import FailoverPolicy, PushRouter, RouterMode
from ..runtime.pipeline import link
from .backend import Backend
from .model_card import MODEL_ROOT, ModelDeploymentCard, ModelEntry
from .preprocessor import OpenAIPreprocessor

logger = logging.getLogger("dynamo.discovery")


class ModelWatcher:
    """Watch ``models/`` and keep a ModelManager in sync with the cluster."""

    def __init__(
        self,
        runtime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        engine_factory: Optional[Callable] = None,
    ) -> None:
        """``engine_factory(entry, card, client, router)`` (sync or async)
        may override pipeline construction (e.g. to insert a KvPushRouter);
        default is preprocessor -> backend -> PushRouter(client)."""
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self.engine_factory = engine_factory
        # model slug -> live registration keys (instances of that model)
        self._instances: Dict[str, Set[str]] = {}
        # slug -> clients owned by that model's pipelines (generate endpoint
        # plus, when the worker embeds, its embed endpoint)
        self._clients: Dict[str, list] = {}
        # per-model async teardowns (e.g. a KvRouter chooser's stop())
        self._cleanups: Dict[str, object] = {}
        self._watch = None
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._watch = await self.runtime.hub.watch_prefix(f"{MODEL_ROOT}/")
        for key, value in self._watch.snapshot:
            try:
                await self._handle_put(key, value)
            except Exception:
                # one bad registration must not block frontend startup; the
                # same isolation _loop applies per event
                logger.exception("model watcher failed on snapshot %s", key)
        self._task = asyncio.create_task(self._loop(), name="model-watcher")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if self._watch is not None:
            await self._watch.close()
        for cleanup in self._cleanups.values():
            with contextlib.suppress(Exception):
                await cleanup()
        self._cleanups.clear()
        for clients in self._clients.values():
            for client in clients:
                with contextlib.suppress(Exception):
                    await client.close()
        self._clients.clear()

    async def _loop(self) -> None:
        try:
            async for ev in self._watch:
                try:
                    if ev.type == "put":
                        await self._handle_put(ev.key, ev.value)
                    elif ev.type == "delete":
                        await self._handle_delete(ev.key)
                except Exception:
                    logger.exception(
                        "model watcher failed on %s %s", ev.type, ev.key
                    )
        except ConnectionError:
            # hub gone: fail loudly -- drop every model so the frontend 404s
            # instead of routing from a frozen view to possibly-dead workers
            logger.critical(
                "hub connection lost; removing all %d models from the frontend",
                len(self._instances),
            )
            for m in list(self.manager.list_models()):
                self.manager.remove_model(m["id"])
            self._instances.clear()
            raise

    # -- put/delete (reference watcher.rs:162-250) ---------------------------

    @staticmethod
    def _slug_of(key: str) -> str:
        # models/{slug}/{lease_hex}
        parts = key.split("/")
        return parts[1] if len(parts) >= 3 else ""

    async def _handle_put(self, key: str, value: bytes) -> None:
        slug = self._slug_of(key)
        if not slug:
            return
        known = self._instances.setdefault(slug, set())
        if key in known:
            return
        known.add(key)
        if len(known) > 1:
            return  # pipeline already built; new instance joins via discovery
        try:
            entry = ModelEntry.from_json(value)
            card = await ModelDeploymentCard.download(self.runtime.hub, entry.name)
            if card is None:
                logger.error(
                    "model %s registered but no MDC published", entry.name
                )
                known.discard(key)
                return
            endpoint = (
                self.runtime.namespace(entry.namespace)
                .component(entry.component)
                .endpoint(entry.endpoint)
            )
            client = await endpoint.client()
            self._clients[slug] = [client]
            # the frontend's workers are fungible replicas: request-level
            # failover is safe (a worker lost before its first response
            # item redispatches to a survivor) and on by default
            router = PushRouter(
                client, mode=self.router_mode,
                failover=FailoverPolicy.from_env(),
            )
            if self.engine_factory is not None:
                engine = self.engine_factory(entry, card, client, router)
                if hasattr(engine, "__await__"):
                    engine = await engine
                # a factory may return (engine, async_cleanup) so auxiliary
                # resources (KV chooser tasks/subscriptions) die with the model
                if isinstance(engine, tuple):
                    engine, cleanup = engine
                    self._cleanups[slug] = cleanup
            else:
                tokenizer = card.tokenizer()
                engine = link(
                    OpenAIPreprocessor(entry.name, tokenizer),
                    Backend(tokenizer),
                    router,
                )
            embed_engine = None
            if entry.embed_endpoint:
                from .embedding import EmbeddingEngine, router_embedder

                embed_client = await (
                    self.runtime.namespace(entry.namespace)
                    .component(entry.component)
                    .endpoint(entry.embed_endpoint)
                    .client()
                )
                self._clients[slug].append(embed_client)
                embed_engine = EmbeddingEngine(
                    router_embedder(
                        PushRouter(embed_client, mode=self.router_mode)
                    ),
                    tokenizer=card.tokenizer(),
                    max_input_tokens=card.context_length,
                )
        except Exception:
            # transient failure must not wedge the model: un-claim the key so
            # a later put (this instance's or another's) rebuilds from scratch
            known.discard(key)
            cleanup = self._cleanups.pop(slug, None)
            if cleanup is not None:  # factory resources registered pre-failure
                with contextlib.suppress(Exception):
                    await cleanup()
            for client in self._clients.pop(slug, []):
                with contextlib.suppress(Exception):
                    await client.close()
            raise
        self.manager.add_chat_model(entry.name, engine)
        self.manager.add_completion_model(entry.name, engine)
        if embed_engine is not None:
            self.manager.add_embedding_model(entry.name, embed_engine)
        logger.info("model %s added (endpoint %s)", entry.name, endpoint.path)

    async def _handle_delete(self, key: str) -> None:
        slug = self._slug_of(key)
        known = self._instances.get(slug)
        if known is None:
            return
        known.discard(key)
        if known:
            return  # other instances still serve this model
        del self._instances[slug]
        cleanup = self._cleanups.pop(slug, None)
        if cleanup is not None:
            with contextlib.suppress(Exception):
                await cleanup()
        for client in self._clients.pop(slug, []):
            with contextlib.suppress(Exception):
                await client.close()
        # find the display name: manager keys are model names, the key holds
        # the slug; names map 1:1 through slugify
        from .model_card import slugify

        for m in list(self.manager.list_models()):
            if slugify(m["id"]) == slug:
                self.manager.remove_model(m["id"])
                logger.info("model %s removed (last instance gone)", m["id"])
