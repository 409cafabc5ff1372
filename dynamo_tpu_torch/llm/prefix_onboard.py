"""Cross-worker prefix onboarding: import another worker's registered KV
blocks, or the G4 store's, instead of recomputing them.

The JAX package's ``llm/prefix_onboard.py`` for ``TorchEngine`` workers,
wire-compatible with it both ways: the same endpoint, request meta, frame
layout and blob bytes.  A frame names its blob's dtype as the JAX package
does (``bfloat16``, ``float32``, ``int8``); a bf16 blob's bytes are its
values' two bytes, held here as ``uint16`` (``kv_cache.wire_dtype``).

Reference block_manager.rs:119-146: any worker can export a blockset and
any worker can import it, turning per-worker prefix caches into
cluster-wide cache capacity.  Mechanism:

  * every worker with the offload plane armed serves ``kv_export`` (a raw
    endpoint): given a chain of sequence hashes, it streams back the
    longest resident prefix as (meta, blob) frame pairs -- the G1 pages in
    one gather, the offload tiers fill the tail (``engine.export_blocks``);
  * the KV router knows who holds what; when the best-cost worker is not
    the best-overlap worker and fetching wins its gate, it stamps the
    donor's instance and block count into the request metadata
    (``prefix_donor``), or ``source: "remote"`` for the G4 store;
  * the serving wrapper on the chosen worker fetches the missing blocks
    into the engine's host tier **before** admission; the scheduler's
    offload onboarding then scatters them into the pool and registers them
    exactly as if they had been evicted locally.  The tested onboard path
    is the only onboard path.

The import stages in the host tier (G2) through the engine's
``KVOffloadEngine`` (every put rides its offload thread), so onboarding
needs the offload plane armed: ``host_offload_blocks > 0`` or
``DYN_KV_OFFLOAD``.  A donor or store failure never fails the request: it
is counted (``failed_fetches``) and the prefix is recomputed.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import time
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np

from ..runtime.component import Namespace, PushRouter
from ..runtime.engine import Annotated, AsyncEngineContext, Context
from ..runtime.transports.codec import ChunkAssembler, encode_chunk_frame

logger = logging.getLogger("dynamo.prefix_onboard")

# The engine's modules (the blob helpers, the offload plane) are imported
# where they are used: the KV router's front end imports this module for
# DONOR_META_KEY and must not load the engine on its event loop.

KV_EXPORT_ENDPOINT = "kv_export"
# request metadata naming the prefix donor: {"instance", "blocks",
# "source": "peer"|"remote"}
DONOR_META_KEY = "prefix_donor"

# Block blobs ride the wire in chunk frames of this size: a big model's
# block can exceed one frame, and the importer stages each block
# incrementally instead of buffering whole frames (the framing of the
# disaggregated KV delivery, runtime/transports/codec.py).
EXPORT_CHUNK_BYTES = 8 * 1024 * 1024


def kv_export_handler(engine):
    """Raw handler of the ``kv_export`` endpoint: the request meta carries
    the hash chain; the response alternates a JSON meta frame and the
    block's chunk frames (index and offset framed, ``codec.
    encode_chunk_frame``)."""

    async def handler(
        hdr: Dict[str, Any],
        chunks: AsyncIterator[bytes],
        ctx: AsyncEngineContext,
    ) -> AsyncIterator[bytes]:
        del ctx
        async for _chunk in chunks:
            pass  # no request body expected

        async def gen() -> AsyncIterator[bytes]:
            from ..engine.kv_cache import (
                QuantKV,
                blob_dtype_name,
                blob_shape,
                pack_quant_blob_bytes,
            )

            hashes = [int(h) for h in (hdr.get("meta") or {}).get("hashes", [])]
            found = await engine.export_blocks(hashes)
            for seq_hash, blob, meta in found:
                if isinstance(blob, QuantKV):
                    # quantized block: int8 data then f32 row scales -- the
                    # importer re-derives both extents from (shape, dtype)
                    raw = pack_quant_blob_bytes(blob)
                else:
                    raw = np.ascontiguousarray(blob).tobytes()
                yield json.dumps(
                    {
                        "seq_hash": int(seq_hash),
                        "dtype": blob_dtype_name(blob),
                        "shape": list(blob_shape(blob)),
                        "chunk_bytes": EXPORT_CHUNK_BYTES,
                        "total_bytes": len(raw),
                        "meta": meta,
                    }
                ).encode()
                view = memoryview(raw)
                # a zero-byte blob emits no chunk frames.  Chunk i covers
                # bytes [i*CB, (i+1)*CB), the bounds KVStagingBuffer.
                # for_byte_chunks derives on the importer
                for idx, off in enumerate(range(0, len(view), EXPORT_CHUNK_BYTES)):
                    yield encode_chunk_frame(idx, off, view[off : off + EXPORT_CHUNK_BYTES])

        return gen()

    return handler


class PrefixOnboardEngine:
    """Serving wrapper: fetch donor blocks into the host tier, then delegate.

    Sits between the endpoint and the engine (it composes with
    ``DisaggDecodeEngine``: onboarding concerns the prefix, disaggregation
    the rest of the prefill)."""

    def __init__(
        self,
        inner,  # the serving engine to delegate to (engine or disagg wrapper)
        namespace: Namespace,
        component: str,
        engine=None,  # the TorchEngine owning pool and offload (default: inner)
    ) -> None:
        self.inner = inner
        self.engine = engine if engine is not None else inner
        self.namespace = namespace
        self.component = component
        self._export_router: Optional[PushRouter] = None
        self.onboarded_blocks = 0
        self.failed_fetches = 0
        # one row per onboard that fetched: (source "peer" or "remote",
        # blocks, blob bytes, seconds from the fetch's start to its last
        # block staged, before the drain barrier)
        self.fetch_log: collections.deque = collections.deque(maxlen=4096)

    async def _router(self) -> PushRouter:
        if self._export_router is None:
            client = await (
                self.namespace.component(self.component).endpoint(KV_EXPORT_ENDPOINT).client()
            )
            self._export_router = PushRouter(client)
        return self._export_router

    async def close(self) -> None:
        if self._export_router is not None:
            await self._export_router.client.close()
            self._export_router = None

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        donor = (request.metadata or {}).get(DONOR_META_KEY)
        if donor and self.engine.offload is not None:
            try:
                await self._onboard(request, donor)
            except Exception:
                # onboarding is an optimization: a donor failure must never
                # fail the request -- it just recomputes the prefix
                self.failed_fetches += 1
                logger.exception("prefix onboarding failed; recomputing")
        return await self.inner.generate(request)

    async def _onboard(self, request: Context[Any], donor: Dict[str, Any]) -> None:
        from ..engine.kv_cache import unpack_quant_blob_bytes, wire_dtype
        from ..offload import BlockMeta, KVStagingBuffer
        from ..tokens.hashing import hash_blocks

        data = request.data
        token_ids = (
            data.token_ids
            if hasattr(data, "token_ids")
            else list((data or {}).get("token_ids") or [])
        )
        block_size = self.engine.sched.block_size
        n = min(int(donor.get("blocks", 0)), max(0, (len(token_ids) - 1) // block_size))
        if n <= 0:
            return
        _, seq_hashes = hash_blocks(token_ids, block_size)
        seq_hashes = seq_hashes[:n]
        pool = self.engine.kv.allocator
        offload = self.engine.offload_engine
        # fetch only what neither the pool nor the local tiers hold; the
        # donor returns its own longest prefix of the chain asked for
        missing = [h for h in seq_hashes if not (pool.is_registered(h) or offload.contains(h))]
        if not missing:
            return
        if donor.get("source") == "remote":
            # the donor is the shared G4 store, not a peer worker: fetch
            # over the offload engine's remote tier instead of kv_export
            await self._onboard_remote(missing)
            return
        router = await self._router()
        t0 = time.perf_counter()
        stream = await router.direct_raw(
            int(donor["instance"]),
            request.id,
            {"hashes": [int(h) for h in missing]},
            b"",
            AsyncEngineContext(request.id),
        )
        pending_meta: Optional[Dict[str, Any]] = None
        staging: Optional["KVStagingBuffer"] = None
        asm: Optional[ChunkAssembler] = None
        fetched = nbytes = 0

        def _store() -> None:
            nonlocal fetched, nbytes, pending_meta, staging, asm
            # the host-ring copy (and any disk demotion it cascades into)
            # runs on the offload thread, never this event loop; payload()
            # unpacks quantized wire bytes into the (data, scales) pair
            offload.submit_put(
                int(pending_meta["seq_hash"]),
                staging.payload(),
                BlockMeta.from_dict(pending_meta["meta"]),
            )
            fetched += 1
            nbytes += staging.flat.size
            pending_meta = staging = asm = None

        async for frame in stream:
            if pending_meta is None:
                pending_meta = json.loads(frame)
                dtype = pending_meta["dtype"]
                wire_dtype(dtype)  # refuses a dtype the port cannot hold
                if "chunk_bytes" not in pending_meta:
                    # legacy donor: the whole blob rides the next frame
                    staging = asm = None
                    continue
                staging = KVStagingBuffer.for_byte_chunks(
                    pending_meta["shape"], dtype, int(pending_meta["chunk_bytes"])
                )
                asm = ChunkAssembler(staging.memoryview, staging.bounds)
                if asm.complete:  # zero-byte blob: no chunk frames follow
                    _store()
            elif asm is None:
                if pending_meta["dtype"] == "int8":
                    blob = unpack_quant_blob_bytes(frame, pending_meta["shape"])
                else:
                    blob = np.frombuffer(frame, wire_dtype(pending_meta["dtype"])).reshape(
                        pending_meta["shape"]
                    )
                offload.submit_put(
                    int(pending_meta["seq_hash"]),
                    blob,
                    BlockMeta.from_dict(pending_meta["meta"]),
                )
                fetched += 1
                nbytes += len(frame)
                pending_meta = None
            else:
                asm.add(frame)
                if asm.complete:
                    _store()
        if pending_meta is not None:
            # the stream ended mid-block (the donor died): the partial block
            # is dropped; everything already stored still onboards
            logger.warning(
                "donor stream ended mid-block for %x; partial block dropped",
                int(pending_meta.get("seq_hash", 0)),
            )
        self.onboarded_blocks += fetched
        if fetched:
            self.fetch_log.append(("peer", fetched, nbytes, time.perf_counter() - t0))
            # barrier: the submitted puts must be resident before the
            # engine's admission-time tier lookup runs (an off-loop wait;
            # the offload thread's queue is at most this request's blocks
            # deep)
            await asyncio.to_thread(offload.drain)
            logger.info(
                "onboarded %d prefix blocks from donor %x", fetched, int(donor["instance"])
            )

    async def _onboard_remote(self, missing: List[int]) -> None:
        """Fetch missing prefix blocks from the G4 store into the host tier.
        The fetches ride the kv-remote thread (their futures awaited here);
        the chain cuts at the first miss -- the scheduler's prefix match
        stops at the first hole, so blocks past a gap are useless."""
        offload = self.engine.offload_engine
        remote = getattr(offload, "remote", None)
        if remote is None:
            return
        fetched = nbytes = 0
        t0 = time.perf_counter()
        for h in missing:
            got = await asyncio.wrap_future(remote.fetch(int(h)))
            if got is None:
                self.failed_fetches += 1
                break
            blob, meta = got
            offload.submit_put(int(h), blob, meta)
            fetched += 1
            nbytes += blob.nbytes
        self.onboarded_blocks += fetched
        if fetched:
            self.fetch_log.append(("remote", fetched, nbytes, time.perf_counter() - t0))
            await asyncio.to_thread(offload.drain)
            logger.info("onboarded %d prefix blocks from the G4 store", fetched)
