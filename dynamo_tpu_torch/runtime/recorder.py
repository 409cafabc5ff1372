"""Recorder / replay: capture engine streams as JSONL fixtures.

The JAX package's ``runtime/recorder.py``: record a live engine once,
replay the exact stream (optionally with its original timing) without the
engine.  The line format is the same, so each package replays the other's
recordings.

Line format (one JSON object per line, append-only)::

    {"type": "request", "request_id": ..., "ts": ..., "data": ...}
    {"type": "item",    "request_id": ..., "dt": ...,  "data": <Annotated>}
    {"type": "end",     "request_id": ..., "dt": ...}
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import time
from typing import Any, AsyncIterator, Dict, List, Optional

from . import thread_sentry
from .engine import Annotated, AsyncEngine, Context, ResponseStream


class RecordingEngine:
    """AsyncEngine wrapper: pass items through, append them to a JSONL file.

    File I/O rides a dedicated single-writer thread: ``_write`` is called
    from inside an async generator on the event loop, so the actual
    ``write()+flush()`` must never run there.  One worker preserves line
    order; :meth:`close` drains queued lines, then closes the handle."""

    def __init__(self, inner: AsyncEngine, path: str) -> None:
        self.inner = inner
        self.path = path
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="recorder-io"
        )
        # open on the writer thread too: every touch of the handle happens
        # on one thread, and the constructor stays loop-safe
        self._fh = None
        self._io.submit(self._open).result()

    def _open(self) -> None:
        """Writer thread only."""
        self._fh = open(self.path, "a", encoding="utf-8")

    def _append(self, line: str) -> None:
        """Writer thread only."""
        thread_sentry.assert_role(
            "recorder-io", what="RecordingEngine._append"
        )
        self._fh.write(line + "\n")
        self._fh.flush()

    def _write(self, entry: Dict[str, Any]) -> None:
        # serialize on the caller (cheap, keeps entry snapshots consistent);
        # hand the disk touch to the writer thread without waiting
        line = json.dumps(entry)
        try:
            self._io.submit(self._append, line)
        except RuntimeError:
            pass  # closed recorder (shutdown race): drop the line

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        t0 = time.monotonic()
        self._write(
            {
                "type": "request",
                "request_id": request.id,
                # request id doubles as the trace id: a recorded request
                # is one hop from GET /trace/{request_id}
                "trace_id": request.id,
                "ts": round(time.time(), 6),
                "data": request.data,
            }
        )
        stream = await self.inner.generate(request)

        async def gen() -> AsyncIterator[Annotated]:
            try:
                async for item in stream:
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    self._write(
                        {
                            "type": "item",
                            "request_id": request.id,
                            "dt": round(time.monotonic() - t0, 6),
                            "data": item.to_dict(),
                        }
                    )
                    yield item
            finally:
                self._write(
                    {
                        "type": "end",
                        "request_id": request.id,
                        "dt": round(time.monotonic() - t0, 6),
                    }
                )

        return ResponseStream(request.ctx, gen())

    def close(self) -> None:
        """Drain queued lines and close the file (blocking; call off-loop or
        via ``asyncio.to_thread`` from async code)."""
        try:
            self._io.submit(self._fh.close)
        except RuntimeError:
            return  # already closed
        self._io.shutdown(wait=True)


def load_recording(path: str) -> List[Dict[str, Any]]:
    """All entries, in file order."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class ReplayEngine:
    """Replay a recording as an AsyncEngine: the i-th generate() call
    receives the i-th recorded stream (requests replay in recording order,
    matching the reference's replay fixtures).  ``timed=True`` reproduces
    the recorded inter-item gaps (scaled by ``speedup``)."""

    def __init__(
        self, path: str, timed: bool = False, speedup: float = 1.0
    ) -> None:
        self.timed = timed
        self.speedup = max(speedup, 1e-9)
        self._streams: List[List[Dict[str, Any]]] = []
        self._requests: List[Dict[str, Any]] = []
        by_id: Dict[str, List[Dict[str, Any]]] = {}
        for entry in load_recording(path):
            if entry["type"] == "request":
                by_id[entry["request_id"]] = []
                self._requests.append(entry)
                self._streams.append(by_id[entry["request_id"]])
            elif entry["type"] == "item":
                by_id[entry["request_id"]].append(entry)
        self._next = 0

    @property
    def num_recorded(self) -> int:
        return len(self._streams)

    def recorded_request(self, i: int) -> Any:
        return self._requests[i]["data"]

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        if self._next >= len(self._streams):
            raise RuntimeError(
                f"replay exhausted after {len(self._streams)} recorded streams"
            )
        items = self._streams[self._next]
        self._next += 1

        async def gen() -> AsyncIterator[Annotated]:
            prev = 0.0
            for entry in items:
                if self.timed:
                    gap = max(0.0, entry["dt"] - prev) / self.speedup
                    prev = entry["dt"]
                    if gap:
                        await asyncio.sleep(gap)
                yield Annotated.from_dict(entry["data"])

        return ResponseStream(request.ctx, gen())
