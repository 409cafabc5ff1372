"""The port's recorder (``runtime/recorder.py``) against the JAX package's.

Recordings cross the packages both ways: a stream of the port's engine
(a tiny f32 ``TorchEngine``, an error stream included) recorded by the
port's ``RecordingEngine`` replays through the JAX package's
``ReplayEngine`` item for item, and a stream of the JAX package's echo
engine recorded by the JAX recorder replays through the port's.  The JSONL
lines are the same: the two recorders write the same entries for the same
stream.  Timed replay keeps the recorded gaps.  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import time

import pytest
import torch

from dynamo_tpu.llm.echo import EchoEngineCore
from dynamo_tpu.runtime import recorder as jax_recorder
from dynamo_tpu.runtime.engine import Annotated as JaxAnnotated
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.engine import ResponseStream as JaxResponseStream
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.runtime import recorder
from dynamo_tpu_torch.runtime.engine import Annotated, Context, ResponseStream

WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


def req(tokens, max_tokens=6) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


async def drain(stream):
    async def go():
        return [item.to_dict() async for item in stream]

    return await asyncio.wait_for(go(), WAIT_S)


class ListEngine:
    """Streams fixed items as a package's Annotated."""

    def __init__(self, items, annotated, response_stream) -> None:
        self.items, self.annotated, self.rs = items, annotated, response_stream

    async def generate(self, request):
        async def gen():
            for d in self.items:
                yield self.annotated.from_dict(d)

        return self.rs(request.ctx, gen())


def tiny_engine() -> TorchEngine:
    cfg = ModelConfig.tiny()
    return TorchEngine(
        cfg, init_params(cfg, 0, torch.device("cpu"), torch.float32),
        EngineConfig(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=64),
        device="cpu",
    )


def test_a_port_recording_replays_in_jax(tmp_path):
    """Two streams of the port's engine and one error stream, recorded by
    the port: the JAX ReplayEngine gives each back item for item, in
    recording order, then says it is exhausted."""
    path = str(tmp_path / "port.jsonl")

    async def body():
        eng = tiny_engine()
        rec = recorder.RecordingEngine(eng, path)
        try:
            live = [
                await drain(await rec.generate(Context.new(req([1, 2, 3], 5)))),
                await drain(await rec.generate(Context.new(req([9, 8], 3)))),
                # a request the engine refuses: one error item
                await drain(await rec.generate(Context.new(
                    dict(req([4]), mm_embeds=[[0.0, 1.0]])))),
            ]
        finally:
            await eng.stop()
            await asyncio.to_thread(rec.close)
        replay = jax_recorder.ReplayEngine(path)
        assert replay.num_recorded == 3
        assert replay.recorded_request(1)["token_ids"] == [9, 8]
        got = [
            await drain(await replay.generate(JaxContext.new(req([0])))) for _ in range(3)
        ]
        with pytest.raises(RuntimeError, match="exhausted"):
            await replay.generate(JaxContext.new(req([0])))
        return live, got

    live, got = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert got == live
    assert sum(len((d.get("data") or {}).get("token_ids") or []) for d in live[0]) == 5
    assert live[2][0].get("event") == "error"


def test_a_jax_recording_replays_in_the_port(tmp_path):
    """The JAX echo engine's streams, recorded by the JAX recorder, replay
    through the port's ReplayEngine item for item; timed, with the
    recorded gaps."""
    path = str(tmp_path / "jax.jsonl")

    async def body():
        rec = jax_recorder.RecordingEngine(EchoEngineCore(delay_ms=20.0), path)
        live = [
            await drain(await rec.generate(JaxContext.new(req([5, 6, 7], 3)))),
            await drain(await rec.generate(JaxContext.new(req([2, 4], 2)))),
        ]
        await asyncio.to_thread(rec.close)
        fast = recorder.ReplayEngine(path)
        got = [await drain(await fast.generate(Context.new(req([0])))) for _ in range(2)]
        timed = recorder.ReplayEngine(path, timed=True)
        t0 = time.monotonic()
        await drain(await timed.generate(Context.new(req([0]))))
        return live, got, time.monotonic() - t0

    live, got, timed_s = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert got == live
    assert [t for d in live[0] for t in (d.get("data") or {}).get("token_ids") or []] == [5, 6, 7]
    assert timed_s >= 0.05  # three recorded gaps of about 20 ms


def test_both_recorders_write_the_same_lines(tmp_path):
    """One fixed stream under one request id through each package's
    recorder: the same entries, line for line, but for the clock stamps."""
    items = [
        {"data": {"token_ids": [7]}},
        {"data": {"token_ids": [8, 9], "finish_reason": "length"}},
    ]
    entries = []
    for mod, ctx_cls, annotated, rs in (
        (recorder, Context, Annotated, ResponseStream),
        (jax_recorder, JaxContext, JaxAnnotated, JaxResponseStream),
    ):
        path = str(tmp_path / f"{mod.__name__}.jsonl")

        async def body():
            rec = mod.RecordingEngine(ListEngine(items, annotated, rs), path)
            await drain(await rec.generate(ctx_cls.new(req([1, 2]), "rid-7")))
            await asyncio.to_thread(rec.close)

        asyncio.run(asyncio.wait_for(body(), RUN_S))
        entries.append([
            {k: v for k, v in e.items() if k not in ("ts", "dt")}
            for e in mod.load_recording(path)
        ])
    assert entries[0] == entries[1]
    assert [e["type"] for e in entries[0]] == ["request", "item", "item", "end"]
    assert entries[0][0]["trace_id"] == "rid-7"
