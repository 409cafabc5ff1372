"""The port's transports against the JAX package's, over real sockets.

* Codec: frames, trace and deadline contexts and chunk frames encode to the
  JAX package's bytes for the same messages, and each side decodes the
  other's.
* Hub: a port ``HubClient`` against a JAX ``HubServer``, a JAX client
  against the port's server (and the port against itself): kv
  put/get/prefix/create/delete and prefix watches, lease expiry, event
  pub/sub with wildcards, the object and blob stores (the blob store also
  through ``HubBlobClient`` from a worker thread) and queues.
* Request plane: a port ``DataPlaneClient`` against a JAX
  ``DataPlaneServer`` and the other way round: a stream arrives whole, a
  killed stream stops the server's generator, an expired deadline is
  answered with the deadline error, and a prologue error reaches the
  caller.

Every wait is bounded by ``asyncio.wait_for``; every server stops in
``finally``.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from dynamo_tpu.runtime import engine as jax_engine
from dynamo_tpu.runtime.transports import client as jax_client
from dynamo_tpu.runtime.transports import codec as jax_codec
from dynamo_tpu.runtime.transports import hub as jax_hub
from dynamo_tpu.runtime.transports import request_plane as jax_rp
from dynamo_tpu_torch.runtime import engine as port_engine
from dynamo_tpu_torch.runtime.transports import client as port_client
from dynamo_tpu_torch.runtime.transports import codec as port_codec
from dynamo_tpu_torch.runtime.transports import hub as port_hub
from dynamo_tpu_torch.runtime.transports import request_plane as port_rp

WAIT_S = 10

PACKAGES = {
    "jax": (jax_hub, jax_client, jax_rp, jax_engine),
    "port": (port_hub, port_client, port_rp, port_engine),
}
# (server side, client side)
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


# -- codec ---------------------------------------------------------------------


HEADERS = [
    ({"t": "req", "sid": 1, "subject": "dynamo.backend.generate", "id": "r-1",
      "meta": {}}, b'{"token_ids": [1, 2, 3]}'),
    ({"t": "ack", "sid": 7}, b""),
    ({"t": "data", "sid": 7}, b'{"data": {"token_ids": [5]}}'),
    ({"t": "end", "sid": 7}, b""),
    ({"t": "err", "sid": 3, "deadline": True, "msg": "deadline exceeded"}, b""),
    ({"t": "err", "sid": 3, "retry": True, "msg": "no handler for subject 'x'"}, b""),
    ({"op": "kv_put", "id": 12, "key": "models/tiny/1a2b", "lease": 26}, b"\x00\xffblob"),
    ({"op": "watch", "id": 2, "prefix": "instances/dynamo/"}, b""),
    ({"t": "req", "sid": 2, "subject": "s", "id": "unicode é世", "meta": {"a": [1, 2.5, None]}}, b""),
]
TRACES = [None, {"tid": "0123456789abcdef0123456789abcdef", "sid": "0123456789abcdef"}]
DEADLINES = [None, 2.5, 0.123456789, 0]


@pytest.mark.parametrize("deadline", DEADLINES)
@pytest.mark.parametrize("trace", TRACES)
@pytest.mark.parametrize("kind", range(len(HEADERS)))
def test_codec_frames_equal_jax(kind, trace, deadline):
    hdr, payload = HEADERS[kind]

    def stamp(codec):
        h = json.loads(json.dumps(hdr))
        return codec.encode_deadline_context(codec.encode_trace_context(h, trace), deadline)

    got = port_codec.encode_frame(stamp(port_codec), payload)
    want = jax_codec.encode_frame(stamp(jax_codec), payload)
    assert got == want
    for codec in (port_codec, jax_codec):
        h = stamp(codec)
        assert codec.decode_trace_context(h) == trace
        if deadline is None:
            assert codec.decode_deadline_context(h) is None
        else:
            assert codec.decode_deadline_context(h) == round(float(deadline), 4)


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_codec_frames_read_across(run, writer, reader):
    """A stream of frames written by one package's ``write_frame`` reads back
    through the other's ``read_frame``, then a clean EOF."""
    wc = {"port": port_codec, "jax": jax_codec}[writer]
    rc = {"port": port_codec, "jax": jax_codec}[reader]

    class Sink:
        def __init__(self):
            self.buf = bytearray()

        def write(self, b):
            self.buf += b

    async def body():
        sink = Sink()
        for hdr, payload in HEADERS:
            wc.write_frame(sink, hdr, payload)
        stream = asyncio.StreamReader()
        stream.feed_data(bytes(sink.buf))
        stream.feed_eof()
        got = []
        while (frame := await rc.read_frame(stream)) is not None:
            got.append(frame)
        assert got == [(hdr, payload) for hdr, payload in HEADERS]

    run(body())


@pytest.mark.parametrize("index, offset, size", [(0, 0, 0), (3, 4096, 17), (255, 2**40, 1 << 16)])
def test_codec_chunk_frames_equal_jax(index, offset, size):
    payload = bytes((i * 31 + index) % 256 for i in range(size))
    got = bytes(port_codec.encode_chunk_frame(index, offset, payload))
    assert got == bytes(jax_codec.encode_chunk_frame(index, offset, payload))
    i, off, view = jax_codec.decode_chunk_frame(got)
    assert (i, off, bytes(view)) == (index, offset, payload)
    parts = list(port_codec.iter_chunk_frames(index, offset, payload, 1000))
    want = list(jax_codec.iter_chunk_frames(index, offset, payload, 1000))
    assert [bytes(p) for p in parts] == [bytes(w) for w in want]
    # the port's assembler places the JAX frames of two chunks, the second
    # arriving first
    head = b"\x07" * 100
    buf = bytearray(len(head) + size)
    asm = port_codec.ChunkAssembler(memoryview(buf), [(0, 100), (100, 100 + size)])
    done = []
    for frame in list(jax_codec.iter_chunk_frames(1, 100, payload, 1000)) + list(
        jax_codec.iter_chunk_frames(0, 0, head, 64)
    ):
        done += asm.add(frame)
    assert asm.complete and bytes(buf) == head + payload
    assert done == ([1, 0] if size else [0])


# -- hub -------------------------------------------------------------------------


async def hub_pair(server_pkg: str, client_pkg: str):
    server = PACKAGES[server_pkg][0].HubServer()
    host, port = await server.start()
    client = await PACKAGES[client_pkg][1].HubClient(host, port).connect()
    return server, client


def hub_test(run, pair, fn):
    async def body():
        server, client = await hub_pair(*pair)
        try:
            await asyncio.wait_for(fn(client, server), 30)
        finally:
            await client.close()
            await server.stop()

    run(body())


@pytest.mark.parametrize("pair", PAIRS)
def test_hub_kv_and_watch_across(run, pair):
    async def fn(client, server):
        await client.kv_put("models/a", b"va")
        await client.kv_put("models/b", b"vb")
        await client.kv_put("other/c", b"vc")
        assert await client.kv_get_prefix("models/") == [("models/a", b"va"), ("models/b", b"vb")]
        watch = await client.watch_prefix("models/")
        assert sorted(k for k, _ in watch.snapshot) == ["models/a", "models/b"]
        await client.kv_put("models/new", b"nv")
        ev = await asyncio.wait_for(watch.events.get(), WAIT_S)
        assert (ev.type, ev.key, ev.value) == ("put", "models/new", b"nv")
        assert await client.kv_delete("models/a") is True
        ev = await asyncio.wait_for(watch.events.get(), WAIT_S)
        assert (ev.type, ev.key) == ("delete", "models/a")
        assert await client.kv_create("models/b", b"x") is False
        assert await client.kv_create("models/z", b"x") is True
        assert await client.kv_delete_prefix("models/") == 3
        assert await client.kv_get_prefix("models/") == []
        await watch.close()

    hub_test(run, pair, fn)


@pytest.mark.parametrize("pair", PAIRS)
def test_hub_lease_expiry_across(run, pair):
    async def fn(client, server):
        lease = await client.lease_grant(ttl=0.5, keepalive=False)
        held = await client.lease_grant(ttl=0.5, keepalive=True)
        await client.kv_put("instances/x", b"1", lease=lease)
        await client.kv_put("instances/y", b"2", lease=held)
        watch = await client.watch_prefix("instances/")
        ev = await asyncio.wait_for(watch.events.get(), WAIT_S)
        assert (ev.type, ev.key) == ("delete", "instances/x")
        await asyncio.sleep(0.6)  # past the TTL: the kept-alive lease holds
        assert await client.kv_get_prefix("instances/") == [("instances/y", b"2")]
        await client.lease_revoke(held)
        ev = await asyncio.wait_for(watch.events.get(), WAIT_S)
        assert (ev.type, ev.key) == ("delete", "instances/y")
        await watch.close()

    hub_test(run, pair, fn)


@pytest.mark.parametrize("pair", PAIRS)
def test_hub_pubsub_across(run, pair):
    async def fn(client, server):
        exact = await client.subscribe("dynamo.events.kv_events")
        wild = await client.subscribe("dynamo.events.*")
        assert await client.publish("dynamo.events.kv_events", b'{"e": 1}') == 2
        assert await client.publish("dynamo.events.kv-hit-rate", b"h") == 1
        assert await client.publish("other.events.kv_events", b"x") == 0
        got = await asyncio.wait_for(exact.next(), WAIT_S)
        assert got == ("dynamo.events.kv_events", b'{"e": 1}')
        first = await asyncio.wait_for(wild.next(), WAIT_S)
        second = await asyncio.wait_for(wild.next(), WAIT_S)
        assert [first, second] == [("dynamo.events.kv_events", b'{"e": 1}'),
                                   ("dynamo.events.kv-hit-rate", b"h")]
        await exact.close()
        await wild.close()

    hub_test(run, pair, fn)


@pytest.mark.parametrize("pair", PAIRS)
def test_hub_objects_blobs_queues_across(run, pair):
    async def fn(client, server):
        big = bytes(range(256)) * 4096
        await client.obj_put("mdc/tiny", b'{"name": "tiny"}')
        assert await client.obj_get("mdc/tiny") == b'{"name": "tiny"}'
        assert await client.obj_get("mdc/none") is None
        assert await client.obj_del("mdc/tiny") is True
        await client.blob_put("kv/0001", big)
        assert await client.blob_get("kv/0001") == big
        stats = await client.blob_stats()
        assert stats["blobs"] == 1 and stats["bytes"] == len(big)
        # the synchronous facade an offload thread uses
        loop = asyncio.get_running_loop()
        blobs = PACKAGES[pair[1]][1].HubBlobClient(client, loop)
        await asyncio.to_thread(blobs.put, "kv/0002", b"abc")
        assert await asyncio.to_thread(blobs.get, "kv/0002") == b"abc"
        assert await asyncio.to_thread(blobs.delete, "kv/0002") is True
        assert await client.blob_get("kv/0002") is None
        await client.queue_push("q", b"1")
        await client.queue_push("q", b"2")
        assert await client.queue_depth("q") == 2
        assert await client.queue_pop("q") == b"1"
        assert await client.queue_pop("q") == b"2"
        assert await client.queue_pop("q", block=False) is None

    hub_test(run, pair, fn)


# -- request plane ------------------------------------------------------------------


def counting_handler(state: dict):
    """A byte handler: ``{"n": N, "sleep": s}`` streams N items, one per
    ``s`` seconds; ``{"boom": msg}`` fails in the prologue.  ``state`` records
    how far each stream got and whether its generator closed."""

    async def handler(hdr, payload, ctx):
        req = json.loads(payload)
        if "boom" in req:
            raise ValueError(req["boom"])

        async def gen():
            try:
                for i in range(req["n"]):
                    if ctx.is_stopped():
                        return
                    state["sent"] = i + 1
                    yield json.dumps({"i": i}).encode()
                    await asyncio.sleep(req.get("sleep", 0))
            finally:
                state["closed"] = True

        return gen()

    return handler


async def plane(server_pkg: str, client_pkg: str, state: dict):
    server = PACKAGES[server_pkg][2].DataPlaneServer(host="127.0.0.1")
    server.register("t.c.e", counting_handler(state))
    host, port = await server.start()
    client = PACKAGES[client_pkg][2].DataPlaneClient()
    return server, client, host, port


def plane_test(run, pair, fn):
    async def body():
        state: dict = {}
        server, client, host, port = await plane(*pair, state)
        ctx_cls = PACKAGES[pair[1]][3].AsyncEngineContext

        def call(req, ctx=None, deadline=None):
            return client.request(host, port, "t.c.e", "rid", {},
                                  json.dumps(req).encode(), ctx or ctx_cls("rid"),
                                  deadline=deadline)

        try:
            await asyncio.wait_for(fn(call, state, ctx_cls, pair[1]), 30)
        finally:
            await client.close()
            await server.stop()

    run(body())


@pytest.mark.parametrize("pair", PAIRS[:2])
def test_request_plane_stream_across(run, pair):
    async def fn(call, state, ctx_cls, side):
        stream = await call({"n": 5})
        got = [json.loads(b)["i"] async for b in stream]
        assert got == [0, 1, 2, 3, 4]
        with pytest.raises(PACKAGES[side][2].RemoteError, match="engine exploded"):
            await call({"boom": "engine exploded"})

    plane_test(run, pair, fn)


@pytest.mark.parametrize("pair", PAIRS[:2])
def test_request_plane_kill_across(run, pair):
    async def fn(call, state, ctx_cls, side):
        ctx = ctx_cls("rid")
        stream = await call({"n": 10_000, "sleep": 0.005}, ctx)
        got = 0
        async for _ in stream:
            got += 1
            if got == 3:
                ctx.kill()
        # the server's generator sees the cancel frame and closes
        for _ in range(500):
            if state.get("closed"):
                break
            await asyncio.sleep(0.01)
        assert state.get("closed") and state["sent"] < 10_000

    plane_test(run, pair, fn)


@pytest.mark.parametrize("pair", PAIRS[:2])
def test_request_plane_deadline_across(run, pair):
    async def fn(call, state, ctx_cls, side):
        errors = (PACKAGES[side][2].RemoteError, PACKAGES[side][3].DeadlineExceededError)
        # a budget spent on the way: refused before the handler runs
        with pytest.raises(errors, match="deadline"):
            await call({"n": 3}, deadline=0)
        assert "sent" not in state
        # a budget that expires mid-stream: the server's watchdog kills it
        stream = await call({"n": 10_000, "sleep": 0.01}, deadline=0.2)
        got = 0
        with pytest.raises(errors, match="deadline"):
            async for _ in stream:
                got += 1
        assert 0 < got < 10_000

    plane_test(run, pair, fn)
