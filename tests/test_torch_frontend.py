"""The port's OpenAI front end against the JAX package's, over HTTP.

Two pipelines serve the same tiny f32 model (the JAX ``init_params``
pytree, carried across by ``params_from_numpy``) with the ``model_dir``
tokenizer, whose vocabulary is the model's: the JAX package's
``HttpService`` over ``link(OpenAIPreprocessor, Backend, JaxEngine)`` and
the port's copies over ``TorchEngine(device="cpu")``.  The same requests
(chat aggregated and SSE, completions with a text and a token prompt, a
stop string, ``max_tokens``) must give identical greedy bodies, ids and
timestamps aside, under the default config and under the classic path
with penalized lanes; an echo completion with ``logprobs`` and
``/v1/embeddings`` (text and token inputs) give the same bodies with
logprobs within 1e-4 and vectors within 1e-5, and the embeddings route
refuses an unknown model, an empty input and an over-long one with the JAX
service's status and message.  SSE bodies are compared as what a client reads from
them (role chunk, text, finish reason, usage, ``[DONE]``): where the chunks
split depends on when each engine commits.

Within the port: 404, 400, the 503 shed, ``/v1/models``, ``/health``,
``/metrics`` (family names and types equal the JAX service's), a 504 on an
expired deadline, a served ``/v1/embeddings`` call, a client that closes
mid-stream frees its lane, and the serving-environment overrides read at
engine construction.  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import json
import re

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.http.service import HttpService as JaxHttpService
from dynamo_tpu.http.service import ModelManager as JaxModelManager
from dynamo_tpu.llm.backend import Backend as JaxBackend
from dynamo_tpu.llm.embedding import EmbeddingEngine as JaxEmbeddingEngine
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.runtime.pipeline import link as jax_link
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.http.service import HttpService, ModelManager
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.embedding import EmbeddingEngine
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.pipeline import link

NAME = "tiny"
ENGINE = dict(max_batch_size=4, max_seq_len=128, page_size=4, num_pages=128,
              mixed_token_budget=16)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
CONFIGS = {
    "default": ({}, {}),
    "classic-penalized": (
        dict(mixed_batching=False, prefill_chunk_tokens=8),
        {"frequency_penalty": 0.5, "presence_penalty": 0.25},
    ),
}


# -- a minimal HTTP client ----------------------------------------------------


async def http(port: int, method: str, path: str, body=None, headers=None):
    """One request; returns (status, headers, body bytes), chunked bodies
    decoded."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = b"" if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode()
        )
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
            f"Content-Length: {len(data)}\r\n{extra}\r\n".encode() + data
        )
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        hdrs = {}
        while True:
            line = await reader.readline()
            if not line.strip():
                break
            k, _, v = line.decode("latin-1").partition(":")
            hdrs[k.strip().lower()] = v.strip()
        if hdrs.get("transfer-encoding") == "chunked":
            out = b""
            while True:
                size = int((await reader.readline()).strip(), 16)
                if size == 0:
                    break
                out += await reader.readexactly(size)
                await reader.readexactly(2)
            return status, hdrs, out
        return status, hdrs, await reader.read()
    finally:
        writer.close()


def sse_events(raw: bytes):
    return [
        line[5:].strip().decode()
        for line in raw.split(b"\n")
        if line.startswith(b"data:")
    ]


def strip_ids(doc):
    doc = dict(doc)
    doc.pop("id", None)
    doc.pop("created", None)
    return doc


def read_sse(raw: bytes) -> dict:
    """What a client reads from an SSE body."""
    events = sse_events(raw)
    assert events[-1] == "[DONE]", events[-3:]
    chunks = [json.loads(e) for e in events[:-1]]
    out = {"text": "", "roles": [], "finish": None, "usage": None,
           "object": {c["object"] for c in chunks}, "model": {c["model"] for c in chunks}}
    for c in chunks:
        if c.get("usage"):
            out["usage"] = c["usage"]
        for ch in c["choices"]:
            delta = ch.get("delta")
            if delta is not None:
                if delta.get("role"):
                    out["roles"].append(delta["role"])
                out["text"] += delta.get("content") or ""
            else:
                out["text"] += ch.get("text") or ""
            out["finish"] = ch.get("finish_reason") or out["finish"]
    return out


# -- the two stacks -------------------------------------------------------------


@pytest.fixture(scope="module")
def stack(model_dir):
    vocab = JaxTokenizer.from_model_dir(model_dir).vocab_size
    jcfg = JaxModelConfig.tiny(vocab_size=vocab)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return model_dir, jcfg, jparams, np_params


def jax_service(stack, engine_kw, **service_kw):
    model_dir, jcfg, jparams, _ = stack
    engine = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **engine_kw}))
    tok = JaxTokenizer.from_model_dir(model_dir)
    pipe = jax_link(JaxPreprocessor(NAME, tok), JaxBackend(tok), engine)
    manager = JaxModelManager()
    manager.add_chat_model(NAME, pipe)
    manager.add_completion_model(NAME, pipe)
    manager.add_embedding_model(
        NAME, JaxEmbeddingEngine(engine.embed, tok, engine.cfg.max_seq_len)
    )
    return engine, JaxHttpService(manager, **service_kw)


def torch_service(stack, engine_kw, **service_kw):
    model_dir, _, _, np_params = stack
    cfg = ModelConfig.tiny(vocab_size=stack[1].vocab_size)
    engine = TorchEngine(
        cfg, params_from_numpy(np_params, cfg, device="cpu"),
        EngineConfig(**{**ENGINE, **engine_kw}), device="cpu",
    )
    tok = Tokenizer.from_model_dir(model_dir)
    pipe = link(OpenAIPreprocessor(NAME, tok), Backend(tok), engine)
    manager = ModelManager()
    manager.add_chat_model(NAME, pipe)
    manager.add_completion_model(NAME, pipe)
    manager.add_embedding_model(NAME, EmbeddingEngine(engine.embed, tok, engine.cfg.max_seq_len))
    return engine, HttpService(manager, **service_kw)


def requests_for(tok: Tokenizer):
    """(name, path, body) in order.  The stop requests stop at a string
    taken from the ``text`` request's output (``STOP`` marks where)."""
    ids = tok.encode("the quick brown fox jumps", add_special_tokens=False)
    return [
        ("chat", "/v1/chat/completions",
         {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 10}),
        ("chat_sse", "/v1/chat/completions",
         {"messages": [{"role": "user", "content": "tell me a story"}],
          "max_tokens": 10, "stream": True}),
        ("text", "/v1/completions", {"prompt": "the lazy dog", "max_tokens": 12}),
        ("text_sse", "/v1/completions",
         {"prompt": "paged attention", "max_tokens": 12, "stream": True}),
        ("tokens", "/v1/completions", {"prompt": ids, "max_tokens": 9}),
        ("max_tokens", "/v1/completions", {"prompt": "abc", "max_tokens": 3}),
        ("stop", "/v1/completions",
         {"prompt": "the lazy dog", "max_tokens": 12, "stop": STOP}),
        ("stop_sse", "/v1/completions",
         {"prompt": "the lazy dog", "max_tokens": 12, "stream": True, "stop": STOP}),
        ("echo", "/v1/completions",
         {"prompt": "the quick brown fox", "max_tokens": 4, "echo": True, "logprobs": 2}),
        ("embed", "/v1/embeddings", {"input": ["the lazy dog", "paged attention x"]}),
        ("embed_tokens", "/v1/embeddings", {"input": ids}),
    ]


# /v1/embeddings bodies both services refuse: (name, body)
EMBED_ERRORS = [
    ("unknown_model", {"model": "nope", "input": "x"}),
    ("empty_input", {"model": NAME, "input": []}),
    ("too_long", {"model": NAME, "input": [[7] * 200]}),
]
# equality tolerance of the float fields: echo logprobs, embedding vectors
CLOSE = {"echo": 1e-4, "embed": 1e-5, "embed_tokens": 1e-5}


def assert_close(got, ref, tol, path="body"):
    """``got == ref`` with floats within ``tol``."""
    if isinstance(ref, float):
        assert isinstance(got, float) and abs(got - ref) <= tol, (path, got, ref)
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_close(got[k], ref[k], tol, f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, tol, f"{path}[{i}]")
    else:
        assert got == ref, (path, got, ref)


STOP = object()


def stop_string(out) -> str:
    text = out["text"]["choices"][0]["text"]
    assert len(text) >= 6, text
    return text[3:5]


async def serve_all(service, engine, reqs):
    await service.start()
    port = service.address[1]
    out = {}
    try:
        for name, path, body in reqs:
            if body.get("stop") is STOP:
                body = {**body, "stop": [stop_string(out)]}
            status, hdrs, raw = await asyncio.wait_for(
                http(port, "POST", path, {"model": NAME, **body}), WAIT_S
            )
            assert status == 200, (name, raw[:300])
            if body.get("stream"):
                assert hdrs["content-type"] == "text/event-stream"
                out[name] = read_sse(raw)
            else:
                out[name] = strip_ids(json.loads(raw))
        for name, body in EMBED_ERRORS:
            status, _, raw = await asyncio.wait_for(
                http(port, "POST", "/v1/embeddings", body), WAIT_S
            )
            out[name] = (status, json.loads(raw))
        for path in ("/v1/models", "/health"):
            status, _, raw = await asyncio.wait_for(http(port, "GET", path), WAIT_S)
            assert status == 200
            out[path] = json.loads(raw)
        status, hdrs, raw = await asyncio.wait_for(http(port, "GET", "/metrics"), WAIT_S)
        assert status == 200
        out["/metrics"] = (hdrs["content-type"], service.metrics.render()[0].decode())
    finally:
        await service.stop()
        await engine.stop()
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request, stack):
    engine_kw, sampling = CONFIGS[request.param]
    tok = Tokenizer.from_model_dir(stack[0])
    reqs = [(n, p, {**b, **sampling}) for n, p, b in requests_for(tok)]

    async def both():
        jeng, jsvc = jax_service(stack, engine_kw)
        jax_out = await serve_all(jsvc, jeng, reqs)
        teng, tsvc = torch_service(stack, engine_kw)
        torch_out = await serve_all(tsvc, teng, reqs)
        return jax_out, torch_out, stop_string(jax_out)

    return asyncio.run(asyncio.wait_for(both(), 4 * WAIT_S))


def test_bodies_equal_jax(served):
    jax_out, torch_out, stop = served
    for name in ("chat", "chat_sse", "text", "text_sse", "tokens", "max_tokens",
                 "stop", "stop_sse"):
        assert torch_out[name] == jax_out[name], name
    for name, tol in CLOSE.items():
        assert_close(torch_out[name], jax_out[name], tol, name)
    for name, _ in EMBED_ERRORS:
        assert torch_out[name] == jax_out[name], name
    assert [s for s, _ in (torch_out[n] for n, _ in EMBED_ERRORS)] == [404, 400, 400]
    # the echo body: the prompt's text and one entry per prompt token, the
    # first without a logprob, then the completion's own entries
    echo = torch_out["echo"]["choices"][0]
    assert echo["text"].startswith("the quick brown fox")
    lp = echo["logprobs"]
    n_prompt = torch_out["echo"]["usage"]["prompt_tokens"]
    assert len(lp["tokens"]) == n_prompt + 4 and lp["token_logprobs"][0] is None
    assert all(x <= 0 for x in lp["token_logprobs"][1:])
    for name, n_inputs in (("embed", 2), ("embed_tokens", 1)):
        data = torch_out[name]["data"]
        assert [d["index"] for d in data] == list(range(n_inputs))
        for d in data:
            assert abs(np.linalg.norm(d["embedding"]) - 1.0) < 1e-5
    assert torch_out["embed_tokens"]["usage"]["prompt_tokens"] == 5
    # each case did what it asks for
    assert torch_out["chat_sse"]["roles"] == ["assistant"]
    assert torch_out["max_tokens"]["choices"][0]["finish_reason"] == "length"
    assert torch_out["max_tokens"]["usage"]["completion_tokens"] == 3
    assert torch_out["stop"]["choices"][0]["finish_reason"] == "stop"
    assert stop not in torch_out["stop"]["choices"][0]["text"]
    assert torch_out["stop_sse"]["text"] == torch_out["stop"]["choices"][0]["text"]
    assert torch_out["tokens"]["usage"]["prompt_tokens"] == 5
    for name in ("chat", "text", "tokens"):
        usage = torch_out[name]["usage"]
        assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]


def test_models_health_metrics_equal_jax(served):
    jax_out, torch_out, _ = served
    assert torch_out["/v1/models"] == jax_out["/v1/models"]
    assert torch_out["/health"] == jax_out["/health"]
    jct, jtext = jax_out["/metrics"]
    tct, ttext = torch_out["/metrics"]
    assert tct == jct

    def types(text):
        return sorted(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))

    def counts(text):
        # request counters and histogram counts: equal traffic, equal values
        return sorted(
            line for line in text.splitlines()
            if line.startswith(("dynamo_http_service_requests_total",
                                "dynamo_http_service_request_duration_seconds_count",
                                "dynamo_http_service_inflight_requests"))
        )

    assert types(ttext) == types(jtext)
    assert counts(ttext) == counts(jtext)
    assert 'dynamo_http_service_requests_total{endpoint="completions",model="tiny",' \
           'status="success"} 7.0' in ttext
    assert 'dynamo_http_service_requests_total{endpoint="embeddings",model="tiny",' \
           'status="success"} 2.0' in ttext


# -- the port's service alone -------------------------------------------------


def test_errors_shed_disconnect_deadline(stack):
    """404, 400, the 503 shed, a 504 deadline, a served /v1/embeddings
    call, and a client that closes mid-stream: its lane is freed well
    before its max_tokens, and the next request is served."""
    engine, service = torch_service(
        stack, dict(max_batch_size=1, max_seq_len=4096, num_pages=1100),
        max_inflight=1,
    )

    async def body():
        await service.start()
        port = service.address[1]
        try:
            status, _, raw = await http(port, "POST", "/v1/completions",
                                        {"model": "nope", "prompt": "x"})
            assert status == 404 and json.loads(raw)["error"]["code"] == 404
            status, _, raw = await http(port, "POST", "/v1/chat/completions", b"{not json")
            assert status == 400
            status, _, raw = await http(port, "POST", "/v1/chat/completions",
                                        {"model": NAME})
            assert status == 400 and json.loads(raw)["error"]["type"] == "invalid_request_error"
            status, _, raw = await http(port, "POST", "/v1/embeddings",
                                        {"model": NAME, "input": "x"})
            assert status == 200
            body = json.loads(raw)
            (vec,) = [d["embedding"] for d in body["data"]]
            assert len(vec) == stack[1].hidden_size
            assert abs(np.linalg.norm(vec) - 1.0) < 1e-5
            assert body["usage"]["prompt_tokens"] == len(engine_tok(stack).encode("x"))
            status, _, raw = await http(
                port, "POST", "/v1/completions",
                {"model": NAME, "prompt": "the lazy dog", "max_tokens": 4000},
                headers={"X-Request-Deadline-S": "0.001"},
            )
            assert status == 504 and json.loads(raw)["error"]["type"] == "timeout_error"
            await wait_idle(engine)

            # a long SSE request holds the one inflight slot and the one lane
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            data = json.dumps({"model": NAME, "prompt": "the lazy dog",
                               "max_tokens": 4000, "stream": True,
                               "ignore_eos": True}).encode()
            writer.write(
                b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                + f"Content-Length: {len(data)}\r\n\r\n".encode() + data
            )
            await writer.drain()
            while b"data:" not in await reader.readline():
                pass
            status, hdrs, raw = await http(port, "POST", "/v1/completions",
                                           {"model": NAME, "prompt": "x"})
            assert status == 503 and hdrs["retry-after"] == "1"
            writer.close()
            await wait_idle(engine)
            assert engine.tokens_generated < 3000
            status, _, raw = await http(port, "POST", "/v1/completions",
                                        {"model": NAME, "prompt": "x", "max_tokens": 4})
            assert status == 200
            assert json.loads(raw)["usage"]["completion_tokens"] == 4
            text = service.metrics.render()[0].decode()
            assert 'dynamo_http_service_sheds_total{endpoint="completions"} 1.0' in text
        finally:
            await service.stop()
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


def engine_tok(stack) -> Tokenizer:
    return Tokenizer.from_model_dir(stack[0])


def test_request_template_fills_defaults(stack):
    """``RequestTemplate`` supplies the model and token budget a client
    left out; the client's own fields win."""
    from dynamo_tpu_torch.protocols.openai import RequestTemplate

    engine, service = torch_service(
        stack, {}, template=RequestTemplate(model=NAME, max_completion_tokens=3)
    )

    async def body():
        await service.start()
        port = service.address[1]
        try:
            status, _, raw = await http(port, "POST", "/v1/completions",
                                        {"prompt": "the lazy dog", "ignore_eos": True})
            assert status == 200 and json.loads(raw)["usage"]["completion_tokens"] == 3
            status, _, raw = await http(port, "POST", "/v1/completions",
                                        {"prompt": "x", "max_tokens": 5, "ignore_eos": True})
            assert status == 200 and json.loads(raw)["usage"]["completion_tokens"] == 5
        finally:
            await service.stop()
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


def test_registry_renders_as_prometheus_client():
    """The port's registry renders the text the JAX package's registry
    (``prometheus_client``) renders for the same families and values (a
    counter named ``x_total`` included), the ``_created`` timestamps
    aside."""
    from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    texts = []
    for reg in (JaxRegistry(), MetricsRegistry()):
        c = reg.counter("x_requests", 'Requests "served"\nback\\slash', ["model", "status"])
        c.labels("m\"1", "ok").inc()
        c.labels("m2", "error").inc(2.5)
        reg.counter("x_plain", "plain").inc(1e7)
        # a counter named with its _total suffix is the family without it
        reg.counter("x_dispatches_total", "By kind", ["kind"]).labels("embed").inc(2)
        g = reg.gauge("x_inflight", "In flight", ["model"])
        g.labels("m").inc()
        g.labels("m").dec(3)
        reg.gauge("x_level", "level").set(1234567.0)
        h = reg.histogram("x_seconds", "Durations", ["model"],
                          buckets=(0.0005, 0.005, 0.5, 1.0, 10.0, 2e7))
        for v in (0.0001, 0.3, 0.7, 12.0, 3e7):
            h.labels("m").observe(v)
        reg.histogram("x_empty", "no children yet", ["a"])
        reg.set_default_labels(worker_id=7, role="decode")
        body, ctype = reg.render()
        texts.append((ctype, re.sub(r"(_created\{[^}]*\}) \S+", r"\1 T", body.decode())))
    assert texts[1] == texts[0]


def test_offload_metrics_render_as_jax():
    """``dynamo_kv_*``: the port's ``OffloadMetrics`` renders the JAX
    package's families -- names, labels, help and buckets -- for the same
    observations, through the port's registry."""
    from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
    from dynamo_tpu.runtime.metrics import OffloadMetrics as JaxOffloadMetrics
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, OffloadMetrics

    texts = []
    for reg, cls in ((JaxRegistry(), JaxOffloadMetrics), (MetricsRegistry(), OffloadMetrics)):
        m = cls(reg)
        m.record_offload("host", 2097152, 0.004)
        m.record_offload("swap", 4194304, 0.02)
        m.record_onboard("prefix", 134217728, 0.011)
        m.record_onboard("swap", 4194304, 0.0005)
        m.tier_blocks.labels("host").set(128)
        m.tier_blocks.labels("disk").set(40)
        m.tier_hits.labels("host").inc(64)
        m.tier_promotes.labels("disk").inc(3)
        m.preemptions.labels("swap").inc()
        m.preemptions.labels("recompute").inc(2)
        m.swap_events.labels("out").inc()
        m.swap_fallbacks.labels("budget").inc()
        m.onboard_fallbacks.labels("truncate").inc(0)
        m.copy_fails.inc(0)
        m.prefetch_issued.inc(7)
        m.prefetch_hits.inc(5)
        m.prefetch_wasted.inc(4096)
        m.prefetch_overlap.observe(0.93)
        body, _ = reg.render()
        texts.append(re.sub(r"(_created\{?[^ ]*) \S+", r"\1 T", body.decode()))
    assert texts[1] == texts[0]
    assert "dynamo_kv_offload_copy_failures_total 0.0" in texts[1]


async def wait_idle(engine, timeout=10.0):
    """Until no lane holds a slot and nothing waits (bounded)."""
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while engine.sched.num_active or engine.sched.waiting:
        assert loop.time() < end, "lane not freed"
        await asyncio.sleep(0.01)


# -- serving-environment overrides ------------------------------------------------

ENV_CASES = {
    "DYN_KV_DTYPE": ["int8", "INT8", "auto", "", "bogus"],
    "DYN_MIXED_TOKEN_BUDGET": ["7", " 12 ", "0", "x"],
    "DYN_PACKED_RAGGED": ["0", "off", "No", "1", "yes", " "],
    "DYN_PACKED_SHAPE_BUDGET": ["3", "1", "x"],
    "DYN_ASYNC_DISPATCH": ["0", "false", "1", "on", ""],
}


def _resolved(engine) -> dict:
    return {
        "DYN_KV_DTYPE": engine.kv.quantized,
        "DYN_MIXED_TOKEN_BUDGET": engine._mixed_budget,
        "DYN_PACKED_RAGGED": engine._packed,
        "DYN_PACKED_SHAPE_BUDGET": engine._packed_shapes.budget,
        "DYN_ASYNC_DISPATCH": engine._pipe_depth,
    }


@pytest.mark.parametrize("var", list(ENV_CASES))
def test_env_override_follows_jax_rule(stack, var, monkeypatch):
    """Each value of the variable resolves to what the JAX engine resolves
    it to, over a config that sets the opposite (or another) value."""
    _, jcfg, jparams, np_params = stack
    cfg = ModelConfig.tiny(vocab_size=jcfg.vocab_size)
    tparams = params_from_numpy(np_params, cfg, device="cpu")
    base = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=32,
                mixed_token_budget=9, packed_ragged=True, async_dispatch=True)
    for value in ENV_CASES[var]:
        monkeypatch.setenv(var, value)
        jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**base))
        teng = TorchEngine(cfg, tparams, EngineConfig(**base), device="cpu")
        assert _resolved(teng)[var] == _resolved(jeng)[var], (var, value)
        asyncio.run(asyncio.wait_for(teng.stop(), RUN_S))
    monkeypatch.delenv(var)
    teng = TorchEngine(cfg, tparams, EngineConfig(**base), device="cpu")
    assert _resolved(teng) == {
        "DYN_KV_DTYPE": False, "DYN_MIXED_TOKEN_BUDGET": 9, "DYN_PACKED_RAGGED": True,
        "DYN_PACKED_SHAPE_BUDGET": 16, "DYN_ASYNC_DISPATCH": 2,
    }
    asyncio.run(asyncio.wait_for(teng.stop(), RUN_S))
