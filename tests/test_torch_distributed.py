"""Distributed serving across the two packages: front ends and workers of
either package on one hub give the same greedy texts.

One hub carries two workers of the same tiny f32 model (the JAX
``init_params`` pytree; the port takes it through ``params_from_numpy``):
a port worker (``TorchEngine`` on the CPU, set up by the CLI's
``serve_worker``) registered as ``tiny-port`` and
a JAX worker (``JaxEngine``) registered as ``tiny-jax``, each with its KV
event and load-metrics publishers and an ``{ep}_embed`` endpoint.  Two
front ends watch the hub: the port's (``ModelWatcher`` + ``HttpService``,
with the ``--router-mode kv`` engine factory) and the JAX package's
(round robin).  So every pairing {port, JAX} front end x {port, JAX} worker
serves the same requests:

* greedy ``/v1/completions`` and ``/v1/chat/completions`` texts equal the
  in-process port pipeline's, in all four pairings;
* ``/v1/embeddings`` through the distributed leg equals the worker
  engine's in-process ``embed`` (within 1e-5), and an over-long input is a
  400 with the worker's reason;
* ``llmctl list`` names both models with one instance each, and
  ``llmctl remove`` deregisters one;
* when the port worker dies its model leaves ``/v1/models`` on both front
  ends and answers 404;
* ``/fleet`` and ``/fleet/metrics`` answer as the JAX service does without
  a fleet observatory (503).

Every wait is bounded; everything shuts down in ``finally``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import time

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.http.service import HttpService as JaxHttpService
from dynamo_tpu.http.service import ModelManager as JaxModelManager
from dynamo_tpu.llm.discovery import ModelWatcher as JaxModelWatcher
from dynamo_tpu.llm.embedding import EmbeddingEngine as JaxEmbeddingEngine
from dynamo_tpu.llm.kv_router.publisher import KvEventPublisher as JaxKvEventPublisher
from dynamo_tpu.llm.kv_router.publisher import WorkerMetricsPublisher as JaxMetricsPublisher
from dynamo_tpu.llm.model_card import register_llm as jax_register_llm
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.runtime.component import DistributedRuntime as JaxRuntime
from dynamo_tpu_torch.cli import kv_engine_factory, run_llmctl, serve_worker
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.http.service import HttpService, ModelManager
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.discovery import ModelWatcher
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest, CompletionRequest
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context, as_response_stream
from dynamo_tpu_torch.runtime.pipeline import link
from dynamo_tpu_torch.runtime.transports.hub import HubServer

from test_torch_frontend import http

ENGINE = dict(max_batch_size=4, max_seq_len=128, page_size=4, num_pages=128,
              mixed_token_budget=16)
MODELS = {"port": "tiny-port", "jax": "tiny-jax"}
FRONTS = ["port", "jax"]
PROMPTS = ["hello world", "tell me a story about the quick brown fox",
           "the lazy dog jumps over the quick brown fox again and again"]
MAX_TOKENS = 8
WAIT_S = 30


def bodies(model: str):
    out = []
    for p in PROMPTS:
        out.append(("completions", {"model": model, "prompt": p, "max_tokens": MAX_TOKENS}))
        out.append(("chat", {"model": model, "max_tokens": MAX_TOKENS,
                             "messages": [{"role": "user", "content": p}]}))
    return out


def text_of(kind: str, doc: dict) -> str:
    choice = doc["choices"][0]
    return choice["text"] if kind == "completions" else choice["message"]["content"]


async def reference_texts(model_dir, cfg, params) -> list:
    """The in-process port pipeline's greedy texts."""
    engine = TorchEngine(cfg, params, EngineConfig(**ENGINE), device="cpu")
    tok = Tokenizer.from_model_dir(model_dir)
    pipe = link(OpenAIPreprocessor("ref", tok), Backend(tok), engine)
    out = []
    try:
        for kind, body in bodies("ref"):
            req = (CompletionRequest if kind == "completions" else ChatCompletionRequest
                   ).from_dict(dict(body, stream=True))
            text = ""
            async for item in await as_response_stream(pipe, Context.new(req)):
                for ch in (item.data or {}).get("choices", []):
                    text += ch.get("text") or (ch.get("delta") or {}).get("content") or ""
            out.append(text)
        vectors = await engine.embed([tok.encode(p) for p in PROMPTS])
    finally:
        await engine.stop()
    return out, vectors


async def wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.02)


async def llmctl(addr: str, *argv) -> tuple:
    ns = argparse.Namespace(hub=addr, llmcmd=argv[0], name=argv[1] if len(argv) > 1 else None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = await run_llmctl(ns)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def served(model_dir):
    vocab = JaxTokenizer.from_model_dir(model_dir).vocab_size
    jcfg = JaxModelConfig.tiny(vocab_size=vocab)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = ModelConfig.tiny(vocab_size=vocab)
    tparams = params_from_numpy(np_params, cfg, device="cpu")

    async def body():
        ref, ref_vectors = await reference_texts(model_dir, cfg, tparams)
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        out = {"ref": ref, "ref_vectors": ref_vectors, "texts": {}, "embed": {},
               "too_long": {}, "models_after": {}, "gone": {}}
        closers = []
        try:
            # the port worker
            teng = TorchEngine(cfg, tparams, EngineConfig(**ENGINE), device="cpu")
            prt = await DistributedRuntime.detached(addr)
            closers.append(teng.stop)
            closers.append(prt.shutdown)
            # as `run in=dyn out=torch` sets it up
            _, ppub = await serve_worker(prt, teng, "dyn://p.backend.generate", model_dir,
                                         MODELS["port"])
            closers.append(ppub.close)
            # the JAX worker
            jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
            jrt = await JaxRuntime.detached(addr)
            closers.append(jeng.stop)
            closers.append(jrt.shutdown)
            jns = jrt.namespace("j")
            jcomp = jns.component("backend")
            jep = jcomp.endpoint("generate")
            await jep.serve(jeng)
            await jcomp.endpoint("generate_embed").serve(
                JaxEmbeddingEngine(jeng.embed, max_input_tokens=ENGINE["max_seq_len"]))
            jpub = JaxKvEventPublisher(jns, worker_id=jrt.primary_lease)
            jpub.hook(jeng)
            closers.append(jpub.close)
            await JaxMetricsPublisher(jeng.metrics).attach(jcomp)
            await jax_register_llm(jrt, jep, model_dir, model_name=MODELS["jax"],
                                   kv_block_size=ENGINE["page_size"],
                                   embed_endpoint="generate_embed")
            # the two front ends
            frt = await DistributedRuntime.detached(addr)
            closers.append(frt.shutdown)
            manager = ModelManager()
            watcher = ModelWatcher(frt, manager, engine_factory=kv_engine_factory(frt))
            await watcher.start()
            closers.append(watcher.stop)
            jfrt = await JaxRuntime.detached(addr)
            closers.append(jfrt.shutdown)
            jmanager = JaxModelManager()
            jwatcher = JaxModelWatcher(jfrt, jmanager)
            await jwatcher.start()
            closers.append(jwatcher.stop)
            services = {"port": HttpService(manager), "jax": JaxHttpService(jmanager)}
            for svc in services.values():
                await svc.start()
                closers.append(svc.stop)
            for mgr in (manager, jmanager):
                await wait_for(lambda: len(mgr.list_models()) == 2, "models not discovered")
            ports = {k: svc.address[1] for k, svc in services.items()}
            for front in FRONTS:
                for worker, model in MODELS.items():
                    texts = []
                    for kind, b in bodies(model):
                        st, _, raw = await http(ports[front], "POST", f"/v1/{kind.replace('chat', 'chat/completions')}", b)
                        assert st == 200, raw
                        texts.append(text_of(kind, json.loads(raw)))
                    out["texts"][(front, worker)] = texts
                    st, _, raw = await http(ports[front], "POST", "/v1/embeddings",
                                            {"model": model, "input": PROMPTS})
                    assert st == 200, raw
                    out["embed"][(front, worker)] = [d["embedding"] for d in json.loads(raw)["data"]]
                    st, _, raw = await http(ports[front], "POST", "/v1/embeddings",
                                            {"model": model, "input": ["hello " * 200]})
                    out["too_long"][(front, worker)] = (st, json.loads(raw))
            for front in FRONTS:
                for path in ("/fleet", "/fleet/metrics"):
                    st, _, raw = await http(ports[front], "GET", path)
                    out.setdefault("fleet", {})[(front, path)] = (st, json.loads(raw))
            out["list"] = await llmctl(addr, "list")
            out["remove"] = await llmctl(addr, "remove", MODELS["jax"])
            for mgr in (manager, jmanager):
                await wait_for(lambda: len(mgr.list_models()) == 1, "removed model still listed")
            out["list_after"] = await llmctl(addr, "list")
            # the port worker dies: its model leaves both front ends
            await ppub.close()
            await teng.stop()
            await prt.shutdown()
            for mgr in (manager, jmanager):
                await wait_for(lambda: len(mgr.list_models()) == 0, "dead worker's model listed")
            for front in FRONTS:
                st, _, raw = await http(ports[front], "GET", "/v1/models")
                out["models_after"][front] = [m["id"] for m in json.loads(raw)["data"]]
                st, _, _ = await http(ports[front], "POST", "/v1/completions",
                                      bodies(MODELS["port"])[0][1])
                out["gone"][front] = st
        finally:
            for close in reversed(closers):
                with contextlib.suppress(Exception):
                    await close()
            await hub.stop()
        return out

    return asyncio.run(asyncio.wait_for(body(), 300))


@pytest.mark.parametrize("worker", list(MODELS))
@pytest.mark.parametrize("front", FRONTS)
def test_greedy_texts_equal_across_pairings(served, front, worker):
    texts = served["texts"][(front, worker)]
    assert texts == served["ref"]
    assert all(texts)


@pytest.mark.parametrize("worker", list(MODELS))
@pytest.mark.parametrize("front", FRONTS)
def test_embeddings_through_the_distributed_leg(served, front, worker):
    got = np.array(served["embed"][(front, worker)])
    np.testing.assert_allclose(got, np.array(served["ref_vectors"]), atol=1e-5)
    st, doc = served["too_long"][(front, worker)]
    assert st == 400 and "token" in doc["error"]["message"]


def test_llmctl_lists_and_removes(served):
    rc, text = served["list"]
    assert rc == 0
    lines = sorted(text.strip().splitlines())
    assert lines == [
        "tiny-jax  instances=1  endpoint=dyn://j.backend.generate  type=backend",
        "tiny-port  instances=1  endpoint=dyn://p.backend.generate  type=backend",
    ]
    rc, text = served["remove"]
    assert rc == 0 and text.strip() == "removed 1 instance entry for 'tiny-jax'"
    rc, text = served["list_after"]
    assert rc == 0 and text.strip().startswith("tiny-port  instances=1")


@pytest.mark.parametrize("front", FRONTS)
def test_model_leaves_when_its_worker_dies(served, front):
    assert served["models_after"][front] == []
    assert served["gone"][front] == 404


@pytest.mark.parametrize("path", ["/fleet", "/fleet/metrics"])
def test_fleet_routes_answer_as_jax_without_an_observatory(served, path):
    assert served["fleet"][("port", path)] == served["fleet"][("jax", path)]
    assert served["fleet"][("port", path)][0] == 503
