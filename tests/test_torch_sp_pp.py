"""Sequence-parallel ring prefill (sp) and pipeline-parallel prefill (pp)
on the port, held to the JAX package (the counterparts of
``tests/test_parallel.py``'s ring and pipeline tests and
``tests/test_parallel_serving.py``'s sp and pp engines).

* The ring body (``ring_attention_chunk``, handed every K/V chunk in ring
  order) gives JAX's shard_mapped ``ring_attention_chunk`` per rank, with
  and without a sliding window, within 1e-5.
* The port's ring prefill (four ranks, threads of this process over a
  ``LocalExchange``) gives JAX's ``ring_prefill_step`` on ``MeshConfig(sp=
  4)``; the pipeline prefill gives JAX's ``pp_prefill_step`` at each (pp,
  M) of the JAX test: logits and the written pages within 1e-4, the JAX
  tests' bound (the pipeline's pages at each lane's prompt positions: past
  them the port's flash prefill writes zero rows, ROADMAP's known
  mismatches).
* Engines over sp = 2 and pp = 2 gloo ranks (one process each) give the
  greedy streams of the port's unsharded engine and of the JAX engine,
  route their full prefills (``sp_prefills``, ``pp_prefills``), and send
  the leader bytes; ``run in=http out=torch --device cpu --sp 2`` answers
  chats as an in-process engine does.

The inputs are drawn with numpy from a seed (weights: JAX's
``init_params``, crossed by ``params_from_numpy``); every wait is bounded.
"""

from __future__ import annotations

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.parallel.mesh import LocalExchange, MeshConfig
from dynamo_tpu_torch.parallel.pipeline_parallel import (
    pp_follower,
    pp_prefill_step,
    stage_params,
)
from dynamo_tpu_torch.parallel.ring_attention import (
    ring_attention_chunk,
    ring_follower,
    ring_prefill_step,
)
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)
from tests.test_torch_tp_serving import (  # noqa: F401 (fixtures)
    CHATS,
    RUN_S,
    WAIT_S,
    _serve,
    _stop,
    assert_chats_agree,
    chat,
    checkpoint,
    collect,
    tp1_chats,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

# logits and pages against JAX's (tests/test_parallel.py's own bound)
TOL = 1e-4
BASE = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=64, seed=0)


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    """Follower processes take one torch thread each, and a collective
    waits a bounded time for a lost peer."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("DYN_DIST_TIMEOUT_S", "60")


def small(**kw):
    over = dict(num_heads=4, num_kv_heads=2, hidden_size=32, head_dim=8, **kw)
    jcfg = JaxModelConfig.tiny(**over)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = ModelConfig.tiny(**over)
    return jcfg, jparams, cfg, params_from_numpy(np_params, cfg, device="cpu")


def run_ranks(leader, followers):
    """``followers`` (callables) on threads and ``leader`` here; every
    thread joined within WAIT_S, and a follower's error raised."""
    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(f,), daemon=True) for f in followers]
    for t in threads:
        t.start()
    out = leader()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a follower rank did not end"
    if errors:
        raise errors[0]
    return out


def pages_err(ref_kv, got_kv: torch.Tensor, pt: np.ndarray) -> float:
    pages = np.unique(pt)
    return float(np.abs(np.asarray(ref_kv)[:, :, pages] - got_kv.numpy()[:, :, pages]).max())


def valid_rows_err(ref_kv, got_kv: torch.Tensor, pt: np.ndarray, lens: np.ndarray) -> float:
    """The pages' rows of each lane's prompt positions.  Past a lane's
    length the flash prefill (kernel 2 and its plain version) returns zero
    rows where JAX's XLA attention averages over the prompt (ROADMAP's
    known mismatches), so a later layer's keys there differ."""
    ref, got = np.asarray(ref_kv), got_kv.numpy()
    page = ref.shape[3]
    err = 0.0
    for b, n in enumerate(lens):
        rows = lambda kv: kv[:, :, pt[b]].reshape(kv.shape[0], 2, -1, *kv.shape[4:])[:, :, :n]
        err = max(err, float(np.abs(rows(ref) - rows(got)).max()))
    assert page * pt.shape[1] >= lens.max()
    return err


# -- the ring body ----------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 11], ids=["full", "window"])
def test_ring_body_equals_jax(window):
    from dynamo_tpu.parallel.ring_attention import make_ring_attention

    sp = 4
    mesh = jax_build_mesh(JaxMeshConfig(sp=sp), jax.devices()[:sp])
    rs = np.random.RandomState(0)
    B, T, Hq, Hkv, D = 2, 32, 8, 2, 16
    q, k, v = (rs.randn(B, T, h, D).astype(np.float32) for h in (Hq, Hkv, Hkv))
    lens = np.asarray([32, 19], np.int32)
    want = np.asarray(jax.jit(make_ring_attention(mesh, "sp", window))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    C = T // sp
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for i in range(sp):
        chunks = [(tk[:, s * C:(s + 1) * C], tv[:, s * C:(s + 1) * C], s)
                  for s in ((i - step) % sp for step in range(sp))]
        got = ring_attention_chunk(tq[:, i * C:(i + 1) * C], chunks, torch.from_numpy(lens),
                                   i, window)
        assert np.abs(got.numpy() - want[:, i * C:(i + 1) * C]).max() < 1e-5


# -- the ring prefill ---------------------------------------------------------------


def test_ring_prefill_equals_jax():
    from dynamo_tpu.engine.step import prefill_step as jax_prefill_step
    from dynamo_tpu.parallel.ring_attention import ring_prefill_step as jax_ring_prefill

    jcfg, jparams, cfg, params = small()
    PAGES, PAGE, B, T, sp = 32, 8, 2, 32, 4
    rs = np.random.RandomState(0)
    tokens = rs.randint(1, cfg.vocab_size - 1, (B, T)).astype(np.int32)
    lens = np.asarray([32, 21], np.int32)
    pt = (1 + np.arange(B * (T // PAGE)).reshape(B, T // PAGE)).astype(np.int32)
    kv0 = jnp.zeros((cfg.num_layers, 2, PAGES, PAGE, cfg.num_kv_heads, cfg.head_dim),
                    jnp.float32)
    mesh = jax_build_mesh(JaxMeshConfig(sp=sp), jax.devices()[:sp])
    # each JAX step donates its pool: a fresh one each
    want_logits, want_kv = jax_ring_prefill(jparams, jcfg, jnp.zeros_like(kv0),
                                            jnp.asarray(tokens), jnp.asarray(lens),
                                            jnp.asarray(pt), mesh)
    _, plain_kv = jax_prefill_step(jparams, jcfg, jnp.zeros_like(kv0), jnp.asarray(tokens),
                                   jnp.asarray(lens), jnp.asarray(pt))

    ring = LocalExchange.group(sp)
    tok, ln = torch.from_numpy(tokens).long(), torch.from_numpy(lens).long()
    pool = torch.zeros(tuple(kv0.shape))
    logits = run_ranks(
        lambda: ring_prefill_step(params, cfg, pool, tok, ln, torch.from_numpy(pt), ring[0]),
        [lambda r=r: ring_follower(params, cfg, tok, ln, ring[r]) for r in range(1, sp)],
    )
    assert float(np.abs(logits.numpy() - np.asarray(want_logits)).max()) < TOL
    assert pages_err(want_kv, pool, pt) < TOL
    assert pages_err(plain_kv, pool, pt) < TOL
    # every follower sent the leader its chunk's K/V of each layer and its rows
    kv_bytes = cfg.num_layers * 2 * B * (T // sp) * cfg.num_kv_heads * cfg.head_dim * 4
    assert [e.to_leader for e in ring[1:]] == [kv_bytes + B * cfg.hidden_size * 4] * (sp - 1)


# -- the pipeline prefill -----------------------------------------------------------


@pytest.mark.parametrize("pp,M", [(2, 2), (4, 2), (2, 4)])
def test_pp_prefill_equals_jax(pp, M):
    from dynamo_tpu.parallel.pipeline_parallel import pp_prefill_step as jax_pp_prefill

    jcfg, jparams, cfg, params = small(num_layers=4)
    PAGES, PAGE, B, T = 64, 8, 4, 16
    rs = np.random.RandomState(0)
    tokens = rs.randint(1, cfg.vocab_size - 1, (B, T)).astype(np.int32)
    lens = np.asarray([16, 9, 12, 16], np.int32)
    pt = (1 + np.arange(B * (T // PAGE)).reshape(B, T // PAGE)).astype(np.int32)
    kv0 = jnp.zeros((cfg.num_layers, 2, PAGES, PAGE, cfg.num_kv_heads, cfg.head_dim),
                    jnp.float32)
    mesh = jax_build_mesh(JaxMeshConfig(pp=pp), jax.devices()[:pp])
    want_logits, want_kv = jax_pp_prefill(jparams, jcfg, jnp.zeros_like(kv0),
                                          jnp.asarray(tokens),
                                          jnp.asarray(lens), jnp.asarray(pt), mesh,
                                          num_microbatches=M)
    pipe = LocalExchange.group(pp)
    tok, ln = torch.from_numpy(tokens).long(), torch.from_numpy(lens).long()
    pool = torch.zeros(tuple(kv0.shape))
    stages = [stage_params(params, cfg, pp, s) for s in range(pp)]
    logits = run_ranks(
        lambda: pp_prefill_step(params, cfg, pool, tok, ln, torch.from_numpy(pt), M, pipe[0]),
        [lambda s=s: pp_follower(stages[s], cfg, tok, ln, M, pipe[s]) for s in range(1, pp)],
    )
    assert float(np.abs(logits.numpy() - np.asarray(want_logits)).max()) < TOL
    assert valid_rows_err(want_kv, pool, pt, lens) < TOL
    # a follower stage holds its layers alone
    assert all(w.shape[0] == cfg.num_layers // pp for w in stages[1]["layers"].values())


# -- engines over gloo ranks ----------------------------------------------------------

# served one at a time, then (other prompts, all in the 8-token bucket) at
# once: a prefill of four lanes, the pipeline's two microbatches of two
ALONE = [[1, 2, 3, 4, 5, 6, 7, 8], list(range(3, 20)), [9, 8, 7], [5, 1, 5, 1, 5, 1]]
TOGETHER = [[11, 12, 13, 14, 15], [21, 22, 23, 24, 25, 26, 27], [31, 32, 33, 34, 35, 36],
            [41, 42, 43, 44, 45, 46, 47, 48]]


def request(tokens, max_tokens=6) -> dict:
    return {"token_ids": list(tokens), "stop_conditions": {"max_tokens": max_tokens},
            "sampling_options": {"temperature": 0.0}, "eos_token_ids": []}


@pytest.fixture(scope="module")
def reference():
    """The tiny model's weights and the greedy streams of the port's
    unsharded engine and of the JAX engine: four requests one at a time,
    then four others at once."""
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = ModelConfig.tiny()
    reqs = ([request(p) for p in ALONE], [request(p) for p in TOGETHER])

    async def streams(engine):
        try:
            return await serve_rounds(engine, reqs)
        finally:
            await engine.stop()

    plain = TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                        EngineConfig(**BASE), device="cpu", metrics_registry=MetricsRegistry())
    port = asyncio.run(asyncio.wait_for(streams(plain), RUN_S))
    jax_engine = JaxEngine(jcfg, jparams, JaxEngineConfig(**BASE), metrics_registry=JaxRegistry())
    jax_streams = asyncio.run(asyncio.wait_for(streams(jax_engine), RUN_S))
    return cfg, np_params, reqs, port, jax_streams


async def serve_rounds(engine, reqs):
    alone, together = reqs
    return ([await collect(engine, r) for r in alone],
            list(await asyncio.gather(*[collect(engine, r) for r in together])))


@pytest.mark.parametrize("axis", ["sp", "pp"])
def test_engine_streams_equal_unsharded_and_jax(reference, axis):
    cfg, np_params, reqs, port, jax_streams = reference
    engine = TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                         EngineConfig(**BASE), device="cpu", metrics_registry=MetricsRegistry(),
                         mesh=MeshConfig(**{axis: 2}))
    assert not engine._mixed, "an sp or pp mesh pins mixed batching off"
    kept = {}

    async def body():
        try:
            got = await serve_rounds(engine, reqs)
            kept["stats"] = engine.rank_stats()
            return got
        finally:
            await engine.stop()

    got = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert got == port
    assert got == jax_streams
    routed = engine.sp_prefills if axis == "sp" else engine.pp_prefills
    assert routed >= 1 and engine.status()["mesh"][axis] == 2
    if axis == "pp":
        # the four prompts served at once prefill together: 2 microbatches
        assert engine.pp_microbatches > engine.pp_prefills
    follower = kept["stats"][1]["collectives"]
    assert follower.get("to_leader_bytes", 0) > 0 and follower.get("send", 0) > 0


def test_cli_sp2_answers_chats_like_one_engine(checkpoint, tp1_chats):
    proc = _serve("--model-path", checkpoint, "--model-name", "m", "--port", "0",
                  "--device", "cpu", "--max-seq-len", "256", "--num-pages", "64", "--sp", "2")
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving m at http://"), (line, proc.stderr.read())
        url = line.split()[3]
        got = [chat(url, t) for t in CHATS]
        assert_chats_agree(got, tp1_chats)
        assert all(g["finish"] == "length" and g["usage"]["completion_tokens"] == 6 for g in got)
    finally:
        (out, err), = _stop([proc])
    assert proc.returncode == 0, err
