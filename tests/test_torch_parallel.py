"""The port's sharding rules, grid and multi-host config against the JAX
package's ``parallel/`` (no engine here; ``test_torch_tp_serving.py``
serves through them).

* ``param_pspecs`` and ``kv_pspec`` equal JAX's PartitionSpecs leaf by
  leaf for the tiny dense (tied and untied, with bias and qk-norm), tiny
  MoE, Llama-3-70B and Mixtral presets; every leaf ``init_params`` makes
  has a rule.
* A rank's slices (``LeafSharder``) of every leaf, f32 and int8,
  concatenate back to the whole along the split axes; ``init_params`` and
  the checkpoint loader with a sharder give exactly those slices.
* ``validate_tp``, ``env_parallel_spec``, ``MultiNodeConfig`` and the
  engine's ``resolve_mesh`` behave as JAX's (the messages too).
* The memory plan per rank equals JAX's plan at tp 2, 4, 8 and ep 2 (and
  tp 2 x ep 4), for Llama-3-70B and Mixtral, bf16 and int8.
* ``assemble_shards`` rebuilds the full-width blob from head slices, and
  ``kv_shard_geometry`` is JAX's.
* Two spawned processes over a ``file://`` rendezvous run the mesh's
  collectives (all-reduce, max, all-gather, broadcast, objects).  Every
  wait there is bounded.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from dynamo_tpu.engine import memory_plan as jax_plan
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.parallel import mesh as jax_mesh
from dynamo_tpu.parallel.multihost import MultiNodeConfig as JaxMultiNodeConfig
from dynamo_tpu.parallel.sharding import kv_pspec as jax_kv_pspec
from dynamo_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from dynamo_tpu_torch.engine import memory_plan
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import resolve_mesh
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.engine.quant import QuantizedTensor
from dynamo_tpu_torch.parallel.mesh import MeshConfig, build_mesh, env_parallel_spec
from dynamo_tpu_torch.parallel.multihost import MultiNodeConfig, initialize_multihost
from dynamo_tpu_torch.parallel.sharding import (
    LeafSharder,
    assemble_shards,
    compatible_spec,
    flatten_params,
    kv_pspec,
    kv_shard_geometry,
    param_pspecs,
    shard_params,
)
from tests.test_torch_ops import _mappings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120  # bound on any spawned process
# a worker past this many memory mappings frees its JAX programs after a
# test here (this module's tests spread over every worker)
FREE_JAX_AT_MAPPINGS = 20000


@pytest.fixture(autouse=True)
def _free_jax_programs():
    """Each compiled JAX program holds memory mappings of its own, and a
    worker that keeps every program of its share of the suite can reach
    the kernel's mapping limit inside a later compile; the cheap tests
    here give every worker a point to free them."""
    yield
    if _mappings() > FREE_JAX_AT_MAPPINGS:
        jax.clear_caches()

PRESETS = {
    "tiny-dense": lambda M: M.tiny(),
    "tiny-untied": lambda M: M.tiny(tie_word_embeddings=False),
    "tiny-bias-qknorm": lambda M: M.tiny(attention_bias=True, qk_norm=True),
    "tiny-moe": lambda M: M.tiny(num_experts=4, num_experts_per_tok=2),
    "llama3-70b": lambda M: M.llama3_70b(),
    "mixtral-8x7b": lambda M: M.mixtral_8x7b(),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_pspecs_equal_jax(preset):
    jcfg, cfg = PRESETS[preset](JaxModelConfig), PRESETS[preset](ModelConfig)
    want = {path: tuple(spec) for path, spec in jax_param_pspecs(jcfg).items()}
    assert param_pspecs(cfg) == want
    assert kv_pspec(cfg) == tuple(jax_kv_pspec(jcfg))


@pytest.mark.parametrize("preset", [p for p in PRESETS if p.startswith("tiny")])
def test_every_leaf_has_a_rule(preset):
    cfg = PRESETS[preset](ModelConfig)
    leaves = flatten_params(init_params(cfg, 0, torch.device("cpu")))
    assert set(leaves) <= set(param_pspecs(cfg)), set(leaves) - set(param_pspecs(cfg))


def _reassemble(parts_by_coords, spec, sizes):
    """Concatenate a grid's slices back along the split axes (a rank off
    coordinate 0 of an axis the leaf does not split holds a replica)."""
    out = {
        c: t for c, t in parts_by_coords.items()
        if all(v == 0 for a, v in c if a not in spec or sizes[a] == 1)
    }
    for axis in ("tp", "ep"):
        if axis not in spec or sizes[axis] == 1:
            continue
        dim = spec.index(axis)
        merged = {}
        for coords, t in out.items():
            key = tuple((a, c) for a, c in coords if a != axis)
            merged.setdefault(key, []).append((dict(coords)[axis], t))
        out = {k: torch.cat([t for _, t in sorted(v, key=lambda x: x[0])], dim=dim)
               for k, v in merged.items()}
    (only,) = out.values()
    return only


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("grid", [dict(tp=2, ep=1), dict(tp=1, ep=2), dict(tp=2, ep=2)])
@pytest.mark.parametrize("preset", ["tiny-untied", "tiny-moe", "tiny-bias-qknorm"])
def test_shards_concatenate_back_to_the_whole(preset, grid, quantize):
    cfg = PRESETS[preset](ModelConfig)
    whole = flatten_params(init_params(cfg, 0, torch.device("cpu"), quantize=quantize))
    coords = [dict(tp=t, ep=e) for e in range(grid["ep"]) for t in range(grid["tp"])]
    for path, leaf in whole.items():
        spec = param_pspecs(cfg)[path]
        for part in ("q", "s") if isinstance(leaf, QuantizedTensor) else (None,):
            full = getattr(leaf, part) if part else leaf
            got = {}
            for c in coords:
                sl = LeafSharder(cfg, grid, c).take(path, leaf)
                got[tuple(sorted(c.items()))] = getattr(sl, part) if part else sl
            eff = compatible_spec(spec, full.shape, grid)
            if all(a is None for a in eff):
                assert all(torch.equal(t, full) for t in got.values()), path
                continue
            assert torch.equal(_reassemble(got, eff, grid), full), (path, part)


def test_shard_params_takes_each_ranks_slices():
    """``shard_params`` on a whole dict: every rank's leaves are its
    ``LeafSharder`` slices, and the dict carries the rank's mesh."""
    from types import SimpleNamespace

    cfg = ModelConfig.tiny(num_experts=4, tie_word_embeddings=False)
    whole = init_params(cfg, 0, torch.device("cpu"))
    for c in ({"tp": 0, "ep": 0}, {"tp": 1, "ep": 1}):
        mesh = SimpleNamespace(tp=2, ep=2, coords=c)
        got = shard_params(whole, cfg, mesh)
        assert got.mesh is mesh
        sh = LeafSharder(cfg, {"tp": 2, "ep": 2}, c)
        for path, leaf in flatten_params(whole).items():
            assert torch.equal(flatten_params(got)[path], sh.take(path, leaf)), path


def test_int8_scales_split_with_columns_and_stay_whole_on_rows():
    cfg = ModelConfig.tiny(tie_word_embeddings=False)
    whole = init_params(cfg, 0, torch.device("cpu"), quantize="int8")
    sh = LeafSharder(cfg, {"tp": 2, "ep": 1}, {"tp": 1, "ep": 0})
    wq = sh.take("layers/wq", whole["layers"]["wq"])
    wo = sh.take("layers/wo", whole["layers"]["wo"])
    half = whole["layers"]["wq"].s.shape[-1] // 2
    assert torch.equal(wq.s, whole["layers"]["wq"].s[..., half:])
    assert torch.equal(wo.s, whole["layers"]["wo"].s)  # row-parallel: whole
    assert wo.q.shape[1] == whole["layers"]["wo"].q.shape[1] // 2


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("grid", [dict(tp=2, ep=1), dict(tp=2, ep=2)])
@pytest.mark.parametrize("preset", ["tiny-untied", "tiny-moe"])
def test_init_params_with_a_sharder_draws_the_slices(preset, grid, quantize):
    cfg = PRESETS[preset](ModelConfig)
    whole = flatten_params(init_params(cfg, 3, torch.device("cpu"), quantize=quantize))
    for c in ({"tp": 1, "ep": 0}, {"tp": 0, "ep": grid["ep"] - 1}):
        sh = LeafSharder(cfg, grid, c)
        got = flatten_params(init_params(cfg, 3, torch.device("cpu"), quantize=quantize,
                                         shard=sh))
        for path, leaf in whole.items():
            want = sh.take(path, leaf)
            if isinstance(want, QuantizedTensor):
                assert torch.equal(got[path].q, want.q) and torch.equal(got[path].s, want.s)
            else:
                assert torch.equal(got[path], want), path


# -- validation and configuration ------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("heads", [(4, 2), (8, 8), (32, 8), (6, 3)])
def test_validate_tp_gives_jax_messages(tp, heads):
    jcfg = JaxModelConfig.tiny(num_heads=heads[0], num_kv_heads=heads[1])
    cfg = ModelConfig.tiny(num_heads=heads[0], num_kv_heads=heads[1])

    def outcome(c):
        try:
            c.validate_tp(tp)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(cfg) == outcome(jcfg)


@pytest.mark.parametrize("ep", [1, 2, 3, 4, 8])
def test_validate_ep_wants_an_equal_share_of_the_experts(ep):
    """An MoE's ep must divide its experts (the port carries no expert
    replication: E = 4 at ep = 3 is refused by name); a dense model has
    no experts to split."""
    moe = ModelConfig.tiny(num_experts=4, num_experts_per_tok=2)
    if 4 % ep:
        with pytest.raises(ValueError, match=f"ep={ep} does not divide num_experts=4"):
            moe.validate_ep(ep)
    else:
        moe.validate_ep(ep)
    ModelConfig.tiny().validate_ep(ep)


def test_env_parallel_spec_as_jax(monkeypatch):
    for env in ({}, {"DYN_TP": "2"}, {"DYN_TP": "1", "DYN_DP": "4"}, {"DYN_TP": " "},
                {"DYN_DP": "0"}):
        for k in ("DYN_TP", "DYN_DP"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert env_parallel_spec() == jax_mesh.env_parallel_spec()
    monkeypatch.setenv("DYN_TP", "lots")
    with pytest.raises(ValueError, match="DYN_TP"):
        env_parallel_spec()


def test_dyn_tp_env_wins_over_config(monkeypatch):
    """JAX ``test_dyn_tp_env_wins_over_config`` on the port's
    ``resolve_mesh`` (a grid, built only when the engine starts ranks)."""
    cfg = ModelConfig.tiny()
    jcfg = JaxModelConfig.tiny()
    monkeypatch.setenv("DYN_TP", "2")
    assert resolve_mesh(EngineConfig(), cfg) == MeshConfig(tp=2)
    assert JaxEngine.resolve_mesh(JaxEngineConfig(), jcfg).shape["tp"] == 2
    monkeypatch.setenv("DYN_TP", "1")
    assert resolve_mesh(EngineConfig(tp=2), cfg) is None
    monkeypatch.delenv("DYN_TP")
    assert resolve_mesh(EngineConfig(tp=2), cfg) == MeshConfig(tp=2)
    assert resolve_mesh(EngineConfig(), cfg) is None
    monkeypatch.setenv("DYN_TP", "lots")
    with pytest.raises(ValueError, match="DYN_TP"):
        resolve_mesh(EngineConfig(), cfg)
    monkeypatch.delenv("DYN_TP")
    with pytest.raises(ValueError, match="num_kv_heads"):
        resolve_mesh(EngineConfig(tp=4), cfg)
    with pytest.raises(ValueError, match="EngineConfig.dp"):
        resolve_mesh(EngineConfig(dp=2), cfg)


def test_multinode_config_from_env(monkeypatch):
    monkeypatch.setenv("DYN_NUM_NODES", "4")
    monkeypatch.setenv("DYN_NODE_RANK", "2")
    monkeypatch.setenv("DYN_LEADER_ADDR", "10.0.0.1:1234")
    cfg, jcfg = MultiNodeConfig.from_env(), JaxMultiNodeConfig.from_env()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_nodes == 4 and cfg.node_rank == 2
    assert cfg.is_multi_node and not cfg.is_leader
    assert cfg.global_rank(1, 2) == 5
    cfg.validate()


@pytest.mark.parametrize("fields", [
    dict(num_nodes=2, node_rank=2, leader_addr="x:1"),
    dict(num_nodes=2, node_rank=0),
    dict(num_nodes=0),
    dict(),
])
def test_multinode_validation_as_jax(fields):
    def outcome(c):
        try:
            c.validate()
        except ValueError as e:
            return str(e)
        return None

    assert outcome(MultiNodeConfig(**fields)) == outcome(JaxMultiNodeConfig(**fields))


def test_single_node_is_noop():
    cfg = initialize_multihost(MultiNodeConfig())
    assert not cfg.is_multi_node
    assert not torch.distributed.is_initialized()


def test_build_mesh_refusals():
    """JAX's "mesh needs N devices, have M" for NCCL ranks past the cards
    (none here); dp, and sp or pp beside another axis, refused by name."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"mesh needs {have + 1} devices, have {have}"):
        build_mesh(MeshConfig(tp=have + 1), device=torch.device("cuda"))
    for grid, match in ((dict(dp=2), "dp=2: data parallelism"),
                        (dict(sp=2, tp=2), "sp=2 with tp=2: not served"),
                        (dict(pp=2, ep=2), "pp=2 with ep=2: not served"),
                        (dict(sp=2, pp=2), "sp=2 with pp=2: not served")):
        with pytest.raises(ValueError, match=match):
            build_mesh(MeshConfig(**grid), init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="mesh needs 8 devices"):
        jax_mesh.build_mesh(jax_mesh.MeshConfig(tp=8), jax.devices()[:4])


def test_nccl_ranks_take_one_card_each(monkeypatch):
    """NCCL ranks take one card each: with too few cards a mesh over NCCL
    is refused by JAX's message, with enough ``check_devices`` passes and
    each rank gets a card of its own from the leader's on."""
    from dynamo_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 4"):
        port_mesh.check_devices(8, "nccl")
    port_mesh.check_devices(4, "nccl")
    port_mesh.check_devices(2, "gloo")
    assert port_mesh.rank_devices(torch.device("cuda:1"), 4) == [
        "cuda:1", "cuda:2", "cuda:3", "cuda:0"]
    assert port_mesh.rank_devices(torch.device("cpu"), 2) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="gloo or nccl"):
        port_mesh.check_devices(2, "mpi")


# -- memory plans -----------------------------------------------------------------

FIELDS = ("param_bytes", "kv_bytes", "scratch_bytes", "reserve_bytes", "hbm_bytes",
          "num_pages", "bytes_per_page", "detail")
CARD = 80 * 1024**3


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("grid", [dict(tp=2), dict(tp=4), dict(tp=8), dict(ep=2),
                                  dict(tp=2, ep=4)], ids=str)
@pytest.mark.parametrize("preset", ["llama3_70b", "mixtral_8x7b"])
def test_plan_per_rank_equals_jax(preset, grid, quantize):
    jcfg, cfg = getattr(JaxModelConfig, preset)(), getattr(ModelConfig, preset)()
    kw = dict(quantize=quantize, num_pages=1024, hbm_bytes=CARD, **grid)
    want, got = jax_plan.plan_memory(jcfg, **kw), memory_plan.plan_memory(cfg, **kw)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.total_bytes == want.total_bytes + got.dequant_bytes
    if quantize is None:
        assert got.dequant_bytes == 0
        assert memory_plan.max_kv_pages(cfg, hbm_bytes=CARD, **grid) == jax_plan.max_kv_pages(
            jcfg, hbm_bytes=CARD, **grid
        )


def test_plan_bytes_are_a_ranks_own():
    """The plan's params per rank are the bytes a rank's slices hold."""
    cfg = ModelConfig.tiny(num_experts=4, tie_word_embeddings=False)
    for grid in (dict(tp=2, ep=1), dict(tp=1, ep=2), dict(tp=2, ep=2)):
        for quantize in (None, "int8"):
            sh = LeafSharder(cfg, grid, {"tp": 0, "ep": 0})
            params = init_params(cfg, 0, torch.device("cpu"), quantize=quantize, shard=sh)
            from dynamo_tpu_torch.engine.quant import weight_bytes

            plan = memory_plan.plan_memory(cfg, quantize=quantize, hbm_bytes=CARD, **grid)
            assert plan.param_bytes == weight_bytes(params), (grid, quantize)


# -- export geometry ----------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_assemble_shards_rebuilds_the_blob(quantized):
    from dynamo_tpu_torch.engine.kv_cache import QuantKV

    g = torch.Generator().manual_seed(0)
    full = torch.randn((2, 2, 5, 4, 4, 16), generator=g)
    parts = list(full.split(2, dim=4))
    if quantized:
        q = (full * 10).to(torch.int8)
        s = torch.rand((2, 2, 5, 4), generator=g)
        got = assemble_shards([QuantKV(q=p, s=s) for p in q.split(2, dim=4)])
        assert torch.equal(got.q, q) and torch.equal(got.s, s)
    else:
        assert torch.equal(assemble_shards(parts), full)


def test_kv_shard_geometry_is_jaxs():
    class FakeMesh:
        tp = 2

    cfg = ModelConfig.tiny()
    assert kv_shard_geometry(FakeMesh(), cfg) == {"axis": 4, "parts": 2}
    assert kv_shard_geometry(None, cfg) is None
    FakeMesh.tp = 1
    assert kv_shard_geometry(FakeMesh(), cfg) is None


# -- the grid's collectives across processes ---------------------------------------

_RANK = textwrap.dedent(
    """
    import sys, torch
    sys.path.insert(0, {root!r})
    from dynamo_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    rank = int(sys.argv[1])
    mesh = build_mesh(MeshConfig(tp=2, ep=2), rank, init_method={init!r})
    x = torch.full((3,), float(rank + 1))
    mesh.all_reduce(x, over="tp")
    y = torch.full((2,), float(rank))
    g = mesh.all_gather(y, dim=0, over="ep")
    m = mesh.all_reduce(torch.tensor([float(rank)]), over="world", op="max")
    b = mesh.broadcast(torch.tensor([7 if rank == 0 else 0]), over="world")
    objs = mesh.gather_objects({{"rank": rank, "coords": mesh.coords}})
    print(x.tolist(), g.tolist(), m.tolist(), b.tolist(), [o["coords"] for o in objs],
          dict(mesh.counts), flush=True)
    """
)


def test_two_by_two_grid_collectives(tmp_path):
    init = f"file://{tmp_path / 'store'}"
    script = tmp_path / "rank.py"
    script.write_text(_RANK.format(root=ROOT, init=init))
    env = dict(os.environ, OMP_NUM_THREADS="1")  # four processes beside the suite's workers
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    coords = [{"ep": r // 2, "tp": r % 2} for r in range(4)]
    for r, line in enumerate(outs):
        row = 2 * (r // 2)
        want_x = [float(row + 1 + row + 2)] * 3  # the tp row's sum
        col = r % 2
        want_g = [float(col)] * 2 + [float(col + 2)] * 2  # the ep column
        assert line.startswith(
            f"{want_x} {want_g} [3.0] [7] {coords}"
        ), line
