"""Sharding rules and the leader's dispatch mirror: the JAX package's
``parallel/sharding.py`` for one process per rank.

Rules.  :func:`param_pspecs` and :func:`kv_pspec` are JAX's
PartitionSpecs as plain tuples of axis names, leaf by leaf (Megatron
tensor parallelism: q/k/v column-parallel over heads, ``wo`` and
``w_down`` row-parallel, the embedding over the hidden axis, ``lm_head``
over the vocabulary; MoE experts over ``ep`` with column/row tp inside
each expert; the KV pool over kv heads).  An axis that does not divide
its dimension stays whole (JAX's ``_compatible_spec``).
:func:`shard_params` takes a rank's slice of every leaf; an int8 leaf's
scales split with its output columns and stay whole on a row-parallel
weight, as JAX's placement (and memory plan) has them.

The mirror.  JAX runs one program over every chip (GSPMD); here each rank
is a process, and the leader (global rank 0) runs the whole engine:
scheduler, decode state, sampling, commits, front end.  Its followers hold
only their shard of the params and of the KV pool.  The seam is the trunk:
every call of ``engine.step.run_trunk`` (the transformer over a flat token
axis, with the attention variant it names) and of ``engine.step.
logits_at`` (the vocabulary-sharded head over some of its rows) first
sends the followers a descriptor -- a fixed-width int64 header on the CPU
side group -- and then broadcasts its integer inputs (tokens, positions,
page tables, lengths) packed into one int64 tensor over the device group
(and a soft prompt's float rows, when there are any).  Each follower runs
the same trunk on its shard; the collectives inside it
(``engine.model``) meet the leader's.  So the followers make exactly the
leader's KV writes, in its order, and need no copy of the lane state: the
decode state, the sampling settings and the penalty histograms live on the
leader alone, and only the leader samples (from logits every tp rank holds
whole after the gather).  Export gathers (``gather_pages``) bring each
rank's head slice to the leader, which rebuilds the full-width blob in
JAX's head order (:func:`assemble_shards`).

CUDA graphs.  Every mesh runs its dispatches eagerly: gloo's collectives
cannot be captured, and NCCL (whose can) is not served yet
(``parallel.mesh``).

:class:`Follower` is a follower's loop; :class:`DispatchMirror` the
leader's sender.  A follower that dies fails the leader's next collective
(gloo reports the closed socket at once; otherwise the group's timeout).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.config import ModelConfig
from ..engine.kv_cache import KVPool, QuantKV
from ..engine.quant import QuantizedTensor
from .mesh import ParallelMesh

Spec = Tuple[Optional[str], ...]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def param_pspecs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Pytree path (``a/b``) -> the axis each dimension splits over."""
    specs: Dict[str, Spec] = {
        "embed": (None, "tp"),
        "final_norm": (None,),
        "layers/wq": (None, None, "tp"),
        "layers/wk": (None, None, "tp"),
        "layers/wv": (None, None, "tp"),
        "layers/wo": (None, "tp", None),
        "layers/input_norm": (None, None),
        "layers/post_norm": (None, None),
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tp")
    if cfg.attention_bias:
        specs["layers/bq"] = (None, "tp")
        specs["layers/bk"] = (None, "tp")
        specs["layers/bv"] = (None, "tp")
    if cfg.qk_norm:  # [L, D] per-head norms replicate
        specs["layers/q_norm"] = (None, None)
        specs["layers/k_norm"] = (None, None)
    if cfg.is_moe:
        specs["layers/router"] = (None, None, None)
        specs["layers/w_gate"] = (None, "ep", None, "tp")
        specs["layers/w_up"] = (None, "ep", None, "tp")
        specs["layers/w_down"] = (None, "ep", "tp", None)
    else:
        specs["layers/w_gate"] = (None, None, "tp")
        specs["layers/w_up"] = (None, None, "tp")
        specs["layers/w_down"] = (None, "tp", None)
    return specs


def kv_pspec(cfg: ModelConfig) -> Spec:
    """KV pages ``[L, 2, pages, page, Hkv, D]``: kv heads over tp."""
    return (None, None, None, None, "tp", None)


def compatible_spec(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """Drop the axes that do not divide their dimension (JAX's
    ``_compatible_spec``)."""
    out = []
    for i, axis in enumerate(spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        out.append(axis if axis is not None and i < len(shape) and shape[i] % n == 0 else None)
    return tuple(out)


def _slices(spec: Spec, shape: Sequence[int], sizes: Dict[str, int],
            coords: Dict[str, int]) -> Tuple[slice, ...]:
    out = []
    for dim, axis in zip(shape, compatible_spec(spec, shape, sizes)):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n == 1:
            out.append(slice(None))
        else:
            w = dim // n
            out.append(slice(coords[axis] * w, (coords[axis] + 1) * w))
    return tuple(out)


def shard_shape(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Tuple[int, ...]:
    return tuple(
        d // (sizes.get(a, 1) if a is not None else 1)
        for d, a in zip(shape, compatible_spec(spec, shape, sizes))
    )


class LeafSharder:
    """Slices leaves for one rank of a grid of ``sizes`` (``{"tp": n,
    "ep": m}``) at ``coords``.  ``layer=True`` takes one layer of a
    stacked leaf (its spec without the leading layer axis)."""

    def __init__(self, cfg: ModelConfig, sizes: Dict[str, int], coords: Dict[str, int]) -> None:
        self.specs = param_pspecs(cfg)
        self.sizes = dict(sizes)
        self.coords = dict(coords)

    def _spec(self, path: str, layer: bool) -> Spec:
        spec = self.specs.get(path, ())
        return spec[1:] if layer and path.startswith("layers/") else spec

    def take(self, path: str, x: Any, layer: bool = False, done: Tuple[str, ...] = ()) -> Any:
        """A rank's slice of ``x`` (a tensor or a ``QuantizedTensor``,
        whose scales are sliced by their own shape), contiguous; axes in
        ``done`` were sliced already."""
        spec = tuple(None if a in done else a for a in self._spec(path, layer))
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(self._cut(spec, x.q), self._cut(spec, x.s))
        return self._cut(spec, x)

    def _cut(self, spec: Spec, t: torch.Tensor) -> torch.Tensor:
        if not spec:
            return t
        sl = _slices(spec, t.shape, self.sizes, self.coords)
        if all(s == slice(None) for s in sl):
            return t
        return t[sl].contiguous()

    def shape(self, path: str, shape: Sequence[int], layer: bool = False,
              only: Optional[Tuple[str, ...]] = None) -> Tuple[int, ...]:
        """The slice's shape (splitting only the axes in ``only``, if
        given)."""
        spec = self._spec(path, layer)
        if only is not None:
            spec = tuple(a if a in only else None for a in spec)
        return tuple(shape) if not spec else shard_shape(spec, shape, self.sizes)

    def expert_range(self, cfg: ModelConfig) -> Tuple[int, int]:
        """This rank's experts ``[lo, hi)`` (all of them when ep does not
        divide the expert count)."""
        ep = self.sizes.get("ep", 1)
        if cfg.num_experts % ep:
            return 0, cfg.num_experts
        n = cfg.num_experts // ep
        return self.coords["ep"] * n, (self.coords["ep"] + 1) * n


def sharder_for(cfg: ModelConfig, mesh: ParallelMesh) -> LeafSharder:
    return LeafSharder(cfg, {"tp": mesh.tp, "ep": mesh.ep}, mesh.coords)


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


class RankParams(dict):
    """A rank's shard of the params (the nested dict the trunk reads) and
    the mesh its collectives run over; on the leader also the mirror that
    sends each trunk call to the followers first."""

    mesh: Optional[ParallelMesh] = None
    mirror: Optional["DispatchMirror"] = None


def rank_params(params: Dict[str, Any], mesh: ParallelMesh) -> RankParams:
    out = RankParams(params)
    out.mesh = mesh
    return out


def shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh: ParallelMesh) -> RankParams:
    """This rank's slice of every leaf of a whole params dict."""
    sh = sharder_for(cfg, mesh)
    flat = {p: sh.take(p, leaf) for p, leaf in flatten_params(params).items()}
    return rank_params(unflatten_params(flat), mesh)


# ---------------------------------------------------------------------------
# per-shard export
# ---------------------------------------------------------------------------


def kv_shard_geometry(mesh: Optional[ParallelMesh], cfg: ModelConfig) -> Optional[Dict[str, int]]:
    """``{"axis": 4, "parts": tp}`` for a pool sharded over kv heads, None
    for one that is not (JAX's ``kv_shard_geometry``): stamped on every KV
    blob that leaves a sharded engine."""
    if mesh is None or mesh.tp == 1 or cfg.num_kv_heads % mesh.tp:
        return None
    return {"axis": 4, "parts": mesh.tp}


def assemble_shards(parts: Sequence[KVPool], axis: int = 4) -> KVPool:
    """The full-width blob from each tp rank's head slice, in rank (= JAX
    head) order.  An int8 blob's data concatenates; its per-row scales are
    the same on every rank (each row's scale is its whole row's), so the
    first rank's stand."""
    if isinstance(parts[0], QuantKV):
        return QuantKV(q=torch.cat([p.q for p in parts], dim=axis), s=parts[0].s)
    return torch.cat(list(parts), dim=axis)


# ---------------------------------------------------------------------------
# the mirror protocol
# ---------------------------------------------------------------------------

HEADER_LEN = 128
OP_STOP, OP_TRUNK, OP_LOGITS, OP_GATHER, OP_STATS, OP_RESET, OP_POOL = range(7)
# the attention variants of ``engine.step.ATTN_KINDS``, by wire id
KIND_IDS = {"packed": 1, "decode": 2, "rect": 3, "prefill": 4, "suffix": 5, "verify": 6}
KIND_NAMES = {v: k for k, v in KIND_IDS.items()}
# wire codes of the trunk's integer inputs (0: absent)
_INT_CODES = {torch.int64: 1, torch.int32: 2, torch.bool: 3}
_INT_DTYPES = {v: k for k, v in _INT_CODES.items()}
_FLOAT_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_FLOAT_DTYPES = {v: k for k, v in _FLOAT_CODES.items()}


def _header(op: int, ints: Sequence[int] = ()) -> torch.Tensor:
    vals = [op, len(ints)] + [int(v) for v in ints]
    if len(vals) > HEADER_LEN:
        raise ValueError(f"mirror header of {len(vals)} ints (limit {HEADER_LEN})")
    h = torch.zeros(HEADER_LEN, dtype=torch.int64)
    h[: len(vals)] = torch.tensor(vals, dtype=torch.int64)
    return h


def _pack_ints(tensors: Sequence[Optional[torch.Tensor]]) -> Tuple[List[int], List[torch.Tensor]]:
    """Header fields (code, ndim, dims per tensor) and the flat int64
    parts of the present ones."""
    fields: List[int] = []
    parts: List[torch.Tensor] = []
    for t in tensors:
        if t is None:
            fields.append(0)
            continue
        fields += [_INT_CODES[t.dtype], t.dim(), *t.shape]
        parts.append(t.reshape(-1).long())
    return fields, parts


def _unpack_ints(fields: List[int], n: int, flat: torch.Tensor) -> List[Optional[torch.Tensor]]:
    out: List[Optional[torch.Tensor]] = []
    off = 0
    for _ in range(n):
        code = fields.pop(0)
        if code == 0:
            out.append(None)
            continue
        nd = fields.pop(0)
        shape = [fields.pop(0) for _ in range(nd)]
        numel = int(np.prod(shape)) if shape else 1
        t = flat[off : off + numel].view(shape)
        off += numel
        dt = _INT_DTYPES[code]
        out.append(t != 0 if dt is torch.bool else t.to(dt))
    return out


class DispatchMirror:
    """The leader's half of the seam (module docstring): each method sends
    the followers one descriptor and then takes its own part."""

    def __init__(self, mesh: ParallelMesh) -> None:
        self.mesh = mesh
        self.sent: Dict[str, int] = {}
        self.closed = False

    def _send(self, op: int, ints: Sequence[int] = ()) -> None:
        if self.closed:
            raise RuntimeError("the mesh's followers are gone")
        self.mesh.broadcast(_header(op, ints), over="side")
        name = _OP_NAMES[op]
        self.sent[name] = self.sent.get(name, 0) + 1

    def trunk(
        self,
        kind: str,
        tokens: torch.Tensor,
        positions: torch.Tensor,
        tensors: Sequence[Optional[torch.Tensor]],
        statics: Sequence[int],
        mm: Optional[Tuple[torch.Tensor, torch.Tensor]],
    ) -> None:
        fields, parts = _pack_ints([tokens, positions, *tensors, *(mm[1:] if mm else ())])
        ints = [KIND_IDS[kind], len(statics), *statics, len(tensors), int(mm is not None)]
        if mm is not None:
            ints += [_FLOAT_CODES[mm[0].dtype], *mm[0].shape]
        self._send(OP_TRUNK, ints + fields)
        self.mesh.broadcast(torch.cat(parts), over="world")
        if mm is not None:
            self.mesh.broadcast(mm[0].contiguous(), over="world")

    def logits(self, idx: Optional[torch.Tensor]) -> None:
        """Rows ``idx`` of the last trunk's hidden state go through the
        vocabulary-sharded head on the leader's tp group (nothing to send
        when the head is whole)."""
        if self.mesh.tp == 1:
            return
        self._send(OP_LOGITS, [-1 if idx is None else idx.numel()])
        if idx is not None:
            self.mesh.broadcast(idx.reshape(-1).long().contiguous(), over="tp")

    def gather_pages(
        self, pool: KVPool, page_ids: torch.Tensor, layer_ids: Optional[torch.Tensor] = None
    ) -> KVPool:
        """Pages ``page_ids`` (of layers ``layer_ids``, else all) of every
        tp rank's pool, full width on the leader."""
        from ..engine.step import gather_block_pages, gather_layer_pages

        n_layers = 0 if layer_ids is None else layer_ids.numel()
        if self.mesh.tp > 1:
            self._send(OP_GATHER, [page_ids.numel(), n_layers])
            ids = page_ids.long().reshape(-1)
            if layer_ids is not None:
                ids = torch.cat([ids, layer_ids.long().reshape(-1)])
            self.mesh.broadcast(ids.contiguous(), over="tp")
        local = (
            gather_block_pages(pool, page_ids) if layer_ids is None
            else gather_layer_pages(pool, layer_ids, page_ids)
        )
        return _gather_heads(self.mesh, local)

    # -- reads ------------------------------------------------------------------

    def rank_stats(self, own: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Every rank's :func:`rank_stats` (the leader's is ``own``)."""
        self._send(OP_STATS)
        return self.mesh.gather_objects(own)

    def reset_stats(self) -> None:
        self._send(OP_RESET)

    def rank_pools(self, own: KVPool) -> List[Any]:
        """Every rank's whole pool on the host, in rank order."""
        self._send(OP_POOL)
        return self.mesh.gather_objects(_host_pool(own))

    def stop(self) -> None:
        if not self.closed:
            try:
                self._send(OP_STOP)
            finally:
                self.closed = True


_OP_NAMES = {
    OP_STOP: "stop", OP_TRUNK: "trunk", OP_LOGITS: "logits", OP_GATHER: "gather",
    OP_STATS: "stats", OP_RESET: "reset", OP_POOL: "pool",
}


def _gather_heads(mesh: ParallelMesh, local: KVPool) -> KVPool:
    """Every tp rank's head slice of ``local``, concatenated on the head
    axis (4) on every rank of the group."""
    if mesh.tp == 1:
        return local
    if isinstance(local, QuantKV):
        return QuantKV(q=mesh.all_gather(local.q, dim=4), s=local.s)
    return mesh.all_gather(local, dim=4)


def _host_pool(pool: KVPool) -> Any:
    if isinstance(pool, QuantKV):
        return (pool.q.cpu(), pool.s.cpu())
    return pool.cpu()


def rank_stats(mesh: ParallelMesh, graphs: Optional[Dict[str, int]] = None,
               params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One rank's counters: every kernel's launches, the gathered decode
    composition's calls, the MoE dispatch's dropped assignments, its
    collectives, its graphs, its expert bytes and its peak device
    memory."""
    from ..engine import attention as att
    from ..engine.model import moe_counts
    from ..engine.quant import weight_bytes
    from ..ops import build

    out: Dict[str, Any] = {
        "rank": mesh.rank,
        "moe_drops": moe_counts(mesh.device)[1],
        "launches": {k.name: k.launches for k in build.KERNELS},
        "gathered_decode_calls": att.gathered_decode_calls,
        "collectives": dict(mesh.counts),
        "graphs": dict(graphs or {}),
    }
    if params is not None:
        layers = params["layers"]
        out["expert_bytes"] = weight_bytes(
            {k: layers[k] for k in ("w_gate", "w_up", "w_down")}
        ) if "router" in layers else 0
    if mesh.device.type == "cuda":
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(mesh.device))
    return out


def reset_rank_stats(mesh: ParallelMesh) -> None:
    from ..engine import attention as att
    from ..engine.model import moe_counts
    from ..ops import build

    for k in build.KERNELS:
        k.launches = 0
    att.gathered_decode_calls = 0
    moe_counts(mesh.device, reset=True)
    mesh.counts.clear()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)


# ---------------------------------------------------------------------------
# the follower
# ---------------------------------------------------------------------------


class Follower:
    """A follower rank's loop: receive each descriptor, run its part."""

    def __init__(self, mesh: ParallelMesh, cfg: ModelConfig, params: RankParams, pool: KVPool) -> None:
        self.mesh = mesh
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.hidden: Optional[torch.Tensor] = None

    def _recv(self) -> Tuple[int, List[int]]:
        h = torch.zeros(HEADER_LEN, dtype=torch.int64)
        self.mesh.broadcast(h, over="side")
        vals = h.tolist()
        return int(vals[0]), [int(v) for v in vals[2 : 2 + int(vals[1])]]

    def serve(self) -> None:
        """Run descriptors until the leader's stop (or a lost leader,
        which raises out of the wait)."""
        while True:
            op, ints = self._recv()
            if op == OP_STOP:
                return
            getattr(self, f"_on_{_OP_NAMES[op]}")(ints)

    def _on_trunk(self, ints: List[int]) -> None:
        from ..engine.step import run_trunk

        kind = KIND_NAMES[ints.pop(0)]
        n_st = ints.pop(0)
        statics = [ints.pop(0) for _ in range(n_st)]
        n_t = ints.pop(0)
        has_mm = ints.pop(0)
        mm_code = mm_shape = None
        if has_mm:
            mm_code = ints.pop(0)
            mm_shape = [ints.pop(0) for _ in range(3)]
        total = _payload_len(list(ints), 2 + n_t + has_mm)
        flat = torch.empty(total, dtype=torch.int64, device=self.mesh.device)
        self.mesh.broadcast(flat, over="world")
        tokens, positions, *rest = _unpack_ints(ints, 2 + n_t + has_mm, flat)
        tensors = rest[:n_t]
        mm = None
        if has_mm:
            emb = torch.empty(mm_shape, dtype=_FLOAT_DTYPES[mm_code], device=self.mesh.device)
            self.mesh.broadcast(emb, over="world")
            mm = (emb, rest[n_t])
        self.hidden = run_trunk(
            self.params, self.cfg, self.pool, kind, tokens, positions, tensors, statics, mm
        )

    def _on_logits(self, ints: List[int]) -> None:
        from ..engine.model import lm_logits

        if not self.mesh.in_leader_tp_row:
            return
        if ints[0] < 0:
            lm_logits(self.params, self.cfg, self.hidden)
            return
        idx = torch.empty(ints[0], dtype=torch.int64, device=self.mesh.device)
        self.mesh.broadcast(idx, over="tp")
        lm_logits(self.params, self.cfg, self.hidden[idx])

    def _on_gather(self, ints: List[int]) -> None:
        from ..engine.step import gather_block_pages, gather_layer_pages

        if not self.mesh.in_leader_tp_row:
            return
        n_ids, n_layers = ints
        buf = torch.empty(n_ids + n_layers, dtype=torch.int64, device=self.mesh.device)
        self.mesh.broadcast(buf, over="tp")
        ids, layers = buf[:n_ids], buf[n_ids:]
        local = (
            gather_block_pages(self.pool, ids) if not n_layers
            else gather_layer_pages(self.pool, layers, ids)
        )
        _gather_heads(self.mesh, local)

    def _on_stats(self, ints: List[int]) -> None:
        # a follower captures no graph: every mesh runs eagerly
        self.mesh.gather_objects(rank_stats(
            self.mesh, {"captures": 0, "replays": 0}, self.params
        ))

    def _on_reset(self, ints: List[int]) -> None:
        reset_rank_stats(self.mesh)

    def _on_pool(self, ints: List[int]) -> None:
        self.mesh.gather_objects(_host_pool(self.pool))


def _payload_len(fields: List[int], n: int) -> int:
    total = 0
    for _ in range(n):
        code = fields.pop(0)
        if code == 0:
            continue
        nd = fields.pop(0)
        shape = [fields.pop(0) for _ in range(nd)]
        total += int(np.prod(shape)) if shape else 1
    return total


ParamsSource = Dict[str, Any]


def build_rank_params(
    source: ParamsSource,
    cfg: ModelConfig,
    mesh: ParallelMesh,
    dtype: torch.dtype,
    whole: Optional[Dict[str, Any]] = None,
) -> RankParams:
    """This rank's params from a ``source``: ``{"kind": "random", "seed":
    s, "quantize": q}`` (``init_params``'s draws, each layer sliced as it
    is made), ``{"kind": "pretrained", "path": p, "quantize": q}`` (each
    layer read and sliced as it lands; int8 quantized whole, then sliced),
    or ``{"kind": "scatter"}``: the leader holds the whole params
    (``whole``) and broadcasts them leaf by leaf; every rank keeps its
    slice."""
    from ..engine.model import init_params
    from ..engine.weights import load_checkpoint_params

    sh = sharder_for(cfg, mesh)
    kind = source["kind"]
    if kind == "random":
        p = init_params(cfg, source["seed"], mesh.device, dtype, quantize=source.get("quantize"),
                        shard=sh)
    elif kind == "pretrained":
        p = load_checkpoint_params(source["path"], cfg, mesh.device, dtype,
                                   quantize=source.get("quantize"), shard=sh)
    elif kind == "scatter":
        p = _scatter_params(mesh, sh, whole)
    else:
        raise ValueError(f"unknown params source {kind!r}")
    return rank_params(p, mesh)


def _scatter_params(mesh: ParallelMesh, sh: LeafSharder, whole: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The leader's whole params, broadcast leaf by leaf over the world
    group; each rank keeps its slice (``whole`` on the leader only)."""
    manifest = None
    if mesh.is_leader:
        manifest = []
        for path, leaf in flatten_params(whole).items():
            parts = (leaf.q, leaf.s) if isinstance(leaf, QuantizedTensor) else (leaf,)
            manifest.append((path, [(tuple(t.shape), str(t.dtype)) for t in parts]))
    manifest = mesh.broadcast_object(manifest)
    flat: Dict[str, Any] = {}
    src = flatten_params(whole) if mesh.is_leader else {}
    for path, parts in manifest:
        got = []
        for i, (shape, dt) in enumerate(parts):
            if mesh.is_leader:
                leaf = src[path]
                t = (leaf.q, leaf.s)[i] if isinstance(leaf, QuantizedTensor) else leaf
                t = t.to(mesh.device).contiguous()
            else:
                t = torch.empty(shape, dtype=getattr(torch, dt.replace("torch.", "")),
                                device=mesh.device)
            got.append(mesh.broadcast(t, over="world"))
        leaf = QuantizedTensor(*got) if len(got) == 2 else got[0]
        flat[path] = sh.take(path, leaf)
    return unflatten_params(flat)


def make_pool(cfg: ModelConfig, mesh: ParallelMesh, num_pages: int, page_size: int,
              dtype: torch.dtype, quantized: bool) -> KVPool:
    """A follower's pool: ``[L, 2, pages, page, Hkv/tp, D]`` (and the
    int8 twin's row scales)."""
    from ..engine.kv_cache import PagedKVCache

    return PagedKVCache(cfg, num_pages, page_size, dtype, mesh.device, quantized=quantized,
                        kv_heads=cfg.num_kv_heads // mesh.tp).pages

