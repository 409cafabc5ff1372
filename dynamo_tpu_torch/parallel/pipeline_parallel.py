"""Pipeline-parallel prefill over the ``pp`` axis (the JAX package's
``parallel/pipeline_parallel.py``, GPipe for inference, one process per
stage).

Stage ``s`` holds layers ``[s L / pp, (s + 1) L / pp)``.  A full prefill's
``B`` lanes split into ``M`` microbatches of ``B / M`` (the engine takes
``M = min(pp, B)``, as JAX's does); each stage runs its layers over every
microbatch in order and hands the activations ``[mb T, H]`` to the next
stage by send and receive, so stage ``s`` works on microbatch ``m`` while
stage ``s + 1`` works on ``m - 1``.  JAX runs every stage as one SPMD
program over ``M + pp - 1`` ticks whose bubble ticks write to trash page
0; here a stage simply waits for its input, so no tick is a bubble.
Each stage's attention is the full flash prefill
(``engine/attention.py prefill_attention_dispatch``: kernel 2 on a card,
its plain version on the CPU), once per stage layer per microbatch.

The pool.  The leader (stage 0) keeps the whole model, because decode
runs on it alone (JAX's decode on a pp mesh is replicated), and the KV
pool: its own layers' pages it writes as it goes; every other stage holds
only its layers' params and sends the leader, after its last microbatch,
its layers' K/V of every lane; the last stage also sends each lane's
last-position hidden row.  No stage sends the leader anything before its
loop ends, so the activations' sends form a chain and no two ranks wait on
each other.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..engine.attention import prefill_attention_dispatch, write_prefill_kv
from ..engine.config import ModelConfig
from ..engine.kv_cache import KVPool
from ..engine.model import (
    Params,
    embed_tokens,
    lm_logits,
    rms_norm,
    rope_cos_sin,
    transformer_layer,
)


def stage_layers(num_layers: int, pp: int, stage: int) -> Tuple[int, int]:
    """Stage ``stage``'s layers ``[lo, hi)``."""
    if num_layers % pp:
        raise ValueError(f"{num_layers} layers not divisible by pp={pp}")
    n = num_layers // pp
    return stage * n, (stage + 1) * n


def stage_params(params: Params, cfg: ModelConfig, pp: int, stage: int) -> Params:
    """A follower stage's params: its layers' slices alone (copies, so the
    whole stack can go)."""
    lo, hi = stage_layers(cfg.num_layers, pp, stage)
    return {"layers": {k: _take_layers(w, lo, hi) for k, w in params["layers"].items()}}


def _take_layers(w, lo: int, hi: int):
    from ..engine.quant import QuantizedTensor

    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(w.q[lo:hi].clone(), w.s[lo:hi].clone())
    return w[lo:hi].clone()


KVSink = Callable[[int, slice, torch.Tensor, torch.Tensor], None]


def pp_prefill_rank(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts
    seq_lens: torch.Tensor,  # [B] true prompt lengths
    num_microbatches: int,
    pipe,  # parallel.mesh.RankExchange over pp (or a LocalExchange)
    sink: KVSink,  # (layer, lanes, k [mb, T, Hkv, D], v) of every stage layer
) -> Optional[torch.Tensor]:
    """Stage ``pipe.rank``'s part of the GPipe schedule.  ``params`` hold
    either every layer (the leader) or the stage's alone.  Returns, on the
    last stage, the pre-norm hidden row of every lane's last prompt
    position ``[B, H]``; else None."""
    B, T = tokens.shape
    pp, s = pipe.size, pipe.rank
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    lo, hi = stage_layers(cfg.num_layers, pp, s)
    layers = params["layers"]
    offset = 0 if layers["wq"].shape[0] == cfg.num_layers else lo
    mb = B // M
    dev = tokens.device
    positions = torch.arange(T, device=dev).repeat(mb)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    window = cfg.sliding_window or 0
    dtype = layers["input_norm"].dtype
    rows = None
    for m in range(M):
        lanes = slice(m * mb, (m + 1) * mb)
        lens = seq_lens[lanes]
        if s == 0:
            x = embed_tokens(params, cfg, tokens[lanes].reshape(-1))
        else:
            like = torch.empty((mb * T, cfg.hidden_size), dtype=dtype, device=dev)
            x = pipe.recv(like, s - 1)

        def attn_fn(q, k, v, _pool, layer, lanes=lanes, lens=lens):
            q4, k4, v4 = (t.view(mb, T, *t.shape[1:]) for t in (q, k, v))
            sink(layer, lanes, k4, v4)
            return prefill_attention_dispatch(q4, k4, v4, lens, window).view(q.shape)

        for layer in range(lo, hi):
            lp = {name: w[layer - offset] for name, w in layers.items()}
            x = transformer_layer(lp, x, cos, sin, cfg, attn_fn, None, layer)
        if s < pp - 1:
            pipe.send(x, s + 1)
            continue
        if rows is None:
            rows = torch.empty((B, cfg.hidden_size), dtype=x.dtype, device=dev)
        last = (lens.long() - 1).clamp(0, T - 1)
        rows[lanes] = x.view(mb, T, -1)[torch.arange(mb, device=dev), last]
    return rows


def pp_follower(params: Params, cfg: ModelConfig, tokens, seq_lens, num_microbatches: int,
                pipe) -> None:
    """A follower stage's pipeline prefill: its part, then its layers' K/V
    (and, from the last stage, the lanes' last rows) to the leader."""
    B, T = tokens.shape
    lo, hi = stage_layers(cfg.num_layers, pipe.size, pipe.rank)
    dtype = params["layers"]["input_norm"].dtype
    kv = torch.empty((hi - lo, 2, B, T, cfg.num_kv_heads, cfg.head_dim), dtype=dtype,
                     device=tokens.device)

    def keep(layer, lanes, k, v):
        kv[layer - lo, 0, lanes] = k
        kv[layer - lo, 1, lanes] = v

    rows = pp_prefill_rank(params, cfg, tokens, seq_lens, num_microbatches, pipe, keep)
    pipe.send(kv, 0)
    if rows is not None:
        pipe.send(rows, 0)


def pp_prefill_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # [L, 2, num_pages, page, Hkv, D], written in place
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts
    seq_lens: torch.Tensor,  # [B] true prompt lengths
    page_table: torch.Tensor,  # [B, T // page_size]
    num_microbatches: int,
    pipe,
) -> torch.Tensor:
    """The leader's pipeline prefill (stage 0): its layers over every
    microbatch, their pages written as it goes; then every other stage's
    K/V into the pool and the last stage's rows through the final norm and
    the head.  Returns the last-token logits ``[B, V]`` f32."""
    B, T = tokens.shape

    def write(layer, lanes, k, v):
        write_prefill_kv(kv_pages, k, v, page_table[lanes], layer)

    pp_prefill_rank(params, cfg, tokens, seq_lens, num_microbatches, pipe, write)
    dtype = params["layers"]["input_norm"].dtype
    rows = None
    for stage in range(1, pipe.size):
        lo, hi = stage_layers(cfg.num_layers, pipe.size, stage)
        like = torch.empty((hi - lo, 2, B, T, cfg.num_kv_heads, cfg.head_dim), dtype=dtype,
                           device=tokens.device)
        kv = pipe.recv(like, stage)
        for layer in range(lo, hi):
            write_prefill_kv(kv_pages, kv[layer - lo, 0], kv[layer - lo, 1], page_table, layer)
        if stage == pipe.size - 1:
            rows = pipe.recv(torch.empty((B, cfg.hidden_size), dtype=dtype,
                                         device=tokens.device), stage)
    hidden = rms_norm(rows, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)
    return lm_logits(params, cfg, hidden)
