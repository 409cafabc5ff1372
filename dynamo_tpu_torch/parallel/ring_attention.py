"""Ring attention: the sequence-parallel prefill over the ``sp`` axis (the
JAX package's ``parallel/ring_attention.py``, one process per rank).

A full prefill's bucket ``T`` is cut into ``sp`` contiguous chunks of
``C = T / sp`` positions; rank ``i`` runs the trunk over chunk ``i`` of
every lane.  At each layer its queries attend to every rank's keys: the
K/V chunks go round the ring one hop a step (``RankExchange.rotate``, a
``batch_isend_irecv``), and the rank folds each chunk it holds into a
flash-style online softmax in f32, causal and windowed over global
positions, so chunks wholly in a query's future add nothing.  JAX computes
this body with XLA einsums outside any Pallas kernel, and so does the port
with plain torch matmuls (:func:`ring_attention_chunk`, over this rank's
queries and an iterable of ``(k, v, source)`` chunks, so the tests can
hand it every chunk in ring order in one process).

The pool.  The leader (rank 0) alone keeps lane state and the KV pool.
Each follower sends it, after the trunk, its chunk's K/V of every layer
and the hidden row of each lane whose last prompt position falls in its
chunk; the leader writes every layer's pages with ``write_prefill_kv``,
takes the final norm and the head, and samples.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, List, Tuple

import torch

from ..engine.attention import write_prefill_kv
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

_NEG_INF = -1e30


def ring_attention_chunk(
    q: torch.Tensor,  # [B, C, Hq, D] this rank's query chunk
    chunks: Iterable[Tuple[torch.Tensor, torch.Tensor, int]],  # (k, v [B, C, Hkv, D], source)
    seq_lens: torch.Tensor,  # [B] global valid length
    idx: int,  # this rank's chunk index
    window: int = 0,  # sliding-window width; 0 = full attention
) -> torch.Tensor:
    """The per-rank body: attention of chunk ``idx``'s queries over the
    K/V chunks it is handed (each with the index of the chunk it holds),
    online softmax in f32, masks over global positions.  Returns ``[B, C,
    Hq, D]`` in ``q``'s dtype."""
    B, C, Hq, D = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qpos = idx * C + torch.arange(C, device=dev)
    qf = q.float()
    lens = seq_lens.to(dev).long()
    m = torch.full((B, Hq, C, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, C, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, C, D), dtype=torch.float32, device=dev)
    for k, v, src in chunks:
        n_rep = Hq // k.shape[2]
        kpos = src * C + torch.arange(C, device=dev)
        kr = k.repeat_interleave(n_rep, dim=2).float()
        vr = v.repeat_interleave(n_rep, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
        causal = kpos[None, :] <= qpos[:, None]
        if window > 0:
            # a key further than window - 1 behind its query adds nothing,
            # whichever rank holds it
            causal = causal & (qpos[:, None] - kpos[None, :] < window)
        mask = causal[None, None] & (kpos[None, None, None, :] < lens[:, None, None, None])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, vr)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe).transpose(1, 2).to(q.dtype)


def ring_chunks(k: torch.Tensor, v: torch.Tensor, ring) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
    """This rank's K/V chunk, then each previous rank's as the ring brings
    it (one rotation between steps, none after the last)."""
    for step in range(ring.size):
        yield k, v, (ring.rank - step) % ring.size
        if step != ring.size - 1:
            k, v = ring.rotate([k, v])


def ring_prefill_rank(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts, T % sp == 0
    seq_lens: torch.Tensor,  # [B] true prompt lengths
    ring,  # parallel.mesh.RankExchange over sp (or a LocalExchange)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``ring.rank``'s part of the ring prefill: the trunk over its
    chunk of every lane.  Returns ``(rows [B, H], kv [L, 2, B, C, Hkv,
    D])``: the pre-norm hidden row of each lane whose last prompt position
    lies in this chunk (zeros for the other lanes) and the chunk's K/V of
    every layer."""
    B, T = tokens.shape
    sp, r = ring.size, ring.rank
    if T % sp:
        raise ValueError(f"prefill bucket {T} not divisible by sp={sp}")
    C = T // sp
    dev = tokens.device
    positions = (r * C + torch.arange(C, device=dev)).repeat(B)
    x = embed_tokens(params, cfg, tokens[:, r * C:(r + 1) * C].reshape(-1))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    L = cfg.num_layers
    kv = torch.empty((L, 2, B, C, cfg.num_kv_heads, cfg.head_dim), dtype=x.dtype, device=dev)
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, _pool, layer):
        q4, k4, v4 = (t.view(B, C, *t.shape[1:]) for t in (q, k, v))
        kv[layer, 0] = k4
        kv[layer, 1] = v4
        out = ring_attention_chunk(q4, ring_chunks(k4, v4, ring), seq_lens, r, window)
        return out.reshape(q.shape)

    layers = params["layers"]
    for i in range(L):
        lp = {name: w[i] for name, w in layers.items()}
        x = transformer_layer(lp, x, cos, sin, cfg, attn_fn, None, i)
    last = (seq_lens.to(dev).long() - 1).clamp(0, T - 1) - r * C
    mine = (last >= 0) & (last < C)
    rows = x.view(B, C, -1)[torch.arange(B, device=dev), last.clamp(0, C - 1)]
    return torch.where(mine[:, None], rows, torch.zeros_like(rows)), kv


def ring_follower(params: Params, cfg: ModelConfig, tokens, seq_lens, ring) -> None:
    """A follower's ring prefill: its part, then its K/V and rows to the
    leader."""
    rows, kv = ring_prefill_rank(params, cfg, tokens, seq_lens, ring)
    ring.send(kv, 0)
    ring.send(rows, 0)


def ring_prefill_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # [L, 2, num_pages, page, Hkv, D], written in place
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts, T % sp == 0
    seq_lens: torch.Tensor,  # [B] true prompt lengths
    page_table: torch.Tensor,  # [B, T // page_size]
    ring,
) -> torch.Tensor:
    """The leader's ring prefill (``engine/step.py prefill_step`` with the
    sequence cut over sp): its own part, then every follower's K/V into the
    pool and the lanes' last rows through the final norm and the head.
    Returns the last-token logits ``[B, V]`` f32."""
    B, T = tokens.shape
    rows, kv = ring_prefill_rank(params, cfg, tokens, seq_lens, ring)
    parts: List[Tuple[torch.Tensor, torch.Tensor]] = [(kv, rows)]
    for src in range(1, ring.size):
        got_kv = ring.recv(kv, src)
        parts.append((got_kv, ring.recv(rows, src)))
    for layer in range(cfg.num_layers):
        k = torch.cat([p[0][layer, 0] for p in parts], dim=1)
        v = torch.cat([p[0][layer, 1] for p in parts], dim=1)
        write_prefill_kv(kv_pages, k, v, page_table, layer)
    C = T // ring.size
    owner = (seq_lens.long() - 1).clamp(0, T - 1) // C
    stacked = torch.stack([p[1] for p in parts])  # [sp, B, H]
    hidden = stacked[owner.to(stacked.device), torch.arange(B, device=stacked.device)]
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)
    return lm_logits(params, cfg, hidden)
