"""Model-based drafter: a second (small) weight load proposing drafts.

The n-gram drafter earns its acceptance only on repetitive text; real
traffic needs a learned proposer.  :class:`ModelDrafter` runs a small
draft model greedily for ``n`` tokens over a bounded history window
(:func:`draft_greedy_tokens`): the torch rewrite of the JAX package's
``spec/model_drafter.py``, on the engine's one device (no mesh).

Design constraints, in order:

* **No KV cache.**  The draft model recomputes causal attention over the
  last ``window`` history tokens each proposal, through the plain causal
  composition (:func:`causal_attention`, the JAX drafter's XLA
  ``prefill_attention``), not a kernel.  A paged draft-KV pool would double
  the cache-management surface for a model that is supposed to be much
  smaller than the target; the recompute makes the drafter stateless, so
  preemption, swap and cancellation need no draft-side bookkeeping.
* **Bounded shapes.**  The window pads to a power-of-two bucket and the
  draft count to the verify path's own pow2 rule.
* **Proposals are hints.**  A wrong (or truncated, or stale) proposal costs
  acceptance, never output: the verify step commits only the target
  model's samples.
* **Off the dispatch path.**  ``propose`` ends in a host read of its n
  tokens.  On the card the forward runs on a stream of its own, its tokens
  come back through a pinned buffer and an event, and the host waits for
  that event alone -- never for the work the engine keeps in flight on
  its own stream.  The engine also precomputes proposals at commit
  (``SpecState.pending_draft``), so the dispatch assembly usually takes a
  list slice, not a forward.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device
from ..engine.bucketing import pow2_bucket
from ..engine.config import ModelConfig
from ..engine.kv_cache import torch_dtype
from ..engine.model import init_params, lm_logits, transformer
from .drafter import MAX_DRAFT_TOKENS

_NEG_INF = -1e30


def causal_attention(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [T, Hkv, D]
    v: torch.Tensor,  # [T, Hkv, D]
    length: int,  # valid keys (positions >= length are masked)
    window: int = 0,
) -> torch.Tensor:
    """Causal self-attention over one window from position 0, as the JAX
    package's ``engine/attention.py`` ``prefill_attention`` computes it:
    scores in the input dtype, softmax in f32, probabilities cast back."""
    T, Hq, D = q.shape
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / torch.sqrt(torch.full((), D, dtype=q.dtype, device=q.device))
    scores = torch.einsum("qhd,khd->hqk", q, k) * scale
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < length)
    if window > 0:
        mask = mask & (pos[:, None] - pos[None, :] < window)
    scores = scores.masked_fill(~mask[None], _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


def draft_greedy_tokens(
    params: Any,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] window tokens, zero-padded tail (int64)
    length: int,  # valid history tokens in the window
    n: int,  # draft count (pow2-bucketed by the caller)
) -> torch.Tensor:
    """Greedy n-token draft: each step reruns the trunk causally over the
    growing window (no KV pages: the window IS the context), takes the last
    valid position's logits, argmaxes and appends.  Returns ``[n]`` int64
    proposed tokens, on the tokens' device; no host sync."""
    T = tokens.shape[0]
    positions = torch.arange(T, device=tokens.device)
    window = cfg.sliding_window or 0
    buf = tokens.clone()
    out = []
    for step in range(n):
        cur = length + step

        def attn_fn(q, k, v, kv, layer, cur=cur):
            return causal_attention(q, k, v, cur, window)

        hidden = transformer(params, cfg, buf, positions, None, attn_fn)
        last = min(max(cur - 1, 0), T - 1)
        nxt = torch.argmax(lm_logits(params, cfg, hidden[last : last + 1]), dim=-1)
        buf[min(cur, T - 1) : min(cur, T - 1) + 1] = nxt
        out.append(nxt)
    return torch.cat(out)


class ModelDrafter:
    """The Drafter protocol over a loaded draft model (one shared instance
    per engine: ``propose`` is stateless)."""

    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        device: Optional[Union[str, torch.device]] = None,
        window: int = 64,
    ) -> None:
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.window = max(int(window), 8)
        self._stream = None

    def propose(self, history: Sequence[int], n: int) -> List[int]:
        n = min(int(n), MAX_DRAFT_TOKENS)
        if n <= 0 or not history:
            return []
        n_pad = pow2_bucket(n)  # the draft axis: {1, 2, 4, 8}
        tail = list(history[-self.window:])
        # the window bucket holds the history and the n_pad appended drafts,
        # so no drafted token is clipped out of the context
        T = pow2_bucket(len(tail) + n_pad, floor=8)
        buf = torch.zeros((T,), dtype=torch.int64)
        buf[: len(tail)] = torch.tensor(tail, dtype=torch.int64)
        if self.device.type != "cuda":
            drafted = draft_greedy_tokens(self.params, self.cfg, buf, len(tail), n_pad)
            return drafted[:n].tolist()
        if self._stream is None:
            # the draft weights were made on the current stream
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            dev_buf = buf.pin_memory().to(self.device, non_blocking=True)
            drafted = draft_greedy_tokens(self.params, self.cfg, dev_buf, len(tail), n_pad)
            host = torch.empty((n_pad,), dtype=torch.int64, pin_memory=True)
            host.copy_(drafted, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return host[:n].tolist()


def load_draft_model(
    spec: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Resolve a ``draft_model`` spec to (config, params) on ``device``.

    Grammar: a checkpoint directory (``config.json`` and ``*.safetensors``,
    read by the port's loader), or ``random[:seed]`` -- ``ModelConfig.tiny()``
    with random weights from ``seed`` (default 0) made by ``init_params``,
    which are the weights ``TorchEngine.random_init`` gives that config on
    the same device: a tiny target and its ``random`` drafter share
    weights, a perfect-drafter preset.  A GGUF file is refused: the port
    has no GGUF reader."""
    device = resolve_device(device)
    if spec.startswith("random"):
        _, _, seed_s = spec.partition(":")
        seed = int(seed_s) if seed_s else 0
        cfg = ModelConfig.tiny()
        return cfg, init_params(cfg, seed, device, torch_dtype(cfg.dtype))
    if not (
        os.path.isdir(spec) and any(f.endswith(".safetensors") for f in os.listdir(spec))
    ):
        raise FileNotFoundError(
            f"draft_model {spec!r}: not a checkpoint directory with *.safetensors"
            " (the port reads no GGUF file)"
        )
    from ..engine.weights import load_safetensors_params

    cfg = ModelConfig.from_pretrained(spec)
    return cfg, load_safetensors_params(spec, cfg, device)
