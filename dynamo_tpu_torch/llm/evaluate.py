"""Perplexity of a loaded checkpoint over a text (``dynamo-tpu-torch eval``).

The port of the JAX package's ``llm/evaluate.py``.  It scores a checkpoint
(bf16 or int8 weights, safetensors or GGUF) on real text through the same
forward the serving path runs -- ``model.transformer`` and ``lm_logits``,
attention through ``attention.prefill_attention_dispatch`` (flash prefill:
the kernel on a CUDA tensor, its plain version on a CPU tensor) over a
scratch paged KV the call discards -- so a loader or quantization
regression shows as a perplexity delta.

Method: the token stream splits into independent windows of ``window``
tokens (no overlapping stride); each window's teacher-forced NLL is summed
over positions 1..len-1, its log-softmax taken in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..engine import attention as att
from ..engine.config import ModelConfig
from ..engine.kv_cache import torch_dtype
from ..engine.model import Params, lm_logits, transformer

# the KV scatter pages the scratch buffer in pages of this many tokens
PAGE = 16
# rows whose logits one projection takes ([512, V] f32 is 263 MB over a
# 128256-id vocabulary)
LOGIT_ROWS = 512


@torch.inference_mode()
def window_nll(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [1, W] window (0-padded), W a multiple of PAGE
    length: int,  # valid tokens in the window
) -> torch.Tensor:
    """Sum of -log p(t_i | t_<i) over positions 1..length-1 (an f32
    scalar on the tokens' device): the serving trunk over a scratch KV."""
    B, W = tokens.shape
    device = tokens.device
    n_pages = W // PAGE + 2  # + trash page 0 + tail slack
    kv = torch.zeros(
        (cfg.num_layers, 2, n_pages, PAGE, cfg.num_kv_heads, cfg.head_dim),
        dtype=torch_dtype(cfg.dtype), device=device,
    )
    page_table = torch.arange(1, 1 + -(-W // PAGE), dtype=torch.int32, device=device)[None]
    positions = torch.arange(W, device=device).repeat(B)
    lens = torch.full((B,), length, dtype=torch.int32, device=device)
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, kv_pages, layer):
        q4, k4, v4 = (x.view(B, W, *x.shape[1:]) for x in (q, k, v))
        out = att.prefill_attention_dispatch(q4, k4, v4, lens, window)
        att.write_prefill_kv(kv_pages, k4, v4, page_table, layer)
        return out.view(q.shape)

    hidden = transformer(params, cfg, tokens.reshape(-1), positions, kv, attn_fn)
    targets = tokens[0, 1:length]
    total = torch.zeros((), dtype=torch.float32, device=device)
    for lo in range(0, length - 1, LOGIT_ROWS):
        hi = min(lo + LOGIT_ROWS, length - 1)
        logp = F.log_softmax(lm_logits(params, cfg, hidden[lo:hi]), dim=-1)
        total -= logp.gather(1, targets[lo:hi, None]).sum()
    return total


def evaluate_perplexity(
    params: Params,
    cfg: ModelConfig,
    token_ids: List[int],
    window: int = 512,
) -> Dict[str, float]:
    """Windowed perplexity of ``token_ids`` under the model, on the
    parameters' device."""
    # the KV scatter pages the buffer: round the window down to a page
    # multiple (floor one page) so any --window value works
    window = max(PAGE, (min(window, cfg.max_position) // PAGE) * PAGE)
    device = params["embed"].device
    ids = torch.tensor(token_ids, dtype=torch.long).to(device)
    # the windows' f32 sums add up in f64 on the device, in order (the JAX
    # package's Python float sum, bit for bit), so the host never waits
    # for a window before it launches the next
    total_nll = torch.zeros((), dtype=torch.float64, device=device)
    total_tokens = 0
    for start in range(0, len(token_ids), window):
        n = min(window, len(token_ids) - start)
        if n < 2:
            continue
        buf = torch.zeros((1, window), dtype=torch.long, device=device)
        buf[0, :n] = ids[start:start + n]
        total_nll += window_nll(params, cfg, buf, n).double()
        total_tokens += n - 1
    if total_tokens == 0:
        raise ValueError("need at least 2 tokens to score")
    avg = float(total_nll) / total_tokens
    return {
        "perplexity": math.exp(avg),
        "avg_nll": avg,
        "tokens_scored": total_tokens,
    }
