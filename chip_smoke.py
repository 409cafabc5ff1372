#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile OUT.txt]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (``nvcc``).  It imports ``dynamo_tpu_torch`` and nothing of JAX.
Every phase is fatal on failure:

1. build: every hand-written kernel builds from ``dynamo_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together; a source may hold
   several kernels); their ``-Xptxas -v`` register / shared-memory lines
   are printed, and an instantiation that spills fails the run.
2. kernels: each of the seven kernel entries against its plain PyTorch version at
   the Llama-3-8B shapes the serve phases give it (Hq=32, Hkv=8, D=128,
   page=16), with and without a sliding window, in bf16 (the main path's
   dtype) and in f32 (where a misplaced key shows): paged decode; packed
   ragged (its prefill chunk both over a resident prefix and from position
   0); the rectangle ragged layout; full flash prefill of the 2048 bucket;
   prefix-suffix flash prefill of a 476-token suffix over a 1024-token
   prefix; the int8 entries of packed and rectangle ragged at the shapes of
   their dense checks, over the int8 pool the port's ``quantize_kv_rows``
   makes of the dense check's pool.  CUDA-event times of the kernel, the
   plain version and one ``scaled_dot_product_attention`` call over the
   gathered (dequantized) K/V with the same mask (a yardstick the port
   never calls), beside the least time the card could take (bytes at 3.35
   TB/s or bf16 operations at 989 TFLOP/s, whichever is larger).  And
   ``quantize_kv_rows`` on the card gives the CPU's int8 bytes and f32
   scales bit for bit on a ``[4096, 8, 128]`` bf16 input.
3. reference: a small f32 model served on the card (kernels) and on the
   CPU (plain versions) from the same weights gives the same greedy
   streams, under the default config, ``mixed_batching=False`` (with
   chunked prefill) and ``packed_ragged=False``, with a
   ``frequency_penalty`` lane and a ``repetition_penalty`` lane in the
   batch; on the card the unpenalized lanes agree across the three.  The
   same three with ``kv_dtype="int8"``: card streams equal the CPU's.
4. serve: ``TorchEngine.random_init(ModelConfig.llama3_8b(),
   EngineConfig(num_pages=1024))`` -- full width, 32 layers, bf16, random
   weights from a seed, default engine settings (mixed batching, packed
   layout, adaptive multistep up to K=8) -- serves one request carrying a
   1024-token prefix, then 8 concurrent requests (prompts of 16 to 1500
   tokens, two sharing that prefix so they hit the prefix cache, greedy
   plus two seeded temperature lanes, max_tokens 64) through
   ``generate()``.  Every stream must finish with 64 tokens, both kernels'
   launch counts must be > 0 for this run, and a K > 1 dispatch must have
   run.  A second engine built the same way serves the same requests and
   must give identical streams.
5. serve-classic: the same model, random weights made once and shared by
   two engines: run A, ``EngineConfig(num_pages=1024,
   mixed_batching=False)``, serves the serve phase's primer and batch with
   one greedy lane carrying ``frequency_penalty=0.5`` and another
   ``repetition_penalty=1.1`` (classic prefill groups, suffix prefills on
   the prefix hits, decode blocks of 16 with penalty histograms); run B,
   ``EngineConfig(num_pages=1024, packed_ragged=False)``, serves the same
   requests without penalties (rectangle unified dispatches, decode
   blocks).  Every stream must finish with 64 tokens; kernels 1, 2 and 3
   must launch in run A, kernels 1 and 4 in run B.

6. serve-int8: the same model, random weights made once and shared by
   three engines with ``EngineConfig(num_pages=1024, kv_dtype="int8")``:
   run Q, the default config (the serve phase's), run QA,
   ``mixed_batching=False`` with run A's penalized lanes, and run QB,
   ``packed_ragged=False``.  Every stream must finish with 64 tokens; the
   int8 entry of packed ragged must launch in Q, flash prefill and
   prefix-suffix prefill in QA, the int8 entry of rectangle ragged in QB;
   paged decode and the dense ragged entries launch in none of them (an
   int8 pool's decode steps take the gathered composition, counted).

``--profile OUT.txt`` adds a last phase: the serve phase's run,
serve-classic runs A and B and serve-int8 run Q once more under
``torch.profiler``, each with
the device's idle share and its kernel time by kind (see
``profile_phase``); the full tables go to ``OUT.txt``.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the kernels' numbers as JSON.  With no CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# f32: kernel and plain version differ by the order of their sums and the
# kernel's fast exponential (a few ulp of outputs below ~4).  A key read at
# the wrong position (a window edge off by one, a dropped last page) moves
# an output by its softmax weight times |v|: some 1e-4 to 1e-2 at 512 to
# 2048 keys, far above this.
F32_TOL = 5e-5
# bf16: each side scores and normalises in f32 and rounds its output to bf16
# once.  The outputs are softmax averages of randn V rows: typically 0.03 to
# 0.1 in magnitude over 1000-2048 keys, up to ~4 for the first rows of a
# chunk that starts at position 0.  Two f32 values a hair apart can round to
# neighbouring bf16 values, one bf16 step apart: at most 2^-7 of the value.
# So |out - ref| <= BF16_ATOL + BF16_RTOL * |ref|, BF16_ATOL covering the f32
# differences before rounding (errors seen on an H100: 4.9e-4 to 2.0e-3,
# each one rounding step of the value it was seen at).
BF16_ATOL = 2e-3
BF16_RTOL = 2.0**-7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def cuda_ms(fn: Callable[[int], object], iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn(i)`` over ``iters`` calls, by CUDA events
    after a warm-up (``i`` lets a caller rotate over layers, so a call
    finds its K/V cold in L2 as the main path does)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float) -> Tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

HQ, HKV, D, PAGE, LAYERS = 32, 8, 128, 16, 32


def make_pool(
    n_pages: int, gen: torch.Generator, dtype=torch.bfloat16, layers: int = LAYERS
) -> torch.Tensor:
    return torch.randn(
        (layers, 2, n_pages, PAGE, HKV, D), generator=gen, device="cuda"
    ).to(dtype)


def f32_generator() -> torch.Generator:
    """The f32 checks' own inputs, so the bf16 inputs stay those of the
    bf16 checks whatever the f32 checks draw."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return gen


def agree(what: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Fail unless the kernel's ``out`` matches the plain version's ``ref``
    within the dtype's tolerance; returns the largest absolute error."""
    torch.cuda.synchronize()
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        ok = err <= F32_TOL
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * ref.abs()).all())
    print(f"kernels: {what} {str(out.dtype)[6:]} max_abs_err={err:.3e}")
    if not ok:
        fail(f"{what} disagrees with its plain version: max_abs_err {err}")
    return err


def int8_pool(pool: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 pool the port's rule makes of a dense one: ``(data,
    scales)``."""
    from dynamo_tpu_torch.engine.kv_cache import quantize_kv_rows

    return quantize_kv_rows(pool)


def dequantized(pq: torch.Tensor, ps: torch.Tensor, dtype) -> torch.Tensor:
    return (pq.float() * ps[..., None, None]).to(dtype)


def lane_tables(need: List[int], width: int, n_pages: int, rng) -> torch.Tensor:
    """Distinct random pool pages for each lane (page 0 stays trash)."""
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(need), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at : at + n]
        at += n
    return torch.from_numpy(table).cuda()


def sdpa_padded(q, k, v, mask):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_lanes(pool, table, bases, lanes, S):
    """The ragged kernels' yardstick operands: ``(q, k, v, mask)`` for one
    SDPA call over the lanes padded to ``[B, Hq, S, K]``, each lane's
    resident prefix (layer 0, through its table row) followed by its fresh
    rows, with the same causal-over-prefix mask.  ``lanes`` holds each
    lane's fresh ``(q [n, Hq, D], k [n, Hkv, D], v)`` rows."""
    B = len(lanes)
    K = max(bs + lq.shape[0] for bs, (lq, _, _) in zip(bases, lanes))
    dtype = lanes[0][0].dtype
    qp = torch.zeros((B, HQ, S, D), dtype=dtype, device="cuda")
    kp = torch.zeros((B, HQ, K, D), dtype=dtype, device="cuda")
    vp = torch.zeros_like(kp)
    mask = torch.zeros((B, 1, S, K), dtype=torch.bool, device="cuda")
    r = torch.arange(S, device="cuda")[:, None]
    c = torch.arange(K, device="cuda")[None, :]
    for b, (bs, (lq, lk, lv)) in enumerate(zip(bases, lanes)):
        n = lq.shape[0]
        pages = table[b, : -(-bs // PAGE)].long()
        keys = torch.cat([pool[0, 0][pages].reshape(-1, HKV, D)[:bs], lk])
        vals = torch.cat([pool[0, 1][pages].reshape(-1, HKV, D)[:bs], lv])
        qp[b, :, :n] = lq.transpose(0, 1)
        kp[b, :, : bs + n] = keys.repeat_interleave(HQ // HKV, 1).transpose(0, 1)
        vp[b, :, : bs + n] = vals.repeat_interleave(HQ // HKV, 1).transpose(0, 1)
        mask[b, 0] = (c <= bs + r) & (r < n)
    mask[:, :, :, 0] |= ~mask.any(-1)  # no fully masked row (pad rows)
    return qp, kp, vp, mask


def check_decode(pa, rng, gen) -> Dict[str, object]:
    B = 8
    kv_lens = [2048, 1791, 1500, 1203, 1024, 640, 257, 33]
    width = 2048 // PAGE
    n_pages = B * width + 1
    pool = make_pool(n_pages, gen)
    table = lane_tables([-(-n // PAGE) for n in kv_lens], width, n_pages, rng)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    err = 0.0
    for window in (0, 512):
        out = pa.paged_decode_attention(q, pool, table, lens, 3, window)
        ref = pa.paged_decode_attention_plain(q, pool, table, lens, 3, window)
        err = max(err, agree(f"paged_decode_attention window={window}", out, ref))
    # timing at the main path's shape (no window: Llama-3 has none);
    # rotating the layer keeps each launch's K/V cold in L2, as in a step
    ms = cuda_ms(lambda i: pa.paged_decode_attention(q, pool, table, lens, i % LAYERS), 64)
    plain_ms = cuda_ms(
        lambda i: pa.paged_decode_attention_plain(q, pool, table, lens, i % LAYERS), 8
    )
    # yardstick: SDPA over the gathered K/V, GQA expanded, same mask
    T = width * PAGE
    k = pool[0, 0][table.long()].reshape(B, T, HKV, D).repeat_interleave(HQ // HKV, 2)
    v = pool[0, 1][table.long()].reshape(B, T, HKV, D).repeat_interleave(HQ // HKV, 2)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    library_ms = cuda_ms(lambda i: sdpa_padded(qs, k, v, mask), 64)
    live = sum(kv_lens)
    bytes_moved = (
        2 * B * HQ * D * 2  # q in, out
        + live * HKV * D * 2 * 2  # each live K and V row once
        + table.numel() * 4 + B * 4
    )
    bound_ms, bound_by = bound(bytes_moved, 4.0 * live * HQ * D)
    del pool, k, v
    g32 = f32_generator()
    pool = make_pool(n_pages, g32, torch.float32, 4)
    q = torch.randn((B, HQ, D), generator=g32, device="cuda")
    for window in (0, 512):
        out = pa.paged_decode_attention(q, pool, table, lens, 3, window)
        ref = pa.paged_decode_attention_plain(q, pool, table, lens, 3, window)
        agree(f"paged_decode_attention window={window}", out, ref)
    del pool
    return dict(
        name="paged_decode_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="dynamo_tpu/ops/paged_attention.py:124",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def check_ragged(ra, bucketing, rng, gen) -> Tuple[Dict[str, object], Dict[str, object]]:
    # the engine's tick at the Llama-3-8B shapes: 7 decode lanes and one
    # 505-row prefill chunk over a 1024-token resident prefix (a prefix
    # hit), packed by the engine's rule (s_max = pow2, off + s_max <= Np);
    # checked also with that chunk starting at position 0.  The dense
    # entry's row, then the int8 entry's over the int8 pool of the same
    # random pool
    bases = [2047, 1790, 1499, 1202, 640, 256, 32, 1024]
    q_lens = [1, 1, 1, 1, 1, 1, 1, 505]
    B = len(bases)
    width = 2048 // PAGE
    n_pages = B * width + 1
    s_max = bucketing.pow2_bucket(max(q_lens))
    seg_off = np.cumsum([0] + q_lens[:-1])
    Np = bucketing.packed_axis_len(s_max, int(seg_off[-1]), sum(q_lens))
    pool = make_pool(n_pages, gen)
    need = [-(-(b + n) // PAGE) for b, n in zip(bases, q_lens)]
    table = lane_tables(need, width, n_pages, rng)
    i32 = dict(dtype=torch.int32, device="cuda")
    base_t = torch.tensor(bases, **i32)
    off_t = torch.tensor(seg_off.tolist(), **i32)
    ql_t = torch.tensor(q_lens, **i32)

    def rand(h):
        return torch.randn((Np, h, D), generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    base_0 = base_t.clone()
    base_0[-1] = 0

    def check(q, k, v, pool, scales=None, what="packed_ragged_attention") -> float:
        err = 0.0
        for chunk_base, bt in ((bases[-1], base_t), (0, base_0)):
            for window in (0, 512):
                lane_args = (q, k, v, pool, table, bt, off_t, ql_t)
                out = ra.packed_ragged_attention(*lane_args, s_max, 3, window, scales)
                ref = ra.packed_ragged_attention_plain(*lane_args, 3, window, scales)
                where = f"{what} chunk_base={chunk_base} window={window} Np={Np}"
                err = max(err, agree(where, out, ref))
        return err

    segs = [slice(o, o + n) for o, n in zip(seg_off.tolist(), q_lens)]
    rows = sum(q_lens)
    keys_seen = sum(bs * n + n * (n + 1) // 2 for bs, n in zip(bases, q_lens))
    other_bytes = (
        rows * HQ * D * 2  # q rows read
        + 2 * rows * HKV * D * 2  # fresh K and V rows read
        + Np * HQ * D * 2  # the whole output written
        + table.numel() * 4 + 3 * B * 4
    )
    # resident prefix positions, each read once for K and once for V
    prefix_kv = sum(bases) * 2

    def measure(pool, scales, prefix_bytes, name, source_pool) -> Dict[str, object]:
        args = (q, k, v, pool, table, base_t, off_t, ql_t)
        ms = cuda_ms(lambda i: ra.packed_ragged_attention(*args, s_max, i % LAYERS, 0, scales), 32)
        plain_ms = cuda_ms(
            lambda i: ra.packed_ragged_attention_plain(*args, i % LAYERS, 0, scales), 4
        )
        padded = sdpa_lanes(source_pool, table, bases, [(q[s], k[s], v[s]) for s in segs], s_max)
        library_ms = cuda_ms(lambda i: sdpa_padded(*padded), 32)
        del padded
        bound_ms, bound_by = bound(other_bytes + prefix_bytes, 4.0 * keys_seen * HQ * D)
        return dict(
            name=name, route="cuda",
            source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
            replaces="dynamo_tpu/ops/ragged_attention.py:527", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )

    err = check(q, k, v, pool)
    dense = dict(measure(pool, None, prefix_kv * HKV * D * 2, "packed_ragged_attention", pool),
                 max_abs_err=err)
    pq, ps = int8_pool(pool)
    del pool
    err8 = check(q, k, v, pq, ps, "packed_ragged_attention_int8")
    # int8 prefix rows plus one f32 scale per position; the yardstick
    # attends to the dequantized rows
    quant = dict(
        measure(pq, ps, prefix_kv * (HKV * D + 4), "packed_ragged_attention_int8",
                dequantized(pq[:1], ps[:1], torch.bfloat16)),
        max_abs_err=err8,
    )
    del pq, ps
    g32 = f32_generator()
    pool = make_pool(n_pages, g32, torch.float32, 4)
    f32_in = [torch.randn((Np, h, D), generator=g32, device="cuda") for h in (HQ, HKV, HKV)]
    check(*f32_in, pool)
    check(*f32_in, *int8_pool(pool), "packed_ragged_attention_int8")
    del pool
    return dense, quant


def sdpa_rows(q_rows, keys, vals, mask):
    """One SDPA call over ``[1, Hq, rows, D]`` queries and the keys
    ``[K, Hkv, D]`` expanded to every query head (outside the timed call)."""
    rep = HQ // HKV

    def heads(x):
        return x.repeat_interleave(rep, 1).transpose(0, 1)[None].contiguous()

    kh, vh = heads(keys), heads(vals)
    return lambda i: sdpa_padded(q_rows, kh, vh, mask)


def check_flash(fp, gen) -> Dict[str, object]:
    # run A's full-prefill group of the 2048 bucket: one lane of 1200
    # tokens (the batch's longest uncached prompt; the primer's 1032-token
    # prompt lands in the same bucket)
    B, T, n = 1, 2048, 1200
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")

    def rand(h, dtype=torch.bfloat16, g=gen):
        return torch.randn((B, T, h, D), generator=g, device="cuda").to(dtype)

    def check(q, k, v) -> float:
        err = 0.0
        for window in (0, 512):
            out = fp.flash_prefill_attention(q, k, v, lens, window)
            ref = fp.flash_prefill_attention_plain(q, k, v, lens, window)
            err = max(err, agree(f"flash_prefill_attention T={T} len={n} window={window}", out, ref))
        return err

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    err = check(q, k, v)
    ms = cuda_ms(lambda i: fp.flash_prefill_attention(q, k, v, lens), 16)
    plain_ms = cuda_ms(lambda i: fp.flash_prefill_attention_plain(q, k, v, lens), 4)
    r = torch.arange(n, device="cuda")[:, None]
    mask = (torch.arange(n, device="cuda")[None, :] <= r)[None, None]
    library_ms = cuda_ms(
        sdpa_rows(q[:, :n].transpose(1, 2).contiguous(), k[0, :n], v[0, :n], mask), 16
    )
    bytes_moved = (
        n * HQ * D * 2 + 2 * n * HKV * D * 2  # the valid q, k, v rows read
        + B * T * HQ * D * 2  # the whole output written
        + B * 4
    )
    flops = 4.0 * HQ * D * n * (n + 1) / 2  # causal (query, key) pairs
    bound_ms, bound_by = bound(bytes_moved, flops)
    g32 = f32_generator()
    check(*[rand(h, torch.float32, g32) for h in (HQ, HKV, HKV)])
    return dict(
        name="flash_prefill_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/flash_prefill.cu",
        replaces="dynamo_tpu/ops/flash_prefill.py:125",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def check_flash_prefix(fp, gen) -> Dict[str, object]:
    # run A's prefix hit: a 476-token suffix (bucket 512) over the cached
    # 1024-token prefix (64 pages, the page bucket of 64)
    B, T, Kp, off, n = 1, 512, 1024, 1024, 476
    offset = torch.tensor([off], dtype=torch.int32, device="cuda")
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")

    def rand(rows, h, dtype=torch.bfloat16, g=gen):
        return torch.randn((B, rows, h, D), generator=g, device="cuda").to(dtype)

    def check(q, kc, vc) -> float:
        err = 0.0
        for window in (0, 512):
            out = fp.flash_prefix_prefill_attention(q, kc, vc, offset, lens, window)
            ref = fp.flash_prefix_prefill_attention_plain(q, kc, vc, offset, lens, window)
            what = f"flash_prefix_prefill_attention T={T} Kp={Kp} len={n} window={window}"
            err = max(err, agree(what, out, ref))
        return err

    q, kc, vc = rand(T, HQ), rand(Kp + T, HKV), rand(Kp + T, HKV)
    err = check(q, kc, vc)
    ms = cuda_ms(lambda i: fp.flash_prefix_prefill_attention(q, kc, vc, offset, lens), 16)
    plain_ms = cuda_ms(
        lambda i: fp.flash_prefix_prefill_attention_plain(q, kc, vc, offset, lens), 4
    )
    keys = torch.cat([kc[0, :off], kc[0, Kp : Kp + n]])
    vals = torch.cat([vc[0, :off], vc[0, Kp : Kp + n]])
    r = torch.arange(n, device="cuda")[:, None]
    kpos = torch.cat([torch.arange(off, device="cuda"), off + torch.arange(n, device="cuda")])
    mask = (kpos[None, :] <= off + r)[None, None]
    library_ms = cuda_ms(sdpa_rows(q[:, :n].transpose(1, 2).contiguous(), keys, vals, mask), 16)
    bytes_moved = (
        n * HQ * D * 2 + 2 * (off + n) * HKV * D * 2  # q rows, prefix and suffix K/V
        + B * T * HQ * D * 2  # the whole output written
        + 2 * B * 4
    )
    flops = 4.0 * HQ * D * (n * off + n * (n + 1) / 2)
    bound_ms, bound_by = bound(bytes_moved, flops)
    g32 = f32_generator()
    check(rand(T, HQ, torch.float32, g32), rand(Kp + T, HKV, torch.float32, g32),
          rand(Kp + T, HKV, torch.float32, g32))
    return dict(
        name="flash_prefix_prefill_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/flash_prefill.cu",
        replaces="dynamo_tpu/ops/flash_prefill.py:311",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def check_rect(ra, rng, gen) -> Tuple[Dict[str, object], Dict[str, object]]:
    # the rectangle at the packed check's geometry: 7 decode lanes and one
    # 505-row chunk over a 1024-token resident prefix, S = pow2(505) = 512;
    # the dense entry's row, then the int8 entry's (as in check_ragged)
    bases = [2047, 1790, 1499, 1202, 640, 256, 32, 1024]
    q_lens = [1, 1, 1, 1, 1, 1, 1, 505]
    B, S = len(bases), 512
    width = 2048 // PAGE
    n_pages = B * width + 1
    pool = make_pool(n_pages, gen)
    table = lane_tables([-(-(b + n) // PAGE) for b, n in zip(bases, q_lens)], width, n_pages, rng)
    i32 = dict(dtype=torch.int32, device="cuda")
    base_t = torch.tensor(bases, **i32)
    ql_t = torch.tensor(q_lens, **i32)

    def rand(h, dtype=torch.bfloat16, g=gen):
        return torch.randn((B, S, h, D), generator=g, device="cuda").to(dtype)

    def check(q, k, v, pool, scales=None, what="ragged_paged_attention") -> float:
        err = 0.0
        for window in (0, 512):
            args = (q, k, v, pool, table, base_t, ql_t, 3, window, scales)
            out = ra.ragged_paged_attention(*args)
            ref = ra.ragged_paged_attention_plain(*args)
            err = max(err, agree(f"{what} S={S} window={window}", out, ref))
        return err

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    rows = sum(q_lens)
    keys_seen = sum(bs * n + n * (n + 1) // 2 for bs, n in zip(bases, q_lens))
    other_bytes = (
        rows * HQ * D * 2 + 2 * rows * HKV * D * 2  # the valid q, k, v rows read
        + B * S * HQ * D * 2  # the whole output written
        + table.numel() * 4 + 2 * B * 4
    )
    # resident prefix positions, each read once for K and once for V
    prefix_kv = sum(bases) * 2

    def measure(pool, scales, prefix_bytes, name, source_pool) -> Dict[str, object]:
        args = (q, k, v, pool, table, base_t, ql_t)
        ms = cuda_ms(lambda i: ra.ragged_paged_attention(*args, i % LAYERS, 0, scales), 32)
        plain_ms = cuda_ms(
            lambda i: ra.ragged_paged_attention_plain(*args, i % LAYERS, 0, scales), 4
        )
        padded = sdpa_lanes(
            source_pool, table, bases,
            [(q[b, :n], k[b, :n], v[b, :n]) for b, n in enumerate(q_lens)], S,
        )
        library_ms = cuda_ms(lambda i: sdpa_padded(*padded), 32)
        del padded
        bound_ms, bound_by = bound(other_bytes + prefix_bytes, 4.0 * keys_seen * HQ * D)
        return dict(
            name=name, route="cuda",
            source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
            replaces="dynamo_tpu/ops/ragged_attention.py:205", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )

    err = check(q, k, v, pool)
    dense = dict(measure(pool, None, prefix_kv * HKV * D * 2, "ragged_paged_attention", pool),
                 max_abs_err=err)
    pq, ps = int8_pool(pool)
    del pool
    err8 = check(q, k, v, pq, ps, "ragged_paged_attention_int8")
    quant = dict(
        measure(pq, ps, prefix_kv * (HKV * D + 4), "ragged_paged_attention_int8",
                dequantized(pq[:1], ps[:1], torch.bfloat16)),
        max_abs_err=err8,
    )
    del pq, ps
    g32 = f32_generator()
    pool = make_pool(n_pages, g32, torch.float32, 4)
    f32_in = [rand(h, torch.float32, g32) for h in (HQ, HKV, HKV)]
    check(*f32_in, pool)
    check(*f32_in, *int8_pool(pool), "ragged_paged_attention_int8")
    del pool
    return dense, quant


def check_quantize_rule() -> None:
    """``quantize_kv_rows`` on the card gives the CPU's int8 bytes and f32
    scales bit for bit (the JAX package's rule, which the CPU tests hold the
    port to), on bf16 rows of magnitudes 0.01 to 50 and one all-zero row."""
    from dynamo_tpu_torch.engine.kv_cache import quantize_kv_rows

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    mag = torch.logspace(-2, 1.7, 4096, device="cuda")[:, None, None]
    x = (torch.randn((4096, HKV, D), generator=gen, device="cuda") * mag).to(torch.bfloat16)
    x[100] = 0.0
    qc, sc = quantize_kv_rows(x)
    qh, sh = quantize_kv_rows(x.cpu())
    same_q = torch.equal(qc.cpu(), qh)
    same_s = torch.equal(sc.cpu().view(torch.int32), sh.view(torch.int32))
    print(f"kernels: quantize_kv_rows card == cpu: int8 {same_q}, scales {same_s}")
    if not (same_q and same_s):
        fail("quantize_kv_rows on the card differs from the CPU's")


# ---------------------------------------------------------------------------
# serving through generate()
# ---------------------------------------------------------------------------


async def serve(engine, batches: List[List[dict]]) -> List[dict]:
    """Serve each batch of requests concurrently, one batch after the
    other; returns per request its tokens, finish reason, frame times and
    time to first token."""
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(req: dict, t0: float) -> dict:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
        tokens: List[int] = []
        top: List[list] = []
        frames: List[Tuple[float, int]] = []
        finish = None
        async for item in stream:
            if item.is_error():
                raise RuntimeError(item.error_message())
            data = item.data or {}
            got = data.get("token_ids") or []
            if got:
                frames.append((time.perf_counter(), len(got)))
                tokens += got
            top += data.get("top_logprobs") or []
            finish = data.get("finish_reason") or finish
        ttft = frames[0][0] - t0 if frames else float("nan")
        return dict(tokens=tokens, finish=finish, frames=frames, ttft=ttft, top=top)

    results: List[dict] = []
    try:
        for batch in batches:
            t0 = time.perf_counter()
            results += await asyncio.gather(*[one(r, t0) for r in batch])
    finally:
        await engine.stop()
    return results


def request(tokens: List[int], max_tokens: int, **sampling) -> dict:
    return {
        "token_ids": [int(t) for t in tokens],
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": sampling,
        "eos_token_ids": [],
    }


REFERENCE_CONFIGS = {
    "default": {},
    "classic": dict(mixed_batching=False, prefill_chunk_tokens=32),
    "rectangle": dict(packed_ragged=False),
}
# each config's int8 pool twin
REFERENCE_CONFIGS.update(
    {f"{name}-int8": dict(kw, kv_dtype="int8") for name, kw in list(REFERENCE_CONFIGS.items())}
)


def reference_phase() -> None:
    """A small f32 model: greedy streams on the card (kernels) equal the
    CPU's (plain versions) from the same weights, under each of the
    reference configs, with one frequency-penalty lane and one
    repetition-penalty lane in the batch; on the card the unpenalized
    lanes agree across the dense configs (the int8 twins' agreement is
    printed: their rounding may move a token).  On a card/CPU mismatch the
    config is served once more on both with top-2 logprobs, and the margin
    between the two best tokens at the first differing token is printed
    before the run fails."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2, num_layers=2)
    ecfg = dict(num_pages=64, mixed_token_budget=32, max_seq_len=256)
    params = init_params(cfg, 3, torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(3)
    shared = rng.integers(1, cfg.vocab_size, 40).tolist()
    # the first batch runs each config's own path; in the second, the
    # penalized lanes turn every tick classic
    batches = [
        [
            request(rng.integers(1, cfg.vocab_size, 70), 12),
            request(shared + [5, 6], 12),
            request(shared + [9], 12),
            request(rng.integers(1, cfg.vocab_size, 3), 12),
        ],
        [
            request(rng.integers(1, cfg.vocab_size, 50), 12, frequency_penalty=0.7),
            request(rng.integers(1, cfg.vocab_size, 20), 12, repetition_penalty=1.3),
            request(shared + [7, 7, 7], 12),
        ],
    ]
    def run(kw, dev, reqs) -> List[dict]:
        p = {
            k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()
        }
        eng = TorchEngine(cfg, p, EngineConfig(**ecfg, **kw), device=dev)
        return asyncio.run(serve(eng, reqs))

    unpenalized = {}
    for name, kw in REFERENCE_CONFIGS.items():
        streams = {dev: [r["tokens"] for r in run(kw, dev, batches)] for dev in ("cuda", "cpu")}
        print(f"reference: {name} card {streams['cuda']}")
        if streams["cuda"] != streams["cpu"]:
            report_margin(name, streams, lambda dev, reqs: run(kw, dev, reqs), batches)
            fail(f"small-model greedy streams differ under {name}: cpu {streams['cpu']}")
        if not all(len(t) == 12 for t in streams["cuda"]):
            fail(f"small-model streams under {name} end early")
        unpenalized[name] = streams["cuda"][:4] + streams["cuda"][6:]
    for pool in ("dense", "int8"):
        group = {n: v for n, v in unpenalized.items() if n.endswith("-int8") == (pool == "int8")}
        agree_all = len({json.dumps(v) for v in group.values()}) == 1
        print(f"reference: unpenalized lanes agree across the {pool} configs: {agree_all}")
        if pool == "dense" and not agree_all:
            fail(f"the unpenalized lanes differ across configs: {group}")


def report_margin(name: str, streams, run, batches) -> None:
    """Print, for the first token where the card's stream leaves the
    CPU's, each device's top-2 logprobs there (served once more with
    ``logprobs=2``)."""
    flat = [r for batch in batches for r in batch]
    i, j = next(
        (i, next(j for j, (a, b) in enumerate(zip(c, h)) if a != b))
        for i, (c, h) in enumerate(zip(streams["cuda"], streams["cpu"]))
        if c != h
    )
    with_lp = [
        [dict(r, sampling_options=dict(r["sampling_options"], logprobs=2)) for r in batch]
        for batch in batches
    ]
    for dev in ("cuda", "cpu"):
        top = run(dev, with_lp)[i]["top"]
        print(f"reference: {name} {dev} request {i} token {j} top-2 logprobs "
              f"{top[j] if j < len(top) else None} (prompt {len(flat[i]['token_ids'])} tokens)")


def serve_requests(vocab: int) -> Tuple[List[dict], List[dict]]:
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, vocab, 1024)

    def toks(n):
        return rng.integers(1, vocab, n)

    primer = [request(np.concatenate([prefix, toks(8)]), 4)]
    mt = 64
    batch = [
        request(np.concatenate([prefix, toks(40)]), mt),
        request(np.concatenate([prefix, toks(476)]), mt),
        request(toks(16), mt),
        request(toks(64), mt),
        request(toks(200), mt, temperature=0.8, seed=7),
        request(toks(500), mt),
        request(toks(900), mt, temperature=1.0, seed=11),
        request(toks(1200), mt),
    ]
    return primer, batch


def serve_phase(kernels, card: str) -> Dict[str, object]:
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    runs = []
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024), seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if run == 0:
            for k in kernels:
                k.launches = 0
        t0 = time.perf_counter()
        res = asyncio.run(serve(engine, [primer, batch]))
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        by_k = dict(engine.dispatches_by_k)
        hits = engine.metrics().gpu_prefix_cache_hit_rate
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        out = res[1:]
        check_streams(f"serve run {run}", res, cfg.vocab_size)
        st = served_stats(res, wall)
        print(
            f"serve: run {run} init_s={init_s:.3f} wall_s={wall:.3f} "
            f"dispatches_by_k={by_k} prefix_hit_rate={hits:.4f} "
            f"tok_s={st['tok_s']:.3f} decode_phase_tok_s={st['dec']:.3f} "
            f"peak_mem_gib={peak_gib:.3f} on {card}"
        )
        print(
            "serve: run %d ttft_ms=%s" % (run, [round(r["ttft"] * 1e3, 3) for r in out])
        )
        runs.append(dict(
            streams=[r["tokens"] for r in out], launches=launches, by_k=by_k, wall=wall
        ))
    first = runs[0]
    print(f"serve: launches on the main path {first['launches']}")
    for name, n in first["launches"].items():
        if n <= 0:
            fail(f"{name} never launched on the main path")
    if not any(k > 1 and n > 0 for k, n in first["by_k"].items()):
        fail("no multistep (K > 1) dispatch ran")
    if runs[1]["streams"] != first["streams"]:
        fail("the second run's streams differ from the first's")
    return first


def served_stats(res: List[dict], wall: float) -> Dict[str, float]:
    """End to end: every generated token (primer and batch) over the run's
    wall time, prefills included; decode phase only: tokens streamed once
    every request of the batch had its first one, over that window."""
    out = res[1:]
    t_all = max(r["frames"][0][0] for r in out)
    t_end = max(r["frames"][-1][0] for r in out)
    n_dec = sum(n for r in out for t, n in r["frames"] if t > t_all)
    return dict(
        tok_s=sum(len(r["tokens"]) for r in res) / wall,
        dec=n_dec / (t_end - t_all) if t_end > t_all else float("nan"),
    )


def check_streams(what: str, res: List[dict], vocab: int) -> None:
    for i, r in enumerate(res[1:]):
        if len(r["tokens"]) != 64 or r["finish"] != "length":
            fail(f"{what} request {i}: {len(r['tokens'])} tokens, finish {r['finish']}")
        if not all(0 <= t < vocab for t in r["tokens"]):
            fail(f"{what} request {i}: token out of range")


def penalized_requests(batch: List[dict]) -> List[dict]:
    """Run A's batch: two greedy lanes carry a frequency and a repetition
    penalty."""
    penalized = [dict(r, sampling_options=dict(r["sampling_options"])) for r in batch]
    penalized[2]["sampling_options"]["frequency_penalty"] = 0.5
    penalized[5]["sampling_options"]["repetition_penalty"] = 1.1
    return penalized


def serve_classic_phase(
    kernels, card: str
) -> Tuple[Dict[str, Dict[str, int]], Dict[str, float]]:
    """Run A (classic, two penalized lanes) and run B (rectangle) at
    Llama-3-8B width on one set of random weights; returns each run's
    kernel launches and wall time."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    runs = {
        "A": (dict(mixed_batching=False), penalized_requests(batch),
              ("paged_decode_attention", "flash_prefill_attention",
               "flash_prefix_prefill_attention")),
        "B": (dict(packed_ragged=False), batch,
              ("paged_decode_attention", "ragged_paged_attention")),
    }
    launches: Dict[str, Dict[str, int]] = {}
    walls: Dict[str, float] = {}
    for run, (kw, reqs, needed) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = asyncio.run(serve(engine, [primer, reqs]))
        walls[run] = wall = time.perf_counter() - t0
        launches[run] = {k.name: k.launches for k in kernels}
        kinds = dict(engine.dispatches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        check_streams(f"serve-classic run {run}", res, cfg.vocab_size)
        st = served_stats(res, wall)
        print(
            f"serve-classic: run {run} {kw} wall_s={wall:.3f} "
            f"dispatches_by_kind={kinds} tok_s={st['tok_s']:.3f} "
            f"decode_phase_tok_s={st['dec']:.3f} peak_mem_gib={peak_gib:.3f} on {card}"
        )
        print(
            "serve-classic: run %s ttft_ms=%s"
            % (run, [round(r["ttft"] * 1e3, 3) for r in res[1:]])
        )
        print(f"serve-classic: run {run} launches {launches[run]}")
        for name in needed:
            if launches[run][name] <= 0:
                fail(f"{name} never launched in serve-classic run {run}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, walls


def serve_int8_phase(
    kernels, card: str
) -> Tuple[Dict[str, Dict[str, int]], Dict[str, float]]:
    """Runs Q (default config), QA (classic, run A's penalized lanes) and
    QB (rectangle) over the int8 pool at Llama-3-8B width on one set of
    random weights; returns each run's kernel launches and wall time."""
    from dynamo_tpu_torch.engine import attention as att
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    runs = {
        "Q": ({}, batch, ("packed_ragged_attention_int8",)),
        "QA": (dict(mixed_batching=False), penalized_requests(batch),
               ("flash_prefill_attention", "flash_prefix_prefill_attention")),
        "QB": (dict(packed_ragged=False), batch, ("ragged_paged_attention_int8",)),
    }
    # the dense pool's attention kernels: an int8 pool reaches none of them
    dense_only = ("paged_decode_attention", "packed_ragged_attention", "ragged_paged_attention")
    launches: Dict[str, Dict[str, int]] = {}
    walls: Dict[str, float] = {}
    for run, (kw, reqs, needed) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, kv_dtype="int8", **kw))
        pool_bytes, pool_nbytes = engine.kv.pool_bytes, engine.kv.pages.nbytes
        if pool_bytes != pool_nbytes:
            fail(f"serve-int8 run {run}: pool_bytes {pool_bytes} != the tensors' {pool_nbytes}")
        for k in kernels:
            k.launches = 0
        att.gathered_decode_calls = 0
        t0 = time.perf_counter()
        res = asyncio.run(serve(engine, [primer, reqs]))
        walls[run] = wall = time.perf_counter() - t0
        launches[run] = {k.name: k.launches for k in kernels}
        gathered = att.gathered_decode_calls
        kinds, by_k = dict(engine.dispatches), dict(engine.dispatches_by_k)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        check_streams(f"serve-int8 run {run}", res, cfg.vocab_size)
        st = served_stats(res, wall)
        print(
            f"serve-int8: run {run} {kw} wall_s={wall:.3f} dispatches_by_kind={kinds} "
            f"dispatches_by_k={by_k} tok_s={st['tok_s']:.3f} "
            f"decode_phase_tok_s={st['dec']:.3f} peak_mem_gib={peak_gib:.3f} "
            f"pool_bytes={pool_bytes} gathered_decode_calls={gathered} on {card}"
        )
        print(
            "serve-int8: run %s ttft_ms=%s"
            % (run, [round(r["ttft"] * 1e3, 3) for r in res[1:]])
        )
        print(f"serve-int8: run {run} launches {launches[run]}")
        for name in needed:
            if launches[run][name] <= 0:
                fail(f"{name} never launched in serve-int8 run {run}")
        for name in dense_only:
            if launches[run][name] != 0:
                fail(f"{name} launched {launches[run][name]} times over the int8 pool in run {run}")
        if gathered <= 0:
            fail(f"no gathered decode call in serve-int8 run {run}")
        if run == "Q" and not any(k > 1 and n > 0 for k, n in by_k.items()):
            fail("no multistep (K > 1) dispatch ran in serve-int8 run Q")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, walls


def profile_phase(out_path: str, plain_walls: Dict[str, float]) -> None:
    """``--profile OUT.txt``: each served cell once more under
    ``torch.profiler`` -- the serve phase's run, serve-classic runs A and B
    and serve-int8 run Q, the same configs and requests on one set of
    random weights; prints
    per cell the device's busy and idle share of the run's wall time and
    its kernel time by kind and by name, and writes the full tables to
    ``out_path``.  The profiler slows the host, so the idle share it shows
    is an upper bound; ``idle_share_est`` sets the profiled busy time
    against ``plain_walls[cell]``, the wall time of the cell's unprofiled
    run in this call (an estimate that assumes the profiler leaves device
    times as they are)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    cells = {
        "serve": ({}, batch),
        "A": (dict(mixed_batching=False), penalized_requests(batch)),
        "B": (dict(packed_ragged=False), batch),
        "Q": (dict(kv_dtype="int8"), batch),
    }
    kinds = {
        "paged_decode_attention": ("paged_decode_kernel",),
        "ragged_attention": ("ragged_kernel",),
        "flash_prefill": ("flash_kernel",),
        "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
    }
    tables = []
    for cell, (kw, reqs) in cells.items():
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            asyncio.run(serve(engine, [primer, reqs]))
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        del engine
        kernels = sorted(
            (
                (e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            ),
            reverse=True,
        )
        if not kernels:
            fail(f"the profiler recorded no device time in cell {cell}")
        by_kind: Dict[str, float] = {}
        for ms, _, name in kernels:
            kind = next(
                (k for k, keys in kinds.items() if any(x in name for x in keys)), "other"
            )
            by_kind[kind] = round(by_kind.get(kind, 0.0) + ms, 3)
        busy_ms = sum(ms for ms, _, _ in kernels)
        plain_ms = plain_walls[cell] * 1e3
        print(
            f"profile: {cell} {kw} wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
            f"idle_share={1.0 - busy_ms / wall_ms:.4f} "
            f"unprofiled_wall_ms={plain_ms:.3f} "
            f"idle_share_est={1.0 - busy_ms / plain_ms:.4f} by_kind_ms={by_kind}"
        )
        for ms, n, name in kernels[:8]:
            print(f"profile: {cell} {ms:.3f} ms over {n} launches: {name[:100]}")
        tables.append(
            f"== {cell} {kw}\n"
            + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
        )
        del prof
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n\n".join(tables))
    del params
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    args = sys.argv[1:]
    profile_out = None
    if args:
        if len(args) != 2 or args[0] != "--profile":
            fail("usage: python3 chip_smoke.py [--profile OUT.txt]")
        profile_out = args[1]
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, ROOT)
    try:
        from dynamo_tpu_torch.engine import bucketing
        from dynamo_tpu_torch.ops import build
        from dynamo_tpu_torch.ops import flash_prefill as fp
        from dynamo_tpu_torch.ops import paged_attention as pa
        from dynamo_tpu_torch.ops import ragged_attention as ra
    except ImportError as e:
        fail(f"dynamo_tpu_torch is not importable beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} torch {torch.__version__} cuda {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    # the main path's kernels (the serve phase), the classic and rectangle
    # paths' (the serve-classic phase) and the int8 pool's entries (the
    # serve-int8 phase)
    main_kernels = [pa.KERNEL, ra.KERNEL]
    kernels = main_kernels + [
        fp.KERNEL, fp.PREFIX_KERNEL, ra.RECT_KERNEL, ra.INT8_KERNEL, ra.RECT_INT8_KERNEL,
    ]
    for name, lines in build.build_all(kernels).items():
        for ln in lines:
            print(f"build: {name}: {ln}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                fail(f"{name} spills: {ln}")
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [check_decode(pa, rng, gen), check_flash(fp, gen), check_flash_prefix(fp, gen)]
    rect, rect8 = check_rect(ra, rng, gen)
    packed, packed8 = check_ragged(ra, bucketing, rng, gen)
    rows += [rect, packed, rect8, packed8]
    check_quantize_rule()
    for r in rows:
        print(
            f"kernels: {r['name']} ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) on {card}"
        )
    gc.collect()
    torch.cuda.empty_cache()

    reference_phase()
    served = serve_phase(main_kernels, card)
    classic, classic_walls = serve_classic_phase(kernels, card)
    quant, quant_walls = serve_int8_phase(kernels, card)
    if profile_out is not None:
        profile_phase(
            profile_out, {"serve": served["wall"], **classic_walls, "Q": quant_walls["Q"]}
        )
    # each kernel's launches from the phase that runs it
    launches = {
        "paged_decode_attention": served["launches"]["paged_decode_attention"],
        "packed_ragged_attention": served["launches"]["packed_ragged_attention"],
        "flash_prefill_attention": classic["A"]["flash_prefill_attention"],
        "flash_prefix_prefill_attention": classic["A"]["flash_prefix_prefill_attention"],
        "ragged_paged_attention": classic["B"]["ragged_paged_attention"],
        "packed_ragged_attention_int8": quant["Q"]["packed_ragged_attention_int8"],
        "ragged_paged_attention_int8": quant["QB"]["ragged_paged_attention_int8"],
    }
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
