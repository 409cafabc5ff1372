#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile OUT.txt]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (``nvcc``).  It imports ``dynamo_tpu_torch`` and nothing of JAX.
Every phase is fatal on failure:

1. build: both hand-written kernels build from ``dynamo_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together); their ``-Xptxas -v``
   register / shared-memory lines are printed.
2. kernels: each kernel against its plain PyTorch version at the
   Llama-3-8B shapes the main path gives it (Hq=32, Hkv=8, D=128,
   page=16), with and without a sliding window (the packed kernel's
   prefill chunk both over a resident prefix and from position 0), in bf16
   (the main path's dtype) and in f32 (where a misplaced key shows);
   CUDA-event times of the kernel, the plain version and one
   ``scaled_dot_product_attention`` call over the gathered K/V (a
   yardstick the port never calls), beside the least time the card could
   take (bytes at 3.35 TB/s or bf16 operations at 989 TFLOP/s, whichever
   is larger).
3. reference: a small f32 model served on the card (kernels) and on the
   CPU (plain versions) from the same weights gives the same greedy
   streams.
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

``--profile OUT.txt`` adds a fifth phase: the serve phase's requests once
more under ``torch.profiler``, with the device's idle share and its kernel
time by kind (see ``profile_phase``); the full table goes to ``OUT.txt``.

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


def check_ragged(ra, bucketing, rng, gen) -> Dict[str, object]:
    # the engine's tick at the Llama-3-8B shapes: 7 decode lanes and one
    # 505-row prefill chunk over a 1024-token resident prefix (a prefix
    # hit), packed by the engine's rule (s_max = pow2, off + s_max <= Np);
    # checked also with that chunk starting at position 0
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
    args = (q, k, v, pool, table, base_t, off_t, ql_t)
    base_0 = base_t.clone()
    base_0[-1] = 0

    def check(q, k, v, pool) -> float:
        err = 0.0
        for chunk_base, bt in ((bases[-1], base_t), (0, base_0)):
            for window in (0, 512):
                lane_args = (q, k, v, pool, table, bt, off_t, ql_t)
                out = ra.packed_ragged_attention(*lane_args, s_max, 3, window)
                ref = ra.packed_ragged_attention_plain(*lane_args, 3, window)
                what = (
                    f"packed_ragged_attention chunk_base={chunk_base} "
                    f"window={window} Np={Np}"
                )
                err = max(err, agree(what, out, ref))
        return err

    err = check(q, k, v, pool)
    ms = cuda_ms(lambda i: ra.packed_ragged_attention(*args, s_max, i % LAYERS), 32)
    plain_ms = cuda_ms(lambda i: ra.packed_ragged_attention_plain(*args, i % LAYERS), 4)
    # yardstick: one SDPA call over the lanes padded to [B, Hq, s_max, K]
    # with the same causal-over-prefix mask
    K = max(b + n for b, n in zip(bases, q_lens))
    qp = torch.zeros((B, HQ, s_max, D), dtype=q.dtype, device="cuda")
    kp = torch.zeros((B, HQ, K, D), dtype=q.dtype, device="cuda")
    vp = torch.zeros_like(kp)
    mask = torch.zeros((B, 1, s_max, K), dtype=torch.bool, device="cuda")
    for b, (bs, n, o) in enumerate(zip(bases, q_lens, seg_off.tolist())):
        pages = table[b, : -(-bs // PAGE)].long()
        pk = pool[0, 0][pages].reshape(-1, HKV, D)[:bs]
        pv = pool[0, 1][pages].reshape(-1, HKV, D)[:bs]
        keys = torch.cat([pk, k[o : o + n]]).repeat_interleave(HQ // HKV, 1)
        vals = torch.cat([pv, v[o : o + n]]).repeat_interleave(HQ // HKV, 1)
        qp[b, :, :n] = q[o : o + n].transpose(0, 1)
        kp[b, :, : bs + n] = keys.transpose(0, 1)
        vp[b, :, : bs + n] = vals.transpose(0, 1)
        r = torch.arange(s_max, device="cuda")[:, None]
        c = torch.arange(K, device="cuda")[None, :]
        mask[b, 0] = (c <= bs + r) & (r < n)
    mask[:, :, :, 0] |= ~mask.any(-1)  # no fully masked row (pad rows)
    library_ms = cuda_ms(lambda i: sdpa_padded(qp, kp, vp, mask), 32)
    rows = sum(q_lens)
    keys_seen = sum(bs * n + n * (n + 1) // 2 for bs, n in zip(bases, q_lens))
    bytes_moved = (
        rows * HQ * D * 2  # q rows read
        + 2 * rows * HKV * D * 2  # fresh K and V rows read
        + sum(bases) * HKV * D * 2 * 2  # resident prefix K and V rows read
        + Np * HQ * D * 2  # the whole output written
        + table.numel() * 4 + 3 * B * 4
    )
    bound_ms, bound_by = bound(bytes_moved, 4.0 * keys_seen * HQ * D)
    del pool, kp, vp
    g32 = f32_generator()
    pool = make_pool(n_pages, g32, torch.float32, 4)
    check(*[torch.randn((Np, h, D), generator=g32, device="cuda") for h in (HQ, HKV, HKV)], pool)
    del pool
    return dict(
        name="packed_ragged_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
        replaces="dynamo_tpu/ops/ragged_attention.py:527",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


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
            finish = data.get("finish_reason") or finish
        ttft = frames[0][0] - t0 if frames else float("nan")
        return dict(tokens=tokens, finish=finish, frames=frames, ttft=ttft)

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


def reference_phase() -> None:
    """A small f32 model: greedy streams on the card (kernels) equal the
    CPU's (plain versions) from the same weights."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2, num_layers=2)
    ecfg = dict(num_pages=64, mixed_token_budget=32, max_seq_len=256)
    params = init_params(cfg, 3, torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(3)
    shared = rng.integers(1, cfg.vocab_size, 40).tolist()
    batch = [
        request(rng.integers(1, cfg.vocab_size, 70), 12),
        request(shared + [5, 6], 12),
        request(shared + [9], 12),
        request(rng.integers(1, cfg.vocab_size, 3), 12),
    ]
    streams = {}
    for dev in ("cuda", "cpu"):
        p = {
            k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()
        }
        eng = TorchEngine(cfg, p, EngineConfig(**ecfg), device=dev)
        streams[dev] = [r["tokens"] for r in asyncio.run(serve(eng, [batch]))]
    print(f"reference: card {streams['cuda']}")
    if streams["cuda"] != streams["cpu"]:
        fail(f"small-model greedy streams differ: cpu {streams['cpu']}")


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
        for i, r in enumerate(out):
            if len(r["tokens"]) != 64 or r["finish"] != "length":
                fail(f"run {run} request {i}: {len(r['tokens'])} tokens, finish {r['finish']}")
            if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
                fail(f"run {run} request {i}: token out of range")
        # end to end: every generated token (primer and batch) over the
        # run's wall time, prefills included
        tok_s = sum(len(r["tokens"]) for r in res) / wall
        # decode phase only: tokens streamed once every request of the batch
        # had its first one, over that window
        t_all = max(r["frames"][0][0] for r in out)
        t_end = max(r["frames"][-1][0] for r in out)
        n_dec = sum(n for r in out for t, n in r["frames"] if t > t_all)
        dec = n_dec / (t_end - t_all) if t_end > t_all else float("nan")
        print(
            f"serve: run {run} init_s={init_s:.3f} wall_s={wall:.3f} "
            f"dispatches_by_k={by_k} prefix_hit_rate={hits:.4f} "
            f"tok_s={tok_s:.3f} decode_phase_tok_s={dec:.3f} "
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


def profile_phase(out_path: str, plain_wall_s: float) -> None:
    """``--profile OUT.txt``: one more served run of the serve phase's
    requests under ``torch.profiler``; prints the device's busy and idle
    share of the run's wall time and its kernel time by kind and by name,
    and writes the full table to ``out_path``.  The profiler slows the
    host, so the idle share it shows is an upper bound; ``idle_share_est``
    sets the profiled busy time against ``plain_wall_s``, the wall time of
    the serve phase's unprofiled run of the same requests (an estimate that
    assumes the profiler leaves device times as they are)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    engine = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024), seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        asyncio.run(serve(engine, [primer, batch]))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    if not kernels:
        fail("the profiler recorded no device time")
    kinds = {
        "paged_decode_attention": ("paged_decode_kernel",),
        "packed_ragged_attention": ("packed_ragged_kernel",),
        "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
    }
    by_kind: Dict[str, float] = {}
    for ms, _, name in kernels:
        kind = next((k for k, keys in kinds.items() if any(x in name for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    busy_ms = sum(ms for ms, _, _ in kernels)
    print(
        f"profile: wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
        f"idle_share={1.0 - busy_ms / wall_ms:.4f} "
        f"unprofiled_wall_ms={plain_wall_s * 1e3:.3f} "
        f"idle_share_est={1.0 - busy_ms / (plain_wall_s * 1e3):.4f} "
        f"by_kind_ms={by_kind}"
    )
    for ms, n, name in kernels[:12]:
        print(f"profile: {ms:.3f} ms over {n} launches: {name[:100]}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    del engine
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
    kernels = [pa.KERNEL, ra.KERNEL]
    for name, lines in build.build_all(kernels).items():
        for ln in lines:
            print(f"build: {name}: {ln}")
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [check_decode(pa, rng, gen), check_ragged(ra, bucketing, rng, gen)]
    for r in rows:
        print(
            f"kernels: {r['name']} ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) on {card}"
        )
    gc.collect()
    torch.cuda.empty_cache()

    reference_phase()
    served = serve_phase(kernels, card)
    if profile_out is not None:
        profile_phase(profile_out, served["wall"])
    for r in rows:
        r["launches"] = served["launches"][r["name"]]
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
