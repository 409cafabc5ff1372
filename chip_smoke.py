#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile OUT.txt]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (``nvcc``).  It imports ``dynamo_tpu_torch`` and nothing of JAX.
Every phase is fatal on failure:

1. build: every hand-written kernel builds from ``dynamo_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together; a source may hold
   several kernels); their ``-Xptxas -v`` register / shared-memory lines
   are printed, and an instantiation that spills fails the run.  The SASS
   of the paged decode, flash prefill and ragged attention libraries
   (``cuobjdump --dump-sass``) must show every bf16 instantiation of their
   tensor-core kernels (``paged_decode_tc_kernel``, ``flash_tc_kernel``,
   ``ragged_tc_kernel``) on the tensor cores (``HMMA`` or ``HGMMA``) and no
   bf16 instantiation of the CUDA-core ``paged_decode_kernel``,
   ``flash_kernel`` or ``ragged_kernel``.
2. kernels: each of the seven kernel entries against its plain PyTorch version at
   the Llama-3-8B shapes the serve phases give it (Hq=32, Hkv=8, D=128,
   page=16), with and without a sliding window, in bf16 (the main path's
   dtype) and in f32 (where a misplaced key shows): paged decode (also
   over a short table of 8 pages, within one of its splits); packed
   ragged (its prefill chunk both over a resident prefix and from position
   0); the rectangle ragged layout; full flash prefill of the 2048 bucket;
   prefix-suffix flash prefill of a 476-token suffix over a 1024-token
   prefix; the int8 entries of packed and rectangle ragged at the shapes of
   their dense checks, over the int8 pool the port's ``quantize_kv_rows``
   makes of the dense check's pool.  CUDA-event times of the kernel, the
   plain version and one ``scaled_dot_product_attention`` call over the
   gathered (dequantized) K/V with the same mask (a yardstick the port
   never calls), beside the least time the card could take (bytes at 3.35
   TB/s or bf16 operations at 989 TFLOP/s, whichever is larger); each row
   adds its rate (``tflops``, operations over kernel time) and
   ``bound_share`` (bound over kernel time), and paged decode, whose
   back-to-back calls the host paces, its ``device_ms`` under
   ``torch.profiler``.  And
   ``quantize_kv_rows`` on the card gives the CPU's int8 bytes and f32
   scales bit for bit on a ``[4096, 8, 128]`` bf16 input.
3. reference: a small f32 model served on the card (kernels) and on the
   CPU (plain versions) from the same weights gives the same greedy
   streams, under the default config, ``mixed_batching=False`` (with
   chunked prefill) and ``packed_ragged=False``, with a
   ``frequency_penalty`` lane and a ``repetition_penalty`` lane in the
   batch; on the card the unpenalized lanes agree across the three.  The
   same three with ``kv_dtype="int8"``: card streams equal the CPU's.  The
   card runs the pipelined loop, and each config must capture and replay
   a decode graph (the first batch's lanes take 24 tokens for that).
4. serve: ``TorchEngine.random_init(ModelConfig.llama3_8b(),
   EngineConfig(num_pages=1024))`` -- full width, 32 layers, bf16, random
   weights from a seed, default engine settings (mixed batching, packed
   layout, adaptive multistep up to K=8) -- serves one request carrying a
   1024-token prefix, then 8 concurrent requests (prompts of 16 to 1500
   tokens, two sharing that prefix so they hit the prefix cache, greedy
   plus two seeded temperature lanes, max_tokens 64) through
   ``generate()`` (cold: each decode graph is captured as its shape first
   comes), then the same 8 requests once more on the same engine (warm:
   the graphs replay).  Every stream must finish with 64 tokens, both
   kernels' launch counts must be > 0 for this run, a K > 1 dispatch must
   have run and a CUDA graph must have replayed.  Run 1, a second engine
   built the same way with ``async_dispatch=False`` (the serial loop),
   serves the same requests and must give identical streams.
5. serve-classic: the same model, random weights made once and shared by
   two engines: run A, ``EngineConfig(num_pages=1024,
   mixed_batching=False)``, serves the serve phase's primer and batch with
   one greedy lane carrying ``frequency_penalty=0.5`` and another
   ``repetition_penalty=1.1`` (classic prefill groups, suffix prefills on
   the prefix hits, decode blocks of 16 with penalty histograms); run B,
   ``EngineConfig(num_pages=1024, packed_ragged=False)``, serves the same
   requests without penalties (rectangle unified dispatches, decode
   blocks).  Run A's twin with ``async_dispatch=False`` must give run A's
   streams.  Each serves cold then warm, as the serve phase.  Every stream
   must finish with 64 tokens; kernels 1, 2 and 3 must launch in run A,
   kernels 1 and 4 in run B, and graphs must replay in A and B.

6. serve-int8: the same model, random weights made once and shared by
   three engines with ``EngineConfig(num_pages=1024, kv_dtype="int8")``:
   run Q, the default config (the serve phase's), run QA,
   ``mixed_batching=False`` with run A's penalized lanes, and run QB,
   ``packed_ragged=False``.  Every stream must finish with 64 tokens; the
   int8 entry of packed ragged must launch in Q, flash prefill and
   prefix-suffix prefill in QA, the int8 entry of rectangle ragged in QB;
   paged decode and the dense ragged entries launch in none of them (an
   int8 pool's decode steps take the gathered composition, counted);
   graphs must replay in Q.

In every served run each kernel's launch count (graph replays included)
must equal what the run's dispatches imply (``expected_launches``), and
the run prints its loop mode, graph captures and replays and the dispatch
spans read from CUDA events, for the whole run and its warm batch.

``--profile OUT.txt`` adds a last phase: the serve phase's run,
serve-classic runs A and B and serve-int8 run Q once more, their warm
batch under ``torch.profiler``, each with the device's idle share and its
kernel time by kind (see ``profile_phase``); the full tables go to
``OUT.txt``.

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
# The bf16 tensor-core kernels (paged decode, kernel 1, flash prefill,
# kernels 2 and 3, and ragged attention, kernels 4 and 5) also round P to
# bf16 before its product with V, as the Pallas kernels do
# (probs.astype(v.dtype)); the plain version keeps P in f32.  Each weight then moves by at most 2^-9 of
# itself, so an output, a weighted average of V rows, moves by at most
# 2^-9 * max|v| before its final rounding.  It shows on rows with few keys
# (an H100 run at kernel 2's check shape: 1 element of 4.9 million over the
# bound above, in row 1 of the prompt, where the kernel's output equals an
# f32 emulation of the Pallas arithmetic).
BF16_P_ROUNDING = 2.0**-9


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


def device_ms(fn: Callable[[int], object], iters: int = 16) -> float:
    """Mean device time of ``fn(i)`` under ``torch.profiler``: the self time
    of every kernel it launches, over ``iters`` calls after a warm-up.
    Unlike ``cuda_ms`` it leaves out the host's time between launches,
    which sets the pace of back-to-back calls of a short kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    )
    return total / iters / 1e3


def check_tensor_cores(build, checks) -> None:
    """Fail unless every bf16 instantiation of each library runs its
    products on the tensor cores.  ``checks`` holds ``(kernel, tc_name,
    core_name, count)``: the SASS of each of the ``count`` instantiations of
    the tensor-core kernel ``tc_name`` in ``kernel``'s library (head dims 64
    and 128 among them) holds ``HMMA`` or ``HGMMA`` instructions, and the
    CUDA-core kernel ``core_name`` has no bf16 instantiation.  The
    libraries are disassembled side by side."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    dumps = [
        subprocess.Popen(
            [tool, "--dump-sass", str(kernel.library_path())],
            stdout=subprocess.PIPE, text=True,
        )
        for kernel, _, _, _ in checks
    ]
    for proc, (kernel, tc_name, core_name, count) in zip(dumps, checks):
        sass, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"cuobjdump failed on {kernel.library_path()}")
        tc = {}
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            name = body.split("\n", 1)[0].strip()
            if f"{core_name}I13__nv_bfloat16" in name:
                fail(f"a bf16 instantiation of the CUDA-core {core_name} is built: {name}")
            if tc_name in name:
                tc[name] = len(re.findall(r"\bH(?:G)?MMA\b", body))
        print(f"build: {kernel.source_name} SASS tensor-core instructions {tc}")
        dims = {d for d in (64, 128) for name in tc if f"ILi{d}E" in name}
        if len(tc) != count or dims != {64, 128} or not all(tc.values()):
            fail(f"the bf16 {tc_name} instantiations do not all run on the tensor cores: {tc}")


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


def agree(
    what: str, out: torch.Tensor, ref: torch.Tensor, p_rounding: float = 0.0
) -> float:
    """Fail unless the kernel's ``out`` matches the plain version's ``ref``
    within the dtype's tolerance (in bf16 plus ``p_rounding``, the bound of
    a kernel that rounds P); returns the largest absolute error."""
    torch.cuda.synchronize()
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        ok = err <= F32_TOL
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * ref.abs() + p_rounding).all())
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
    # the served decode mix: 8 lanes of 33 to 2048 positions over a
    # 128-page table (the bf16 kernel's 8 splits of 256 positions), then a
    # short table of 8 pages (one split: no merge), each in bf16 and f32,
    # with and without a window
    B = 8
    cases = {
        "": ([2048, 1791, 1500, 1203, 1024, 640, 257, 33], 2048 // PAGE, 512),
        " short-table": ([128, 100, 77, 64, 63, 17, 1, 0], 8, 50),
    }
    err = 0.0
    operands = {}
    for case, (kv_lens, width, win) in cases.items():
        n_pages = B * width + 1
        pool = make_pool(n_pages, gen)
        table = lane_tables([-(-n // PAGE) for n in kv_lens], width, n_pages, rng)
        lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
        q = torch.randn((B, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
        for window in (0, win):
            out = pa.paged_decode_attention(q, pool, table, lens, 3, window)
            ref = pa.paged_decode_attention_plain(q, pool, table, lens, 3, window)
            what = f"paged_decode_attention{case} window={window}"
            err = max(err, agree(what, out, ref, p_rounding(pool[3, 1])))
        operands[case] = (q, pool, table, lens, kv_lens, width)
    q, pool, table, lens, kv_lens, width = operands[" short-table"]
    short = lambda i: pa.paged_decode_attention(q, pool, table, lens, i % LAYERS)  # noqa: E731
    print(
        f"kernels: paged_decode_attention short-table ms={cuda_ms(short, 64):.5f} "
        f"device_ms={device_ms(short):.5f}"
    )
    del operands[" short-table"], pool
    # timing at the main path's shape (no window: Llama-3 has none);
    # rotating the layer keeps each launch's K/V cold in L2, as in a step
    q, pool, table, lens, kv_lens, width = operands.pop("")
    ms = cuda_ms(lambda i: pa.paged_decode_attention(q, pool, table, lens, i % LAYERS), 64)
    dev_ms = device_ms(lambda i: pa.paged_decode_attention(q, pool, table, lens, i % LAYERS))
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
    flops = 4.0 * live * HQ * D
    bound_ms, bound_by = bound(bytes_moved, flops)
    del pool, k, v
    g32 = f32_generator()
    for case, (kv_lens, width, win) in cases.items():
        n_pages = B * width + 1
        pool = make_pool(n_pages, g32, torch.float32, 4)
        table = lane_tables([-(-n // PAGE) for n in kv_lens], width, n_pages, rng)
        lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
        q = torch.randn((B, HQ, D), generator=g32, device="cuda")
        for window in (0, win):
            out = pa.paged_decode_attention(q, pool, table, lens, 3, window)
            ref = pa.paged_decode_attention_plain(q, pool, table, lens, 3, window)
            agree(f"paged_decode_attention{case} window={window}", out, ref)
        del pool
    return dict(
        name="paged_decode_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="dynamo_tpu/ops/paged_attention.py:124",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms, device_ms=dev_ms,
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
                err = max(err, agree(where, out, ref, ragged_p_rounding(pool, scales, v)))
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
        flops = 4.0 * keys_seen * HQ * D
        bound_ms, bound_by = bound(other_bytes + prefix_bytes, flops)
        return dict(
            name=name, route="cuda",
            source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
            replaces="dynamo_tpu/ops/ragged_attention.py:527", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
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


def p_rounding(v: torch.Tensor) -> float:
    """The bf16 tensor-core kernels' extra bound: 2^-9 of the largest |v|."""
    return BF16_P_ROUNDING * v.float().abs().max().item() if v.dtype == torch.bfloat16 else 0.0


def ragged_p_rounding(pool, scales, v: torch.Tensor) -> float:
    """``p_rounding`` of the V rows a ragged check's kernel reads: the
    pool's layer 3 (dequantized for the int8 pool) and the fresh rows."""
    pv = pool[3, 1] if scales is None else dequantized(pool[3, 1], scales[3, 1], v.dtype)
    return p_rounding(torch.cat([pv.flatten(), v.flatten()]))


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
            what = f"flash_prefill_attention T={T} len={n} window={window}"
            err = max(err, agree(what, out, ref, p_rounding(v)))
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
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
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
            err = max(err, agree(what, out, ref, p_rounding(vc)))
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
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
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
            where = f"{what} S={S} window={window}"
            err = max(err, agree(where, out, ref, ragged_p_rounding(pool, scales, v)))
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
        flops = 4.0 * keys_seen * HQ * D
        bound_ms, bound_by = bound(other_bytes + prefix_bytes, flops)
        return dict(
            name=name, route="cuda",
            source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
            replaces="dynamo_tpu/ops/ragged_attention.py:205", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
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


async def serve(
    engine, batches: List[List[dict]], between: Callable[[int], None] = None
) -> List[dict]:
    """Serve each batch of requests concurrently, one batch after the
    other (``between(i)`` runs before batch ``i`` > 0 starts); returns per
    request its tokens, finish reason, frame times and time to first
    token."""
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
        for i, batch in enumerate(batches):
            if i and between is not None:
                between(i)
            t0 = time.perf_counter()
            results += await asyncio.gather(*[one(r, t0) for r in batch])
    finally:
        await engine.stop()
    return results


def serve_cold_warm(engine, primer: List[dict], reqs: List[dict], hook=None):
    """One served run: the primer and then the batch (cold: each graph is
    captured, after its eager warm-up, as its shape first comes), then the
    same batch once more on the same engine (warm: the graphs replay).
    ``hook()`` runs as the warm batch starts.  Returns the cold results
    (primer first) and wall time -- until the warm batch starts --, the
    warm results and their wall time (to their last frame), and the
    engine's dispatch spans and graph captures as the warm batch
    started."""
    marks: Dict[str, object] = {}

    def between(i: int) -> None:
        if i == 2:
            marks["spans"] = engine.dispatch_spans()
            marks["captures"] = engine.graph_captures
            marks["replays"] = engine.graph_replays
            if hook is not None:
                hook()
            marks["t"] = time.perf_counter()

    t0 = time.perf_counter()
    res = asyncio.run(serve(engine, [primer, reqs, reqs], between))
    cold, warm = res[: 1 + len(reqs)], res[1 + len(reqs):]
    wall_warm = max(r["frames"][-1][0] for r in warm) - marks["t"]
    return cold, marks["t"] - t0, warm, wall_warm, marks


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
    # the first batch runs each config's own path, long enough that the
    # card replays its decode graphs; in the second, the penalized lanes
    # turn every tick classic
    batches = [
        [
            request(rng.integers(1, cfg.vocab_size, 70), 24),
            request(shared + [5, 6], 24),
            request(shared + [9], 24),
            request(rng.integers(1, cfg.vocab_size, 3), 24),
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
        out = asyncio.run(serve(eng, reqs))
        if dev == "cuda":
            # the card runs the pipelined loop with its decode graphs
            print(f"reference: {kw} async_dispatch={eng.cfg.async_dispatch} "
                  f"graph_captures={eng.graph_captures} graph_replays={eng.graph_replays}")
            if not eng.cfg.async_dispatch or not sum(eng.graph_replays.values()):
                fail(f"reference {kw}: no pipelined loop or no graph replay on the card")
        return out

    unpenalized = {}
    for name, kw in REFERENCE_CONFIGS.items():
        streams = {dev: [r["tokens"] for r in run(kw, dev, batches)] for dev in ("cuda", "cpu")}
        print(f"reference: {name} card {streams['cuda']}")
        if streams["cuda"] != streams["cpu"]:
            report_margin(name, streams, lambda dev, reqs: run(kw, dev, reqs), batches)
            fail(f"small-model greedy streams differ under {name}: cpu {streams['cpu']}")
        want = [r["stop_conditions"]["max_tokens"] for batch in batches for r in batch]
        if [len(t) for t in streams["cuda"]] != want:
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
    # run 0: the default, pipelined loop; run 1: the serial loop
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = TorchEngine.random_init(
            cfg, EngineConfig(num_pages=1024, async_dispatch=run == 0), seed=0
        )
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        reset_launches()
        res, wall, warm, wall_w, marks = serve_cold_warm(engine, primer, batch)
        counted = read_launches()
        launches = {k.name: counted[k.name] for k in kernels}
        by_k = dict(engine.dispatches_by_k)
        hits = engine.metrics().gpu_prefix_cache_hit_rate
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_launch_invariants(f"serve: run {run}", engine, counted)
        loop, loop_w = loop_line(engine, wall + wall_w), loop_line(engine, wall_w, marks)
        replays = engine.graph_replays
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        out = res[1:]
        check_streams(f"serve run {run}", out, cfg.vocab_size)
        check_streams(f"serve run {run} warm", warm, cfg.vocab_size)
        st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
        print(
            f"serve: run {run} init_s={init_s:.3f} wall_s={wall:.3f} "
            f"dispatches_by_k={by_k} prefix_hit_rate={hits:.4f} "
            f"tok_s={st['tok_s']:.3f} decode_phase_tok_s={st['dec']:.3f} "
            f"peak_mem_gib={peak_gib:.3f} on {card}"
        )
        print(
            "serve: run %d ttft_ms=%s" % (run, [round(r["ttft"] * 1e3, 3) for r in out])
        )
        print(
            f"serve: run {run} warm wall_s={wall_w:.3f} tok_s={st_w['tok_s']:.3f} "
            f"decode_phase_tok_s={st_w['dec']:.3f} ttft_ms="
            f"{[round(r['ttft'] * 1e3, 3) for r in warm]} on {card}"
        )
        print(f"serve: run {run} {loop}")
        print(f"serve: run {run} warm {loop_w}")
        runs.append(dict(
            streams=[r["tokens"] for r in out + warm], launches=launches, by_k=by_k,
            wall=wall, wall_warm=wall_w, replays=replays,
        ))
    first = runs[0]
    print(f"serve: launches on the main path {first['launches']}")
    for name, n in first["launches"].items():
        if n <= 0:
            fail(f"{name} never launched on the main path")
    if not any(k > 1 and n > 0 for k, n in first["by_k"].items()):
        fail("no multistep (K > 1) dispatch ran")
    if not sum(first["replays"].values()):
        fail("no CUDA graph replayed in the serve phase")
    if runs[1]["streams"] != first["streams"]:
        fail("the serial loop's streams (run 1) differ from the pipelined loop's (run 0)")
    return first


def served_stats(res: List[dict], wall: float, primed: bool = True) -> Dict[str, float]:
    """End to end: every generated token (primer, when ``primed``, and
    batch) over the run's wall time, prefills included; decode phase only:
    tokens streamed once every request of the batch had its first one,
    over that window."""
    out = res[1:] if primed else res
    t_all = max(r["frames"][0][0] for r in out)
    t_end = max(r["frames"][-1][0] for r in out)
    n_dec = sum(n for r in out for t, n in r["frames"] if t > t_all)
    return dict(
        tok_s=sum(len(r["tokens"]) for r in res) / wall,
        dec=n_dec / (t_end - t_all) if t_end > t_all else float("nan"),
    )


def reset_launches() -> None:
    """Every kernel's launch count and the gathered decode composition's
    call count to 0."""
    from dynamo_tpu_torch.engine.graphs import launch_counts, set_launch_counts

    set_launch_counts([0] * len(launch_counts()))


def read_launches() -> Dict[str, int]:
    from dynamo_tpu_torch.engine import attention as att
    from dynamo_tpu_torch.ops import build

    out = {k.name: k.launches for k in build.KERNELS}
    out["gathered_decode"] = att.gathered_decode_calls
    return out


def expected_launches(engine) -> Dict[str, int]:
    """The launches a served run must count, from its dispatches (graph
    replays included): per layer, packed ragged (the pool's entry) once per
    packed unified dispatch, rectangle ragged once per rectangle unified
    dispatch, flash prefill once per full-prompt prefill group,
    prefix-suffix prefill once per suffix prefill (chunks included), and
    one decode step -- paged decode over a dense pool, the gathered
    composition over an int8 pool -- per fused step past the first of
    each packed dispatch and per step of each decode block."""
    layers = engine.model_cfg.num_layers
    d = engine.dispatches
    unified = d.get("unified", 0)
    steps = sum((k - 1) * n for k, n in engine.dispatches_by_k.items())
    steps += engine.cfg.decode_block_size * d.get("decode_block", 0)
    q = engine.kv.quantized
    packed = engine.cfg.packed_ragged
    return {
        "packed_ragged_attention": layers * unified if packed and not q else 0,
        "packed_ragged_attention_int8": layers * unified if packed and q else 0,
        "ragged_paged_attention": layers * unified if not packed and not q else 0,
        "ragged_paged_attention_int8": layers * unified if not packed and q else 0,
        "flash_prefill_attention": layers * engine.prefill_dispatches["full"],
        "flash_prefix_prefill_attention": layers * engine.prefill_dispatches["suffix"],
        "paged_decode_attention": 0 if q else layers * steps,
        "gathered_decode": layers * steps if q else 0,
    }


def check_launch_invariants(what: str, engine, launches: Dict[str, int]) -> None:
    want = expected_launches(engine)
    print(f"{what} launch invariants: counted {launches} expected {want}")
    if launches != want:
        fail(f"{what}: launches {launches} differ from the dispatches' {want}")


def loop_line(engine, wall: float, since=None) -> str:
    """The pipelined loop's numbers of a served run: loop mode, graph
    captures (and the host ms they took, eager warm-ups included) and
    replays, and the dispatch spans on CUDA events (device ms from each
    dispatch's first launch to its last, gap ms from one dispatch's end to
    the next one's start, their share of the wall; by kind, replays apart
    as ``<kind>/graph``).  With ``since`` (``serve_cold_warm``'s marks),
    what the warm batch alone added."""
    spans = engine.dispatch_spans()
    captures = engine.graph_captures
    replays = engine.graph_replays
    head = f"graph_capture_ms={engine.graphs.capture_ms:.3f} "
    if since is not None:
        before = since["spans"]
        spans = {
            k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
            for k, v in spans.items()
        }
        spans = {k: v for k, v in spans.items() if v["n"]}
        captures -= since["captures"]
        replays = {k: n - since["replays"].get(k, 0) for k, n in replays.items()}
        head = ""
    dev = sum(v["device_ms"] for v in spans.values())
    gap = sum(v["gap_ms"] for v in spans.values())
    by_kind = {
        k: {"n": int(v["n"]), "device_ms": round(v["device_ms"], 3), "gap_ms": round(v["gap_ms"], 3)}
        for k, v in spans.items()
    }
    return (
        f"async_dispatch={engine.cfg.async_dispatch} graph_captures={captures} {head}"
        f"graph_replays={replays} span_device_ms={dev:.3f} span_gap_ms={gap:.3f} "
        f"span_share={dev / (wall * 1e3):.4f} gap_share={gap / (wall * 1e3):.4f} "
        f"spans_by_kind={by_kind}"
    )


def check_streams(what: str, out: List[dict], vocab: int) -> None:
    """Every request of a batch finished with its 64 tokens, in range."""
    for i, r in enumerate(out):
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
        # run A's serial-loop twin: its streams must equal run A's
        "A-serial": (dict(mixed_batching=False, async_dispatch=False),
                     penalized_requests(batch), ()),
        "B": (dict(packed_ragged=False), batch,
              ("paged_decode_attention", "ragged_paged_attention")),
    }
    launches: Dict[str, Dict[str, int]] = {}
    walls: Dict[str, float] = {}
    streams: Dict[str, List[List[int]]] = {}
    for run, (kw, reqs, needed) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
        reset_launches()
        res, wall, warm, wall_w, marks = serve_cold_warm(engine, primer, reqs)
        walls[run] = wall_w
        counted = read_launches()
        launches[run] = {k.name: counted[k.name] for k in kernels}
        kinds = dict(engine.dispatches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_launch_invariants(f"serve-classic: run {run}", engine, counted)
        loop, loop_w = loop_line(engine, wall + wall_w), loop_line(engine, wall_w, marks)
        replays = engine.graph_replays
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        check_streams(f"serve-classic run {run}", res[1:], cfg.vocab_size)
        check_streams(f"serve-classic run {run} warm", warm, cfg.vocab_size)
        streams[run] = [r["tokens"] for r in res + warm]
        st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
        print(
            f"serve-classic: run {run} {kw} wall_s={wall:.3f} "
            f"dispatches_by_kind={kinds} tok_s={st['tok_s']:.3f} "
            f"decode_phase_tok_s={st['dec']:.3f} peak_mem_gib={peak_gib:.3f} on {card}"
        )
        print(
            "serve-classic: run %s ttft_ms=%s"
            % (run, [round(r["ttft"] * 1e3, 3) for r in res[1:]])
        )
        print(
            f"serve-classic: run {run} warm wall_s={wall_w:.3f} tok_s={st_w['tok_s']:.3f} "
            f"decode_phase_tok_s={st_w['dec']:.3f} ttft_ms="
            f"{[round(r['ttft'] * 1e3, 3) for r in warm]} on {card}"
        )
        print(f"serve-classic: run {run} {loop}")
        print(f"serve-classic: run {run} warm {loop_w}")
        print(f"serve-classic: run {run} launches {launches[run]}")
        for name in needed:
            if launches[run][name] <= 0:
                fail(f"{name} never launched in serve-classic run {run}")
        if run != "A-serial" and not sum(replays.values()):
            fail(f"no CUDA graph replayed in serve-classic run {run}")
    if streams["A-serial"] != streams["A"]:
        fail("serve-classic: the serial loop's streams differ from run A's")
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
        reset_launches()
        res, wall, warm, wall_w, marks = serve_cold_warm(engine, primer, reqs)
        walls[run] = wall_w
        counted = read_launches()
        launches[run] = {k.name: counted[k.name] for k in kernels}
        gathered = att.gathered_decode_calls
        kinds, by_k = dict(engine.dispatches), dict(engine.dispatches_by_k)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_launch_invariants(f"serve-int8: run {run}", engine, counted)
        loop, loop_w = loop_line(engine, wall + wall_w), loop_line(engine, wall_w, marks)
        replays = engine.graph_replays
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        check_streams(f"serve-int8 run {run}", res[1:], cfg.vocab_size)
        check_streams(f"serve-int8 run {run} warm", warm, cfg.vocab_size)
        st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
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
        print(
            f"serve-int8: run {run} warm wall_s={wall_w:.3f} tok_s={st_w['tok_s']:.3f} "
            f"decode_phase_tok_s={st_w['dec']:.3f} ttft_ms="
            f"{[round(r['ttft'] * 1e3, 3) for r in warm]} on {card}"
        )
        print(f"serve-int8: run {run} {loop}")
        print(f"serve-int8: run {run} warm {loop_w}")
        print(f"serve-int8: run {run} launches {launches[run]}")
        if run == "Q" and not sum(replays.values()):
            fail("no CUDA graph replayed in serve-int8 run Q")
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
    """``--profile OUT.txt``: each served cell once more -- the serve
    phase's run, serve-classic runs A and B and serve-int8 run Q, the same
    configs and requests on one set of random weights -- with its warm
    batch under ``torch.profiler``; prints per cell the device's busy and
    idle share of the warm batch's wall time and its kernel time by kind
    and by name, and writes the full tables to ``out_path``.  The profiler
    slows the host, so the idle share it shows is an upper bound;
    ``idle_share_est`` sets the profiled busy time against
    ``plain_walls[cell]``, the wall time of the cell's unprofiled warm
    batch in this call (an estimate that assumes the profiler leaves
    device times as they are)."""
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
        "paged_decode_attention": (
            "paged_decode_kernel", "paged_decode_tc_kernel", "paged_decode_merge_kernel",
        ),
        "ragged_attention": ("ragged_kernel", "ragged_tc_kernel"),
        "flash_prefill": ("flash_kernel", "flash_tc_kernel"),
        "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
    }
    tables = []
    for cell, (kw, reqs) in cells.items():
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def start() -> None:
            torch.cuda.synchronize()
            prof.start()

        *_, wall_w, _ = serve_cold_warm(engine, primer, reqs, hook=start)
        torch.cuda.synchronize()
        prof.stop()
        wall_ms = wall_w * 1e3
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
    check_tensor_cores(build, [
        # head dims 64 and 128, groups 2 and 4
        (pa.KERNEL, "paged_decode_tc_kernel", "paged_decode_kernel", 4),
        (fp.KERNEL, "flash_tc_kernel", "flash_kernel", 2),  # head dims 64 and 128
        # head dims 64 and 128, groups 2 and 4, the dense and the int8 pool
        (ra.KERNEL, "ragged_tc_kernel", "ragged_kernel", 8),
    ])
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
            f"({r['bound_by']}) tflops={r['tflops']:.3f} "
            f"bound_share={r['bound_share']:.4f}"
            + (f" device_ms={r['device_ms']:.5f}" if "device_ms" in r else "")
            + f" on {card}"
        )
    gc.collect()
    torch.cuda.empty_cache()

    reference_phase()
    served = serve_phase(main_kernels, card)
    classic, classic_walls = serve_classic_phase(kernels, card)
    quant, quant_walls = serve_int8_phase(kernels, card)
    if profile_out is not None:
        profile_phase(
            profile_out,
            {"serve": served["wall_warm"], **classic_walls, "Q": quant_walls["Q"]},
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
