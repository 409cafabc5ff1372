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
   makes of the dense check's pool; and the speculative verify shapes:
   prefix-suffix flash prefill of 8 lanes of S = 5 and S = 9 columns over
   their whole gathered 2048-position tables at prefixes of 33 to 2000
   tokens off the page (the standalone verify), packed ragged with 8
   verify segments of 5 rows beside 8 decode rows (the folded verify).  CUDA-event times of the kernel, the
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

7. serve-http: the OpenAI front end (``HttpService`` over
   ``link(OpenAIPreprocessor, Backend, TorchEngine)``, driven by the
   port's ``bench_serving`` client with token-id prompts).  (a) The
   reference phase's f32 model and batches, with a byte-level tokenizer of
   its 256 ids written here, served through ``/v1/completions`` on the card
   and on the CPU, once as SSE and once aggregated: the texts must be equal
   card to CPU, and equal to the tokenizer's incremental decode of the
   reference phase's direct streams.  (b) Llama-3-8B at full width and
   depth, bf16, random weights of seed 0, ``EngineConfig(num_pages=1024)``
   and a byte-level tokenizer of 128256 ids (Llama 3's specials at 128000
   to 128255) written here: the serve phase's primer and batch of 8 with
   ``ignore_eos``, cold then warm.  Every request must end ``length`` with
   exact usage and no error frame, the launch invariants hold, and
   ``/metrics`` must parse with its request counter equal to the requests
   sent; client-side TTFT p50/p99, ``tok_s``, the decode-phase rate and how
   many greedy texts equal the serve phase's decoded direct streams are
   printed (bf16 logits may move with the dispatch around a row, so this
   is reported, not held).  (c) A checkpoint directory at Llama-3-8B width
   with 2 layers (``config.json``, a ``model.safetensors`` of about 3 GB
   written by this script's own writer, the tokenizer files) is served by
   ``python -m dynamo_tpu_torch run in=http out=torch --model-path DIR`` in
   a subprocess: a few greedy requests (completions and one chat), then
   SIGINT, which must end it with exit code 0.  Its texts must equal an
   in-process engine's, built from the same numpy arrays through
   ``params_from_numpy``.  The directory is deleted after the run.

8. serve-a3: the engine's other callers of flash prefill (kernel 2).
   (a) The reference phase's f32 model on the card and on the CPU: echo
   requests' prompt-logprob entries (the same ids, logprobs within 1e-4),
   ``TorchEngine.embed`` vectors (within 1e-5) and the greedy streams of
   soft-prompt requests (identical) agree, and on the card the model's own
   embedding rows fed as ``mm_embeds`` give the token prompt's greedy
   stream exactly.  (b) Llama-3-8B at full width and depth, bf16, serve's
   weights and ``EngineConfig(num_pages=1024)``, behind the HTTP service
   with an embedding model: the primer, the batch cold, the batch warm
   alone, then the batch again with 4 echo completions (``logprobs: 5``,
   8 tokens, 2 of them on the cached 1024-token prefix) posted beside it;
   one ``/v1/embeddings`` call with the batch's 8 token-id prompts (unit
   vectors, exact ``prompt_tokens``), then one call for each prompt alone:
   each batched vector must be within ``EMBED_TOL`` of its own (and cosine
   at least 1 - 1e-4), and every other prompt's at least 10 x as far as
   its own and over 2 x ``EMBED_TOL`` away, so pooling over pad rows or a
   neighbour's rows fails, and 2
   ``generate()`` requests of 576 soft-prompt rows (llava-1.5's 24 x 24
   patches) over the same 64 placeholder-led text tokens, one after the
   other, which must hit no cached prefix.  Every echo body has one
   logprob entry per prompt and completion token, the first null, every
   logprob <= 0 and each top list sorted.  (c) Kernel 2 launches exactly
   once per layer per scoring, embedding and soft-prompt prefill dispatch
   and nothing else launches it; ``/metrics`` counts the scoring and
   embedding dispatches the engine counted.  It prints each kind's
   dispatch spans from CUDA events and the plain streams' decode-phase
   rate alone and beside the echoes.

9. serve-a45: speculative decoding and weight-only int8.  (a) The
   reference phase's f32 model on the card and on the CPU: speculation
   with the n-gram drafter (folded and ``fold_spec_verify=False``), with
   the ``random`` model drafter, and ``quantize="int8"`` give the card the
   CPU's streams, the speculating runs the plain ones; a model drafter
   over the target's own weights accepts every column on the card.  (b)
   Llama-3-8B at full width and depth, bf16, serve's weights and
   ``EngineConfig(num_pages=1024)``: the primer and the batch, cold then
   warm, every lane speculating with the n-gram drafter (4 drafts), then
   with an oracle that proposes serve's plain streams, then the oracle
   with ``fold_spec_verify=False``.  Every stream must end with its 64
   tokens and the launch invariants hold (kernel 3 also once per layer per
   standalone verify dispatch); the folded runs pay no standalone verify
   dispatch, the fold-off run some.  Printed: acceptance, accepted tokens
   per verify, the rates beside serve's plain warm ones, and how many
   greedy streams equal serve's (bf16 rows may move with the dispatch
   around them, so this is reported, not held).  (c) ``quantize="int8"``
   from the same weights serves the primer and the batch, cold then warm:
   64 tokens each and the launch invariants held; weight bytes against
   bf16, peak GiB and the rates printed.

10. serve-kvbm: the KV block manager's lower tiers.  (a) The reference
   phase's f32 model on the card and on the CPU with the offload plane
   armed -- host only, host+disk (a ring of 1 block), and both over the
   int8 pool -- serves two prefixes, churn that evicts them and the two
   again: the same streams, blocks offloaded, host-only onboarded on the
   card; then two growing lanes over 8 pages in the serial loop: swap,
   recompute and a roomy pool give the same streams, card and CPU, the
   swapped lane resuming under graph replay.  (b) Llama-3-8B at full
   width, bf16, random weights of seed 0, ``EngineConfig(num_pages=512,
   host_offload_blocks=128, disk_offload_blocks=1024,
   disk_offload_dir=<temporary directory>)``: round 1 (8 requests over 4
   1024-token prefixes, two each, suffixes of 16 to 256 tokens, 32 new
   tokens, two seeded temperature lanes), round 2 (4 other prefixes, whose
   admissions evict round 1's blocks into the host ring and spill it to
   disk), round 3 (round 1's requests again, last first, arriving as round
   2's first token streams, so they queue and the engine prefetches their
   chains).  Printed per round: wall, tok/s, TTFT from arrival and from
   admission, distinct prefix blocks reused from G1 and onboarded from G2
   and G3; offload and onboard bytes and GB/s from ``dynamo_kv_*``; ring
   bytes; peak GiB.  Round 3 must onboard from both tiers, and every round-1
   prefix block it onboarded or kept resident must equal, bit for bit, a
   copy of round 1's pages taken before round 2.  (c) 8 lanes of
   256-token prompts and 256 new tokens over ``num_pages=160`` with
   ``host_offload_blocks=512``: swap (the device fast path), swap over
   host blobs only, ``swap_preemption=False`` and a roomy
   ``num_pages=1024``; preemptions by kind, swap-out and swap-in bytes and
   GB/s by path, wall and decode-phase tok/s, and the greedy agreement
   with the roomy run (the first divergence's top-2 logprobs).  (d) One
   1024-token prefix evicted and onboarded over an int8 pool at full
   width: data and scales bit-exact.  No offload copy failure and no swap
   or onboard fallback may be counted.

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
import zlib
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
# bf16 embeddings (serve-a3): a unit vector of 4096 elements, each some
# 1/64 in magnitude, pooled in f32 from bf16 rows.  The same prompt in
# another batch and bucket moves an element by rounding steps of the
# trunk's GEMMs, some 1e-4; pooling over a pad row or a neighbour's row
# moves it by about its own size.
EMBED_TOL = 1e-3


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


def check_flash_prefix_verify(fp, gen) -> Dict[str, object]:
    # the standalone speculative verify (serve-a45's fold-off run): 8 lanes,
    # S = 1 + pow2(draft) columns (5 for 4 drafts, 9 for 8) over each lane's
    # whole gathered page table (Kp = 2048, the page bucket of the longest
    # lane), at prefixes of 33 to 2000 tokens off the page and the key tile
    offs = [33, 150, 477, 801, 1029, 1500, 1777, 2000]
    B, Kp = len(offs), 2048
    offset = torch.tensor(offs, dtype=torch.int32, device="cuda")
    row = {}
    for S, lens_l in ((5, [5, 5, 3, 5, 1, 5, 4, 5]), (9, [9, 9, 5, 9, 2, 9, 7, 9])):
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")

        def rand(rows, h, dtype=torch.bfloat16, g=gen):
            return torch.randn((B, rows, h, D), generator=g, device="cuda").to(dtype)

        def check(q, kc, vc) -> float:
            err = 0.0
            for window in (0, 512):
                out = fp.flash_prefix_prefill_attention(q, kc, vc, offset, lens, window)
                ref = fp.flash_prefix_prefill_attention_plain(q, kc, vc, offset, lens, window)
                what = f"flash_prefix_prefill_attention verify S={S} Kp={Kp} window={window}"
                err = max(err, agree(what, out, ref, p_rounding(vc)))
            return err

        q, kc, vc = rand(S, HQ), rand(Kp + S, HKV), rand(Kp + S, HKV)
        err = check(q, kc, vc)
        ms = cuda_ms(lambda i: fp.flash_prefix_prefill_attention(q, kc, vc, offset, lens), 32)
        plain_ms = cuda_ms(
            lambda i: fp.flash_prefix_prefill_attention_plain(q, kc, vc, offset, lens), 4
        )
        # yardstick: one SDPA call over the lanes padded to [B, Hq, S, K]
        K = max(offs) + S
        qp = torch.zeros((B, HQ, S, D), dtype=torch.bfloat16, device="cuda")
        kp = torch.zeros((B, HQ, K, D), dtype=torch.bfloat16, device="cuda")
        vp = torch.zeros_like(kp)
        mask = torch.zeros((B, 1, S, K), dtype=torch.bool, device="cuda")
        r = torch.arange(S, device="cuda")[:, None]
        c = torch.arange(K, device="cuda")[None, :]
        for b, (off, n) in enumerate(zip(offs, lens_l)):
            keys = torch.cat([kc[b, :off], kc[b, Kp : Kp + n]]).repeat_interleave(HQ // HKV, 1)
            vals = torch.cat([vc[b, :off], vc[b, Kp : Kp + n]]).repeat_interleave(HQ // HKV, 1)
            qp[b, :, :n] = q[b, :n].transpose(0, 1)
            kp[b, :, : off + n] = keys.transpose(0, 1)
            vp[b, :, : off + n] = vals.transpose(0, 1)
            mask[b, 0] = (c <= off + r) & (r < n)
        mask[:, :, :, 0] |= ~mask.any(-1)
        library_ms = cuda_ms(lambda i: sdpa_padded(qp, kp, vp, mask), 32)
        del qp, kp, vp
        rows = sum(lens_l)
        bytes_moved = (
            rows * HQ * D * 2  # the valid q rows read
            + sum(2 * (o + n) * HKV * D * 2 for o, n in zip(offs, lens_l))  # prefix, suffix K/V
            + B * S * HQ * D * 2  # the whole output written
            + 2 * B * 4
        )
        flops = 4.0 * HQ * D * sum(n * o + n * (n + 1) / 2 for o, n in zip(offs, lens_l))
        bound_ms, bound_by = bound(bytes_moved, flops)
        g32 = f32_generator()
        check(rand(S, HQ, torch.float32, g32), rand(Kp + S, HKV, torch.float32, g32),
              rand(Kp + S, HKV, torch.float32, g32))
        print(
            f"kernels: flash_prefix_prefill_attention verify S={S} ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} bound_ms={bound_ms:.5f} "
            f"({bound_by})"
        )
        if S == 5:  # the row: four drafts, the serve-a45 shape
            row = dict(
                name="flash_prefix_prefill_attention/verify", route="cuda",
                source="dynamo_tpu_torch/csrc/flash_prefill.cu",
                replaces="dynamo_tpu/ops/flash_prefill.py:311",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
            )
        del q, kc, vc
    return row


def check_ragged_verify(ra, bucketing, rng, gen) -> Dict[str, object]:
    # folded speculative verify: 8 verify segments of 5 rows (last committed
    # token + 4 drafts) beside 8 decode rows, over prefixes of 33 to 2000
    # tokens, packed by the engine's rule (s_max = pow2(5) = 8)
    bases = [33, 150, 477, 801, 1029, 1500, 1777, 2000, 2047, 1790, 1499, 1202, 640, 256, 32, 1024]
    q_lens = [5] * 8 + [1] * 8
    B = len(bases)
    width = 2048 // PAGE
    need = [-(-(b + n) // PAGE) for b, n in zip(bases, q_lens)]
    n_pages = sum(need) + 1
    s_max = bucketing.pow2_bucket(max(q_lens))
    seg_off = np.cumsum([0] + q_lens[:-1])
    Np = bucketing.packed_axis_len(s_max, int(seg_off[-1]), sum(q_lens))
    pool = make_pool(n_pages, gen)
    table = lane_tables(need, width, n_pages, rng)
    i32 = dict(dtype=torch.int32, device="cuda")
    base_t = torch.tensor(bases, **i32)
    off_t = torch.tensor(seg_off.tolist(), **i32)
    ql_t = torch.tensor(q_lens, **i32)

    def check(q, k, v, pool) -> float:
        err = 0.0
        for window in (0, 512):
            args = (q, k, v, pool, table, base_t, off_t, ql_t)
            out = ra.packed_ragged_attention(*args, s_max, 3, window)
            ref = ra.packed_ragged_attention_plain(*args, 3, window)
            what = f"packed_ragged_attention verify segments window={window} Np={Np}"
            err = max(err, agree(what, out, ref, ragged_p_rounding(pool, None, v)))
        return err

    def rand(h, dtype=torch.bfloat16, g=gen):
        return torch.randn((Np, h, D), generator=g, device="cuda").to(dtype)

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    err = check(q, k, v, pool)
    args = (q, k, v, pool, table, base_t, off_t, ql_t)
    ms = cuda_ms(lambda i: ra.packed_ragged_attention(*args, s_max, i % LAYERS), 32)
    plain_ms = cuda_ms(lambda i: ra.packed_ragged_attention_plain(*args, i % LAYERS), 4)
    segs = [slice(o, o + n) for o, n in zip(seg_off.tolist(), q_lens)]
    padded = sdpa_lanes(pool, table, bases, [(q[s], k[s], v[s]) for s in segs], s_max)
    library_ms = cuda_ms(lambda i: sdpa_padded(*padded), 32)
    del padded
    rows = sum(q_lens)
    keys_seen = sum(bs * n + n * (n + 1) // 2 for bs, n in zip(bases, q_lens))
    bytes_moved = (
        rows * HQ * D * 2 + 2 * rows * HKV * D * 2  # q, fresh K and V rows read
        + Np * HQ * D * 2  # the whole output written
        + table.numel() * 4 + 3 * B * 4
        + sum(bases) * 2 * HKV * D * 2  # each resident K and V row once
    )
    flops = 4.0 * keys_seen * HQ * D
    bound_ms, bound_by = bound(bytes_moved, flops)
    del pool
    g32 = f32_generator()
    pool = make_pool(n_pages, g32, torch.float32, 4)
    check(rand(HQ, torch.float32, g32), rand(HKV, torch.float32, g32),
          rand(HKV, torch.float32, g32), pool)
    del pool
    return dict(
        name="packed_ragged_attention/verify", route="cuda",
        source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
        replaces="dynamo_tpu/ops/ragged_attention.py:527",
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
    request its tokens, finish reason, frame times, time to first token,
    top logprobs, the frames' prompt logprobs and the finish item's
    speculation stats."""
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(req: dict, t0: float) -> dict:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
        tokens: List[int] = []
        top: List[list] = []
        plp: List[list] = []
        frames: List[Tuple[float, int]] = []
        finish = spec = None
        async for item in stream:
            if item.is_error():
                raise RuntimeError(item.error_message())
            data = item.data or {}
            got = data.get("token_ids") or []
            if got:
                frames.append((time.perf_counter(), len(got)))
                tokens += got
            top += data.get("top_logprobs") or []
            if data.get("prompt_logprobs") is not None:
                plp.append(data["prompt_logprobs"])
            finish = data.get("finish_reason") or finish
            spec = data.get("spec") or spec
        ttft = frames[0][0] - t0 if frames else float("nan")
        return dict(tokens=tokens, finish=finish, frames=frames, ttft=ttft, top=top,
                    plp=plp, spec=spec)

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


def reference_phase() -> Dict[str, object]:
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
        eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**ecfg, **kw), device=dev)
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
        if name == "default":
            default_streams = streams["cuda"]
    for pool in ("dense", "int8"):
        group = {n: v for n, v in unpenalized.items() if n.endswith("-int8") == (pool == "int8")}
        agree_all = len({json.dumps(v) for v in group.values()}) == 1
        print(f"reference: unpenalized lanes agree across the {pool} configs: {agree_all}")
        if pool == "dense" and not agree_all:
            fail(f"the unpenalized lanes differ across configs: {group}")
    return dict(cfg=cfg, ecfg=ecfg, params=params, batches=batches,
                streams=default_streams)


def params_on(params, dev) -> Dict[str, object]:
    """The model's parameters (a dict of tensors and of a dict of stacked
    layer tensors) on ``dev``."""
    return {
        k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
        for k, v in params.items()
    }


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
            wall=wall, wall_warm=wall_w, replays=replays, tok_s_warm=st_w["tok_s"],
            dec_warm=st_w["dec"],
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
    dispatch (folded verify columns ride it), flash prefill once per
    full-prompt prefill group (soft-prompt groups included), prompt-scoring
    dispatch and embedding dispatch, prefix-suffix prefill once per suffix
    prefill (chunks included) and per standalone verify dispatch, and
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
        "flash_prefill_attention": layers * (
            engine.prefill_dispatches["full"] + d.get("prompt_score", 0) + d.get("embed", 0)
        ),
        "flash_prefix_prefill_attention": layers * (
            engine.prefill_dispatches["suffix"] + d.get("verify", 0)
        ),
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


# ---------------------------------------------------------------------------
# serving through the HTTP front end
# ---------------------------------------------------------------------------

LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant"
    "<|end_header_id|>\n\n{% endif %}"
)


def write_tokenizer(path: str, ordinary: int, specials: int) -> None:
    """A byte-level BPE ``tokenizer.json`` (Llama 3's pre-tokenizer: its
    split pattern, then ByteLevel) with ``ordinary`` ids -- the 256 byte
    characters, then tokens merged from them, two bytes and then three --
    and ``specials`` special tokens above them (Llama 3's names at 128000
    to 128255), and a ``tokenizer_config.json`` with a chat template."""
    from dynamo_tpu_torch.llm.tokenizer import _byte_maps

    chars = [_byte_maps()[0][b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars)}
    merges: List[List[str]] = []
    pairs = ((a, b) for a in chars for b in chars)
    while len(vocab) < min(ordinary, 256 + 256 * 256):
        a, b = next(pairs)
        merges.append([a, b])
        vocab[a + b] = len(vocab)
    two = [t for t in vocab if len(t) == 2]
    triples = ((ab, c) for ab in two for c in chars)
    while len(vocab) < ordinary:
        ab, c = next(triples)
        merges.append([ab, c])
        vocab[ab + c] = len(vocab)
    names = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 6: "<|start_header_id|>",
             7: "<|end_header_id|>", 9: "<|eot_id|>"}
    added = [
        {"id": ordinary + i, "content": names.get(i, f"<|reserved_special_token_{i}|>"),
         "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True}
        for i in range(specials)
    ]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False},
        ]},
        "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                           "trim_offsets": False, "use_regex": True},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    cfg = {"chat_template": CHAT_TEMPLATE}
    if specials:
        cfg.update(bos_token="<|begin_of_text|>", eos_token="<|eot_id|>")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f)


def stream_text(tokenizer, tokens: List[int]) -> str:
    """What the HTTP path's detokenizer makes of an engine stream: the
    tokenizer's incremental decode (``DecodeStream``) deltas, joined."""
    ds = tokenizer.decode_stream()
    return "".join(d for d in (ds.step(t) for t in tokens) if d)


def bench_items(reqs: List[dict]) -> List[dict]:
    """The serving client's workload items for engine request dicts."""
    return [
        dict(token_ids=r["token_ids"], max_tokens=r["stop_conditions"]["max_tokens"],
             at=0.0, **r["sampling_options"])
        for r in reqs
    ]


async def http_call(port: int, method: str, path: str, body=None) -> Tuple[int, bytes]:
    """One HTTP/1.1 request with ``Connection: close`` to 127.0.0.1:port
    (a Content-Length body back)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = b"" if body is None else json.dumps(body).encode()
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n\r\n".encode()
            + data
        )
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


class Tap:
    """The engine as a pipeline's last stage, stamping each output item's
    token count as it leaves the engine (the served decode-phase rate)."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.frames: Dict[str, List[Tuple[float, int]]] = {}
        # requests that asked for prompt logprobs (echo)
        self.echoes: set = set()

    async def generate(self, request):
        if (request.data or {}).get("prompt_logprobs") is not None:
            self.echoes.add(request.id)
        stream = await self.engine.generate(request)
        frames = self.frames.setdefault(request.id, [])

        async def gen():
            async for item in stream:
                n = len((item.data or {}).get("token_ids") or [])
                if n:
                    frames.append((time.perf_counter(), n))
                yield item

        return gen()


def decode_phase_rate(frames: List[List[Tuple[float, int]]]) -> float:
    """Tokens the engine streamed once every request had its first one,
    over that window."""
    t_all = max(f[0][0] for f in frames)
    t_end = max(f[-1][0] for f in frames)
    n = sum(k for f in frames for t, k in f if t > t_all)
    return n / (t_end - t_all) if t_end > t_all else float("nan")


async def http_serve(engine, tokenizer, batches: List[List[dict]], stream: bool,
                     tap: "Tap" = None) -> Tuple[list, bytes]:
    """Serve each batch of engine requests through the port's HttpService
    over ``link(OpenAIPreprocessor, Backend, engine)`` with its serving
    client (``/v1/completions``, token-id prompts, ``ignore_eos``), one
    batch after the other; returns each batch's report and the
    ``/metrics`` body.  The engine is stopped at the end."""
    from dynamo_tpu_torch.bench_serving import run_bench
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.pipeline import link

    pipe = link(OpenAIPreprocessor("m", tokenizer), Backend(tokenizer), tap or engine)
    manager = ModelManager()
    manager.add_completion_model("m", pipe)
    manager.add_chat_model("m", pipe)
    service = HttpService(manager, port=0)
    await service.start()
    host, port = service.address
    reports = []
    try:
        for batch in batches:
            reports.append(await run_bench(
                host, port, "m", bench_items(batch), concurrency=len(batch), stream=stream
            ))
        status, metrics = await http_call(port, "GET", "/metrics")
        if status != 200:
            fail(f"GET /metrics answered {status}")
    finally:
        await service.stop()
        await engine.stop()
    return reports, metrics


def check_http_results(what: str, reports, batches) -> None:
    """Every request completed with its max_tokens (finish ``length``), its
    usage exact and no error frame."""
    for report, batch in zip(reports, batches):
        for i, (r, req) in enumerate(zip(report.results, batch)):
            want = req["stop_conditions"]["max_tokens"]
            usage = r.usage or {}
            if not r.ok:
                fail(f"{what} request {i}: {r.error}")
            if (r.finish_reason != "length" or usage.get("completion_tokens") != want
                    or usage.get("prompt_tokens") != len(req["token_ids"])):
                fail(f"{what} request {i}: finish {r.finish_reason} usage {usage}, "
                     f"want {want} tokens after {len(req['token_ids'])}")


def metrics_requests(body: bytes) -> Dict[str, float]:
    """``/metrics``' request counter by status, parsed line by line."""
    out: Dict[str, float] = {}
    for line in body.decode().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        m = re.fullmatch(r'([a-zA-Z_:][\w:]*)(\{[^}]*\})? (\S+)', line)
        if m is None:
            fail(f"/metrics line does not parse: {line!r}")
        float(m.group(3))
        if m.group(1) == "dynamo_http_service_requests_total":
            status = re.search(r'status="([^"]*)"', m.group(2)).group(1)
            out[status] = out.get(status, 0.0) + float(m.group(3))
    return out


def serve_http_phase(ref: Dict[str, object], served: Dict[str, object], card: str) -> Dict[str, int]:
    """(a) the reference model through HTTP, card against CPU; (b)
    Llama-3-8B through HTTP, cold then warm; (c) the CLI's HTTP server as a
    subprocess on a checkpoint directory written here.  Returns (b)'s
    kernel launches."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    tmp = tempfile.mkdtemp(prefix="chip-smoke-http-")
    try:
        # (a) the reference phase's f32 model and batches, 256 byte tokens
        cfg, params, batches = ref["cfg"], ref["params"], ref["batches"]
        tok_dir = os.path.join(tmp, "bytes")
        os.makedirs(tok_dir)
        write_tokenizer(tok_dir, cfg.vocab_size, 0)
        tok = Tokenizer.from_model_dir(tok_dir)
        flat = [r for b in batches for r in b]
        want = [stream_text(tok, t) for t in ref["streams"]]
        texts = {}
        for stream in (True, False):
            for dev in ("cuda", "cpu"):
                eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**ref["ecfg"]),
                                  device=dev)
                reset_launches()
                reports, _ = asyncio.run(http_serve(eng, tok, batches, stream))
                if dev == "cuda":
                    check_launch_invariants(f"serve-http (a) stream={stream}", eng, read_launches())
                check_http_results(f"serve-http (a) {dev} stream={stream}", reports, batches)
                texts[dev, stream] = [r.text for rep in reports for r in rep.results]
            if texts["cuda", stream] != texts["cpu", stream]:
                fail(f"serve-http (a) stream={stream}: card texts {texts['cuda', stream]} "
                     f"differ from the CPU's {texts['cpu', stream]}")
            if texts["cuda", stream] != want:
                fail(f"serve-http (a) stream={stream}: texts {texts['cuda', stream]} differ "
                     f"from the decoded direct streams {want}")
        print(f"serve-http: (a) {len(flat)} requests x SSE and aggregated: card texts == "
              f"CPU texts == decoded direct streams")

        # (b) Llama-3-8B at full width and depth, bf16, through HTTP
        t0 = time.perf_counter()
        big = os.path.join(tmp, "llama3")
        os.makedirs(big)
        write_tokenizer(big, 128000, 256)
        tok8 = Tokenizer.from_model_dir(big)
        print(f"serve-http: (b) tokenizer of {tok8.vocab_size} ids written and read "
              f"in {time.perf_counter() - t0:.3f} s")
        cfg8 = ModelConfig.llama3_8b()
        primer, batch = serve_requests(cfg8.vocab_size)
        eng8 = TorchEngine.random_init(cfg8, EngineConfig(num_pages=1024), seed=0)
        tap = Tap(eng8)
        reset_launches()
        runs = [primer, batch, batch]
        reports, metrics = asyncio.run(http_serve(eng8, tok8, runs, True, tap))
        counted = read_launches()
        check_launch_invariants("serve-http (b)", eng8, counted)
        check_http_results("serve-http (b)", reports, runs)
        for name in ("packed_ragged_attention", "paged_decode_attention"):
            if counted[name] <= 0:
                fail(f"{name} never launched in serve-http (b)")
        by_status = metrics_requests(metrics)
        sent = sum(len(b) for b in runs)
        if by_status != {"success": float(sent)}:
            fail(f"serve-http (b): /metrics counts {by_status}, {sent} requests sent")
        ids = list(tap.frames)
        order = [ids[:1], ids[1:1 + len(batch)], ids[1 + len(batch):]]
        greedy = [i for i, r in enumerate(batch) if not r["sampling_options"]]
        same = 0
        for label, rep, rids, streams in (
            ("cold", reports[1], order[1], served["streams"][:len(batch)]),
            ("warm", reports[2], order[2], served["streams"][len(batch):]),
        ):
            s = rep.summary()
            dec = decode_phase_rate([tap.frames[r] for r in rids])
            print(f"serve-http: (b) {label} ttft_p50_ms={s['ttft_ms']['p50']} "
                  f"ttft_p99_ms={s['ttft_ms']['p99']} tok_s={s['output_tok_s']} "
                  f"decode_phase_tok_s={dec:.3f} wall_s={s['wall_s']} on {card}")
            print(f"serve-http: (b) {label} client ttft_ms="
                  f"{[round(r.ttft_s * 1e3, 3) for r in rep.results]}")
            same += sum(rep.results[i].text == stream_text(tok8, streams[i]) for i in greedy)
        print(f"serve-http: (b) launches {counted} dispatches={dict(eng8.dispatches)}")
        print(f"serve-http: (b) greedy texts equal to the serve phase's decoded direct "
              f"streams: {same} of {2 * len(greedy)}")
        del eng8, tap
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the CLI over a checkpoint directory, against an in-process engine
        cli_texts, direct_texts = cli_phase(tmp, card)
        if cli_texts != direct_texts:
            fail(f"serve-http (c): the CLI's texts {cli_texts} differ from the in-process "
                 f"engine's {direct_texts}")
        print(f"serve-http: (c) {len(cli_texts)} requests: CLI texts == in-process texts")
        return {k: counted[k] for k in ("packed_ragged_attention", "paged_decode_attention")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- serve-a3: the full flash prefill's other callers ----------------------------


def a3_reference(ref: Dict[str, object]) -> None:
    """serve-a3 (a): the reference phase's f32 model on the card and on the
    CPU: echo requests' prompt-logprob entries (the same ids, logprobs
    within 1e-4), embeddings (within 1e-5) and soft-prompt greedy streams
    (identical) agree, and on the card the model's own embedding rows fed
    as a soft prompt give the token prompt's greedy stream exactly."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    cfg, params, ecfg = ref["cfg"], ref["params"], ref["ecfg"]
    rng = np.random.default_rng(21)
    V, H = cfg.vocab_size, cfg.hidden_size

    def toks(n):
        return rng.integers(1, V, n)

    prompt = toks(12).tolist()
    own_rows = params["embed"][prompt[:8]].numpy()
    batch = [
        dict(request(toks(70), 8), prompt_logprobs=3),  # past a mixed budget
        dict(request(toks(9), 8), prompt_logprobs=0),
        request(prompt, 10),
        dict(request([0] * 8 + prompt[8:], 10), mm_embeds=own_rows.tolist()),
        dict(request([0] * 40 + toks(5).tolist(), 10),
             mm_embeds=(0.05 * rng.standard_normal((40, H))).tolist()),
    ]
    inputs = [toks(n).tolist() for n in (3, 100, 17, 64, 1)]
    out = {}
    for dev in ("cuda", "cpu"):
        # a private registry: the HTTP service's /metrics of (b) reads the
        # default one
        eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**ecfg), device=dev,
                          metrics_registry=MetricsRegistry())
        reset_launches()
        vecs = np.asarray(asyncio.run(eng.embed(inputs)))
        res = asyncio.run(serve(eng, [batch]))
        out[dev] = (vecs, res)
        if dev == "cuda":
            check_launch_invariants("serve-a3 (a)", eng, read_launches())
    (cv, cres), (hv, hres) = out["cuda"], out["cpu"]
    err = float(np.abs(cv - hv).max())
    if err > 1e-5 or not np.allclose(np.linalg.norm(cv, axis=1), 1.0, atol=1e-5):
        fail(f"serve-a3 (a): card embeddings differ from the CPU's by {err}")
    lp_err = 0.0
    for i, (c, h) in enumerate(zip(cres, hres)):
        if c["tokens"] != h["tokens"] or len(c["tokens"]) != batch[i]["stop_conditions"]["max_tokens"]:
            fail(f"serve-a3 (a) request {i}: card stream {c['tokens']} differs from the "
                 f"CPU's {h['tokens']}")
        if "prompt_logprobs" not in batch[i]:
            continue
        if len(c["plp"]) != 1 or len(h["plp"]) != 1:
            fail(f"serve-a3 (a) request {i}: {len(c['plp'])} frames carry prompt logprobs")
        (ce,), (he,) = c["plp"], h["plp"]
        if [e[0] for e in ce] != batch[i]["token_ids"] or [e[0] for e in he] != [e[0] for e in ce]:
            fail(f"serve-a3 (a) request {i}: prompt logprob ids differ")
        for a, b in zip(ce[1:], he[1:]):
            lp_err = max(lp_err, abs(a[1] - b[1]))
            if a[2] is not None and [t for t, _ in a[2]] != [t for t, _ in b[2]]:
                fail(f"serve-a3 (a) request {i}: top prompt logprob ids differ")
    if lp_err > 1e-4:
        fail(f"serve-a3 (a): card prompt logprobs differ from the CPU's by {lp_err}")
    if cres[3]["tokens"] != cres[2]["tokens"]:
        fail(f"serve-a3 (a): the model's own embedding rows as a soft prompt gave "
             f"{cres[3]['tokens']}, the token prompt {cres[2]['tokens']}")
    print(f"serve-a3: (a) card == CPU: embeddings max_abs_err={err:.3e}, prompt logprobs "
          f"max_abs_err={lp_err:.3e}, {len(batch)} greedy streams (2 soft prompts) equal; "
          f"own embedding rows == token prompt")


async def a3_serve(engine, tokenizer, primer, batch, echoes, embeds, soft) -> Dict[str, object]:
    """serve-a3 (b) on one event loop: the port's HttpService over
    ``link(OpenAIPreprocessor, Backend, engine)`` and an EmbeddingEngine
    over ``engine.embed``.  The primer, the batch twice (cold, then warm
    alone: the baseline), the batch once more with the ``echoes`` posted
    beside it, one ``/v1/embeddings`` call of ``embeds`` and one for each
    of its inputs alone, then the ``soft`` requests through ``generate()``
    one after the other.  The engine is stopped at the end."""
    from dynamo_tpu_torch.bench_serving import run_bench
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.embedding import EmbeddingEngine
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.pipeline import link

    tap = Tap(engine)
    pipe = link(OpenAIPreprocessor("m", tokenizer), Backend(tokenizer), tap)
    manager = ModelManager()
    manager.add_completion_model("m", pipe)
    manager.add_embedding_model(
        "m", EmbeddingEngine(engine.embed, tokenizer, engine.cfg.max_seq_len)
    )
    service = HttpService(manager, port=0)
    await service.start()
    host, port = service.address
    out: Dict[str, object] = {"tap": tap, "marks": []}

    async def mark(label: str) -> None:
        # read every span enqueued so far (the device is idle here), so
        # each step's dispatches show apart
        await engine._on_executor(engine._drain_spans, True)
        out["marks"].append((label, engine.dispatch_spans()))

    try:
        runs = []
        for reqs in (primer, batch, batch):
            runs.append(await run_bench(host, port, "m", bench_items(reqs),
                                        concurrency=len(reqs), stream=True))
        seen = set(tap.frames)
        bench = asyncio.ensure_future(run_bench(
            host, port, "m", bench_items(batch), concurrency=len(batch), stream=True
        ))
        answers = await asyncio.gather(*[
            http_call(port, "POST", "/v1/completions", body) for body in echoes
        ])
        runs.append(await bench)
        out["runs"] = runs
        out["baseline_ids"] = list(tap.frames)[len(primer) + len(batch):][: len(batch)]
        out["with_echo_ids"] = [r for r in tap.frames if r not in seen and r not in tap.echoes]
        out["echoes"] = answers
        await mark("batch")
        out["embeds"] = await http_call(port, "POST", "/v1/embeddings",
                                        {"model": "m", "input": embeds})
        await mark(f"embed of {len(embeds)} inputs")
        out["embed_solo"] = []
        for e in embeds:
            out["embed_solo"].append(await http_call(port, "POST", "/v1/embeddings",
                                                     {"model": "m", "input": e}))
            await mark(f"embed of the {len(e)}-token input alone")
        hits = engine._prefix_hits
        out["soft"] = []
        for i, r in enumerate(soft):
            out["soft"].append(await serve_one(engine, r))
            await mark(f"soft prompt {i}")
        out["soft_hits"] = engine._prefix_hits - hits
        status, metrics = await http_call(port, "GET", "/metrics")
        if status != 200:
            fail(f"GET /metrics answered {status}")
        out["metrics"] = metrics
    finally:
        await service.stop()
        await engine.stop()
    return out


async def serve_one(engine, req: dict) -> List[int]:
    """One request through ``generate()``: its tokens."""
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    tokens: List[int] = []
    async for item in stream:
        if item.is_error():
            fail(f"serve-a3: a soft-prompt request failed: {item.error_message()}")
        tokens += (item.data or {}).get("token_ids") or []
    return tokens


def check_echo_body(i: int, status: int, raw: bytes, prompt_len: int, max_tokens: int) -> None:
    """One echo completion: 200, its usage, one logprob entry per prompt
    token (the first without a logprob) and per completion token, every
    logprob <= 0, each top list sorted."""
    if status != 200:
        fail(f"serve-a3 (b) echo {i}: status {status} {raw[:300]!r}")
    body = json.loads(raw)
    usage = body["usage"]
    if usage["prompt_tokens"] != prompt_len or usage["completion_tokens"] != max_tokens:
        fail(f"serve-a3 (b) echo {i}: usage {usage}")
    lp = body["choices"][0]["logprobs"]
    n = prompt_len + max_tokens
    if len(lp["token_logprobs"]) != n or len(lp["top_logprobs"]) != n:
        fail(f"serve-a3 (b) echo {i}: {len(lp['token_logprobs'])} entries, want {n}")
    if lp["token_logprobs"][0] is not None or lp["top_logprobs"][0] is not None:
        fail(f"serve-a3 (b) echo {i}: entry 0 carries a logprob")
    if not all(x is not None and x <= 0 for x in lp["token_logprobs"][1:]):
        fail(f"serve-a3 (b) echo {i}: a logprob is missing or positive")
    for top in lp["top_logprobs"][1:]:
        vals = list(top.values())
        if not vals or vals != sorted(vals, reverse=True) or vals[0] > 0:
            fail(f"serve-a3 (b) echo {i}: a top list is empty or unsorted: {top}")


def dispatch_counter(body: bytes) -> Dict[str, float]:
    """``/metrics``' engine dispatch counter by kind."""
    out: Dict[str, float] = {}
    for line in body.decode().splitlines():
        m = re.fullmatch(r'dynamo_engine_dispatches_total\{kind="(\w+)"\} (\S+)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def serve_a3_phase(ref: Dict[str, object], card: str) -> Dict[str, object]:
    """serve-a3: (a) ``a3_reference``; (b) Llama-3-8B at full width and
    depth, bf16, serve's weights and config, behind the HTTP service
    (``a3_serve``): the serve batch's 8 token-id prompts embedded in one
    call (unit vectors; each within ``EMBED_TOL`` of the same prompt
    embedded alone and far from every other prompt's; exact
    ``prompt_tokens``), 4 echo completions (``logprobs: 5``, 8 tokens; 2 on
    the cached 1024-token prefix) beside the streaming batch, 2 requests of
    576 soft-prompt rows (llava-1.5's 24 x 24 patches) and 64 text tokens
    over the same placeholder ids; (c) kernel 2 launches exactly once per
    layer per scoring, embedding and soft-prompt prefill dispatch, nothing
    else launches it, every other launch invariant holds, and ``/metrics``
    counts the scoring and embedding dispatches.  Returns (b)'s launches
    and spans."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    t_phase = time.perf_counter()
    a3_reference(ref)
    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    rng = np.random.default_rng(8)
    prefix = primer[0]["token_ids"][:1024]
    echo_prompts = [
        prefix + rng.integers(1, cfg.vocab_size, 24).tolist(),
        prefix + rng.integers(1, cfg.vocab_size, 300).tolist(),
        rng.integers(1, cfg.vocab_size, 120).tolist(),
        rng.integers(1, cfg.vocab_size, 700).tolist(),
    ]
    echoes = [
        {"model": "m", "prompt": p, "echo": True, "logprobs": 5, "max_tokens": 8,
         "ignore_eos": True}
        for p in echo_prompts
    ]
    embeds = [r["token_ids"] for r in batch]
    text = rng.integers(1, cfg.vocab_size, 64).tolist()
    soft = [
        dict(request([0] * 576 + text, 32),
             mm_embeds=(0.02 * rng.standard_normal((576, cfg.hidden_size))).astype(
                 np.float32).tolist())
        for _ in range(2)
    ]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-a3-")
    try:
        write_tokenizer(tmp, 128000, 256)
        tok = Tokenizer.from_model_dir(tmp)
        engine = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024), seed=0)
        reset_launches()
        t0 = time.perf_counter()
        res = asyncio.run(a3_serve(engine, tok, primer, batch, echoes, embeds, soft))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counted = read_launches()
    d = dict(engine.dispatches)
    check_launch_invariants("serve-a3 (b)", engine, counted)
    layers = cfg.num_layers

    # (b) the plain streams, the echoes, the embeddings, the soft prompts
    runs = [primer, batch, batch, batch]
    check_http_results("serve-a3 (b)", res["runs"], runs)
    for i, ((status, raw), p) in enumerate(zip(res["echoes"], echo_prompts)):
        check_echo_body(i, status, raw, len(p), 8)
    status, raw = res["embeds"]
    if status != 200:
        fail(f"serve-a3 (b) /v1/embeddings: status {status} {raw[:300]!r}")
    body = json.loads(raw)
    vecs = np.asarray([e["embedding"] for e in body["data"]], np.float64)
    norms = np.linalg.norm(vecs, axis=1)
    if vecs.shape != (len(embeds), cfg.hidden_size) or np.abs(norms - 1.0).max() > 1e-4:
        fail(f"serve-a3 (b): embeddings of shape {vecs.shape}, norms {norms}")
    if body["usage"]["prompt_tokens"] != sum(len(e) for e in embeds):
        fail(f"serve-a3 (b): embeddings usage {body['usage']}")
    solo = []
    for i, (status, raw) in enumerate(res["embed_solo"]):
        if status != 200:
            fail(f"serve-a3 (b) /v1/embeddings of input {i} alone: status {status} {raw[:300]!r}")
        solo.append(json.loads(raw)["data"][0]["embedding"])
    solo = np.asarray(solo, np.float64)
    # dist[i, j]: batched vector i against input j embedded alone
    dist = np.abs(vecs[:, None, :] - solo[None, :, :]).max(axis=2)
    solo_err = float(np.diag(dist).max())
    cos_min = float(((vecs * solo).sum(axis=1)
                     / (norms * np.linalg.norm(solo, axis=1))).min())
    # each batched vector's nearest other input: at least 10 x as far as its
    # own, and over 2 x EMBED_TOL, so no other input's vector passes for it
    others = dist + np.diag(np.full(len(embeds), np.inf))
    near = others.argmin(axis=1)
    margin = float((others.min(axis=1) / np.maximum(np.diag(dist), 1e-30)).min())
    apart = float(others.min())
    i_near = int(others.min(axis=1).argmin())
    if (solo_err > EMBED_TOL or cos_min < 1.0 - 1e-4 or margin < 10.0
            or apart <= 2 * EMBED_TOL):
        fail(f"serve-a3 (b): batched embeddings against each input alone: own max_abs_err "
             f"{np.diag(dist)}, least cosine {cos_min}, nearest other input "
             f"{others.min(axis=1)} (inputs {near}), least ratio {margin}")
    for i, toks in enumerate(res["soft"]):
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"serve-a3 (b) soft prompt {i}: {len(toks)} tokens")
    if res["soft_hits"] != 0:
        fail(f"serve-a3 (b): soft prompts hit {res['soft_hits']} cached prefix tokens")

    # (c) kernel 2's launches: the scoring, embedding and soft-prompt
    # prefill dispatches, nothing else
    flash = counted["flash_prefill_attention"]
    want = layers * (d.get("prompt_score", 0) + d.get("embed", 0) + d.get("prefill", 0))
    if (flash != want or d.get("prompt_score") != len(echoes) or d.get("embed") != 1 + len(embeds)
            or d.get("prefill") != len(soft)
            or engine.prefill_dispatches != {"full": len(soft), "suffix": 0}):
        fail(f"serve-a3 (c): flash prefill launched {flash}, want {want}; dispatches {d}, "
             f"prefill routes {engine.prefill_dispatches}")
    for name in ("packed_ragged_attention", "paged_decode_attention"):
        if counted[name] <= 0:
            fail(f"{name} never launched in serve-a3 (b)")
    exported = dispatch_counter(res["metrics"])
    for kind in ("prompt_score", "embed"):
        if exported.get(kind) != d[kind]:
            fail(f"serve-a3 (c): /metrics counts {exported.get(kind)} {kind} dispatches, "
                 f"the engine {d[kind]}")
    print(f"serve-a3: (b) {len(echoes)} echo bodies, {len(embeds)} embeddings (norms within "
          f"{np.abs(norms - 1.0).max():.2e} of 1; against each input alone max_abs_err={solo_err:.3e} "
          f"least cosine={cos_min:.9f}, nearest other input {apart:.3e} ({len(embeds[i_near])} "
          f"against {len(embeds[near[i_near]])} tokens), least ratio {margin:.3e}), "
          f"{len(soft)} soft prompts of 576 rows, {len(batch)} plain streams of 64 tokens: ok")
    print(f"serve-a3: (c) flash prefill launches {flash} == {layers} x (prompt_score "
          f"{d['prompt_score']} + embed {d['embed']} + prefill {d['prefill']}); /metrics "
          f"dispatches {exported}; launches {counted}")

    # what the echoes cost the plain streams, and each dispatch's span
    tap = res["tap"]
    base = decode_phase_rate([tap.frames[r] for r in res["baseline_ids"]])
    beside = decode_phase_rate([tap.frames[r] for r in res["with_echo_ids"]])
    print(f"serve-a3: decode_phase_tok_s alone={base:.3f} with_echoes={beside:.3f} "
          f"drop={1.0 - beside / base:.4f} wall_s={wall:.3f} on {card}")
    spans = engine.dispatch_spans()
    for kind in ("prompt_score", "embed", "prefill"):
        st = spans.get(kind)
        if not st or not st["n"]:
            fail(f"serve-a3: no {kind} span was read")
        print(f"serve-a3: span {kind} n={int(st['n'])} device_ms={st['device_ms']:.3f} "
              f"mean_ms={st['device_ms'] / st['n']:.3f} gap_ms={st['gap_ms']:.3f} on {card}")
    # each embedding call's and each soft prompt's own spans
    marks = res["marks"]
    for (_, before), (label, after) in zip(marks, marks[1:]):
        for kind in ("embed", "prefill"):
            n = after.get(kind, {}).get("n", 0) - before.get(kind, {}).get("n", 0)
            if n:
                ms = after[kind]["device_ms"] - before.get(kind, {}).get("device_ms", 0.0)
                print(f"serve-a3: span {label}: {kind} n={int(n)} device_ms={ms:.3f} "
                      f"on {card}")
    print(f"serve-a3: phase {time.perf_counter() - t_phase:.3f} s")
    del engine, res, tap
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=flash, dispatches=d, spans=spans)


# ---------------------------------------------------------------------------
# phase 9: speculative decoding and weight-only int8
# ---------------------------------------------------------------------------


class StreamOracle:
    """A drafter that proposes known streams: for a history that starts
    with one of its prompts, the next tokens of that prompt's stream."""

    def __init__(self, pairs) -> None:
        self.pairs = [(list(p), list(p) + list(t)) for p, t in pairs]

    def propose(self, history, n):
        for prompt, full in self.pairs:
            if len(history) >= len(prompt) and history[: len(prompt)] == prompt:
                return full[len(history) : len(history) + n]
        return []


def speculating(reqs: List[dict], drafter: str, n: int = 4) -> List[dict]:
    """``reqs`` with speculation armed (the engine leaves penalized lanes
    plain)."""
    spec = {"enabled": True, "num_draft_tokens": n, "drafter": drafter}
    return [dict(r, speculation=spec) for r in reqs]


def spec_line(engine) -> str:
    """A served run's speculation numbers."""
    drafted, accepted, verifies = engine.spec_drafted, engine.spec_accepted, engine.spec_verify_steps
    standalone = engine.dispatches.get("verify", 0)
    return (
        f"spec_drafted={drafted} spec_accepted={accepted} verify_steps={verifies} "
        f"accept_rate={accepted / max(drafted, 1):.4f} "
        f"accepted_per_verify={accepted / max(verifies, 1):.4f} "
        f"standalone_verifies={standalone} folded_verifies={verifies - standalone} "
        f"auto_disabled={engine.spec_auto_disabled} enabled_frac={engine.spec_enabled_frac:.4f}"
    )


def first_divergence(streams: List[List[int]], plain: List[List[int]]) -> str:
    """How many streams equal the plain ones, and where the first that
    does not leaves its plain stream."""
    same = sum(a == b for a, b in zip(streams, plain))
    at = next(
        (
            (i, next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b))))
            for i, (a, b) in enumerate(zip(streams, plain))
            if a != b
        ),
        None,
    )
    first = "none" if at is None else f"request {at[0]} token {at[1]}"
    return f"{same} of {len(plain)} equal the plain streams, first divergence: {first}"


def a45_reference(ref: Dict[str, object]) -> None:
    """The small f32 model, card and CPU from the same weights: speculation
    with the n-gram drafter, folded and with ``fold_spec_verify=False``,
    with the ``random`` model drafter, and ``quantize="int8"`` each give
    the card the CPU's streams; the speculating runs give the plain
    streams (``ref``'s).  A model drafter over the target's own weights
    accepts every column on the card.  (The ``random`` preset is
    ``ModelConfig.tiny()``, whose head size the kernels do not take, so it
    cannot be the target here: the self-drafter stands in for the perfect
    drafter.)"""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.spec.model_drafter import ModelDrafter

    cfg, ecfg, params, batches = ref["cfg"], ref["ecfg"], ref["params"], ref["batches"]
    spec = lambda drafter: [speculating(b, drafter) for b in batches]  # noqa: E731
    runs = {
        "ngram": ({}, spec("ngram")),
        "ngram fold-off": (dict(fold_spec_verify=False), spec("ngram")),
        "model-random": (dict(draft_model="random"), spec("model")),
        "int8-weights": (dict(quantize="int8"), batches),
    }
    for name, (kw, reqs) in runs.items():
        streams = {}
        for dev in ("cuda", "cpu"):
            eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**ecfg, **kw), device=dev)
            t0 = time.perf_counter()
            streams[dev] = [r["tokens"] for r in asyncio.run(serve(eng, reqs))]
            if dev == "cuda":
                print(f"serve-a45: reference {name} card {streams['cuda']} {spec_line(eng)}")
                print(f"serve-a45: reference {name} {loop_line(eng, time.perf_counter() - t0)}")
        if streams["cuda"] != streams["cpu"]:
            fail(f"serve-a45 reference {name}: card {streams['cuda']} != cpu {streams['cpu']}")
        if kw.get("quantize") is None and streams["cuda"] != ref["streams"]:
            fail(f"serve-a45 reference {name}: speculation changed the streams")
    eng = TorchEngine(cfg, params_on(params, "cuda"), EngineConfig(**ecfg), device="cuda")
    # its window holds every history of the batch, so it sees what the
    # target sees
    eng.model_drafter = ModelDrafter(params_on(params, "cuda"), cfg, "cuda", window=256)
    t0 = time.perf_counter()
    out = asyncio.run(serve(eng, spec("model")))
    stats = [r["spec"] for r in out if r["spec"] is not None]
    print(f"serve-a45: reference self-drafter {spec_line(eng)} per request {stats}")
    # the drafter's forwards run on a stream of their own: the loop's gaps
    print(f"serve-a45: reference self-drafter {loop_line(eng, time.perf_counter() - t0)}")
    if [r["tokens"] for r in out] != ref["streams"]:
        fail("serve-a45 reference: the self-drafter changed the streams")
    if not stats or any(s["accepted_tokens"] != s["drafted_tokens"] for s in stats):
        fail(f"serve-a45 reference: the self-drafter did not accept every column: {stats}")


def serve_a45_phase(ref: Dict[str, object], served: Dict[str, object], card: str):
    """(a) ``a45_reference``.  (b) Llama-3-8B at full width and depth,
    bf16, serve's weights and ``EngineConfig(num_pages=1024)``: the primer
    and the batch, cold then warm, with every lane speculating -- the
    n-gram drafter (4 drafts), then an oracle proposing serve's plain
    streams, folded and with ``fold_spec_verify=False``.  (c) The same
    weights with ``quantize="int8"`` serving the batch.  Returns the
    launches of the folded and the fold-off oracle runs."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.engine.quant import weight_bytes
    from dynamo_tpu_torch.spec import register_drafter

    a45_reference(ref)
    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    plain = served["streams"]  # the batch cold, then warm
    pairs = [(r["token_ids"], t) for r, t in zip(batch, plain[: len(batch)])]
    register_drafter("smoke-oracle", lambda: StreamOracle(pairs))
    runs = {
        "ngram": ({}, "ngram"),
        "oracle": ({}, "smoke-oracle"),
        "oracle fold-off": (dict(fold_spec_verify=False), "smoke-oracle"),
    }
    # the oracle runs ask for top-2 logprobs: where a stream leaves serve's,
    # they show the margin between the two best tokens there
    with_top2 = [
        dict(r, sampling_options=dict(r["sampling_options"], logprobs=2)) for r in batch
    ]
    launches: Dict[str, Dict[str, int]] = {}
    for run, (kw, drafter) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
        reset_launches()
        res, wall, warm, wall_w, marks = serve_cold_warm(
            engine, speculating(primer, drafter),
            speculating(with_top2 if drafter == "smoke-oracle" else batch, drafter),
        )
        launches[run] = read_launches()
        check_launch_invariants(f"serve-a45: run {run}", engine, launches[run])
        folded = engine._fold_spec
        verifies = engine.dispatches.get("verify", 0)
        line = spec_line(engine)
        loop, loop_w = loop_line(engine, wall + wall_w), loop_line(engine, wall_w, marks)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        check_streams(f"serve-a45 run {run}", res[1:], cfg.vocab_size)
        check_streams(f"serve-a45 run {run} warm", warm, cfg.vocab_size)
        if folded and verifies:
            fail(f"serve-a45 run {run}: {verifies} standalone verify dispatches while folded")
        if not folded and not verifies:
            fail(f"serve-a45 run {run}: no standalone verify dispatch with folding off")
        st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
        print(f"serve-a45: run {run} {kw} {line}")
        print(
            f"serve-a45: run {run} wall_s={wall:.3f} tok_s={st['tok_s']:.3f} "
            f"decode_phase_tok_s={st['dec']:.3f} warm wall_s={wall_w:.3f} "
            f"tok_s={st_w['tok_s']:.3f} decode_phase_tok_s={st_w['dec']:.3f} (serve's "
            f"plain warm: tok_s={served['tok_s_warm']:.3f} decode_phase_tok_s="
            f"{served['dec_warm']:.3f}) peak_mem_gib={peak_gib:.3f} on {card}"
        )
        greedy = [i for i, r in enumerate(batch) if not r["sampling_options"].get("temperature")]
        streams = [r["tokens"] for r in res[1:] + warm]
        pick = lambda s: [s[i] for i in greedy] + [s[len(batch) + i] for i in greedy]  # noqa: E731
        print(f"serve-a45: run {run} greedy streams: {first_divergence(pick(streams), pick(plain))}")
        for i in greedy:
            got, want, top = res[1 + i]["tokens"], plain[i], res[1 + i]["top"]
            j = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), None)
            if j is not None and top:
                print(f"serve-a45: run {run} request {i} token {j}: serve's {want[j]}, "
                      f"here {got[j]}, this run's top-2 logprobs there {top[j]}")
        print(f"serve-a45: run {run} {loop}")
        print(f"serve-a45: run {run} warm {loop_w}")
    # (c) weight-only int8 from the same weights
    bf16_bytes = weight_bytes(params)
    engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, quantize="int8"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    int8_bytes = weight_bytes(engine.params)
    reset_launches()
    res, wall, warm, wall_w, marks = serve_cold_warm(engine, primer, batch)
    counted = read_launches()
    check_launch_invariants("serve-a45: run int8-weights", engine, counted)
    loop_w = loop_line(engine, wall_w, marks)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    check_streams("serve-a45 run int8-weights", res[1:], cfg.vocab_size)
    check_streams("serve-a45 run int8-weights warm", warm, cfg.vocab_size)
    st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
    print(
        f"serve-a45: run int8-weights weight_bytes={int8_bytes} bf16_weight_bytes={bf16_bytes} "
        f"ratio={int8_bytes / bf16_bytes:.4f} wall_s={wall:.3f} tok_s={st['tok_s']:.3f} "
        f"decode_phase_tok_s={st['dec']:.3f} warm tok_s={st_w['tok_s']:.3f} "
        f"decode_phase_tok_s={st_w['dec']:.3f} peak_mem_gib={peak_gib:.3f} on {card}"
    )
    print(f"serve-a45: run int8-weights warm {loop_w}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: serve-kvbm, the KV block manager's lower tiers
# ---------------------------------------------------------------------------


def kv_series(engine) -> Dict[str, float]:
    """The engine's ``dynamo_kv_*`` samples, read from its registry's
    rendering: ``name{labels}`` -> value."""
    body, _ = engine.obs.registry.render()
    out = {}
    for line in body.decode().splitlines():
        if line.startswith("dynamo_kv_") and "_created" not in line:
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def kv_rate(after: Dict[str, float], before: Dict[str, float], family: str, tier: str) -> str:
    """Bytes, seconds and GB/s of one ``dynamo_kv_<family>`` tier between
    two readings."""
    b = after.get(f'dynamo_kv_{family}_bytes_total{{tier="{tier}"}}', 0.0) - before.get(
        f'dynamo_kv_{family}_bytes_total{{tier="{tier}"}}', 0.0)
    s = after.get(f'dynamo_kv_{family}_seconds_sum{{tier="{tier}"}}', 0.0) - before.get(
        f'dynamo_kv_{family}_seconds_sum{{tier="{tier}"}}', 0.0)
    return f"{family}[{tier}] bytes={int(b)} s={s:.6f} gb_s={b / s / 1e9 if s > 0 else 0.0:.3f}"


def check_no_fallback(what: str, engine) -> None:
    """No offload copy failed and no swap or onboard fell back."""
    oe = engine.offload_engine
    bad = dict(copy_fails=oe.copy_fails, swap_fallbacks=oe.swap_fallbacks,
               onboard_fallbacks=oe.onboard_fallbacks)
    if any(bad.values()):
        fail(f"{what}: offload fallbacks counted {bad}")


def prefix_pages(engine, hashes) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """Host copies of the pool pages registered under ``hashes``."""
    from dynamo_tpu_torch.engine.kv_cache import QuantKV

    pool, kv = engine.sched.pool, engine.kv.pages
    out = {}
    for h in hashes:
        blk = pool._registered.get(h)
        if blk is None:
            continue
        ids = torch.tensor(blk.pages, device=kv.q.device if isinstance(kv, QuantKV) else kv.device)
        parts = (kv.q, kv.s) if isinstance(kv, QuantKV) else (kv,)
        out[h] = tuple(t[:, :, ids].cpu() for t in parts)
    return out


KVBM_REFERENCE = {
    "host": dict(host_offload_blocks=16),
    "host+disk": dict(host_offload_blocks=1, disk_offload_blocks=64),
}
KVBM_REFERENCE.update(
    {f"{name}-int8": dict(kw, kv_dtype="int8") for name, kw in list(KVBM_REFERENCE.items())}
)


def kvbm_reference(ref: Dict[str, object]) -> None:
    """(a) The small f32 model on the card and on the CPU from the same
    weights, the offload plane armed: two prefixes, churn that evicts
    them, the two prefixes again -- the same streams, under host-only and
    host+disk (a ring of 1 block) and their int8-pool twins, with blocks
    offloaded and, host-only, onboarded on the card.  Then swap pressure:
    swap == recompute == a roomy pool on both."""
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg, params = ref["cfg"], ref["params"]
    V = cfg.vocab_size
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(1, V, 48).tolist() for _ in range(2)]
    again = [request(prefixes[0] + [5], 12), request(prefixes[1] + [6, 7], 12)]
    churn = [[request(rng.integers(1, V, 70), 12) for _ in range(2)] for _ in range(2)]
    batches = [again] + churn + [again]
    ecfg = dict(num_pages=20, max_seq_len=256, mixed_token_budget=32, max_batch_size=2)
    for name, kw in KVBM_REFERENCE.items():
        streams, stats = {}, {}
        for dev in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as tmp:
                ekw = dict(ecfg, **kw)
                if "disk_offload_blocks" in kw:
                    ekw["disk_offload_dir"] = tmp
                eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**ekw), device=dev)
                streams[dev] = [r["tokens"] for r in asyncio.run(serve(eng, batches))]
                oe = eng.offload_engine
                stats[dev] = dict(offloaded=oe.offload_bytes, tier_hits=dict(oe.tier_hits),
                                  disk_promotes=oe.disk_promotes)
                check_no_fallback(f"serve-kvbm reference {name} {dev}", eng)
        print(f"serve-kvbm: reference {name} card {streams['cuda']} card {stats['cuda']} "
              f"cpu {stats['cpu']}")
        if streams["cuda"] != streams["cpu"]:
            fail(f"serve-kvbm reference {name}: card {streams['cuda']} != cpu {streams['cpu']}")
        if streams["cuda"][-2:] != streams["cuda"][:2]:
            fail(f"serve-kvbm reference {name}: the onboarded prefixes changed the streams")
        if not stats["cuda"]["offloaded"]:
            fail(f"serve-kvbm reference {name}: nothing was offloaded on the card")
        if "disk_offload_blocks" not in kw and not stats["cuda"]["tier_hits"]["host"]:
            fail(f"serve-kvbm reference {name}: nothing was onboarded on the card")
    # swap pressure: two growing lanes a tight pool cannot hold together,
    # in the serial loop (the pipelined one may preempt a lane whose first
    # token is still device-only, which recomputes)
    pair = [request(rng.integers(1, V, 20), 60) for _ in range(2)]
    for kv_dtype in (None, "int8"):
        runs = {}
        for run, (pages, swap) in {"roomy": (64, True), "swap": (9, True),
                                   "recompute": (9, False)}.items():
            for dev in ("cuda", "cpu"):
                eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(
                    **dict(ecfg, num_pages=pages), host_offload_blocks=32, swap_preemption=swap,
                    kv_dtype=kv_dtype, async_dispatch=False), device=dev)
                out = [r["tokens"] for r in asyncio.run(serve(eng, [pair]))]
                runs[(run, dev)] = out
                check_no_fallback(f"serve-kvbm reference swap {run} {dev}", eng)
                if dev == "cuda":
                    print(f"serve-kvbm: reference swap {run} kv_dtype={kv_dtype} "
                          f"preempt_swap={eng.sched.preempt_swap} "
                          f"preempt_recompute={eng.sched.preempt_recompute} "
                          f"swap_ins={eng.offload_engine.swap_ins} "
                          f"graph_replays={eng.graph_replays}")
                    if run == "swap" and not (eng.sched.preempt_swap
                                              and sum(eng.graph_replays.values())):
                        fail("serve-kvbm reference: no preemption swapped, or no graph "
                             "replayed, on the card")
                    if run == "recompute" and not eng.sched.preempt_recompute:
                        fail("serve-kvbm reference: no preemption recomputed on the card")
        want = runs[("roomy", "cpu")]
        if any(v != want for v in runs.values()):
            fail(f"serve-kvbm reference swap kv_dtype={kv_dtype}: streams differ: {runs}")
    print("serve-kvbm: reference card == cpu under every offload config; swap == recompute == roomy")


def kvbm_round_requests(prefixes, rng, vocab: int) -> List[dict]:
    """8 requests over 4 prefixes, two each, suffixes of 16 to 256 tokens,
    32 new tokens; greedy but for two seeded temperature lanes."""
    suffix = [16, 256, 40, 200, 64, 128, 96, 180]
    out = []
    for i, n in enumerate(suffix):
        kw = {}
        if i == 3:
            kw = dict(temperature=0.8, seed=7)
        elif i == 6:
            kw = dict(temperature=1.0, seed=11)
        out.append(request(np.concatenate([prefixes[i // 2], rng.integers(1, vocab, n)]), 32, **kw))
    return out


def kvbm_tiers(params, card: str) -> None:
    """(b) Llama-3-8B, bf16, ``EngineConfig(num_pages=512,
    host_offload_blocks=128, disk_offload_blocks=1024)``: round 1 (8
    requests over 4 1024-token prefixes, two each), round 2 (4 other
    prefixes: its admissions evict round 1's blocks into the host ring,
    whose overflow spills to disk), round 3 (round 1's requests again, last
    first, arriving as round 2's first token streams, so they queue for
    slots and the engine prefetches their offloaded chains meanwhile).  Per
    round: wall, tok/s, TTFT from arrival and from admission, and the
    distinct prefix blocks reused from G1 and onboarded from G2 and G3 (a
    block's tier as round 3 arrives); offload and onboard bytes and GB/s
    from ``dynamo_kv_*``.  Round 3 must onboard from both tiers, and every
    round-1 prefix block round 3 onboarded or kept resident must hold, bit
    for bit, the bytes copied before round 2."""
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    from dynamo_tpu_torch.tokens.sequence import TokenBlockSequence

    cfg = ModelConfig.llama3_8b()
    V = cfg.vocab_size
    rng = np.random.default_rng(11)
    prefixes = {r: [rng.integers(1, V, 1024) for _ in range(4)] for r in (1, 2)}
    reqs = {r: kvbm_round_requests(prefixes[r], rng, V) for r in (1, 2)}
    # round 3 sends round 1's requests last first: the chains round 2
    # evicted last are still in the ring and are walked (pinned) first,
    # before the promotions of the chains on disk churn the ring
    reqs[3] = reqs[1][::-1]
    block_hashes = {
        r: {h for q in reqs[r] for h in TokenBlockSequence(q["token_ids"], 16).sequence_hashes()}
        for r in (1, 2)
    }
    prefix_hashes = [
        h for p in prefixes[1] for h in TokenBlockSequence(p.tolist(), 16).sequence_hashes()
    ]
    with tempfile.TemporaryDirectory() as tmp:
        engine = TorchEngine(cfg, params, EngineConfig(
            num_pages=512, host_offload_blocks=128, disk_offload_blocks=1024,
            disk_offload_dir=tmp), metrics_registry=MetricsRegistry())
        oe = engine.offload_engine
        pool = engine.sched.pool
        # observe the prefix match: blocks matched in G1, blocks a tier
        # lookup served
        matched, served = set(), set()
        looked: List[Tuple[float, int, bool]] = []
        # checksums of round 1's blocks the tiers handed back (an admission
        # that did not fit the pool hands them back and may miss them at
        # its retry), the blocks scattered into a lane's pages, and those
        # evicted once round 3 arrived (their pages may since hold a
        # recompute)
        blobs: Dict[int, int] = {}
        onboarded_all: set = set()
        evicted_late: set = set()
        match, lookup, on_evict = pool.match, engine.sched.offload_lookup, pool.on_evict
        apply_onboards = engine._apply_onboards

        def recording_match(hashes):
            out = match(hashes)
            matched.update(b.sequence_hash for b in out)
            return out

        def recording_lookup(h):
            hit = lookup(h)
            if hit is not None:
                served.add(h)
                if h in block_hashes[1]:
                    blobs[h] = zlib.crc32(hit[0])
            looked.append((time.perf_counter(), h, hit is not None))
            return hit

        def recording_apply(seq):
            onboarded_all.update(h for h, *_ in seq.pending_onboard)
            apply_onboards(seq)

        def recording_evict(blk):
            if "classes" in state:
                evicted_late.add(blk.sequence_hash)
            on_evict(blk)

        pool.match = recording_match
        pool.on_evict = recording_evict
        engine._apply_onboards = recording_apply
        engine.sched.offload_lookup = recording_lookup
        admitted: Dict[str, float] = {}
        first: Dict[int, Dict[str, float]] = {1: {}, 2: {}, 3: {}}
        state: Dict[str, object] = {}

        async def one(rnd: int, i: int, t0: float) -> dict:
            rid = f"kvbm-{rnd}-{i}"
            ctx = Context.new(PreprocessedRequest.from_dict(reqs[rnd][i]), rid)
            stream = await engine.generate(ctx)
            tokens, frames = [], []
            async for item in stream:
                if item.is_error():
                    raise RuntimeError(item.error_message())
                got = (item.data or {}).get("token_ids") or []
                if got:
                    if not frames:
                        mono = time.monotonic()
                        seq = next((s for s in engine.sched.slots
                                    if s is not None and s.request_id == rid), None)
                        admitted[rid] = mono - seq.admitted_s if seq is not None else float("nan")
                        first[rnd][rid] = time.perf_counter()
                    frames.append((time.perf_counter(), len(got)))
                    tokens += got
            return dict(tokens=tokens, frames=frames, ttft=frames[0][0] - t0,
                        ttft_admit=admitted[rid])

        async def drain() -> None:
            # the offload thread's backlog, waited for off the engine's loop
            await asyncio.get_running_loop().run_in_executor(None, oe.drain)

        async def drive() -> Dict[int, List[dict]]:
            out = {}
            try:
                state["kv0"] = kv_series(engine)
                t0 = time.perf_counter()
                out[1] = await asyncio.gather(*[one(1, i, t0) for i in range(8)])
                state["t1"] = (t0, time.perf_counter())
                await drain()
                state["copy"] = prefix_pages(engine, prefix_hashes)
                state["kv1"] = kv_series(engine)
                state["g1"] = (set(matched), set(served))
                t2 = time.perf_counter()
                round2 = [asyncio.ensure_future(one(2, i, t2)) for i in range(8)]
                # round 3 arrives as round 2's first token streams: round
                # 2's admissions have evicted round 1's blocks, and round 2's
                # lanes hold every slot for a while yet
                while not first[2]:
                    await asyncio.sleep(0.002)
                state["backlog"] = oe._ex._work_queue.qsize()
                await drain()
                # where round 1's blocks are as round 3 arrives
                state["classes"] = {
                    h: "G1" if pool.is_registered(h) else "G2" if h in engine.offload._slots
                    else "G3" if h in oe.disk else "none"
                    for h in block_hashes[1]
                }
                state["g2"] = (set(matched), set(onboarded_all))
                t3 = time.perf_counter()
                round3 = [asyncio.ensure_future(one(3, i, t3)) for i in range(8)]
                out[2] = await asyncio.gather(*round2)
                state["t2"] = (t2, time.perf_counter())
                out[3] = await asyncio.gather(*round3)
                state["t3"] = (t3, time.perf_counter())
                await drain()
                state["kv3"] = kv_series(engine)
            finally:
                await engine.stop()
            return out

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = asyncio.run(drive())
        check_launch_invariants("serve-kvbm: tiers", engine, read_launches())
        check_no_fallback("serve-kvbm: tiers", engine)
        classes = state["classes"]
        census = {t: sum(1 for h in prefix_hashes if classes[h] == t)
                  for t in ("G1", "G2", "G3", "none")}
        print(f"serve-kvbm: round 1's prefix blocks as round 3 arrives: {census}")
        m2, s2 = state["g2"]
        for i, p in enumerate(prefixes[1]):
            hs = TokenBlockSequence(p.tolist(), 16).sequence_hashes()
            at = "".join(classes[h][1] if classes[h] != "none" else "-" for h in hs)
            got = "".join("o" if h in onboarded_all - s2 else "m" if h in matched - m2 else "."
                          for h in hs)
            print(f"serve-kvbm: prefix {i} blocks by tier at round 3's arrival {at}; "
                  f"round 3 onboarded (o) / matched in G1 (m) {got}")
        # round 3's reuse: the G1 matches and tier hits on round 1's blocks
        # after round 3 arrived
        reuse = {
            1: (block_hashes[1] & state["g1"][0], set()),
            2: (block_hashes[2] & matched, set()),
            3: (block_hashes[1] & (matched - m2), block_hashes[1] & (onboarded_all - s2)),
        }
        for rnd in (1, 2, 3):
            res = out[rnd]
            t0 = state[f"t{rnd}"][0]
            wall = max(x["frames"][-1][0] for x in res) - t0
            g1, onb = reuse[rnd]
            g2 = sum(1 for h in onb if classes[h] != "G3")
            g3 = sum(1 for h in onb if classes[h] == "G3")
            ttft = [x["ttft"] * 1e3 for x in res]
            ttft_a = [x["ttft_admit"] * 1e3 for x in res]
            print(
                f"serve-kvbm: round {rnd} wall_s={wall:.3f} "
                f"tok_s={sum(len(x['tokens']) for x in res) / wall:.3f} "
                f"ttft_ms={min(ttft):.3f} to {max(ttft):.3f} "
                f"ttft_from_admission_ms={min(ttft_a):.3f} to {max(ttft_a):.3f} "
                f"distinct prompt blocks reused: G1 {len(g1)} G2 {g2} G3 {g3} "
                f"(tokens {16 * len(g1)}, {16 * g2}, {16 * g3}) on {card}"
            )
            state[f"by_tier{rnd}"] = (g2, g3)
        for name, a, b in (("round 1", "kv1", "kv0"), ("rounds 2 and 3", "kv3", "kv1")):
            print(f"serve-kvbm: {name} {kv_rate(state[a], state[b], 'offload', 'host')} "
                  f"{kv_rate(state[a], state[b], 'onboard', 'prefix')} on {card}")
        mine = [(t - state["t3"][0], hit) for t, h, hit in looked
                if h in block_hashes[1] and t >= state["t3"][0]]
        print(
            f"serve-kvbm: round 3 tier lookups {len(mine)}, served {sum(hit for _, hit in mine)}, "
            f"first at {min((t for t, _ in mine), default=float('nan')):.3f} s after arrival; "
            f"offload backlog at arrival {state['backlog']} tasks; "
            f"prefetch overlap ratios {oe.prefetch_overlap_n} "
            f"mean {oe.prefetch_overlap_sum / max(oe.prefetch_overlap_n, 1):.4f}; "
            f"offload seconds {oe.offload_seconds:.3f} for {oe.offload_bytes} bytes"
        )
        print(
            f"serve-kvbm: tiers disk_promotes={oe.disk_promotes} "
            f"prefetch_issued={oe.prefetch_issued} prefetch_hits={oe.prefetch_hits} "
            f"ring_bytes={engine.offload.ring_nbytes} g2_blocks={len(engine.offload)} "
            f"g3_blocks={len(oe.disk)} preempt_swap={engine.sched.preempt_swap} "
            f"preempt_recompute={engine.sched.preempt_recompute} "
            f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f} on {card}"
        )
        r1 = [x["ttft_admit"] * 1e3 for x in out[1]]
        r3 = [x["ttft_admit"] * 1e3 for x in out[3][::-1]]
        print(f"serve-kvbm: ttft from admission, round 3 against round 1 (ms): "
              f"{[round(t, 3) for t in r3]} against {[round(t, 3) for t in r1]}; "
              f"means {sum(r3) / len(r3):.3f} against {sum(r1) / len(r1):.3f}")
        g2, g3 = state["by_tier3"]
        if not g2 or not g3:
            fail(f"serve-kvbm: round 3 onboarded G2 {g2} and G3 {g3} blocks: not from both")
        # byte-exact: the blobs the tiers handed back, and the pages
        # registered under round 1's prefix hashes that round 3 onboarded
        # (or kept resident) and nothing evicted since, equal round 1's
        # pages copied before round 2
        from dynamo_tpu_torch.engine.kv_cache import host_view

        now, copy = prefix_pages(engine, prefix_hashes), state["copy"]
        onboarded = reuse[3][1]
        bad_blobs = [h for h, crc in blobs.items()
                     if h in copy and crc != zlib.crc32(host_view(copy[h][0]))]
        checked = [h for h in now if h in copy and h not in evicted_late
                   and (h in onboarded or classes[h] == "G1")]
        bad = [h for h in checked if any(not torch.equal(a, b) for a, b in zip(now[h], copy[h]))]
        print(f"serve-kvbm: byte-exact: {len(bad_blobs)} of {len(blobs)} tier blobs of round 1's "
              f"prefix blocks differ from round 1's pages; {len(bad)} of {len(checked)} pages "
              f"registered under them after round 3 ({len(onboarded & set(checked))} onboarded) "
              f"differ")
        if bad or bad_blobs or not (onboarded & set(checked)):
            fail("serve-kvbm: onboarded prefix blocks differ from round 1's bytes")
        for rnd, res in out.items():
            for j, r in enumerate(res):
                if len(r["tokens"]) != 32:
                    fail(f"serve-kvbm: round {rnd} request {j} gave {len(r['tokens'])} tokens")
        greedy = [j for j, r in enumerate(reqs[1]) if not r["sampling_options"].get("temperature")]
        same = sum(out[3][7 - j]["tokens"] == out[1][j]["tokens"] for j in greedy)
        print(f"serve-kvbm: round 3 greedy streams equal to round 1's: {same} of {len(greedy)}")
        del engine, state, copy, now
        gc.collect()
        torch.cuda.empty_cache()


def kvbm_swap(params, card: str) -> None:
    """(c) Llama-3-8B, bf16: 8 lanes of 256-token prompts and 256 new
    tokens over ``num_pages=160`` with ``host_offload_blocks=512``: swap
    (device fast path), swap over host blobs only, ``swap_preemption=
    False``, and a roomy ``num_pages=1024``."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    cfg = ModelConfig.llama3_8b()
    rng = np.random.default_rng(13)
    reqs = [request(rng.integers(1, cfg.vocab_size, 256), 256, logprobs=2) for _ in range(8)]
    runs = {
        "swap": (dict(num_pages=160, host_offload_blocks=512), None),
        "swap host-blob": (dict(num_pages=160, host_offload_blocks=512), 0),
        "recompute": (dict(num_pages=160, host_offload_blocks=512, swap_preemption=False), None),
        "roomy": (dict(num_pages=1024), None),
    }
    streams = {}
    for run, (kw, dev_blocks) in runs.items():
        engine = TorchEngine(cfg, params, EngineConfig(**kw), metrics_registry=MetricsRegistry())
        oe = engine.offload_engine
        if dev_blocks is not None:
            oe.swap_device_blocks = dev_blocks
        reset_launches()
        before = kv_series(engine)
        t0 = time.perf_counter()
        res = asyncio.run(serve(engine, [reqs]))
        wall = max(r["frames"][-1][0] for r in res) - t0
        counted = read_launches()
        check_launch_invariants(f"serve-kvbm: swap run {run}", engine, counted)
        st = served_stats(res, wall, primed=False)
        line = (f"serve-kvbm: swap run {run} preempt_swap={engine.sched.preempt_swap} "
                f"preempt_recompute={engine.sched.preempt_recompute} wall_s={wall:.3f} "
                f"tok_s={st['tok_s']:.3f} "
                f"decode_phase_tok_s={st['dec']:.3f}")
        if oe is not None:
            check_no_fallback(f"serve-kvbm: swap run {run}", engine)
            kv = kv_series(engine)
            paths = {p: f"bytes={int(b)} s={s:.6f} gb_s={b / s / 1e9 if s > 0 else 0.0:.3f}"
                     for p, (b, s) in engine.swap_in_paths.items()}
            line += (f" swap_outs={oe.swap_outs} swap_ins={oe.swap_ins} "
                     f"{kv_rate(kv, before, 'offload', 'swap')} "
                     f"{kv_rate(kv, before, 'onboard', 'swap')} swap_in_by_path={paths}")
            if run.startswith("swap") and not engine.sched.preempt_swap:
                fail(f"serve-kvbm: swap run {run} swapped no preemption")
            if run == "swap host-blob" and "host" not in engine.swap_in_paths:
                fail("serve-kvbm: the host-blob run restored nothing from a host blob")
            if run == "recompute" and not engine.sched.preempt_recompute:
                fail("serve-kvbm: the recompute run preempted nothing")
        print(line + f" on {card}")
        for j, r in enumerate(res):
            if len(r["tokens"]) != 256:
                fail(f"serve-kvbm: swap run {run} request {j} gave {len(r['tokens'])} tokens")
        streams[run] = res
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    # greedy agreement among the runs; in bf16 a row may move with the
    # dispatch around it (identity is held in f32 by the reference)
    for run, other in (("swap", "recompute"), ("swap", "roomy"), ("recompute", "roomy"),
                       ("swap host-blob", "swap")):
        got = [r["tokens"] for r in streams[run]]
        want = [r["tokens"] for r in streams[other]]
        line = first_divergence(got, want).replace("the plain streams", f"{other}'s")
        for i, (a, b) in enumerate(zip(got, want)):
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if j is not None:
                top = streams[run][i]["top"]
                line += (f"; there {other}'s {b[j]}, {run}'s {a[j]}, {run}'s top-2 logprobs "
                         f"{top[j] if j < len(top) else None}")
                break
        print(f"serve-kvbm: swap run {run} greedy streams against {other}: {line}")


def kvbm_int8(params, card: str) -> None:
    """(d) One 1024-token prefix over an int8 pool at Llama-3-8B width,
    evicted to the host ring and onboarded back: data and scales
    bit-exact."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    from dynamo_tpu_torch.tokens.sequence import TokenBlockSequence

    cfg = ModelConfig.llama3_8b()
    rng = np.random.default_rng(17)
    prefix = rng.integers(1, cfg.vocab_size, 1024)
    a = request(np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 16)]), 4)
    churn = request(rng.integers(1, cfg.vocab_size, 1500), 4)
    hashes = TokenBlockSequence(prefix.tolist(), block_size=16).sequence_hashes()
    engine = TorchEngine(cfg, params, EngineConfig(
        num_pages=96, kv_dtype="int8", host_offload_blocks=128),
        metrics_registry=MetricsRegistry())
    oe = engine.offload_engine
    state = {}

    def between(i: int) -> None:
        if i == 1:
            state["copy"] = prefix_pages(engine, hashes)
        elif i == 2:
            oe.drain()
            state["evicted"] = sum(not engine.sched.pool.is_registered(h) for h in hashes)
            state["kv"] = kv_series(engine)

    reset_launches()
    res = asyncio.run(serve(engine, [[a], [churn], [a]], between))
    check_launch_invariants("serve-kvbm: int8", engine, read_launches())
    check_no_fallback("serve-kvbm: int8", engine)
    kv = kv_series(engine)
    now, copy = prefix_pages(engine, hashes), state["copy"]
    same = sum(all(torch.equal(x, y) for x, y in zip(now[h], copy[h])) for h in hashes if h in now)
    print(f"serve-kvbm: int8 prefix blocks evicted={state['evicted']} of {len(hashes)} "
          f"onboarded_blocks={int(oe.onboard_detail.get('prefix', [0])[0] // engine.kv.bytes_per_page)} "
          f"bit-exact (data and scales) {same} of {len(copy)} "
          f"{kv_rate(kv, state['kv'], 'onboard', 'prefix')} "
          f"streams first {res[0]['tokens']} again {res[2]['tokens']} on {card}")
    if state["evicted"] != len(hashes) or not oe.tier_hits["host"]:
        fail("serve-kvbm: int8 prefix not evicted and onboarded")
    if len(copy) != len(hashes) or same != len(hashes):
        fail(f"serve-kvbm: int8 round trip: {len(hashes) - same} blocks not bit-exact")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def serve_kvbm_phase(ref: Dict[str, object], card: str) -> None:
    """serve-kvbm: (a) ``kvbm_reference``, then at Llama-3-8B width from
    random bf16 weights of seed 0: (b) ``kvbm_tiers``, (c) ``kvbm_swap``,
    (d) ``kvbm_int8``."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model import init_params

    kvbm_reference(ref)
    cfg = ModelConfig.llama3_8b()
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    kvbm_tiers(params, card)
    kvbm_swap(params, card)
    kvbm_int8(params, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def write_safetensors(path: str, tensors: Dict[str, Tuple[Tuple[int, ...], Callable]]) -> None:
    """A ``.safetensors`` file of BF16 tensors: the 8-byte little-endian
    header length, the JSON header (padded to 8 bytes), the raw tensors.
    ``tensors`` maps a name to its shape and a function giving its f32
    values (bf16 values), called only as the tensor is written."""
    import struct

    header, off = {}, 0
    for name, (shape, _) in tensors.items():
        n = int(np.prod(shape)) * 2
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, (shape, make) in tensors.items():
            a = bf16_bits(make())
            if a.shape != tuple(shape):
                fail(f"writer: {name} has shape {a.shape}, not {shape}")
            a.tofile(f)


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """bf16 bits, row-major, of an f32 array (or a transposed view of one)
    whose values are bf16 values (torch's cast is exact there, and
    multithreaded)."""
    t = torch.from_numpy(a).to(torch.bfloat16).contiguous()
    return t.view(torch.int16).numpy().view(np.uint16)


def cli_phase(tmp: str, card: str) -> Tuple[List[str], List[str]]:
    """Write a checkpoint at Llama-3-8B width with 2 layers, serve it with
    ``python -m dynamo_tpu_torch run in=http out=torch`` in a subprocess
    (SIGINT must end it with exit code 0) and with an in-process engine
    built from the same numpy arrays through ``params_from_numpy``, the
    same greedy requests one at a time; returns both sets of texts."""
    import signal
    import socket

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    path = os.path.join(tmp, "ckpt")
    os.makedirs(path)
    hf = {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
          "intermediate_size": 14336, "num_hidden_layers": 2, "num_attention_heads": 32,
          "num_key_value_heads": 8, "rope_theta": 500000.0,
          "max_position_embeddings": 8192, "rms_norm_eps": 1e-5}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    write_tokenizer(path, 128000, 256)
    cfg = ModelConfig.from_pretrained(path)
    t0 = time.perf_counter()
    p = init_params(cfg, 5, torch.device("cuda"), torch.bfloat16)
    arrays = {k: ({n: w.float().cpu().numpy() for n, w in v.items()}
                  if isinstance(v, dict) else v.float().cpu().numpy())
              for k, v in p.items()}
    del p
    lay = arrays["layers"]
    H, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    # HF name -> ([out, in] shape, the leaf and its transpose flag)
    tensors = {
        "model.embed_tokens.weight": ((V, H), lambda: arrays["embed"]),
        "model.norm.weight": ((H,), lambda: arrays["final_norm"]),
        "lm_head.weight": ((V, H), lambda: arrays["lm_head"].T),
    }
    linears = {"wq": ("self_attn.q_proj", (q, H)), "wk": ("self_attn.k_proj", (kv, H)),
               "wv": ("self_attn.v_proj", (kv, H)), "wo": ("self_attn.o_proj", (H, q)),
               "w_gate": ("mlp.gate_proj", (I, H)), "w_up": ("mlp.up_proj", (I, H)),
               "w_down": ("mlp.down_proj", (H, I))}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for key, (name, shape) in linears.items():
            tensors[pre + name + ".weight"] = (shape, lambda k=key, i=i: lay[k][i].T)
        tensors[pre + "input_layernorm.weight"] = ((H,), lambda i=i: lay["input_norm"][i])
        tensors[pre + "post_attention_layernorm.weight"] = (
            (H,), lambda i=i: lay["post_norm"][i])
    t1 = time.perf_counter()
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    size = os.path.getsize(os.path.join(path, "model.safetensors"))
    print(f"serve-http: (c) weights made in {t1 - t0:.3f} s, model.safetensors "
          f"{size / 2**30:.3f} GiB written in {time.perf_counter() - t1:.3f} s")

    tok = Tokenizer.from_model_dir(path)
    rng = np.random.default_rng(5)
    reqs = [request(rng.integers(1, 128000, n), 16) for n in (5, 40, 300)]
    chat = {"model": "ckpt", "max_tokens": 16,
            "messages": [{"role": "user", "content": "Hello from the port! Ça va?"}]}

    async def ask(port: int) -> List[str]:
        from dynamo_tpu_torch.bench_serving import run_bench

        out = []
        for req in reqs:
            rep = await run_bench("127.0.0.1", port, "ckpt", bench_items([req]),
                                  concurrency=1, stream=False)
            check_http_results("serve-http (c)", [rep], [[req]])
            out.append(rep.results[0].text)
        status, body = await http_call(port, "POST", "/v1/chat/completions", chat)
        if status != 200:
            fail(f"serve-http (c): chat answered {status}: {body[:300]!r}")
        doc = json.loads(body)
        out.append(doc["choices"][0]["message"]["content"])
        return out

    # the CLI in a subprocess
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    log_path = os.path.join(tmp, "cli.log")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=http", "out=torch",
             "--model-path", path, "--port", str(port)],
            cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT, text=True,
        )

    def cli_log() -> str:
        with open(log_path) as f:
            return f.read()

    try:
        while True:
            if proc.poll() is not None:
                fail(f"the CLI exited with {proc.returncode}: {cli_log()[-3000:]}")
            if time.perf_counter() - t0 > 300:
                fail("the CLI did not answer /health within 300 s")
            try:
                status, _ = asyncio.run(http_call(port, "GET", "/health"))
                if status == 200:
                    break
            except OSError:
                pass
            time.sleep(0.25)
        up = time.perf_counter() - t0
        cli_texts = asyncio.run(ask(port))
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=120)
        log = cli_log()
        print(f"serve-http: (c) CLI healthy after {up:.3f} s, exit code {proc.returncode}; "
              f"its output: {log.strip().splitlines()[:3]}")
        if proc.returncode != 0:
            fail(f"the CLI exited with {proc.returncode} on SIGINT: {log[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # the same requests in process, from the same arrays
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.pipeline import link

    engine = TorchEngine(cfg, params_from_numpy(arrays, cfg, device="cuda"), EngineConfig())
    del arrays

    async def in_process() -> List[str]:
        pipe = link(OpenAIPreprocessor("ckpt", tok), Backend(tok), engine)
        manager = ModelManager()
        manager.add_completion_model("ckpt", pipe)
        manager.add_chat_model("ckpt", pipe)
        service = HttpService(manager, port=0)
        await service.start()
        try:
            return await ask(service.address[1])
        finally:
            await service.stop()
            await engine.stop()

    reset_launches()
    direct_texts = asyncio.run(in_process())
    check_launch_invariants("serve-http (c) in process", engine, read_launches())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return cli_texts, direct_texts


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
    rows += [check_flash_prefix_verify(fp, gen), check_ragged_verify(ra, bucketing, rng, gen)]
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

    ref = reference_phase()
    served = serve_phase(main_kernels, card)
    classic, classic_walls = serve_classic_phase(kernels, card)
    quant, quant_walls = serve_int8_phase(kernels, card)
    http_launches = serve_http_phase(ref, served, card)
    print(f"serve-http: launches on the HTTP path {http_launches}")
    a3 = serve_a3_phase(ref, card)
    print(f"serve-a3: flash prefill launches {a3['launches']}")
    a45 = serve_a45_phase(ref, served, card)
    serve_kvbm_phase(ref, card)
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
        # the verify shapes' callers: the standalone verify dispatches of
        # the fold-off run, the folded verify segments' packed dispatches
        "flash_prefix_prefill_attention/verify":
            a45["oracle fold-off"]["flash_prefix_prefill_attention"],
        "packed_ragged_attention/verify": a45["oracle"]["packed_ragged_attention"],
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
