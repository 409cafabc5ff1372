"""NCCL ranks on four cards: what ``chip_smoke.py`` (one card) cannot run.

Run from the repository root on a host with four NVIDIA cards::

    python3 chip_multi.py

It builds the kernels and, in order (the first failure ends the run):

(a) ``tests/test_torch_cuda.py -k "tp_ or sp_pp"``: tp = 2 engines over
    gloo (one card) and NCCL (two), their streams and pools against one
    card's, the follower's graph captures and replays equal to the
    leader's, each stop within 30 s; sp = 2 and pp = 2 engines over both
    backends against one card's streams.
(b) ``run in=http out=torch --tp 2`` on a checkpoint at Llama-3-8B's
    width (2 layers): chats end ``length`` with exact usage, and SIGINT
    ends the process (and its follower) with exit code 0 within 30 s.
(c) Llama-3-70B's preset at 16 layers, bf16, seed 0, at tp = 4 over NCCL
    against the same preset on one card: a prefill-only batch's whole
    prompt blocks (every rank's against the one-card pages' head slice,
    within
    ``chip_smoke``'s ``SPPP_BF16_BOUNDS``), then serve's primer
    and batch cold and warm with top-2 logprobs: greedy lanes part from
    one card's only at a bf16 near tie; per rank the launch invariants of
    the leader's dispatches, the same collectives, and the follower
    ranks' graph captures and replays equal to the leader's.
(d) Kernels 1 and 5 at a tp = 4 rank of Llama-3-70B (16 query heads, 2
    kv heads, D 128) against their plain versions, timed beside SDPA and
    their bound, launches from (c)'s leader rank.

``DYN_STOP_TRACE_S`` is set to 60 for every engine and process started
here: a stop that waits longer prints every thread's stack.  Each line
names the cards (``nvidia-smi``'s name and power limit).  The last line is
``{"ok": true, ...}`` with the cards and the rows of (d).
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from typing import Dict, List

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

os.environ.setdefault("DYN_STOP_TRACE_S", "60")
CARDS = 4


def tests_phase(card: str) -> None:
    """(a) The card tests of tp, sp and pp, both backends."""
    t0 = time.perf_counter()
    argv = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m",
            "cuda", "-q", "-rA", "-x", "-s", "tests/test_torch_cuda.py", "-k", "tp_ or sp_pp"]
    try:
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=420)
    except subprocess.TimeoutExpired as e:
        # the stacks DYN_STOP_TRACE_S printed say where it waits
        for out in (e.stdout, e.stderr):
            text = out.decode() if isinstance(out, bytes) else (out or "")
            print(text[-20000:])
        cs.fail("multi (a): the card tests did not end within 420 s")
    tail = proc.stdout.strip().splitlines()
    for ln in tail:
        if ln.startswith(("PASSED", "FAILED", "ERROR", "SKIPPED")) or " passed" in ln:
            print(f"multi: (a) {ln}")
    if proc.returncode != 0:
        print(proc.stdout[-12000:])
        print(proc.stderr[-12000:])
        cs.fail(f"multi (a): the card tests failed (exit {proc.returncode})")
    print(f"multi: (a) {time.perf_counter() - t0:.3f} s on {card}", flush=True)


def chat(url: str, text: str) -> dict:
    req = urllib.request.Request(
        url + "/v1/chat/completions",
        data=json.dumps({"model": "m", "max_tokens": 8, "temperature": 0.0, "ignore_eos": True,
                         "messages": [{"role": "user", "content": text}]}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
    return {"finish": body["choices"][0]["finish_reason"], "usage": body["usage"]}


def cli_phase(card: str) -> None:
    """(b) ``--tp 2`` over NCCL behind the CLI, stopped by SIGINT."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-multi-")
    try:
        ckpt = cs.write_cli_checkpoint(tmp, "multi: (b)")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=http", "out=torch",
             "--model-path", ckpt[0], "--model-name", "m", "--port", "0", "--num-pages", "256",
             "--tp", "2"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            line = proc.stdout.readline()
            if not line.startswith("serving m at http://"):
                proc.kill()
                cs.fail(f"multi (b): no server: {line!r} {proc.stderr.read()[-4000:]}")
            url = line.split()[3]
            start_s = time.perf_counter() - t0
            got = [chat(url, t) for t in ("hello", "tell me a story about the quick brown fox")]
            for g in got:
                if g["finish"] != "length" or g["usage"]["completion_tokens"] != 8:
                    cs.fail(f"multi (b): a chat ended {g}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            try:
                out, err = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.send_signal(signal.SIGQUIT)
                time.sleep(5)
                proc.kill()
                out, err = proc.communicate()
                print(err[-12000:])
                cs.fail("multi (b): --tp 2 outlived SIGINT by 30 s")
            stop_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            cs.fail(f"multi (b): exit {proc.returncode} after SIGINT: {err[-4000:]}")
        print(f"multi: (b) run in=http out=torch --tp 2 (NCCL): served in {start_s:.3f} s; "
              f"chats {got}; SIGINT to exit {stop_s:.3f} s (exit 0) on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def prompt_pages(engine, reqs) -> List[torch.Tensor]:
    """Every rank's pages of ``reqs``' whole prompt blocks, in prompt
    order (each block once), on the host: the leader's block pool names
    the pages, every rank's pool holds its heads of them.  (The page a
    block lands on follows the ticks' schedule, which the pipelined loop's
    timing moves, so pools are compared block by block, not page by
    page.)"""
    from dynamo_tpu_torch.tokens.hashing import hash_blocks

    hashes = list(dict.fromkeys(
        h for r in reqs for h in hash_blocks(r["token_ids"], engine.cfg.page_size)[1]))
    blocks = engine.sched.pool._registered
    if not all(h in blocks for h in hashes):
        cs.fail("multi (c): a prompt block is not held in the pool")
    ids = torch.tensor([p for h in hashes for p in blocks[h].pages])
    return [pool[:, :, ids] for pool in engine.rank_pools()]


def check_tp_pools(what: str, one, ranks, tp: int) -> str:
    """Every rank's prompt pages against one card's head slice."""
    w = one.shape[4] // tp
    lines = []
    for r, p in enumerate(ranks):
        lines.append(f"rank {r} " + cs.sppp_pool_check(what, p, one[..., r * w:(r + 1) * w, :]))
    return "; ".join(lines)


def llama70b_phase(card: str) -> Dict[str, int]:
    """(c) Llama-3-70B at 16 layers, tp = 4 over NCCL, against one card."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    cfg = ModelConfig.llama3_70b(num_layers=16)
    primer, batch = cs.serve_requests(cfg.vocab_size)
    batch = [dict(r, sampling_options=dict(r["sampling_options"], logprobs=2)) for r in batch]
    pool_reqs = cs.sppp_pool_requests(cfg.vocab_size)
    greedy = [not r["sampling_options"].get("temperature") for r in batch] * 2
    runs: Dict[str, dict] = {}
    for name, mesh in (("one card", None), ("tp=4 NCCL", MeshConfig(tp=4))):
        t0 = time.perf_counter()
        eng = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024), seed=0, device="cuda:0",
                                      mesh=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng.reset_rank_stats()
        cs.reset_launches()
        kept: Dict[str, object] = {}
        marks: Dict[str, object] = {}

        def between(i: int, eng=eng) -> None:
            if i == 1:
                marks["pools"] = prompt_pages(eng, pool_reqs)
            if i == 3:
                marks["t"] = time.perf_counter()

        reads = cs.tp_reads(eng, kept)

        def before_stop(reads=reads) -> None:
            reads()
            marks["stop"] = time.perf_counter()

        t0 = time.perf_counter()
        res = asyncio.run(cs.serve(eng, [pool_reqs, primer, batch, batch], between, before_stop))
        stop_s = time.perf_counter() - marks["stop"]
        n = len(pool_reqs)
        cold, warm = res[n:n + 1 + len(batch)], res[n + 1 + len(batch):]
        wall, wall_w = marks["t"] - t0, max(r["frames"][-1][0] for r in warm) - marks["t"]
        cs.check_streams(f"multi (c) {name}", cold[1:], cfg.vocab_size)
        cs.check_streams(f"multi (c) {name} warm", warm, cfg.vocab_size)
        st, st_w = cs.served_stats(cold, wall), cs.served_stats(warm, wall_w, primed=False)
        if mesh is None:
            cs.check_launch_invariants("multi: (c) one card", eng, cs.read_launches())
            peaks = [torch.cuda.max_memory_allocated(0) / 2**30]
            launches = cs.read_launches()
        else:
            stats = kept["stats"]
            want = cs.expected_launches(eng)
            captures, replays = eng.graph_captures, sum(eng.graph_replays.values())
            for s, got in zip(stats, cs.tp_rank_launches(stats)):
                got = {k: got.get(k, 0) for k in want}
                print(f"multi: (c) rank {s['rank']}: launches {got} (expected {want}); "
                      f"collectives {s['collectives']}; graphs {s['graphs']}")
                if got != want:
                    cs.fail(f"multi (c) rank {s['rank']}: launches {got} differ from {want}")
                if s["rank"] and s["graphs"] != {"captures": captures, "replays": replays}:
                    cs.fail(f"multi (c) rank {s['rank']}: graphs {s['graphs']}, the leader's "
                            f"{captures} captures and {replays} replays")
            if len({json.dumps(s["collectives"], sort_keys=True) for s in stats}) != 1:
                cs.fail("multi (c): the ranks' collectives differ")
            if not captures or not replays:
                cs.fail("multi (c): an NCCL mesh captured or replayed no graph")
            peaks = [s.get("peak_bytes", 0) / 2**30 for s in stats]
            launches = cs.tp_rank_launches(stats)[0]
            print(f"multi: (c) pools {check_tp_pools('(c)', runs['one card']['pool'], marks['pools'], 4)}")
            print(f"multi: (c) streams: {cs.tp_near_ties('(c)', cold[1:] + warm, runs['one card']['streams'], greedy)}")
        runs[name] = dict(pool=marks["pools"][0], streams=[r["tokens"] for r in cold[1:] + warm])
        print(f"multi: (c) Llama-3-70B 16 layers bf16 {name}: init {init_s:.3f} s; cold wall "
              f"{wall:.3f} s tok_s={st['tok_s']:.3f} ttft_ms="
              f"{[round(r['ttft'] * 1e3, 3) for r in cold[1:]]}; warm wall {wall_w:.3f} s "
              f"tok_s={st_w['tok_s']:.3f} decode_phase_tok_s={st_w['dec']:.3f}; graph captures "
              f"{eng.graph_captures} replays {sum(eng.graph_replays.values())}; peak GiB per "
              f"rank {[round(p, 3) for p in peaks]}; stop {stop_s:.3f} s on {card}", flush=True)
        del eng, between, before_stop, reads
        gc.collect()
        torch.cuda.empty_cache()
    return {k: launches[k] for k in ("paged_decode_attention", "packed_ragged_attention")}


def main() -> None:
    t_all = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        cs.fail(f"chip_multi needs {CARDS} CUDA devices")
    from dynamo_tpu_torch.engine import bucketing
    from dynamo_tpu_torch.ops import build
    from dynamo_tpu_torch.ops import flash_prefill as fp
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().replace("\n", " | ")
    print(f"multi: torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{torch.cuda.nccl.version()}")
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build_all([pa.KERNEL, ra.KERNEL, fp.KERNEL, fp.PREFIX_KERNEL, ra.RECT_KERNEL,
                     ra.INT8_KERNEL, ra.RECT_INT8_KERNEL])
    print(f"multi: build {time.perf_counter() - t0:.3f} s", flush=True)
    tests_phase(card)
    cli_phase(card)
    launches = llama70b_phase(card)
    geom = {"llama3_70b_tp4_rank": ((16, 2, 128, 0), ("paged_decode_attention",
                                                       "packed_ragged_attention"))}
    rows: List[dict] = cs.geometry_rows(pa, fp, ra, bucketing, geom)
    for r in rows:
        r["launches"] = launches[r["name"].split("/")[0]]
        print(f"multi: (d) {r['name']} ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"bound_share={r['bound_share']:.4f} launches={r['launches']} on {card}")
    print(f"multi: whole run {time.perf_counter() - t_all:.3f} s on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
