"""Serving benchmark client: drive an OpenAI HTTP frontend, measure TTFT and
throughput.

A copy of the JAX package's ``bench_serving.py``; the workload is
synthetic (``--isl/--osl`` + Poisson ``--request-rate``) or a datagen trace
(``--trace`` JSONL: hash_ids/input_length/output_length/timestamp --
replayed at trace timing, prefix sharing reproduced by deriving prompt
token blocks from the trace's hash ids).  Per request: TTFT (first SSE
choices chunk), end-to-end latency, output tokens, and the completion's
text, finish reason and usage; aggregate: percentiles, output tok/s,
request throughput.  A request is sent streamed (SSE) by default, or
aggregated (``stream=False``: one JSON body, no TTFT); an item may carry
the OpenAI sampling fields (``temperature``, ``seed``, the penalties ...).

Everything is measured from the client side of the HTTP socket -- the full
stack (SSE codec, detokenizer, engine) is in the measured path.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np



def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile of an ascending list (the JAX package's
    ``datagen/analyzer.py`` rule)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(p * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return float(sorted_vals[idx])


@dataclass
class RequestResult:
    ok: bool
    ttft_s: Optional[float] = None
    latency_s: float = 0.0
    output_tokens: int = 0
    error: str = ""
    text: str = ""
    finish_reason: Optional[str] = None
    usage: Optional[Dict[str, Any]] = None


@dataclass
class BenchReport:
    results: List[RequestResult] = field(default_factory=list)
    wall_s: float = 0.0

    def summary(self) -> Dict[str, Any]:
        ok = [r for r in self.results if r.ok]
        ttfts = sorted(r.ttft_s for r in ok if r.ttft_s is not None)

        def pct(vals, p):
            if not vals:
                return None
            return round(_percentile(vals, p) * 1e3, 2)

        out_tokens = sum(r.output_tokens for r in ok)
        return {
            "num_requests": len(self.results),
            "num_ok": len(ok),
            "num_errors": len(self.results) - len(ok),
            "wall_s": round(self.wall_s, 3),
            "output_tok_s": round(out_tokens / self.wall_s, 2)
            if self.wall_s
            else 0.0,
            "requests_s": round(len(ok) / self.wall_s, 3) if self.wall_s else 0.0,
            "ttft_ms": {
                "p50": pct(ttfts, 0.50),
                "p90": pct(ttfts, 0.90),
                "p99": pct(ttfts, 0.99),
            },
            "latency_ms_p50": pct(sorted(r.latency_s for r in ok), 0.50),
            "mean_output_tokens": round(out_tokens / len(ok), 1) if ok else 0.0,
        }


# -- workload construction ---------------------------------------------------


def synth_workload(
    num_requests: int,
    isl: int,
    osl: int,
    request_rate: float,
    vocab: int = 29000,
    seed: int = 0,
    speculation: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """Poisson arrivals (rate 0 = all at t0), random prompts (no sharing).

    ``speculation`` stamps every request with the OpenAI speculation
    extension (e.g. ``{"num_draft_tokens": 4}``) -- the spec-on serving
    line runs the same workload with per-request drafting armed."""
    rs = np.random.RandomState(seed)
    t = 0.0
    out = []
    for _ in range(num_requests):
        item: Dict[str, Any] = {
            "token_ids": rs.randint(2, vocab, (isl,)).tolist(),
            "max_tokens": osl,
            "at": t,
        }
        if speculation is not None:
            item["speculation"] = speculation
        out.append(item)
        if request_rate > 0:
            t += float(rs.exponential(1.0 / request_rate))
    return out


def trace_workload(
    path: str,
    block_size: Optional[int] = None,
    vocab: int = 29000,
    speedup: float = 1.0,
    limit: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Replay a datagen trace: each hash id expands to one deterministic
    token block, so equal ids become equal token blocks -- the prefix
    sharing the trace encodes is reproduced at the token level and hits
    real prefix caches / KV routers.

    Tokens-per-block is INFERRED from the first record carrying
    ``input_length`` (``input_length // len(hash_ids)`` -- exact for
    datagen-synthesized traces); ``block_size`` only overrides when no
    record says.  A caller-supplied block size that contradicts the trace
    would silently shrink/stretch every prompt."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if limit is not None and limit < len(records):
        print(
            f"bench: trace has {len(records)} records; replaying first {limit}",
            file=sys.stderr,
        )
        records = records[:limit]

    # infer tokens-per-block, preferring a record whose input_length is an
    # exact multiple of its block count (a trailing partial block skews the
    # floor division); when no record divides exactly, fall back to the
    # approximate floor-division inference rather than an arbitrary default
    # -- a ~1-off block size beats a ~30x-off one
    inferred: Optional[int] = None
    approx: Optional[int] = None
    for r in records:
        ids = r.get("hash_ids") or []
        if ids and r.get("input_length"):
            n = int(r["input_length"])
            if approx is None:
                approx = max(1, n // len(ids))
            if n % len(ids) == 0:
                inferred = max(1, n // len(ids))
                break
    per_block = inferred or approx or block_size or 16
    if inferred and block_size and inferred != block_size:
        print(
            f"bench: trace implies {inferred} tokens/block; overriding "
            f"--trace-block-size {block_size}",
            file=sys.stderr,
        )

    out = []
    t0: Optional[float] = None
    for r in records:
        ids = r.get("hash_ids") or []
        toks: List[int] = []
        for h in ids:
            rs = np.random.RandomState(h % (2**31))
            toks.extend(rs.randint(2, vocab, (per_block,)).tolist())
        if not toks:
            continue
        # honour the trace's exact prompt length: the last block may be
        # partial (input_length = (blocks-1)*block + leftover)
        want = int(r.get("input_length") or 0)
        if 0 < want < len(toks):
            toks = toks[:want]
        ts = float(r.get("timestamp", 0.0))
        if t0 is None:
            t0 = ts
        out.append(
            {
                "token_ids": toks,
                "max_tokens": max(1, int(r.get("output_length", 16))),
                "at": (ts - t0) / speedup,
            }
        )
    return out


# -- the HTTP driver ---------------------------------------------------------


async def _body_lines(
    reader: asyncio.StreamReader, headers: Dict[str, str]
) -> AsyncIterator[bytes]:
    """Yield body LINES with HTTP framing decoded.

    Handles ``Transfer-Encoding: chunked`` properly: chunk framing and SSE
    line boundaries are independent, so a chunk may end mid-line -- lines
    are reassembled from the dechunked byte stream.  (A readline() over the
    raw socket would hand hex size-lines and partial events to the SSE
    parser, which only works by coincidence against servers that emit one
    whole event per chunk.)"""
    buf = b""
    if headers.get("transfer-encoding", "").lower() == "chunked":
        while True:
            size_line = await reader.readline()
            try:
                size = int(size_line.strip().split(b";")[0], 16)
            except ValueError:
                break
            if size == 0:
                await reader.readline()  # trailing CRLF
                break
            chunk = await reader.readexactly(size)
            await reader.readexactly(2)  # CRLF after chunk data
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                yield line
    else:
        n = headers.get("content-length")
        data = await (reader.readexactly(int(n)) if n else reader.read())
        buf = data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            yield line
    if buf:
        yield buf


async def _sse_request(
    host: str, port: int, model: str, item: Dict[str, Any], stream: bool = True
) -> RequestResult:
    """POST /v1/completions (token-id prompt) and time the chunks; with
    ``stream=False`` the one aggregated body."""
    payload: Dict[str, Any] = {
        "model": model,
        "prompt": item["token_ids"],
        "max_tokens": item["max_tokens"],
        "stream": stream,
        "ignore_eos": True,
    }
    for key in ("speculation", "temperature", "top_p", "top_k", "seed",
                "frequency_penalty", "presence_penalty", "repetition_penalty"):
        if item.get(key) is not None:
            payload[key] = item[key]
    body = json.dumps(payload).encode()
    t0 = time.monotonic()
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(
            b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n".encode()
            + b"Connection: close\r\n\r\n"
            + body
        )
        await writer.drain()
        status_line = await reader.readline()
        status = int(status_line.split()[1])
        headers: Dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if not raw.strip():
                break
            k, _, v = raw.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        if status != 200 or not stream:
            payload = b"".join([l async for l in _body_lines(reader, headers)])
            if status != 200:
                return RequestResult(
                    ok=False, error=f"HTTP {status}: {payload[:200]!r}"
                )
            doc = json.loads(payload)
            choice = (doc.get("choices") or [{}])[0]
            usage = doc.get("usage") or {}
            return RequestResult(
                ok=True,
                latency_s=time.monotonic() - t0,
                output_tokens=int(usage.get("completion_tokens") or 0),
                text=choice.get("text") or "",
                finish_reason=choice.get("finish_reason"),
                usage=usage,
            )
        ttft = None
        n_chunks = 0
        usage = None
        error = ""
        parts: List[str] = []
        finish = None
        async for raw in _body_lines(reader, headers):
            line = raw.strip()
            if not line.startswith(b"data:"):
                continue
            payload = line[5:].strip()
            if payload == b"[DONE]":
                break
            chunk = json.loads(payload)
            if "error" in chunk:
                error = str(chunk["error"])
                break
            # the final chunk carries the authoritative usage block; one SSE
            # chunk can cover a whole decode block's text, so chunk counting
            # alone undercounts
            if chunk.get("usage"):
                usage = chunk["usage"]
            for c in chunk.get("choices") or []:
                # TTFT stamps on the first *token arrival* (any choices
                # chunk), not the first non-empty text: incremental detok
                # can render early tokens as "" (byte-partial BPE pieces)
                if ttft is None:
                    ttft = time.monotonic() - t0
                if c.get("text"):
                    n_chunks += 1
                    parts.append(c["text"])
                if c.get("finish_reason"):
                    finish = c["finish_reason"]
        if usage and usage.get("completion_tokens") is not None:
            n_tokens = int(usage["completion_tokens"])
        else:
            n_tokens = n_chunks
        if error:
            return RequestResult(ok=False, error=error)
        return RequestResult(
            ok=True,
            ttft_s=ttft,
            latency_s=time.monotonic() - t0,
            output_tokens=n_tokens,
            text="".join(parts),
            finish_reason=finish,
            usage=usage,
        )
    except Exception as e:
        return RequestResult(ok=False, error=str(e), latency_s=time.monotonic() - t0)
    finally:
        if writer is not None:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()


async def fetch_fleet(host: str, port: int) -> Dict[str, Any]:
    """GET /fleet from the front end: the observatory's cluster summary,
    attached to bench reports so a run's client-side numbers and the
    fleet's server-side state land in one JSON document."""
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(
            b"GET /fleet HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        )
        await writer.drain()
        status_line = await reader.readline()
        status = int(status_line.split()[1])
        headers: Dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if not raw.strip():
                break
            k, _, v = raw.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b"".join([ln async for ln in _body_lines(reader, headers)])
        doc = json.loads(body)
        if status != 200:
            raise RuntimeError(f"GET /fleet -> HTTP {status}: {doc}")
        return doc
    finally:
        if writer is not None:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()


async def run_bench(
    host: str,
    port: int,
    model: str,
    workload: List[Dict[str, Any]],
    concurrency: int = 64,
    stream: bool = True,
) -> BenchReport:
    """Fire the workload at its arrival times (bounded concurrency) and
    collect per-request results, in workload order."""
    sem = asyncio.Semaphore(concurrency)
    report = BenchReport()
    t0 = time.monotonic()

    async def one(item):
        delay = item["at"] - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        async with sem:
            return await _sse_request(host, port, model, item, stream)

    report.results = list(await asyncio.gather(*[one(i) for i in workload]))
    report.wall_s = time.monotonic() - t0
    return report
