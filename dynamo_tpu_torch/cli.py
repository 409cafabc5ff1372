"""dynamo-tpu-torch run: the PyTorch port's launch entry point.

The JAX package's ``run`` for single-process serving on the card::

    python -m dynamo_tpu_torch run in=http out=torch --model-path DIR
    python -m dynamo_tpu_torch run in=text out=torch --model-path DIR --prompt "hi"
    python -m dynamo_tpu_torch run in=batch out=torch --model-path DIR --input-file p.jsonl
    python -m dynamo_tpu_torch bench --port 8080 --model NAME

``in=http`` serves ``link(OpenAIPreprocessor, Backend, TorchEngine)`` behind
the OpenAI ``HttpService``; ``in=text`` runs one prompt (or a stdin REPL)
through the same pipeline, ``in=batch`` a JSONL file of prompts.  ``DIR``
is a local HuggingFace checkpoint directory: ``config.json``,
``*.safetensors``, ``tokenizer.json`` and ``tokenizer_config.json``.  The
engine runs on the card; ``--device cpu`` runs it on the CPU.  ``bench``
drives a running front end with the serving benchmark client.

Flags of the JAX CLI whose features the port does not have yet (the
parallel degrees, the remote KV tier, disaggregation, the hub) are
refused with an error that names them, never ignored.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import os
import signal
import sys
from typing import Optional, Tuple

logger = logging.getLogger("dynamo.torch.run")

# flags the port refuses while their features are not ported: name ->
# whether the parsed value asks for the feature
_REFUSED = {
    "--tp": lambda a: a.tp != 1,
    "--dp": lambda a: a.dp != 1,
    "--sp": lambda a: a.sp != 1,
    "--pp": lambda a: a.pp != 1,
    "--ep": lambda a: a.ep != 1,
    "--kv-remote": lambda a: a.kv_remote is not None,
    "--disagg": lambda a: a.disagg is not None,
    "--hub": lambda a: a.hub is not None,
}


def _add_engine_flags(p) -> None:
    """The engine flags of the JAX CLI whose features the port has, with
    the JAX defaults, plus the refused ones."""
    p.add_argument("--model-path", help="HF model dir (weights + tokenizer)")
    p.add_argument("--model-name", help="served model name (default: dir name)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--decode-block-size", type=int, default=16)
    p.add_argument("--kv-dtype", default=None, metavar="DTYPE",
                   help="paged KV pool dtype: 'int8' = quantized per-row "
                        "layout, default = model dtype (env DYN_KV_DTYPE "
                        "overrides)")
    p.add_argument("--no-async-dispatch", dest="async_dispatch",
                   action="store_false", default=True,
                   help="serial tick loop instead of the pipelined one (env "
                        "DYN_ASYNC_DISPATCH overrides)")
    p.add_argument("--prefill-chunk-tokens", type=int, default=None,
                   help="chunked prefill: split long prompts into chunks "
                        "of this many tokens, interleaved with decode")
    p.add_argument("--no-mixed-batching", dest="mixed_batching",
                   action="store_false", default=True,
                   help="separate prefill and decode dispatches per tick")
    p.add_argument("--mixed-token-budget", type=int, default=None,
                   help="fresh tokens per unified dispatch (env "
                        "DYN_MIXED_TOKEN_BUDGET overrides)")
    p.add_argument("--no-packed-ragged", dest="packed_ragged",
                   action="store_false", default=True,
                   help="lane-rectangle layout for unified dispatches (env "
                        "DYN_PACKED_RAGGED overrides)")
    p.add_argument("--no-multistep-decode", dest="multistep_decode",
                   action="store_false", default=True,
                   help="one decode step per packed dispatch (the port's "
                        "multistep ceiling pinned to 1)")
    p.add_argument("--multistep-max-k", type=int, default=8, metavar="K",
                   help="ceiling for the adaptive multi-step decode "
                        "controller (default 8)")
    p.add_argument("--no-fold-spec-verify", dest="fold_spec_verify",
                   action="store_false", default=True,
                   help="standalone speculative verify dispatches instead of "
                        "verify columns folded into the packed unified "
                        "dispatch (env DYN_SPEC_FOLD overrides)")
    p.add_argument("--no-spec-auto-disable", dest="spec_auto_disable",
                   action="store_false", default=True,
                   help="keep low-acceptance lanes drafting instead of "
                        "reverting them to plain decode (env "
                        "DYN_SPEC_AUTO_DISABLE overrides)")
    p.add_argument("--draft-model", default=None, metavar="PATH",
                   help="model drafter: a checkpoint dir (or 'random[:seed]', "
                        "the tiny test preset) loaded as a second model; "
                        "requests select it with speculation drafter 'model' "
                        "(env DYN_DRAFT_MODEL overrides)")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="weight-only quantization of the matmul weights")
    p.add_argument("--kv-prefetch-window", type=int, default=None,
                   help="queue-side prefetch window: offloaded prefix "
                        "chains of the first N queued requests stage "
                        "toward host RAM while they wait; 0 disables "
                        "(env DYN_KV_PREFETCH overrides)")
    p.add_argument("--host-offload-blocks", type=int, default=0,
                   help="G2 host-RAM KV offload capacity (blocks); 0 = off "
                        "(env DYN_KV_OFFLOAD arms/overrides the whole plane)")
    p.add_argument("--disk-offload-blocks", type=int, default=0,
                   help="G3 disk KV offload capacity (blocks); 0 = off")
    p.add_argument("--disk-offload-dir",
                   help="directory for G3 disk offload files")
    p.add_argument("--no-swap-preemption", dest="swap_preemption",
                   action="store_false", default=True,
                   help="disable swap-based preemption (offload the "
                        "victim's KV and restore it on resume); preempted "
                        "sequences always recompute instead")
    # refused: their features are not ported yet
    for flag in ("--tp", "--dp", "--sp", "--pp", "--ep"):
        p.add_argument(flag, type=int, default=1, help="not served by the port yet")
    p.add_argument("--kv-remote", default=None, help="not served by the port yet")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynamo-tpu-torch",
        description="dynamo-tpu's PyTorch/CUDA port: OpenAI serving on one card",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="serve, or run prompts through, the engine")
    run.add_argument("io", nargs=2, metavar=("in=...", "out=..."),
                     help="in=http|text|batch out=torch")
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--port", type=int, default=8080)
    _add_engine_flags(run)
    run.add_argument("--request-template",
                     help="JSON file with request defaults "
                          "{model, temperature, max_completion_tokens} "
                          "applied when the client omits them")
    run.add_argument("--prompt", help="in=text: run one prompt and exit")
    run.add_argument("--input-file", help="in=batch: JSONL prompts file")
    run.add_argument("--output-file", help="in=batch: JSONL results path "
                                           "(default stdout)")
    run.add_argument("--max-tokens", type=int, default=128)
    run.add_argument("--hub", help="not served by the port yet")
    run.add_argument("--disagg", choices=["decode", "prefill"],
                     help="not served by the port yet")

    bn = sub.add_parser("bench",
                        help="drive a frontend with a workload; report "
                             "tok/s + TTFT percentiles")
    bn.add_argument("--host", default="127.0.0.1")
    bn.add_argument("--port", type=int, required=True)
    bn.add_argument("--model", required=True)
    bn.add_argument("--num-requests", type=int, default=None,
                    help="synthetic: workload size (default 64); trace: "
                         "cap on records replayed (default: whole trace)")
    bn.add_argument("--isl", type=int, default=128)
    bn.add_argument("--osl", type=int, default=64)
    bn.add_argument("--request-rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = all at once")
    bn.add_argument("--concurrency", type=int, default=64)
    bn.add_argument("--vocab-size", type=int, default=29000)
    bn.add_argument("--trace", help="datagen JSONL trace to replay instead "
                                    "of the synthetic workload")
    bn.add_argument("--trace-block-size", type=int, default=16,
                    help="tokens per trace hash id (fallback only: the "
                         "trace's input_length fields take precedence)")
    bn.add_argument("--speedup-ratio", type=float, default=1.0,
                    help="trace replay time compression")
    bn.add_argument("--seed", type=int, default=0)
    return p


def _parse_io(io) -> Tuple[str, str]:
    try:
        kv = dict(part.split("=", 1) for part in io)
    except ValueError:
        kv = {}
    if "in" not in kv or "out" not in kv:
        raise SystemExit("usage: run in=<http|text|batch> out=torch")
    return kv["in"], kv["out"]


def _check_served(args) -> None:
    """Refuse what the port cannot serve yet, naming it."""
    refused = [flag for flag, asks in _REFUSED.items() if asks(args)]
    if refused:
        raise SystemExit(
            f"not served by the PyTorch port yet: {', '.join(refused)}"
        )
    if args.inp not in ("http", "text", "batch"):
        raise SystemExit(f"not served by the PyTorch port yet: in={args.inp}")
    if args.out != "torch":
        raise SystemExit(
            f"not served by the PyTorch port: out={args.out} (use out=torch)"
        )


def _load_template(args):
    """--request-template JSON -> RequestTemplate, or None."""
    if not args.request_template:
        return None
    from .protocols.openai import RequestTemplate

    return RequestTemplate.load(args.request_template)


def _make_engine(args):
    """The TorchEngine over ``--model-path``'s checkpoint, on the card
    unless ``--device`` names another device."""
    from .device import resolve_device
    from .engine import EngineConfig, TorchEngine
    from .llm.local_model import resolve_model_path

    if not args.model_path:
        raise SystemExit("out=torch requires --model-path")
    args.model_path = resolve_model_path(args.model_path)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (--device cpu)")
    cfg = EngineConfig(
        max_batch_size=args.max_batch_size,
        max_seq_len=args.max_seq_len,
        page_size=args.page_size,
        num_pages=args.num_pages,
        decode_block_size=args.decode_block_size,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        mixed_batching=args.mixed_batching,
        packed_ragged=args.packed_ragged,
        kv_dtype=args.kv_dtype,
        async_dispatch=args.async_dispatch,
        multistep_max_k=args.multistep_max_k if args.multistep_decode else 1,
        fold_spec_verify=args.fold_spec_verify,
        spec_auto_disable=args.spec_auto_disable,
        draft_model=args.draft_model,
        quantize=args.quantize,
        host_offload_blocks=args.host_offload_blocks,
        disk_offload_blocks=args.disk_offload_blocks,
        disk_offload_dir=args.disk_offload_dir,
        swap_preemption=args.swap_preemption,
    )
    if args.mixed_token_budget is not None:
        cfg.mixed_token_budget = args.mixed_token_budget
    if args.kv_prefetch_window is not None:
        cfg.kv_prefetch_window = args.kv_prefetch_window
    logger.info("loading %s onto %s ...", args.model_path, device)
    return TorchEngine.from_pretrained(args.model_path, cfg, device=device)


def _tokenizer_for(args):
    from .llm.tokenizer import Tokenizer

    return Tokenizer.from_model_dir(args.model_path)


def _model_name(args) -> str:
    if args.model_name:
        return args.model_name
    return os.path.basename(os.path.normpath(args.model_path))


def _pipeline(args):
    """(engine, name, tokenizer, the linked preprocessor -> backend ->
    engine)."""
    from .llm.backend import Backend
    from .llm.preprocessor import OpenAIPreprocessor
    from .runtime.pipeline import link

    engine = _make_engine(args)
    tokenizer = _tokenizer_for(args)
    name = _model_name(args)
    return engine, name, tokenizer, link(
        OpenAIPreprocessor(name, tokenizer), Backend(tokenizer), engine
    )


async def _wait_for_signal() -> None:
    """Park until SIGINT or SIGTERM."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()


async def run_http_local(args) -> None:
    """in=http out=torch: single-process aggregated serving."""
    from .http.service import HttpService, ModelManager

    from .llm.embedding import EmbeddingEngine

    engine, name, tokenizer, pipeline = _pipeline(args)
    manager = ModelManager()
    manager.add_chat_model(name, pipeline)
    manager.add_completion_model(name, pipeline)
    # /v1/embeddings: the engine's trunk embeds, inputs tokenized here
    manager.add_embedding_model(
        name,
        EmbeddingEngine(
            engine.embed, tokenizer=tokenizer,
            max_input_tokens=engine.cfg.max_seq_len,
        ),
    )
    service = HttpService(
        manager, host=args.host, port=args.port, template=_load_template(args)
    )
    await service.start()
    print(f"serving {name} at {service.url}  (POST /v1/chat/completions)", flush=True)
    try:
        await _wait_for_signal()
    finally:
        await service.stop()
        await engine.stop()


async def _ask(pipeline, name: str, text: str, max_tokens: int, on_delta) -> Optional[str]:
    """One chat prompt through the pipeline; ``on_delta`` takes each text
    delta.  Returns the error message, if the stream ended in one."""
    from .protocols.openai import ChatCompletionRequest
    from .runtime.engine import Annotated, Context, as_response_stream

    req = ChatCompletionRequest.from_dict(
        {
            "model": name,
            "messages": [{"role": "user", "content": text}],
            "stream": True,
            "max_tokens": max_tokens,
        }
    )
    stream = await as_response_stream(pipeline, Context.new(req))
    async for item in stream:
        if not isinstance(item, Annotated):
            item = Annotated.from_data(item)
        if item.is_error():
            return item.error_message()
        for choice in (item.data or {}).get("choices", []):
            delta = (choice.get("delta") or {}).get("content")
            if delta:
                on_delta(delta)
    return None


async def run_text(args) -> None:
    """in=text out=torch: one prompt (``--prompt``), or a REPL on stdin,
    through the full preprocessor -> engine -> detokenizer pipeline."""
    engine, name, _, pipeline = _pipeline(args)

    def show(delta: str) -> None:
        print(delta, end="", flush=True)

    async def ask(text: str) -> None:
        error = await _ask(pipeline, name, text, args.max_tokens, show)
        if error:
            print(f"\n[error] {error}", flush=True)
            return
        print()

    try:
        if args.prompt is not None:
            await ask(args.prompt)
            return
        loop = asyncio.get_running_loop()
        while True:
            line = await loop.run_in_executor(None, sys.stdin.readline)
            if not line:
                break
            line = line.strip()
            if line in ("exit", "quit"):
                break
            if line:
                await ask(line)
    finally:
        await engine.stop()


async def run_batch(args) -> None:
    """in=batch out=torch: a JSONL file of prompts through the pipeline
    concurrently; one JSON result line per prompt, in input order.

    Input lines: ``{"text": "..."}`` (or ``{"prompt": ...}``), optional
    ``max_tokens``.  Output lines: ``{"index", "text", "response"}``.
    """
    if not args.input_file:
        raise SystemExit("in=batch requires --input-file prompts.jsonl")
    engine, name, _, pipeline = _pipeline(args)

    def read_prompts() -> list:
        with open(args.input_file, encoding="utf-8") as fh:
            return [json.loads(line) for line in fh if line.strip()]

    prompts = await asyncio.to_thread(read_prompts)

    async def one(i, entry):
        text = entry.get("text") or entry.get("prompt") or ""
        parts: list = []
        error = await _ask(
            pipeline, name, text, int(entry.get("max_tokens", args.max_tokens)),
            parts.append,
        )
        out = {"index": i, "text": text, "response": "".join(parts)}
        if error:
            out["error"] = error
        return out

    def write_results(results: list) -> None:
        sink = (
            open(args.output_file, "w", encoding="utf-8")
            if args.output_file else sys.stdout
        )
        try:
            for r in results:
                sink.write(json.dumps(r) + "\n")
            sink.flush()
        finally:
            if args.output_file:
                sink.close()

    try:
        results = await asyncio.gather(*(one(i, e) for i, e in enumerate(prompts)))
        await asyncio.to_thread(write_results, results)
    finally:
        await engine.stop()


async def run_bench(args) -> int:
    """bench: fire the workload at a running front end, print one JSON
    summary (output tok/s, TTFT percentiles, error counts)."""
    from .bench_serving import run_bench as drive, synth_workload, trace_workload

    if args.trace:
        workload = trace_workload(
            args.trace,
            block_size=args.trace_block_size,
            vocab=args.vocab_size,
            speedup=args.speedup_ratio,
            limit=args.num_requests,
        )
    else:
        workload = synth_workload(
            args.num_requests if args.num_requests is not None else 64,
            args.isl, args.osl, args.request_rate,
            vocab=args.vocab_size, seed=args.seed,
        )
    report = await drive(
        args.host, args.port, args.model, workload, concurrency=args.concurrency,
    )
    summary = report.summary()
    print(json.dumps(summary, indent=2))
    return 0 if summary["num_errors"] == 0 else 1


def main(argv=None) -> int:
    logging.basicConfig(
        level=getattr(logging, os.environ.get("DYN_LOG", "info").upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        return asyncio.run(run_bench(args))
    args.inp, args.out = _parse_io(args.io)
    _check_served(args)
    runner = {"http": run_http_local, "text": run_text, "batch": run_batch}[args.inp]
    try:
        asyncio.run(runner(args))
    except KeyboardInterrupt:
        pass
    return 0
