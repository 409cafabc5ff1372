"""dynamo-tpu-torch run: the PyTorch port's launch entry point.

The JAX package's ``run``, single-process and distributed::

    python -m dynamo_tpu_torch run in=http out=torch --model-path DIR
    python -m dynamo_tpu_torch run in=text out=torch --model-path DIR --prompt "hi"
    python -m dynamo_tpu_torch run in=batch out=torch --model-path DIR --input-file p.jsonl
    python -m dynamo_tpu_torch run in=http out=mocker --model-path DIR
    python -m dynamo_tpu_torch run in=http out=echo --model-path DIR --echo-delay-ms 5
    python -m dynamo_tpu_torch hub --port 6650
    python -m dynamo_tpu_torch run in=dyn out=torch --model-path DIR --hub H:P
    python -m dynamo_tpu_torch run in=dyn out=mocker --model-path DIR --hub H:P
    python -m dynamo_tpu_torch run in=http out=dyn --hub H:P --router-mode kv
    python -m dynamo_tpu_torch run in=dyn out=torch --model-path DIR --hub H:P --disagg decode
    python -m dynamo_tpu_torch run in=dyn out=torch --model-path DIR --hub H:P --disagg prefill
    python -m dynamo_tpu_torch disagg-conf --hub H:P --max-local-prefill-length N
    python -m dynamo_tpu_torch llmctl --hub H:P list
    python -m dynamo_tpu_torch fleet --hub H:P --once --json
    python -m dynamo_tpu_torch metrics --hub H:P --port 9091
    python -m dynamo_tpu_torch bench --port 8080 --model NAME
    python -m dynamo_tpu_torch profile http://H:P --watch 5 --device 1 --json t.json
    python -m dynamo_tpu_torch profile-sla --out torch --model-path DIR --isl 128,512 --batch 1,4,8
    python -m dynamo_tpu_torch trace --hub H:P REQUEST_ID
    python -m dynamo_tpu_torch eval --model-path DIR --text-file T [--window 512] [--quantize int8]

``in=http out=torch`` serves ``link(OpenAIPreprocessor, Backend,
TorchEngine)`` behind the OpenAI ``HttpService``; ``in=text`` runs one
prompt (or a stdin REPL) through the same pipeline, ``in=batch`` a JSONL
file of prompts.  ``DIR`` is a local HuggingFace checkpoint directory
(``config.json``, ``*.safetensors``, ``tokenizer.json`` and
``tokenizer_config.json``) or a GGUF checkpoint: a ``.gguf`` file, or a
directory holding one and no safetensors, whose metadata gives the config
and the tokenizer and whose weights dequantize on load (``llm/gguf.py``).
The engine runs on the card; ``--device cpu`` runs it on the CPU.
``eval`` prints one JSON line, the windowed perplexity of the text under
the checkpoint loaded as ``run`` loads it (``llm/evaluate.py``).
``out=mocker`` and ``out=echo`` serve the model-free engines
(``mocker/``, ``llm/echo.py``) on no device: the mocker's deterministic
tokens (its vocabulary ``--model-path``'s tokenizer's, else
32000) and the echo engine's prompt ids back (``--echo-delay-ms`` per
token); ``/v1/embeddings`` answers with ``fake_embedder``'s vectors for an
engine that embeds nothing.  ``bench`` drives a running front end with the serving
benchmark client.  ``profile`` reads a running front end's tick profiler
(``GET /profile/ticks``; ``--watch S`` arms it and samples S seconds of
traffic, ``--device S`` takes a device trace on the server) and prints
where the ticks' wall time went; ``trace`` assembles one request's spans
from every component on a hub.  ``profile-sla`` drives the engine of
``--out`` (built as ``run`` builds it) through the planner's SLA profiler
(``planner/profile_sla.py``): TTFT per ``--isl`` on cold prompts, ITL and
tok/s per ``--batch`` of concurrent streams of ``--osl`` tokens, printed
as one JSON object with the recommendation for ``--ttft-slo-ms`` and
``--itl-slo-ms``.

``hub`` runs the control plane.  ``in=dyn out=torch|mocker`` serves the
engine as a worker on the hub: its generate endpoint, a ``{ep}_embed``
endpoint, the KV event, load-metrics and telemetry publishers and the
model's registration (an echo worker has no embed leg, KV events or load
metrics; a worker without ``--model-path`` registers no model card).
``in=http out=dyn`` is the discovery-driven front end: a pipeline per
registered model, routed round robin, at random, or by KV overlap
(``--router-mode kv``).  ``--hub auto`` runs a hub in the process.
``llmctl`` lists and removes registered models.  The front end carries
the fleet observatory (``fleet/``): it reads the workers' telemetry
snapshots, serves them at ``GET /fleet`` and ``GET /fleet/metrics``,
quarantines stragglers from the KV router's placements and prices the
router's prefix fetches by its fitted links.  ``fleet`` prints the same
summary from the hub as a table (``--json``: the summary itself);
``metrics`` serves the cluster's load gauges (``llm_kv_blocks_active``
...) on its own port.

``--disagg`` splits a worker's two phases over two processes
(``llm/disagg.py``): ``decode`` serves the model like a plain worker but
ships prompts longer than ``--max-local-prefill-length`` (after the
router's prefix credit) to the namespace's prefill queue on the hub, its
``kv_deliver`` endpoint taking their KV back; ``prefill`` is a queue
consumer only -- no generate endpoint, no model registration, no embed
leg -- that prefills the queued prompts in batches and streams their KV to
the decode worker that shipped them (``--kv-chunk-layers`` layers per
chunk, or one monolithic upload with ``--no-chunked-kv``).  ``disagg-conf``
rewrites the decode workers' policy live.

A worker with the KV offload plane armed (``--host-offload-blocks``,
``--disk-offload-blocks``, ``DYN_KV_OFFLOAD``) serves cross-worker prefix
onboarding (``llm/prefix_onboard.py``): a ``kv_export`` endpoint for its
peers, and an importer in front of its engine that fetches a donor's
blocks -- a peer's, or the G4 store's -- before admission.  It publishes
its tier holdings to the router, and with ``--kv-remote`` (or
``DYN_KV_REMOTE``) it attaches the G4 tier over the hub's blob verbs.
The KV-routed front end reads ``DYN_KV_REMOTE`` for its
fetch-vs-recompute priors.

Flags of the JAX CLI whose features the port does not have yet (the
parallel degrees) are refused with an error that names them, never
ignored; so is ``--disagg`` outside ``in=dyn``, which the JAX CLI ignores.
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
from typing import Dict, Optional, Tuple

logger = logging.getLogger("dynamo.torch.run")

# the local engines of ``out=``
ENGINES = ("torch", "mocker", "echo")

# flags the port refuses while their features are not ported: name ->
# whether the parsed value asks for the feature (dp inside one engine,
# sp's ring prefill and pp's pipeline prefill)
_REFUSED = {
    "--dp": lambda a: a.dp != 1,
    "--sp": lambda a: a.sp != 1,
    "--pp": lambda a: a.pp != 1,
}
# the flags of what a tensor- or expert-parallel engine does not carry
# yet: name -> whether the parsed value asks for it
_REFUSED_UNDER_MESH = {
    "--host-offload-blocks": lambda a: bool(a.host_offload_blocks),
    "--disk-offload-blocks": lambda a: bool(a.disk_offload_blocks),
    "--kv-remote": lambda a: a.kv_remote is not None,
    "--draft-model": lambda a: bool(a.draft_model),
    "--disagg decode": lambda a: a.disagg == "decode",
}


def _add_engine_flags(p) -> None:
    """The engine flags of the JAX CLI whose features the port has, with
    the JAX defaults, plus the refused ones."""
    p.add_argument("--echo-delay-ms", type=float, default=0.0,
                   help="out=echo: per-token delay")
    p.add_argument("--model-path", help="HF model dir (weights + tokenizer), or a .gguf checkpoint")
    p.add_argument("--model-name", help="served model name (default: dir name)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--block-size", type=int, default=None,
                   help="router-visible KV block size, a multiple of the page "
                        "size (default: page size; another value turns "
                        "prefix caching off)")
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
                   help="one decode step per packed dispatch (env "
                        "DYN_MULTISTEP overrides)")
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
    p.add_argument("--kv-admit-budget", default=None, metavar="SPEC",
                   help="KV-budget admission: 'on' or "
                        "'util=0.9,headroom=256,reserve=16,floor_s=2,"
                        "skips=4' -- admit against predicted KV pages "
                        "with a skip-ahead fairness floor instead of "
                        "slot count (env DYN_KV_ADMIT_BUDGET overrides)")
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
    p.add_argument("--kv-remote", default=None, metavar="SPEC",
                   help="G4 fleet KV store tier: 'on', or "
                        "'mirror=1,fetch=1,prefill_tok_s=4000,gbps=1.0,"
                        "namespace=dynamo' (offload.parse_kv_remote_spec); "
                        "requires the offload plane armed and a hub; env "
                        "DYN_KV_REMOTE wins")
    p.add_argument("--no-swap-preemption", dest="swap_preemption",
                   action="store_false", default=True,
                   help="disable swap-based preemption (offload the "
                        "victim's KV and restore it on resume); preempted "
                        "sequences always recompute instead")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: one rank per process with "
                        "--device cpu (gloo; NCCL ranks on cards are not served "
                        "yet); env DYN_TP wins")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (MoE experts sharded over ranks)")
    # refused: their features are not ported yet
    for flag in ("--dp", "--sp", "--pp"):
        p.add_argument(flag, type=int, default=1, help="not served by the port yet")
    # multi-host engine (torch.distributed; env DYN_NUM_NODES /
    # DYN_NODE_RANK / DYN_LEADER_ADDR also work)
    p.add_argument("--num-nodes", type=int, default=None,
                   help="hosts in the engine's multi-host world")
    p.add_argument("--node-rank", type=int, default=None,
                   help="this host's rank (0 = leader: scheduler and front end)")
    p.add_argument("--leader-addr", default=None,
                   help="leader host:port of the torch.distributed rendezvous")


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynamo-tpu-torch",
        description="dynamo-tpu's PyTorch/CUDA port: OpenAI serving on the card",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="serve, or run prompts through, the engine")
    run.add_argument("io", nargs=2, metavar=("in=...", "out=..."),
                     help="in=http|text|batch|dyn out=torch|mocker|echo|dyn")
    run.add_argument("--hub", help="hub address host:port, or 'auto'")
    run.add_argument("--endpoint", default="dyn://dynamo.backend.generate",
                     help="worker endpoint id (dyn://ns.comp.ep)")
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--port", type=int, default=8080)
    run.add_argument("--router-mode", default="round_robin",
                     choices=["round_robin", "random", "kv"])
    run.add_argument("--router-index-shards", type=_positive_int, default=1,
                     help="KV router index shards (>1 = worker-sharded "
                          "index for large fleets)")
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
    # disaggregated prefill/decode (in=dyn workers only)
    run.add_argument("--disagg", choices=["decode", "prefill"],
                     help="serve as a disaggregated decode or prefill worker")
    run.add_argument("--max-local-prefill-length", type=int, default=512)
    run.add_argument("--max-prefill-queue-depth", type=int, default=16)
    run.add_argument(
        "--kv-chunk-layers", type=int, default=None,
        help="layers per chunk for the streamed KV export (prefill "
             "workers; default splits the stack into ~8 groups)",
    )
    run.add_argument(
        "--no-chunked-kv", action="store_true",
        help="legacy monolithic KV export/upload (disables the pipelined "
             "chunked transfer path)",
    )

    # standalone hub (the control plane process)
    hub = sub.add_parser("hub", help="run a standalone hub server")
    hub.add_argument("--host", default="0.0.0.0")
    hub.add_argument("--port", type=int, default=6650)
    hub.add_argument("--data-dir", default=None,
                     help="persist state (WAL + snapshot) here; a restart "
                          "restores KV/leases/queues/objects")

    # standalone cluster metrics component (reference components/metrics)
    mt = sub.add_parser("metrics",
                        help="cluster Prometheus metrics on :9091")
    mt.add_argument("--hub", required=True, help="hub address host:port")
    mt.add_argument("--namespace", default="dynamo")
    mt.add_argument("--component", default="backend",
                    help="worker component to scrape")
    mt.add_argument("--host", default="0.0.0.0")
    mt.add_argument("--port", type=int, default=9091)

    # fleet: the observatory's read side over the hub -- subscribe to the
    # workers' telemetry topic, render a live cluster table
    fl = sub.add_parser("fleet",
                        help="live fleet table from worker telemetry")
    fl.add_argument("--hub", required=True, help="hub address host:port")
    fl.add_argument("--namespace", default="dynamo")
    fl.add_argument("--interval", type=float, default=2.0,
                    help="seconds between table refreshes")
    fl.add_argument("--once", action="store_true",
                    help="print one table after --interval and exit")
    fl.add_argument("--json", dest="json_out", action="store_true",
                    help="print the raw /fleet summary JSON instead")
    fl.add_argument("--plan", action="store_true",
                    help="show the planner's last adjustment and reason per "
                         "pool (note_adjustment, or a snapshot's plan)")

    # disagg-conf: live-reload the disagg routing policy (reference
    # disagg_router.rs:38-90 etcd watch); decode workers pick it up without
    # restarts
    dc = sub.add_parser("disagg-conf",
                        help="update the live disagg routing policy")
    dc.add_argument("--hub", required=True, help="hub address host:port")
    dc.add_argument("--namespace", default="dynamo")
    dc.add_argument("--max-local-prefill-length", type=int, default=None)
    dc.add_argument("--max-prefill-queue-depth", type=int, default=None)

    # llmctl: cluster model administration
    ctl = sub.add_parser("llmctl", help="list/remove models on a hub")
    ctl.add_argument("--hub", required=True, help="hub address host:port")
    ctlsub = ctl.add_subparsers(dest="llmcmd", required=True)
    ctlsub.add_parser("list", help="list registered models + instances")
    rm = ctlsub.add_parser("remove", help="deregister a model by name")
    rm.add_argument("name")

    # profile: the tick profiler's read side against a live front end
    pf = sub.add_parser("profile",
                        help="tick-phase profile of a live serving front end")
    pf.add_argument("url", help="front end base url, e.g. http://127.0.0.1:8080")
    pf.add_argument("--enable", action="store_true",
                    help="arm tick profiling on the server first "
                         "(POST /profile/ticks)")
    pf.add_argument("--disable", action="store_true",
                    help="disarm tick profiling on the server and exit")
    pf.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="arm profiling, wait this long under live traffic, "
                         "then report (implies --enable)")
    pf.add_argument("--json", dest="json_out",
                    help="write the merged Chrome-trace JSON (tick phases "
                         "and request spans) here")
    pf.add_argument("--device", type=float, default=None, metavar="SECONDS",
                    help="also take a bounded device trace on the server "
                         "(POST /profile/device)")

    # trace: one request's cross-component span timeline from the hub
    # (every served component answers a _trace scrape endpoint)
    tr = sub.add_parser("trace", help="assemble a request's cross-component trace")
    tr.add_argument("--hub", required=True, help="hub address host:port")
    tr.add_argument("--namespace", default="dynamo")
    tr.add_argument("request_id", help="the request id (X-Request-Id header)")
    tr.add_argument("--json", dest="json_out",
                    help="write Chrome-trace JSON here (chrome://tracing, "
                         "ui.perfetto.dev)")
    tr.add_argument("--timeout", type=float, default=2.0,
                    help="per-component scrape timeout seconds")

    # profile-sla: pre-deployment TTFT/ITL profiling (reference
    # docs/architecture/planner.md profile_sla workflow)
    ps = sub.add_parser("profile-sla",
                        help="measure TTFT/ITL per config, recommend SLO point")
    ps.add_argument("--out", default="torch", choices=list(ENGINES),
                    help="engine to profile")
    ps.add_argument("--isl", default="128,512",
                    help="comma-separated prefill lengths to probe")
    ps.add_argument("--batch", default="1,4,8",
                    help="comma-separated decode batch sizes to probe")
    ps.add_argument("--osl", type=int, default=64,
                    help="decode tokens per probe stream (span several "
                         "flushes of up to 8 tokens, or ITL is unmeasurable)")
    ps.add_argument("--ttft-slo-ms", type=float, default=None)
    ps.add_argument("--itl-slo-ms", type=float, default=None)
    _add_engine_flags(ps)

    # eval: perplexity of a checkpoint on a text, loaded as serving loads it
    ev = sub.add_parser("eval", help="score a checkpoint's perplexity on a text")
    ev.add_argument("--model-path", required=True)
    ev.add_argument("--text-file", help="UTF-8 text to score")
    ev.add_argument("--text", help="inline text to score")
    ev.add_argument("--window", type=int, default=512,
                    help="independent scoring window (tokens)")
    ev.add_argument("--quantize", choices=["int8"], default=None)
    ev.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")

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
    bn.add_argument("--fleet", action="store_true",
                    help="also fetch GET /fleet from the front end and "
                         "attach the cluster summary to the report")
    return p


def _parse_io(io) -> Tuple[str, str]:
    try:
        kv = dict(part.split("=", 1) for part in io)
    except ValueError:
        kv = {}
    if "in" not in kv or "out" not in kv:
        raise SystemExit(
            "usage: run in=<http|text|batch|dyn> out=<torch|mocker|echo|dyn>"
        )
    return kv["in"], kv["out"]


def _check_refused(args) -> None:
    _apply_parallel_env(args)
    refused = [flag for flag, asks in _REFUSED.items() if asks(args)]
    if refused:
        raise SystemExit(
            f"not served by the PyTorch port yet: {', '.join(refused)}"
        )
    if max(getattr(args, "tp", 1), getattr(args, "ep", 1)) > 1:
        refused = [f for f, asks in _REFUSED_UNDER_MESH.items() if asks(args)]
        if refused:
            raise SystemExit(
                f"--tp {args.tp} --ep {args.ep}: not served under tensor or expert "
                f"parallelism yet: {', '.join(refused)}"
            )


def _apply_parallel_env(args) -> None:
    """``DYN_TP``/``DYN_DP`` win over the flags (the JAX CLI's rule; a
    malformed value stops the command)."""
    if not hasattr(args, "tp"):
        return
    from .parallel.mesh import env_parallel_spec

    try:
        env = env_parallel_spec()
    except ValueError as e:
        raise SystemExit(str(e))
    if env["tp"] is not None:
        args.tp = env["tp"]
    if env["dp"] is not None:
        args.dp = env["dp"]


def _multinode(args):
    """The multi-host config from the flags over ``DYN_NUM_NODES`` /
    ``DYN_NODE_RANK`` / ``DYN_LEADER_ADDR``."""
    from .parallel.multihost import MultiNodeConfig

    mn = MultiNodeConfig.from_env()
    if args.num_nodes is not None:
        mn.num_nodes = args.num_nodes
    if args.node_rank is not None:
        mn.node_rank = args.node_rank
    if args.leader_addr is not None:
        mn.leader_addr = args.leader_addr
    try:
        mn.validate()
    except ValueError as e:
        raise SystemExit(str(e))
    return mn


def _rank_plan(args, device):
    """``(mesh_cfg, multinode, local_ranks, devices, backend)`` of a
    sharded ``out=torch`` engine, checked before any weight loads: the
    degrees against the model's heads and this host's cards (JAX's "mesh
    needs N devices, have M"; NCCL ranks on cards, one each, are refused by
    name after that)."""
    from .engine.config import ModelConfig
    from .parallel.mesh import MeshConfig

    mesh_cfg = MeshConfig(tp=args.tp, ep=args.ep)
    mn = _multinode(args)
    if mesh_cfg.num_devices % mn.num_nodes:
        raise SystemExit(
            f"--tp {args.tp} --ep {args.ep}: {mesh_cfg.num_devices} ranks do not "
            f"split over {mn.num_nodes} nodes"
        )
    local = mesh_cfg.num_devices // mn.num_nodes
    model_cfg = ModelConfig.from_pretrained(args.model_path)
    try:
        model_cfg.validate_tp(args.tp)
    except ValueError as e:
        raise SystemExit(f"--tp {args.tp}: {e}")
    try:
        model_cfg.validate_ep(args.ep)
    except ValueError as e:
        raise SystemExit(f"--ep {args.ep}: {e}")
    if device.type == "cuda":
        from .parallel.mesh import check_devices

        try:
            check_devices(local, "nccl")
        except ValueError as e:
            raise SystemExit(f"--tp {args.tp} --ep {args.ep}: {e}")
    return mesh_cfg, mn, local, [str(device)] * local, "gloo"


def _start_node_ranks(args, cfg, device):
    """A multi-host node: its other local ranks started, this process
    joined to the world as the node's local rank 0.  Returns ``(mesh,
    ranks)``; the leader's engine announces itself to every follower."""
    from .parallel.launch import grid_spec, start_local_ranks
    from .parallel.mesh import build_mesh
    from .parallel.multihost import initialize_multihost

    mesh_cfg, mn, local, devices, backend = _rank_plan(args, device)
    spec = grid_spec(mesh_cfg, devices * mn.num_nodes, backend, local_ranks=local)
    spec["multinode"] = dict(num_nodes=mn.num_nodes, node_rank=mn.node_rank,
                             leader_addr=mn.leader_addr)
    first = mn.global_rank(0, local)
    ranks = start_local_ranks(mesh_cfg, spec, ranks=list(range(first + 1, first + local)))
    initialize_multihost(mn, 0, local, backend)
    mesh = build_mesh(mesh_cfg, first, devices[0], backend, local_ranks=local)
    return mesh, ranks


def run_follower_node(args) -> int:
    """``--node-rank`` above 0: this host's ranks follow the leader's
    engine (no front end here) until it stops."""
    from .device import resolve_device
    from .llm.local_model import resolve_model_path
    from .parallel.launch import follow

    if not args.model_path:
        raise SystemExit("out=torch requires --model-path")
    args.model_path = resolve_model_path(args.model_path)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (--device cpu)")
    mesh, ranks = _start_node_ranks(args, _engine_config(args), device)
    print(f"follower ranks of node {args.node_rank} serving the leader at "
          f"{args.leader_addr}", flush=True)
    try:
        follow(mesh)
    except KeyboardInterrupt:
        pass
    finally:
        mesh.close()
        ranks.join()
    return 0


def _check_served(args) -> None:
    """Refuse what the port cannot serve yet, naming it."""
    _check_refused(args)
    if args.inp not in ("http", "text", "batch", "dyn"):
        raise SystemExit(f"not served by the PyTorch port yet: in={args.inp}")
    if args.disagg is not None and (args.inp, args.out) != ("dyn", "torch"):
        # the JAX CLI ignores it there; the port refuses rather than serve
        # an aggregated process the operator did not ask for
        raise SystemExit(
            f"--disagg serves in=dyn out=torch workers only, not in={args.inp} "
            f"out={args.out}"
        )
    if args.kv_remote is not None and (args.inp, args.out) != ("dyn", "torch"):
        # the G4 store is the hub's: the JAX CLI parses the spec anywhere
        # and attaches it on workers only; the port refuses rather than
        # ignore it
        raise SystemExit(
            f"--kv-remote serves in=dyn out=torch workers only, not in={args.inp} "
            f"out={args.out}"
        )
    if args.out == "dyn":
        if args.inp != "http":
            raise SystemExit(f"out=dyn serves only in=http, not in={args.inp}")
        if not args.hub:
            raise SystemExit("in=http out=dyn requires --hub")
        return
    if args.out not in ENGINES:
        raise SystemExit(
            f"not served by the PyTorch port: out={args.out} "
            f"(use out={'|'.join(ENGINES)})"
        )
    if args.inp != "dyn":
        if args.hub is not None:
            raise SystemExit(
                f"--hub serves in=dyn and out=dyn only, not in={args.inp} "
                f"out={args.out}"
            )
        return
    if not args.hub:
        raise SystemExit("in=dyn requires --hub")
    if args.kv_chunk_layers is not None and args.kv_chunk_layers <= 0:
        raise SystemExit(f"--kv-chunk-layers must be positive, got {args.kv_chunk_layers}")


def _load_template(args):
    """--request-template JSON -> RequestTemplate, or None."""
    if not args.request_template:
        return None
    from .protocols.openai import RequestTemplate

    return RequestTemplate.load(args.request_template)


def _make_engine(args):
    """The local engine of ``out=``: the echo engine; the mocker, its
    vocabulary ``--model-path``'s tokenizer's (else 32000), as the JAX CLI
    builds them; or the TorchEngine over ``--model-path``'s checkpoint, on
    the card unless ``--device`` names another device."""
    if args.out == "echo":
        from .llm.echo import EchoEngineCore

        return EchoEngineCore(delay_ms=args.echo_delay_ms)
    if args.out == "mocker":
        from .mocker import MockerConfig, MockerEngine

        vocab = 32000
        if args.model_path:
            # emit ids the model's tokenizer can detokenize
            vocab = _tokenizer_for(args).vocab_size
        block = args.block_size or args.page_size
        return MockerEngine(MockerConfig(block_size=block, vocab_size=vocab))
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
    cfg = _engine_config(args)
    logger.info("loading %s onto %s ...", args.model_path, device)
    if max(args.tp, args.ep) > 1:
        return _make_sharded_engine(args, cfg, device)
    return TorchEngine.from_pretrained(args.model_path, cfg, device=device)


def _make_sharded_engine(args, cfg, device):
    """The leader's engine of a tp x ep grid: this host's follower ranks
    started by the engine (one node), or joined through the multi-host
    rendezvous (``--num-nodes``); the front end stays here."""
    from .engine import TorchEngine
    from .parallel.mesh import MeshConfig

    mesh_cfg, mn, local, _devices, _backend = _rank_plan(args, device)
    if not mn.is_multi_node:
        return TorchEngine.from_pretrained(
            args.model_path, cfg, device=device, mesh=MeshConfig(tp=args.tp, ep=args.ep)
        )
    mesh, ranks = _start_node_ranks(args, cfg, device)
    try:
        engine = TorchEngine.from_pretrained(args.model_path, cfg, device=device, mesh=mesh)
    except BaseException:
        ranks.kill()
        raise
    # the engine dismisses every node's followers when it stops
    engine._ranks = ranks
    return engine


def _engine_config(args):
    from .engine import EngineConfig

    cfg = EngineConfig(
        max_batch_size=args.max_batch_size,
        max_seq_len=args.max_seq_len,
        page_size=args.page_size,
        num_pages=args.num_pages,
        block_size=args.block_size,
        decode_block_size=args.decode_block_size,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        mixed_batching=args.mixed_batching,
        packed_ragged=args.packed_ragged,
        kv_admit_budget=args.kv_admit_budget,
        kv_dtype=args.kv_dtype,
        async_dispatch=args.async_dispatch,
        multistep_decode=args.multistep_decode,
        multistep_max_k=args.multistep_max_k,
        fold_spec_verify=args.fold_spec_verify,
        spec_auto_disable=args.spec_auto_disable,
        draft_model=args.draft_model,
        quantize=args.quantize,
        host_offload_blocks=args.host_offload_blocks,
        disk_offload_blocks=args.disk_offload_blocks,
        disk_offload_dir=args.disk_offload_dir,
        swap_preemption=args.swap_preemption,
        kv_remote=args.kv_remote,
    )
    if args.mixed_token_budget is not None:
        cfg.mixed_token_budget = args.mixed_token_budget
    if args.kv_prefetch_window is not None:
        cfg.kv_prefetch_window = args.kv_prefetch_window
    return cfg


def _tokenizer_for(args):
    from .llm.local_model import resolve_model_path
    from .llm.tokenizer import Tokenizer

    if not args.model_path:
        raise SystemExit("this mode needs --model-path for the tokenizer")
    args.model_path = resolve_model_path(args.model_path)
    return Tokenizer.from_model_dir(args.model_path)


def _model_name(args) -> str:
    if args.model_name:
        return args.model_name
    if args.model_path:
        return os.path.basename(os.path.normpath(args.model_path))
    return "mocker"


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


async def _wait_forever(
    stop: Optional[asyncio.Event] = None, drain_runtime=None
) -> None:
    """Park until a signal (or ``stop``).  With ``drain_runtime`` set,
    SIGTERM triggers a graceful drain first -- deregister from discovery,
    finish in-flight requests (``DYN_DRAIN_TIMEOUT_S``, default 30) --
    before stopping.  SIGINT stays immediate."""
    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    drain_tasks: set = set()

    async def _drain_then_stop() -> None:
        try:
            await drain_runtime.drain(
                float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "30"))
            )
        finally:
            stop.set()

    def _on_term() -> None:
        if drain_runtime is None or drain_runtime.draining:
            stop.set()
            return
        task = asyncio.ensure_future(_drain_then_stop())
        drain_tasks.add(task)
        task.add_done_callback(drain_tasks.discard)

    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGINT, stop.set)
    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGTERM, _on_term)
    await stop.wait()


async def _resolve_hub(args):
    """Returns (hub_address, owned_hub_server|None); runs one in this
    process for ``--hub auto``."""
    if args.hub == "auto":
        from .runtime.transports.hub import HubServer

        server = HubServer()
        host, port = await server.start()
        logger.info("spawned in-process hub at %s:%d", host, port)
        return f"{host}:{port}", server
    return args.hub, None


async def run_http_local(args) -> None:
    """in=http out=torch: single-process aggregated serving."""
    from .http.service import HttpService, ModelManager

    from .llm.embedding import EmbeddingEngine, fake_embedder

    engine, name, tokenizer, pipeline = _pipeline(args)
    manager = ModelManager()
    manager.add_chat_model(name, pipeline)
    manager.add_completion_model(name, pipeline)
    # /v1/embeddings, inputs tokenized here: the engine's trunk embeds; an
    # engine with no embed (echo) answers with the deterministic fake
    manager.add_embedding_model(
        name,
        EmbeddingEngine(
            engine.embed if hasattr(engine, "embed") else fake_embedder(),
            tokenizer=tokenizer,
            max_input_tokens=_max_input_tokens(engine),
        ),
    )
    service = HttpService(
        manager, host=args.host, port=args.port, template=_load_template(args)
    )
    await service.start()
    print(f"serving {name} at {service.url}  (POST /v1/chat/completions)", flush=True)
    try:
        await _wait_forever()
    finally:
        await service.stop()
        await engine.stop()


def _max_input_tokens(engine) -> Optional[int]:
    """The engine's ``max_seq_len`` (the mocker and echo engines have none)."""
    return getattr(getattr(engine, "cfg", None), "max_seq_len", None)


def kv_engine_factory(runtime, index_shards: int = 1, remote_spec=None,
                      observatory=None):
    """The ``ModelWatcher`` engine factory of ``--router-mode kv``: per
    model, a ``KvRouter`` over the worker component's KV events, holdings
    and load metrics, and ``link(OpenAIPreprocessor, Backend,
    KvPushRouter)``.  The chooser stops with its model.  With a fleet
    ``observatory`` the router places no new request on its quarantined
    workers, and the fetch-vs-recompute gate prices a donor with the
    observatory's fitted link (``predict_transfer_ms``); a link with no
    samples yet, or no observatory, falls back to ``remote_spec``'s priors
    (``offload.parse_kv_remote_spec``; its defaults when None).
    ``factory.choosers`` maps each model's name to its ``KvRouter``,
    ``factory.push_routers`` to its ``KvPushRouter``."""
    from .llm.backend import Backend
    from .llm.kv_router.router import KvPushRouter, KvRouter
    from .llm.preprocessor import OpenAIPreprocessor
    from .runtime.pipeline import link

    async def factory(entry, card, client, router):
        ns = runtime.namespace(entry.namespace)
        chooser = KvRouter(
            ns, ns.component(entry.component), block_size=card.kv_block_size,
            index_shards=index_shards,
            quarantine=(
                None if observatory is None else observatory.quarantine_source()
            ),
        )
        await chooser.start()
        factory.choosers[entry.name] = chooser
        push = KvPushRouter(
            router, chooser,
            transfer_ms=(
                None if observatory is None else observatory.predict_transfer_ms
            ),
            remote_spec=remote_spec,
        )
        factory.push_routers[entry.name] = push
        tokenizer = card.tokenizer()
        engine = link(OpenAIPreprocessor(entry.name, tokenizer), Backend(tokenizer), push)
        return engine, chooser.stop

    factory.choosers = {}
    factory.push_routers = {}
    return factory


async def run_http_frontend(args) -> None:
    """in=http out=dyn: the discovery-driven front end over the hub, with
    the fleet observatory reading every worker's telemetry on namespace
    ``dynamo`` (``GET /fleet``, ``GET /fleet/metrics``; the KV router's
    quarantine and link prices)."""
    from .fleet import FleetObservatory
    from .http.service import HttpService, ModelManager
    from .llm.discovery import ModelWatcher
    from .runtime.component import DistributedRuntime, RouterMode

    remote_spec = None
    if args.router_mode == "kv":
        # the gate's priors; parsed before the hub connection, whose lease
        # the offload module's import would outlast on the event loop
        from .offload import env_remote_spec

        try:
            remote_spec = env_remote_spec()
        except ValueError:
            logger.warning("ignoring malformed DYN_KV_REMOTE")
    # built before the router factory: the KV router's quarantine filter
    # and fetch-vs-recompute gate read its live straggler and link state
    observatory = FleetObservatory()
    addr, owned_hub = await _resolve_hub(args)
    runtime = await DistributedRuntime.detached(addr)
    manager = ModelManager()
    if args.router_mode == "kv":
        watcher = ModelWatcher(
            runtime, manager,
            engine_factory=kv_engine_factory(
                runtime, args.router_index_shards, remote_spec=remote_spec,
                observatory=observatory,
            ),
        )
    else:
        watcher = ModelWatcher(
            runtime, manager, router_mode=RouterMode(args.router_mode)
        )
    service = None
    try:
        await watcher.start()
        await observatory.start(runtime.namespace("dynamo"))
        service = HttpService(
            manager, host=args.host, port=args.port, template=_load_template(args),
            observatory=observatory,
        )
        await service.start()
        print(f"frontend at {service.url} (hub {addr}); models appear on discovery",
              flush=True)
        stop = asyncio.Event()
        # hub loss must end the front end (fail loud), not freeze its view
        if hasattr(runtime.hub, "on_connection_lost"):
            runtime.hub.on_connection_lost = stop.set
        await _wait_forever(stop)
    finally:
        if service is not None:
            await service.stop()
        await observatory.stop()
        await watcher.stop()
        await runtime.shutdown()
        if owned_hub:
            await owned_hub.stop()


class ServedWorker:
    """The publishers and wrappers :func:`serve_worker` set up around an
    engine: the KV event publisher (``events``), the tier holdings
    publisher (``holdings``, with the offload plane armed) and the prefix
    importer in front of the engine (``onboard``, likewise).  ``close()``
    them before stopping the engine."""

    def __init__(self, events=None, holdings=None, onboard=None) -> None:
        self.events = events
        self.holdings = holdings
        self.onboard = onboard

    async def close(self) -> None:
        if self.onboard is not None:
            await self.onboard.close()
        if self.holdings is not None:
            await self.holdings.close()
        if self.events is not None:
            await self.events.close()


def wire_offload_plane(runtime, engine, ns):
    """A worker's offload plane on the hub, every role's: with a parsed
    ``kv_remote`` spec the G4 tier attaches over the hub's blob verbs, and
    the plane's tier holdings (peer host and disk copies, G4 adverts) are
    published for the router's cluster-global prefix index.  Returns the
    holdings publisher, or None when the plane is not armed."""
    if engine.offload_engine is None:
        return None
    from .llm.kv_router.publisher import KvHoldingsPublisher
    from .runtime.transports.client import HubBlobClient

    if engine.kv_remote_spec is not None:
        engine.attach_remote_kv(
            HubBlobClient(runtime.hub, asyncio.get_running_loop()),
            worker_id=runtime.primary_lease,
        )
    holdings = KvHoldingsPublisher(ns, worker_id=runtime.primary_lease)
    holdings.hook(engine)
    return holdings


async def serve_worker(runtime, engine, endpoint: str, model_path: str,
                       model_name: Optional[str] = None, served=None,
                       block_size: Optional[int] = None):
    """What ``run in=dyn`` serves on a connected runtime: ``served`` (the
    engine, or a ``--disagg decode`` worker's ``DisaggDecodeEngine``) on
    ``endpoint`` (``dyn://ns.comp.ep``), the engine's embeddings on
    ``{ep}_embed``, the KV event and load-metrics publishers, and the
    model's registration with the engine's own block size as the router's
    blocks (:func:`engine_block_size`; ``block_size`` only for an engine
    without one).  An engine serves only
    the legs it has: the echo engine embeds nothing and publishes neither
    KV events nor load metrics, and without ``model_path`` no model card
    is registered (the card comes back None).  With the offload plane armed, as the JAX
    package's worker does: ``kv_export`` is served for peers, ``served``
    goes behind a ``PrefixOnboardEngine`` that imports donors' blocks, and
    :func:`wire_offload_plane` publishes the holdings and attaches the G4
    tier.  Returns the model card and a :class:`ServedWorker` (close it
    before stopping the engine)."""
    from .llm.embedding import EmbeddingEngine
    from .llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
    from .llm.model_card import register_llm
    from .protocols.endpoint import parse_endpoint_id

    ns_name, comp_name, ep_name = parse_endpoint_id(endpoint)
    ns = runtime.namespace(ns_name)
    comp = ns.component(comp_name)
    ep = comp.endpoint(ep_name)
    worker = ServedWorker()
    served = served or engine
    if getattr(engine, "offload", None) is not None:
        from .llm.prefix_onboard import (
            KV_EXPORT_ENDPOINT,
            PrefixOnboardEngine,
            kv_export_handler,
        )

        await comp.endpoint(KV_EXPORT_ENDPOINT).serve_raw(kv_export_handler(engine))
        served = worker.onboard = PrefixOnboardEngine(served, ns, comp_name, engine=engine)
    await ep.serve(served)
    embed_ep_name = ""
    if hasattr(engine, "embed"):
        # pooled-embedding leg: a sibling endpoint the front end's watcher
        # finds through the model entry's embed_endpoint field
        embed_ep_name = f"{ep_name}_embed"
        await comp.endpoint(embed_ep_name).serve(
            EmbeddingEngine(engine.embed, max_input_tokens=_max_input_tokens(engine))
        )
    if hasattr(engine, "metrics"):
        worker.events = KvEventPublisher(ns, worker_id=runtime.primary_lease)
        worker.events.hook(engine)
        await WorkerMetricsPublisher(engine.metrics).attach(comp)
    if hasattr(engine, "offload_engine"):
        worker.holdings = wire_offload_plane(runtime, engine, ns)
    if not model_path:
        return None, worker
    # the router hashes prompts in the card's blocks, so they are the
    # blocks the engine's KV events hash
    card = await register_llm(
        runtime, ep, model_path,
        model_name=model_name,
        kv_block_size=engine_block_size(engine, block_size),
        embed_endpoint=embed_ep_name,
    )
    return card, worker


def engine_block_size(engine, default: Optional[int] = None) -> int:
    """The block size an engine's KV events hash: the torch engine's router
    blocks (``EngineConfig.block_size``, else its pages), the mocker's
    blocks; ``default`` (else 16) for an engine with neither."""
    sched = getattr(engine, "sched", None)
    if sched is not None and getattr(sched, "block_size", None):
        return int(sched.block_size)
    cfg = getattr(engine, "cfg", None)
    return int(getattr(cfg, "block_size", None) or default or 16)


async def serve_disagg_decode(runtime, engine, endpoint: str, model_path: str,
                              model_name: Optional[str] = None, cfg=None,
                              block_size: Optional[int] = None):
    """What ``run in=dyn --disagg decode`` serves: a ``DisaggDecodeEngine``
    over ``engine`` (instance id: the runtime's primary lease, which
    ``serve`` registers under) with its ``kv_deliver`` endpoint served
    first -- a shipped request's write-back must never race a missing
    endpoint --, the live policy watch started, then :func:`serve_worker`
    with the decode engine on the generate endpoint (behind the prefix
    importer when the offload plane is armed).  Returns the decode engine,
    the model card and the :class:`ServedWorker`."""
    from .llm.disagg import KV_DELIVER_ENDPOINT, DisaggDecodeEngine
    from .protocols.endpoint import parse_endpoint_id

    ns_name, comp_name, _ = parse_endpoint_id(endpoint)
    ns = runtime.namespace(ns_name)
    block_size = engine_block_size(engine, block_size)
    disagg = DisaggDecodeEngine(
        engine, ns, comp_name, instance_id=runtime.primary_lease, cfg=cfg,
        block_size=block_size,
    )
    await ns.component(comp_name).endpoint(KV_DELIVER_ENDPOINT).serve_raw(
        disagg.kv_deliver_handler()
    )
    await disagg.start_config_watch()
    card, worker = await serve_worker(runtime, engine, endpoint, model_path, model_name,
                                      served=disagg, block_size=block_size)
    return disagg, card, worker


async def run_worker(args) -> None:
    """in=dyn out=torch|mocker|echo: the engine as a worker on the hub --
    aggregated, or one role of disaggregated serving (``--disagg
    decode|prefill``, torch only).  The worker stamps its identity on its
    metrics and publishes telemetry snapshots for the fleet's observatory,
    as the JAX worker does."""
    from .llm.disagg import DisaggConfig, PrefillWorker
    from .protocols.endpoint import parse_endpoint_id
    from .runtime import metrics as rtm
    from .runtime.component import DistributedRuntime
    from .runtime.telemetry import TelemetryPublisher

    # build the engine BEFORE connecting: weight loading blocks the event
    # loop long enough to starve lease keepalives and get this worker evicted
    engine = _make_engine(args)
    owned_hub = runtime = pub = disagg = prefill = telemetry = None
    try:
        addr, owned_hub = await _resolve_hub(args)
        runtime = await DistributedRuntime.detached(addr)
        if args.disagg == "prefill":
            # a queue consumer only: no generate endpoint, no embed leg, no
            # model registration, and no load metrics a KV router would
            # take it for a decode candidate by; its offload plane still
            # publishes holdings and mirrors into the G4 store
            ns = runtime.namespace(parse_endpoint_id(args.endpoint)[0])
            pub = ServedWorker(holdings=wire_offload_plane(runtime, engine, ns))
            prefill = PrefillWorker(
                engine, ns,
                chunked=not args.no_chunked_kv, layers_per_chunk=args.kv_chunk_layers,
            )
            await prefill.start()
            banner = f"prefill worker consuming {prefill.queue.name} (hub {addr})"
        elif args.disagg == "decode":
            disagg, card, pub = await serve_disagg_decode(
                runtime, engine, args.endpoint, args.model_path, args.model_name,
                cfg=DisaggConfig(
                    max_local_prefill_length=args.max_local_prefill_length,
                    max_prefill_queue_depth=args.max_prefill_queue_depth,
                ),
                block_size=args.block_size,
            )
            banner = (f"decode worker serving model {card.name} on {args.endpoint} "
                      f"(hub {addr})")
        else:
            card, pub = await serve_worker(
                runtime, engine, args.endpoint, args.model_path, args.model_name,
                block_size=args.block_size or args.page_size,
            )
            if card is None:
                banner = f"worker serving on {args.endpoint} (hub {addr}; no model card)"
            else:
                banner = f"worker serving model {card.name} on {args.endpoint} (hub {addr})"
        role = args.disagg or "worker"
        rtm.set_worker_identity(worker_id=runtime.primary_lease, role=role)
        ns = runtime.namespace(parse_endpoint_id(args.endpoint)[0])
        telemetry = TelemetryPublisher(
            ns, worker_id=runtime.primary_lease, role=role,
            # the mocker's synthetic link observations ride its own log;
            # every other engine's, the process-wide one the disagg and G4
            # paths feed
            transfer_log=getattr(engine, "transfer_log", None),
        )
        telemetry.start()
        stop = asyncio.Event()
        # hub loss orphans this worker's registrations: exit so a supervisor
        # restarts it into a live cluster (fail loud)
        if hasattr(runtime.hub, "on_connection_lost"):
            runtime.hub.on_connection_lost = stop.set
        print(banner, flush=True)
        await _wait_forever(stop, drain_runtime=runtime)
    finally:
        if telemetry is not None:
            await telemetry.stop(final=False)
        if prefill is not None:
            await prefill.stop()
        if disagg is not None:
            await disagg.stop_config_watch()
        if pub is not None:
            await pub.close()
        await engine.stop()
        if runtime is not None:
            await runtime.shutdown()
        if owned_hub:
            await owned_hub.stop()


async def run_disagg_conf(args) -> int:
    """Write the live disagg routing policy to the hub; every decode worker
    watching the key reloads it (``llm/disagg.py`` start_config_watch)."""
    from .llm.disagg import disagg_conf_key
    from .runtime.component import DistributedRuntime

    conf = {}
    if args.max_local_prefill_length is not None:
        conf["max_local_prefill_length"] = args.max_local_prefill_length
    if args.max_prefill_queue_depth is not None:
        conf["max_prefill_queue_depth"] = args.max_prefill_queue_depth
    if not conf:
        print("nothing to update (pass --max-local-prefill-length and/or "
              "--max-prefill-queue-depth)")
        return 2
    rt = await DistributedRuntime.detached(args.hub)
    try:
        # read-modify-write: a partial update must not drop fields an
        # earlier update set -- workers that join later apply the snapshot
        key = disagg_conf_key(args.namespace)
        merged: dict = {}
        for k, value in await rt.hub.kv_get_prefix(key):
            try:
                merged.update(json.loads(value))
            except ValueError:
                # malformed old value: overwrite it, but say so
                logger.warning("discarding malformed disagg conf at %s", k)
        merged.update(conf)
        await rt.hub.kv_put(key, json.dumps(merged).encode())
        print(f"disagg conf updated for namespace {args.namespace}: {merged}")
    finally:
        await rt.shutdown()
    return 0


async def run_hub(args) -> None:
    """hub: the standalone control plane, until SIGINT or SIGTERM."""
    from .runtime.transports.hub import HubServer

    server = HubServer(host=args.host, port=args.port, data_dir=args.data_dir)
    host, port = await server.start()
    print(f"hub at {host}:{port}", flush=True)
    try:
        await _wait_forever()
    finally:
        await server.stop()


async def run_llmctl(args) -> int:
    """Model administration against a live hub: list or remove models."""
    from .llm.model_card import MDC_OBJ_PREFIX, MODEL_ROOT, ModelEntry, slugify
    from .runtime.transports.client import HubClient

    host, _, port = args.hub.rpartition(":")
    try:
        hub = await HubClient(host or "127.0.0.1", int(port)).connect()
    except OSError as e:
        raise SystemExit(f"cannot reach hub at {args.hub}: {e}")
    try:
        entries = await hub.kv_get_prefix(f"{MODEL_ROOT}/")
        if args.llmcmd == "list":
            by_slug: Dict[str, list] = {}
            for key, blob in entries:
                slug = key.split("/")[1]
                by_slug.setdefault(slug, []).append(ModelEntry.from_json(blob))
            if not by_slug:
                print("no models registered")
                return 0
            for slug, insts in sorted(by_slug.items()):
                e = insts[0]
                print(
                    f"{e.name}  instances={len(insts)}  "
                    f"endpoint=dyn://{e.namespace}.{e.component}.{e.endpoint}  "
                    f"type={e.model_type}"
                )
            return 0
        slug = slugify(args.name)
        n = await hub.kv_delete_prefix(f"{MODEL_ROOT}/{slug}/")
        # the card object is keyed by slug as well; best-effort cleanup
        with contextlib.suppress(Exception):
            await hub.obj_del(f"{MDC_OBJ_PREFIX}/{slug}")
        print(f"removed {n} instance entr{'y' if n == 1 else 'ies'} for "
              f"{args.name!r}")
        return 0 if n else 1
    finally:
        await hub.close()


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
    if args.fleet:
        from .bench_serving import fetch_fleet

        try:
            summary["fleet"] = await fetch_fleet(args.host, args.port)
        except Exception as e:
            summary["fleet"] = {"error": repr(e)}
    print(json.dumps(summary, indent=2))
    return 0 if summary["num_errors"] == 0 else 1


async def run_profile_sla(args) -> int:
    """profile-sla: drive the engine, print the TTFT/ITL table + the SLO
    recommendation as one JSON object."""
    from .planner.profile_sla import SlaProfiler

    isls = [int(x) for x in args.isl.split(",") if x]
    batches = [int(x) for x in args.batch.split(",") if x]
    engine = _make_engine(args)  # built as `run` builds it (shared flags)
    try:
        vocab = _tokenizer_for(args).vocab_size if args.model_path else 30000
        prof = await SlaProfiler(engine, vocab_size=vocab).profile(
            isls=isls, batches=batches, osl=args.osl
        )
        print(
            json.dumps(
                {
                    "profile": prof.to_dict(),
                    "recommendation": prof.recommend(
                        args.ttft_slo_ms, args.itl_slo_ms
                    ),
                },
                indent=2,
            )
        )
    finally:
        await engine.stop()
    return 0


async def run_metrics(args) -> int:
    """metrics: the standalone cluster Prometheus component (reference
    components/metrics :9091) -- scrapes worker load_metrics through the
    hub, subscribes to kv-hit-rate events, serves GET /metrics."""
    from .llm.components import MetricsService
    from .runtime.component import DistributedRuntime

    runtime = await DistributedRuntime.detached(args.hub)
    svc = MetricsService(runtime, args.namespace, args.component)
    try:
        await svc.start()
        host, port = await svc.serve_http(args.host, args.port)
        print(f"cluster metrics at http://{host}:{port}/metrics (hub {args.hub})",
              flush=True)
        stop = asyncio.Event()
        if hasattr(runtime.hub, "on_connection_lost"):
            runtime.hub.on_connection_lost = stop.set
        await _wait_forever(stop)
    finally:
        await svc.stop()
        await runtime.shutdown()
    return 0


def format_fleet_table(summary, show_plan: bool = False) -> str:
    """One ``GET /fleet`` summary as the ``fleet`` subcommand's table."""
    import time

    lines = []
    totals = summary.get("totals", {})
    roles = totals.get("workers_by_role", {})
    head = ", ".join(
        f"{n} {role}" for role, n in sorted(roles.items())
    ) or "no workers"
    lines.append(
        f"fleet: {head} | kv pressure "
        f"{totals.get('kv_pressure', 0.0):.2f} | queue "
        f"{totals.get('queue_depth', 0)}"
    )
    slo = totals.get("slo_attainment") or {}
    if slo:
        lines.append(
            "slo:   "
            + "  ".join(f"{k}={v:.3f}" for k, v in sorted(slo.items()))
        )
    cols = ("id", "role", "tok/s", "step ms", "kv", "queue", "slots", "flag")
    rows = []
    for w in summary.get("workers", []):
        step = w.get("step_ms")
        rows.append(
            (
                str(w["worker_id"]),
                w.get("role", "?"),
                f"{w.get('tokens_per_s', 0.0):.1f}",
                "-" if step is None else f"{step:.2f}",
                f"{w.get('kv_pages_used', 0)}/{w.get('kv_pages_total', 0)}",
                str(w.get("queue_depth", 0)),
                f"{w.get('batch_occupancy', 0)}/{w.get('batch_slots', 0)}",
                "QUARANTINED" if w.get("quarantined")
                else ("STRAGGLER" if w.get("straggler") else ""),
            )
        )
    if rows:
        widths = [
            max(len(cols[i]), max(len(r[i]) for r in rows))
            for i in range(len(cols))
        ]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        lines.append(fmt.format(*cols))
        for r in rows:
            lines.append(fmt.format(*r))
    if show_plan:
        plan = summary.get("plan") or {}
        if not plan:
            lines.append("plan:  (no planner adjustments yet)")
        for kind in sorted(plan):
            rec = plan[kind]
            ts = rec.get("ts")
            age = f" ({max(time.time() - ts, 0.0):.0f}s ago)" if ts else ""
            lines.append(
                f"plan:  {kind}: {rec.get('action', '?')} from "
                f"{rec.get('count_before', '?')} -- "
                f"{rec.get('reason', '')}{age}"
            )
    for link in summary.get("links", []):
        bw = link.get("bandwidth_bytes_per_s")
        setup = link.get("setup_ms")
        lines.append(
            f"link {link['src']}->{link['dst']}: "
            + ("fitting..." if bw is None
               else f"{bw / 1e6:.1f} MB/s + {setup or 0.0:.2f} ms setup")
            + f" ({link.get('samples', 0)} samples)"
        )
    return "\n".join(lines)


async def run_fleet(args) -> int:
    """fleet: subscribe to worker telemetry on the hub, print a live
    cluster table (the CLI face of ``GET /fleet``)."""
    from .fleet import FleetObservatory
    from .runtime.component import DistributedRuntime
    from .runtime.metrics import MetricsRegistry

    # private registry: the CLI process has no scrape surface, and must
    # not add fleet families to a colocated default registry
    observatory = FleetObservatory(MetricsRegistry())
    runtime = await DistributedRuntime.detached(args.hub)
    stop = asyncio.Event()
    # SIGINT ends the loop as it ends the serving commands (_wait_forever),
    # even where the parent left it ignored
    with contextlib.suppress(NotImplementedError):
        asyncio.get_running_loop().add_signal_handler(signal.SIGINT, stop.set)
    if hasattr(runtime.hub, "on_connection_lost"):
        runtime.hub.on_connection_lost = stop.set
    try:
        await observatory.start(runtime.namespace(args.namespace))
        while not stop.is_set():
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(stop.wait(), args.interval)
            if stop.is_set():
                break
            summary = observatory.summary()
            if args.json_out:
                print(json.dumps(summary, indent=2), flush=True)
            else:
                print(format_fleet_table(summary, show_plan=args.plan), flush=True)
                print(flush=True)
            if args.once:
                break
    finally:
        await observatory.stop()
        await runtime.shutdown()
    return 0


async def run_profile(args) -> int:
    """profile: read a live front end's tick profile (``GET
    /profile/ticks``) and print where the ticks' wall time went: the host
    phases, the host occupancy and the dispatch gap.  ``--watch S`` arms
    profiling and samples S seconds of live traffic first; ``--device S``
    also takes a bounded device trace on the server."""
    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")
    if "://" not in base:
        base = "http://" + base

    def _call(path: str, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            base + path,
            data=data,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=35.0) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            # a structured non-2xx body (/profile/device's 503 {ok:false})
            # is an answer, not a connectivity failure
            body = e.read().decode(errors="replace")
            try:
                return json.loads(body)
            except ValueError:
                raise OSError(f"HTTP {e.code}: {body[:200]}") from e

    async def call(path: str, payload=None):
        return await asyncio.to_thread(_call, path, payload)

    try:
        if args.disable:
            out = await call("/profile/ticks", {"enabled": False})
            print(f"tick profiling disabled (server enabled={out['enabled']})")
            return 0
        if args.enable or args.watch is not None:
            await call("/profile/ticks", {"enabled": True, "clear": True})
        if args.watch is not None:
            print(f"profiling armed; sampling {args.watch:g}s of traffic...")
            await asyncio.sleep(max(args.watch, 0.0))
        if args.device is not None:
            dev = await call("/profile/device", {"duration_s": args.device})
            if dev.get("ok"):
                print(f"device trace captured to {dev['log_dir']}")
            else:
                print(f"device trace unavailable: {dev.get('error')}")
        data = await call("/profile/ticks")
    except OSError as e:
        print(f"cannot reach {base}: {e}")
        return 1
    summ = data.get("summary") or {}
    if not summ.get("ticks"):
        print(
            "no tick records yet (is the profiler enabled -- "
            "DYN_TICK_PROFILE=1, --enable, or --watch -- and is the "
            "engine serving traffic?)"
        )
        return 1
    wall = summ.get("wall_s") or 0.0
    print(
        f"{summ['ticks']} ticks, {summ['dispatches']} dispatches, "
        f"wall {wall:.3f}s, host occupancy {summ.get('host_occupancy')}"
    )
    print(f"{'phase':<12} {'total_s':>10} {'% wall':>8}")
    totals = summ.get("phase_totals_s") or {}
    for name, tot in sorted(totals.items(), key=lambda kv: -kv[1]):
        frac = 100.0 * tot / wall if wall else 0.0
        print(f"{name:<12} {tot:>10.4f} {frac:>7.1f}%")
    print(
        f"dispatch gap p50={summ.get('gap_p50_ms')}ms "
        f"p95={summ.get('gap_p95_ms')}ms"
    )
    if args.json_out:
        payload = json.dumps(data.get("chrome_trace") or {}, indent=2)
        await asyncio.to_thread(_write_text, args.json_out, payload)
        print(f"chrome trace written to {args.json_out}")
    return 0


async def run_trace(args) -> int:
    """trace: assemble one request's span timeline from every component
    on the hub.  Discovery reads the hub's ``instances/`` keyspace; each
    component's ``_trace`` endpoint returns its process's spans for the
    request id, and the merged set prints as one offset-ordered timeline
    (and, with ``--json``, a Chrome trace)."""
    from .runtime import tracing
    from .runtime.component import INSTANCE_ROOT_PATH, DistributedRuntime, Instance

    rt = await DistributedRuntime.detached(args.hub)
    try:
        prefix = f"{INSTANCE_ROOT_PATH}/{args.namespace}/"
        components = set()
        for key, value in await rt.hub.kv_get_prefix(prefix):
            try:
                components.add(Instance.from_json(value).component)
            except Exception:
                logger.warning("skipping malformed instance record at %s", key)
        if not components:
            print(f"no components registered under namespace {args.namespace}")
            return 1
        ns = rt.namespace(args.namespace)
        # scraped together: one wedged component costs one timeout in all
        comps = sorted(components)
        results = await asyncio.gather(
            *(
                ns.component(comp).scrape_trace(args.request_id, timeout_s=args.timeout)
                for comp in comps
            ),
            return_exceptions=True,
        )
        spans = []
        for comp, res in zip(comps, results):
            if isinstance(res, Exception):
                logger.warning("trace scrape failed for %s: %s", comp, res)
            else:
                spans.extend(res)
        # co-located components share one process collector: the same span
        # comes back from every component scrape in that process
        seen, deduped = set(), []
        for sp in spans:
            key = sp.get("span_id")
            if key:
                if key in seen:
                    continue
                seen.add(key)
            deduped.append(sp)
        spans = deduped
        if not spans:
            print(
                f"no spans for request {args.request_id} "
                f"(is DYN_TRACE=1 set on the serving processes?)"
            )
            return 1
        spans.sort(key=lambda sp: sp.get("start_s", 0.0))
        t0 = spans[0].get("start_s", 0.0)
        trace_ids = {sp.get("trace_id") for sp in spans if sp.get("trace_id")}
        print(
            f"request {args.request_id}: {len(spans)} spans across "
            f"{len({sp.get('component') or 'process' for sp in spans})} "
            f"components (trace {', '.join(sorted(trace_ids)) or 'n/a'})"
        )
        print(f"{'offset_ms':>10}  {'dur_ms':>9}  {'component':<24} name")
        for sp in spans:
            off = (sp.get("start_s", 0.0) - t0) * 1e3
            print(
                f"{off:10.3f}  {sp.get('duration_ms', 0.0):9.3f}  "
                f"{(sp.get('component') or '-'):<24} {sp.get('name', '')}"
            )
        if args.json_out:
            payload = json.dumps(tracing.chrome_trace(spans), indent=2)
            await asyncio.to_thread(_write_text, args.json_out, payload)
            print(f"chrome trace written to {args.json_out}")
        return 0
    finally:
        await rt.shutdown()


def run_eval(args) -> int:
    """Perplexity of a checkpoint on a text: weights loaded as serving
    loads them (safetensors, else GGUF; ``--quantize int8`` included),
    scored by ``llm/evaluate.py`` on ``--device`` (default the card); one
    JSON line, floats rounded to 4 decimals."""
    from .device import resolve_device
    from .engine.config import ModelConfig
    from .engine.engine import check_model_geometry
    from .engine.kv_cache import torch_dtype
    from .engine.quant import quantize_params
    from .engine.weights import load_checkpoint_params
    from .llm.evaluate import evaluate_perplexity
    from .llm.local_model import resolve_model_path
    from .llm.tokenizer import Tokenizer

    if not args.text and not args.text_file:
        raise SystemExit("need --text or --text-file")
    if args.text:
        text = args.text
    else:
        with open(args.text_file, encoding="utf-8") as f:
            text = f.read()
    path = resolve_model_path(args.model_path)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (--device cpu)")
    model_cfg = ModelConfig.from_pretrained(path)
    check_model_geometry(model_cfg, device)
    params = load_checkpoint_params(path, model_cfg, device, quantize=args.quantize)
    if args.quantize == "int8":
        params = quantize_params(params, torch_dtype(model_cfg.dtype))
    ids = Tokenizer.from_model_dir(path).encode(text)
    out = evaluate_perplexity(params, model_cfg, ids, window=args.window)
    out["model"] = args.model_path
    out["quantize"] = args.quantize
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}), flush=True)
    return 0


def _write_text(path: str, payload: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(payload)


def main(argv=None) -> int:
    logging.basicConfig(
        level=getattr(logging, os.environ.get("DYN_LOG", "info").upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        return asyncio.run(run_bench(args))
    if args.cmd == "profile":
        return asyncio.run(run_profile(args))
    if args.cmd == "trace":
        return asyncio.run(run_trace(args))
    if args.cmd == "llmctl":
        return asyncio.run(run_llmctl(args))
    if args.cmd == "disagg-conf":
        return asyncio.run(run_disagg_conf(args))
    if args.cmd == "profile-sla":
        _check_refused(args)
        return asyncio.run(run_profile_sla(args))
    if args.cmd == "eval":
        return run_eval(args)
    if args.cmd == "hub":
        asyncio.run(run_hub(args))
        return 0
    if args.cmd in ("metrics", "fleet"):
        runner = run_metrics if args.cmd == "metrics" else run_fleet
        try:
            return asyncio.run(runner(args))
        except KeyboardInterrupt:
            return 0
    args.inp, args.out = _parse_io(args.io)
    _check_served(args)
    if args.out == "torch" and max(args.tp, args.ep) > 1 and _multinode(args).node_rank > 0:
        return run_follower_node(args)
    if args.out == "dyn":
        runner = run_http_frontend
    else:
        runner = {"http": run_http_local, "text": run_text, "batch": run_batch,
                  "dyn": run_worker}[args.inp]
    try:
        asyncio.run(runner(args))
    except KeyboardInterrupt:
        pass
    return 0
