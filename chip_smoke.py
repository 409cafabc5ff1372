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
   verify segments of 5 rows beside 8 decode rows (the folded verify);
   and serve-disagg's shapes: full flash prefill of its export batch (the
   8 long prompts of 1024 to 2000 tokens, B = 8, T = 2048), paged decode
   over the decode worker's 16 lanes, and packed ragged over its 16 decode
   rows and over a 16-lane tick of its short prompts' local prefill; and
   eval's windows (serve-gguf (b)): full flash prefill of one lane of 512
   and of 2048 tokens, every row valid; paged decode and packed
   ragged at a rank of Llama-3-8B at tp = 2 (16/4/128, serve's shapes);
   and full flash prefill of a pipeline stage's microbatch
   (serve-sp-pp (b): two lanes of 1100 and 1500 tokens in a 2048 bucket).
   CUDA-event times of the kernel, the
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

8. serve-prof: the observability plane (``runtime/profiling.py``,
   ``slo.py``, ``compile_sentry.py``), right after serve-http.  (a) The
   reference phase's f32 model on the card and on the CPU under
   ``DYN_MULTISTEP`` = 0, 4 and adaptive, and adaptive with the tick
   profiler armed, the compile sentry armed: the streams equal the CPU's
   and the reference phase's, K is 1 or 4 under 4, and on the card the
   sentry's graph events equal ``graph_captures``.  (b) Llama-3-8B at
   full width and depth, bf16, serve's weights and traffic through the
   in-process HTTP service under ``DYN_SLO`` targets: the primer, the
   batch cold and warm, warm with the tick profiler armed by ``POST
   /profile/ticks`` (every tick's phases sum to its wall within 10%, its
   dispatches by kind equal the engine's counters; the phase shares, host
   occupancy, dispatch gap p50/p95 and dispatches printed from ``GET
   /profile/ticks``), warm unprofiled again (the three ``tok_s`` printed),
   then a warm batch beside ``POST /profile/device {"duration_s": 1.0}``,
   whose trace must hold kernels 5 and 1 by name (the device's busy
   share, the host threads whose ops it holds, whether its clock aligns
   with the tick records' and, aligned, the five longest device-idle gaps
   with the tick phase under way at each, printed); ``GET /trace/{id}``
   must hold a mixed ``engine.prefill_dispatch``; a request with a 1 ms
   deadline must get a 504 whose ``flightrec`` snapshot holds tick
   records, the engine's state and the ``deadline`` violation, and
   ``/metrics`` the ``dynamo_slo_attainment`` series; the launch
   invariants hold.  (c) Inside serve-http's CLI phase, ``python -m
   dynamo_tpu_torch profile --watch 3 --device 1 --json OUT`` against its
   ``run in=http out=torch`` process under traffic: exit code 0, the
   device trace captured, ``engine.tick`` rows in the Chrome trace.

9. serve-a3: the engine's other callers of flash prefill (kernel 2).
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

10. serve-a45: speculative decoding and weight-only int8.  (a) The
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

11. serve-kvbm: the KV block manager's lower tiers.  (a) The reference
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

12. serve-dyn: the distributed runtime.  (a) The reference phase's f32
   model as one worker on the card behind a loopback ``HubServer`` and the
   front end of ``run in=http out=dyn --router-mode kv`` (``ModelWatcher``
   over ``HttpService``, the KV router's pipeline): the greedy
   ``/v1/completions`` texts equal the reference phase's direct streams
   decoded, and ``/v1/embeddings`` through the distributed leg (the
   worker's ``{ep}_embed`` endpoint) is within ``EMBED_TOL`` of the
   engine's in-process ``embed``.  (b) Two Llama-3-8B workers (full width
   and depth, bf16, random weights of seed 0, ``EngineConfig(num_pages=
   1024)``), each on its own ``DistributedRuntime`` in this process, set
   up by the CLI's ``serve_worker``: 4 distinct 1024-token prefixes, 4
   requests each with suffixes of 16 to 256 tokens, 32 new tokens, greedy;
   round 1 sends one request per prefix, round 2 the other 12 once the
   router's index holds round 1's 4 x 64 prefix blocks.  Under ``kv``
   every round-2 request must go to the worker that served its prefix,
   with at least 64 overlap blocks (the router's hit-rate events), that
   worker's engine must count at least 1024 cached prompt tokens for each,
   every request must end ``length`` with exact usage, and the launch
   counts must equal the sum of both engines' dispatches.  The same
   traffic on fresh workers under ``round_robin``; requests per worker,
   round-2 prefix-hit blocks, client TTFT p50/p99, ``tok_s`` and peak GiB
   printed for both.  (c) ``python -m dynamo_tpu_torch hub``, ``run in=dyn
   out=torch`` over a 2-layer Llama-3-8B-width checkpoint and ``run
   in=http out=dyn --router-mode kv`` as three processes: their texts
   equal an in-process engine's from the same arrays, ``llmctl list``
   names the model with one instance, SIGINT ends each with exit code 0.

13. serve-disagg: disaggregated prefill/decode (``llm/disagg.py``).  (a)
   A 3-layer f32 model, a decode worker and a prefill worker on the card
   behind a loopback hub, ``max_local_prefill_length`` 32: three short
   prompts prefill locally, three long ones ship; the greedy streams equal
   the CPU's aggregated engine (``mixed_batching=False``) exactly over the
   same-process device handoff, the chunked wire (2 layers a chunk, which
   does not divide 3, then 1), the monolithic wire, and an int8 decode
   pool fed by the dense prefiller (wire and device), and every remote
   lane's pages in the decode pool equal its export (or its quantization)
   bit for bit, and each run's launches equal both engines' dispatches.
   (b) Two engines at Llama-3-8B's full width (bf16, random weights of
   seed 0 each, ``EngineConfig(num_pages=1024, max_batch_size=16)``: 16
   lanes, so the long requests are admitted while the short ones decode;
   32 layers over the device handoff, ``WIRE_LAYERS`` = 8 over the two
   host-bound wires, whose bytes and seconds move with the layer count),
   a decode and a prefill worker in this process
   set up as the CLI sets them up: 8 short requests (16 to 256 prompt
   tokens, 128 new) start, and once all stream, 8 long ones (1024 to 2000
   tokens, 64 new) arrive and ship; greedy, top-2 logprobs.  Run over the
   device handoff, the chunked wire and the monolithic wire, each on fresh
   engines, and once at each depth on one aggregated engine
   (``mixed_batching=False``, the export's dispatch site) as the twin.  Every request must end with
   its tokens, 8 prompts go remote and 8 stay local, each remote lane's
   first token is the prefill worker's sample, its pages in the decode
   pool equal its export (blake2b of both), and the launches equal both
   engines' dispatches (kernel 2 once per layer per export dispatch).
   Printed: the longs' TTFT p50/p99, the shorts' largest inter-token gap
   while the longs arrive (the twin's beside them), bytes per delivery and
   GB/s by path, ``transfer_stats()`` (export-before-first-byte), the
   export dispatch spans, peak GiB, the greedy agreement with the twin
   (at each first divergence the top-2 logprob gap), and a sampling
   profile of the process's threads over the traffic (``ThreadSampler``:
   the event loop's busy share and the places that took the most
   time).  (c) ``hub``, ``run
   in=dyn out=torch --disagg decode --max-local-prefill-length 32``,
   ``--disagg prefill`` and ``run in=http out=dyn`` as four processes over
   serve-dyn (c)'s checkpoint: their texts equal the in-process engine's,
   the prefill worker's log names the 40- and 300-token prompts (each
   delivery's bytes and milliseconds between processes printed),
   ``disagg-conf --max-local-prefill-length 100000`` turns the next long
   prompt local, SIGINT ends each with exit code 0.

14. serve-onboard: cross-worker prefix onboarding and the G4 remote tier
   (``llm/prefix_onboard.py``, ``offload.RemoteTier``).  (a) The reference
   phase's f32 model, a donor and an importer on the card (each
   ``host_offload_blocks=8``) behind a loopback hub: the importer onboards
   a 2-block prefix from the donor's ``kv_export``, then a fresh importer
   from an ``InMemoryBlobStore``; their greedy streams equal a plain CPU
   engine's, 2 blocks onboarded, no fetch failed.  (b) Llama-3-8B at full
   width and ``WIRE_LAYERS`` = 8 of its 32 layers (the legs move KV over
   the host, so their seconds go with the layers), bf16, random weights
   of seed 0, two workers at a time
   in this process set up by the CLI's ``serve_worker`` behind the
   KV-routed front end.  Peer leg: worker A (``EngineConfig(num_pages=
   1024, host_offload_blocks=512)``) serves 4 1024-token prefixes (64 new
   tokens); cold worker B (the same config) is sent 4 requests on them (a
   suffix of 16 to 256 tokens, 64 new, greedy, top-2 logprobs) straight to
   its endpoint with A as their donor (64 blocks), then a routed round
   whose router decisions are printed.  G4 leg: worker A' (``num_pages=
   160``, the ring, ``kv_remote="on"``) serves 4 other prefixes and two
   1900-token churn prompts, so every prefix block is evicted to its host
   ring and mirrored into the hub's blob store; cold worker B' (1024
   pages, the ring, G4) joins, A' leaves, and B' gets requests on those
   prefixes through the front end's router, which must stamp the G4 store
   as donor (4 ``kv_remote`` decisions).  Each leg: the importer onboards
   all 256 blocks, its pages equal the donor's (blake2b per block: A's
   pages, A''s mirrored host blobs), its engine counts 1024 cached prompt
   tokens per request, no fetch, G4 fetch or offload copy failed, the
   launches over both engines are exact (kernels 5 and 1 launched), and
   every request ends with its 64 tokens.  Printed: the greedy agreement
   with a recompute twin (a cold worker, no donor hint, the same path) and
   the top-2 gap at each first divergence (reported, not held: the twin
   computes the prefix's KV in other batches, and bf16 rows move with the
   dispatch around them); blocks and bytes onboarded, each request's
   fetch GB/s, the G4 puts' and fetches' GB/s (``dynamo_kv_g4_*``), TTFT
   from arrival p50/p99 beside the twin's, wall, peak GiB and the
   threads' profile.  The front end carries the fleet observatory
   (``fleet/observatory.py``) the CLI's front end carries, fed by A''s and
   B''s telemetry snapshots over the hub: both G4 links have as many
   samples as the tier's puts and fetches, the routed round's gate priced
   each fetch by the 1 GB/s prior (no G4 -> B' sample yet), and a gate
   round then routes a fifth mirrored prefix to B', whose gate prices the
   fetch by the fitted link (``predict_transfer_ms``, exactly); the fitted
   GB/s beside the measured, and both rounds' decisions, are printed, and
   which way the gate round decides is measured, not held.  (c)
   ``hub``, two ``run in=dyn out=torch --host-offload-blocks 256
   --kv-remote on`` workers and ``run in=http out=dyn --router-mode kv`` as
   four processes over serve-dyn (c)'s checkpoint: both ``kv_export``
   endpoints discovered, texts equal the in-process engine's, SIGINT ends
   each with exit code 0.

15. serve-mocker: the model-free engine in a fleet (see
   ``serve_mocker_phase``), and the front end's fleet observatory: ``GET
   /fleet`` lists the four workers, its stragglers are the straggler rule's
   over the step means of the same snapshots, the ``worker.slow`` mocker
   among them and quarantined, a batch on its prefix placed elsewhere;
   ``GET /fleet/metrics`` holds the fleet families; ``fleet --once --json``
   and ``metrics`` run as processes and name the same workers.

16. serve-planner: the planner (``planner/``).  (a) and (b) run inside
   serve-kvbm after serve-chaos, on its weights (Llama-3-8B at full width
   and depth, bf16, seed 0).  (a) ``SlaProfiler`` over
   ``TorchEngine(EngineConfig(num_pages=1024))``: TTFT of cold prompts of
   128, 512 and 2048 tokens, ITL and tok/s of 1, 4 and 8 streams of 64
   tokens; every number finite and positive, ``recommend`` equal to its
   rule worked out from the table, the launch invariants held; the table
   printed.  (b) A ``LocalConnector`` decode pool of ``TorchEngine``
   workers on the shared weights (256 pages each), each publishing
   telemetry into a ``FleetObservatory``, scaled by a ``Planner`` over
   ``fleet_metrics_source`` (see ``serve_planner_phase``): up from 1 to
   2 when worker 1's KV load passes 0.8 under 8 streams, the selector
   placing 8 more on worker 2, down to 1 once both are idle, the
   observatory's victim drained before it stops and its pool's memory
   returned.  (c) ``profile-sla --out torch`` over serve-dyn (c)'s
   checkpoint and ``--out mocker``, as subprocesses: exit code 0 and
   the recommendation the rule gives for the printed table.

17. serve-moe: the Mixtral family (``_moe_mlp``'s capacity dispatch, the
   memory plan, Mixtral checkpoints, the SentencePiece-style tokenizer),
   last.  (a) A small f32 MoE model (E = 4, K = 2, so nothing can drop;
   D 64, group 2) served on the card and on the CPU from the same weights,
   the reference phase's batches with top-2 logprobs, under the default,
   classic and rectangle configs: identical greedy streams, logprobs
   within ``MOE_LOGPROB_TOL``; one dispatch card against CPU.  (b)
   Mixtral-8x7B's widths at 16 of its 32 layers, bf16, random weights of
   seed 0 (the earlier phases' weights freed first): the bytes the card
   allocated for them equal the memory plan's ``param_bytes``;
   ``_moe_mlp`` against ``_moe_mlp_dense`` at N = 8 and 512 where nothing
   drops, within ``MOE_BF16_RTOL``; serve's primer and batch
   (``EngineConfig(num_pages=1024)``, 8 lanes, page 16, pipelined), cold
   and warm, at the preset's cf = 2, with the warm batch's dropped share
   of assignments counted by the dispatch (``model.moe_counts``); then at cf = E
   / K, where nothing can drop, the pipelined and the serial loop give the
   same streams.  (c) The whole model, 32 layers, int8 weights made and
   quantized one layer at a time (``TorchEngine.random_init`` under
   ``quantize="int8"``): serve's batch with 32 new tokens, cold and warm;
   its weights hold the plan's bytes, its peak stays under the card's
   memory and the plan's params + KV + scratch + dequantization.  (d) A
   Mixtral-layout checkpoint written here (small width, E = 8, K = 2, 2
   layers, a SentencePiece-style ``tokenizer.json`` with byte fallback)
   served by ``python -m dynamo_tpu_torch run in=http out=torch`` in a
   subprocess gives an in-process engine's texts on the same directory.
   Every run holds its launch invariants and prints wall, ``tok_s``,
   decode-phase tok/s, TTFT and peak GiB.

18. serve-gguf: GGUF checkpoints (``llm/gguf.py``), the Unigram tokenizer
   and eval (``llm/evaluate.py``), last.  Every file is written here from
   seeded weights, quantized on the card tensor by tensor into a temporary
   directory (GGUF v3, ``tests/test_gguf.py``'s Q8_0/Q4_0 layouts and q/k
   permutation), and removed.  (a) A SentencePiece (``llama``) and a
   ``gpt2`` GGUF of small f32 models (D 64, group 2; between them F32,
   F16, BF16, Q8_0 and Q4_0 tensors, the second with tied embeddings): the
   dequantized params on the card equal the CPU's bit for bit, greedy
   streams of the default config are identical card to CPU, and
   ``evaluate_perplexity`` agrees within ``GGUF_EVAL_RTOL``.  (b)
   Mistral-7B-Instruct-v0.2's published widths at full depth from a Q4_0
   file (Q4_0 trunk and ``token_embd``, Q8_0 ``output``, F32 norms; some 4.1
   GB) with a 32000-piece SentencePiece tokenizer drawn from README.md and
   a ``[INST]`` template: every leaf of ``TorchEngine.from_pretrained``
   equals ``dequant(quant(w))`` of the seeded weights bit for bit; serve's
   primer and batch, cold then warm, end every request with its 64 tokens
   under exact launch invariants; ``evaluate_perplexity`` over README.md
   at windows 512 and 2048 launches kernel 2 once per layer per window and
   nothing else, and its first window's NLL equals the sum of an echo
   request's ``-prompt_logprobs`` within ``GGUF_ECHO_RTOL``.  Printed: file
   write seconds, load seconds and GB/s, peak GiB, cold and warm ``tok_s``
   beside serve's, eval tokens/s per window.  (c) Llama-3-8B's widths at 4
   layers from a Q8_0 file (F16 ``token_embd``) with a 128256-token
   ``gpt2`` tokenizer converted from ``write_tokenizer``'s: ``python -m
   dynamo_tpu_torch run in=http out=torch --model-path FILE.gguf`` answers
   chats through the file's template (``length``, exact usage; SIGINT ends
   it with exit code 0), and ``eval --model-path DIR --text-file README.md
   --window 512``, bare and with ``--quantize int8``, print their JSON
   lines, the bare one within ``GGUF_CLI_RTOL`` of in-process
   ``evaluate_perplexity``.

19. serve-tp: tensor and expert parallelism (``parallel/``).  Two
   grids of two ranks, each a follower process beside this one, serve
   one engine after another: on one card both ranks share it over gloo
   (the one gloo mesh over CUDA tensors of the package's, built here and
   printed; collectives eager, no graphs; NCCL ranks, one card each, run
   on four cards in ``chip_multi.py``).  (a) The reference phase's
   small f32 model at tp = 2 under the default, classic and rectangle
   configs, the int8 pool and int8 weights, and a small MoE at ep = 2 (cf
   = E / K, nothing dropped; cf = 0.5, the drops of one card on every
   rank): greedy streams equal one card's and (dense) the CPU's; every
   rank's pool the one-card pool's head slice (``tp_pools_match``); per
   rank the launch invariants of the leader's dispatches, the same
   collectives, and no graph.  (b) Llama-3-8B at full width and depth,
   bf16, tp = 2, serve's weights and traffic with top-2 logprobs, cold
   then warm: every request ends with its 64 tokens; per rank the launch
   invariants, 2 all-reduces a layer and 2 all-gathers a trunk pass;
   where streams part from serve run 0's, a greedy lane only at a bf16
   near tie.  (c) Mixtral-8x7B's widths at 16 layers, bf16, ep = 2, cf =
   4: nothing dropped on either rank, each rank half of one card's expert
   bytes.  (d), with serve-mocker's checkpoint: ``run in=http --dp 2`` is
   refused by name, and with one card ``--tp 2``, ``--sp 2`` and ``--pp
   2`` by JAX's "mesh needs 2 devices, have 1".  Printed: backend, grid
   seconds, per rank launches, collectives, graphs, drops, expert bytes
   and peak GiB, cold and warm ``tok_s``, TTFT, the phase's seconds.

20. serve-sp-pp: the ring prefill over sp (``parallel/ring_attention.py``)
   and the pipeline prefill over pp (``parallel/pipeline_parallel.py``),
   last.  A grid of two ranks a prefill axis, both on this card over
   gloo, serve one engine after another; the leader holds the model, the
   pool and the lanes and decodes alone (its graphs captured), mixed
   batching pinned off.  (a) The reference phase's small f32 model at sp
   = 2 and at pp = 2: the CPU's greedy streams (penalized lanes
   included), the whole prompt blocks in the pool one card's within
   ``SPPP_F32_BOUNDS``, full prefills routed.  (b) Llama-3-8B at full width and
   depth, bf16, serve's weights on every rank, at sp = 2 and at pp = 2: a
   pool-check batch (four fresh prompts of 1100 to 1900 tokens, one token
   each: one prefill of four lanes, two microbatches of two) whose whole
   prompt blocks in the pool must equal one card's prefill of them within
   the bf16 bounds
   ``SPPP_BF16_BOUNDS``, then
   serve's primer and batch with top-2 logprobs, cold and warm: every
   request ends with its 64 tokens, a greedy lane parts from serve run 0's
   only at a bf16 near tie.  In (a) and (b) the leader's launches equal
   its dispatches' (kernel 2 once per stage layer per microbatch of each
   pipeline prefill; kernel 1 on the decode lanes), a ring follower
   launches nothing and a pipeline follower kernel 2 alone, neither
   captures a graph.  Printed: routed prefills and microbatches, bytes
   each rank sent the leader, peak GiB a rank, TTFT, cold and warm
   ``tok_s``, the phase's seconds.

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
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import struct
import subprocess
import sys
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

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
    # the processes a CLI phase started and has not ended: their logs'
    # ends say why a request to them failed
    for p in list(Proc.running):
        print(f"chip_smoke: {p.name} (exit code {p.proc.poll()}), its log's end: "
              f"{p.log()[-4000:]}", file=sys.stderr, flush=True)
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
    the tensor-core kernel ``tc_name`` in ``kernel``'s library (every head
    dim of ``GEOM_HEAD_DIMS`` among them) holds ``HMMA`` or ``HGMMA``
    instructions, and the
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
        dims = {d for d in GEOM_HEAD_DIMS for name in tc if f"ILi{d}E" in name}
        if len(tc) != count or dims != set(GEOM_HEAD_DIMS) or not all(tc.values()):
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
    what: str, out: torch.Tensor, ref: torch.Tensor, p_rounding: float = 0.0,
    quiet: bool = False,
) -> float:
    """Fail unless the kernel's ``out`` matches the plain version's ``ref``
    within the dtype's tolerance (in bf16 plus ``p_rounding``, the bound of
    a kernel that rounds P); returns the largest absolute error, printed
    unless ``quiet``."""
    torch.cuda.synchronize()
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        ok = err <= F32_TOL
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * ref.abs() + p_rounding).all())
    if not quiet:
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


def sdpa_lanes(pool, table, bases, lanes, S, window: int = 0):
    """The ragged kernels' yardstick operands: ``(q, k, v, mask)`` for one
    SDPA call over the lanes padded to ``[B, Hq, S, K]``, each lane's
    resident prefix (layer 0, through its table row) followed by its fresh
    rows, with the same causal-over-prefix mask (and window).  ``lanes``
    holds each lane's fresh ``(q [n, Hq, D], k [n, Hkv, D], v)`` rows; the
    head geometry and page size come from them and the pool."""
    B = len(lanes)
    K = max(bs + lq.shape[0] for bs, (lq, _, _) in zip(bases, lanes))
    dtype = lanes[0][0].dtype
    hq, hkv, d = lanes[0][0].shape[1], lanes[0][1].shape[1], lanes[0][0].shape[2]
    page = pool.shape[3]
    qp = torch.zeros((B, hq, S, d), dtype=dtype, device="cuda")
    kp = torch.zeros((B, hq, K, d), dtype=dtype, device="cuda")
    vp = torch.zeros_like(kp)
    mask = torch.zeros((B, 1, S, K), dtype=torch.bool, device="cuda")
    r = torch.arange(S, device="cuda")[:, None]
    c = torch.arange(K, device="cuda")[None, :]
    for b, (bs, (lq, lk, lv)) in enumerate(zip(bases, lanes)):
        n = lq.shape[0]
        pages = table[b, : -(-bs // page)].long()
        keys = torch.cat([pool[0, 0][pages].reshape(-1, hkv, d)[:bs], lk])
        vals = torch.cat([pool[0, 1][pages].reshape(-1, hkv, d)[:bs], lv])
        qp[b, :, :n] = lq.transpose(0, 1)
        kp[b, :, : bs + n] = keys.repeat_interleave(hq // hkv, 1).transpose(0, 1)
        vp[b, :, : bs + n] = vals.repeat_interleave(hq // hkv, 1).transpose(0, 1)
        mask[b, 0] = (c <= bs + r) & (r < n)
        if window > 0:
            mask[b, 0] &= bs + r - c < window
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


def disagg_lengths() -> Tuple[List[int], List[int]]:
    """serve-disagg (b)'s prompt lengths: the 8 short and the 8 long ones."""
    shorts, longs = disagg_requests(128256)
    return [len(r["token_ids"]) for r in shorts], [len(r["token_ids"]) for r in longs]


def check_export_flash(fp, bucketing, gen) -> Dict[str, object]:
    # serve-disagg's export dispatch: the 8 long prompts (1024 to 2000
    # tokens) in one full-prompt group, B = 8 at their bucket
    _, longs = disagg_lengths()
    B, n_max = len(longs), max(longs)
    T = bucketing.pick_bucket(bucketing.prefill_buckets(PAGE, 2048), n_max)
    lens = torch.tensor(longs, dtype=torch.int32, device="cuda")

    def rand(h, dtype=torch.bfloat16, g=gen):
        return torch.randn((B, T, h, D), generator=g, device="cuda").to(dtype)

    def check(q, k, v) -> float:
        err = 0.0
        for window in (0, 512):
            out = fp.flash_prefill_attention(q, k, v, lens, window)
            ref = fp.flash_prefill_attention_plain(q, k, v, lens, window)
            what = f"flash_prefill_attention export B={B} T={T} window={window}"
            err = max(err, agree(what, out, ref, p_rounding(v)))
        return err

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    err = check(q, k, v)
    ms = cuda_ms(lambda i: fp.flash_prefill_attention(q, k, v, lens), 16)
    plain_ms = cuda_ms(lambda i: fp.flash_prefill_attention_plain(q, k, v, lens), 4)
    # yardstick: one SDPA call over the batch padded to [B, Hq, n_max, D]
    rep = HQ // HKV
    qs = q[:, :n_max].transpose(1, 2).contiguous()
    ks = k[:, :n_max].repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    vs = v[:, :n_max].repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    r = torch.arange(n_max, device="cuda")[:, None]
    c = torch.arange(n_max, device="cuda")[None, :]
    mask = (c <= r)[None] & (r[None] < lens[:, None, None].long())
    mask = mask[:, None]
    mask[:, :, :, 0] |= ~mask.any(-1)  # no fully masked row (pad rows)
    library_ms = cuda_ms(lambda i: sdpa_padded(qs, ks, vs, mask), 16)
    del qs, ks, vs
    rows = sum(longs)
    bytes_moved = (
        rows * HQ * D * 2 + 2 * rows * HKV * D * 2  # the valid q, k, v rows read
        + B * T * HQ * D * 2  # the whole output written
        + B * 4
    )
    flops = 4.0 * HQ * D * sum(n * (n + 1) / 2 for n in longs)
    bound_ms, bound_by = bound(bytes_moved, flops)
    del q, k, v
    g32 = f32_generator()
    check(*[rand(h, torch.float32, g32) for h in (HQ, HKV, HKV)])
    return dict(
        name="flash_prefill_attention/export", route="cuda",
        source="dynamo_tpu_torch/csrc/flash_prefill.cu",
        replaces="dynamo_tpu/ops/flash_prefill.py:125",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
    )


def check_eval_flash(fp, gen, T: int) -> Dict[str, object]:
    """Kernel 2 at eval's shape (``llm/evaluate.py`` over serve-gguf (b)'s
    Mistral-7B widths): one window of ``T`` tokens, every row valid, no
    sliding window."""
    lens = torch.tensor([T], dtype=torch.int32, device="cuda")

    def rand(h, dtype=torch.bfloat16, g=gen):
        return torch.randn((1, T, h, D), generator=g, device="cuda").to(dtype)

    def check(q, k, v) -> float:
        out = fp.flash_prefill_attention(q, k, v, lens)
        ref = fp.flash_prefill_attention_plain(q, k, v, lens)
        return agree(f"flash_prefill_attention eval T={T}", out, ref, p_rounding(v))

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    err = check(q, k, v)
    ms = cuda_ms(lambda i: fp.flash_prefill_attention(q, k, v, lens), 32)
    plain_ms = cuda_ms(lambda i: fp.flash_prefill_attention_plain(q, k, v, lens), 4)
    r = torch.arange(T, device="cuda")[:, None]
    mask = (torch.arange(T, device="cuda")[None, :] <= r)[None, None]
    library_ms = cuda_ms(sdpa_rows(q.transpose(1, 2).contiguous(), k[0], v[0], mask), 32)
    bytes_moved = (
        T * HQ * D * 2 + 2 * T * HKV * D * 2  # q, k, v read
        + T * HQ * D * 2  # the output written
        + 4
    )
    flops = 4.0 * HQ * D * T * (T + 1) / 2  # causal (query, key) pairs
    bound_ms, bound_by = bound(bytes_moved, flops)
    g32 = f32_generator()
    check(*[rand(h, torch.float32, g32) for h in (HQ, HKV, HKV)])
    return dict(
        name=f"flash_prefill_attention/eval-{T}", route="cuda",
        source="dynamo_tpu_torch/csrc/flash_prefill.cu",
        replaces="dynamo_tpu/ops/flash_prefill.py:125",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
    )


def disagg_decode_lanes() -> Tuple[List[int], List[int]]:
    """The decode worker's 16 lanes while the delivered long lanes decode:
    each lane's committed cache length (a short one 64 tokens into its
    128, a long one 32 into its 64) and its KV length with the new row."""
    shorts, longs = disagg_lengths()
    bases = [n + 64 for n in shorts] + [n + 32 for n in longs]
    return bases, [b + 1 for b in bases]


def check_disagg_decode(pa, rng, gen) -> Dict[str, object]:
    # kernel 1 at the decode worker's 16 lanes over the 128-page table (the
    # page bucket of its longest lane)
    _, kv_lens = disagg_decode_lanes()
    B, width = len(kv_lens), 2048 // PAGE
    n_pages = B * width + 1
    table = lane_tables([-(-n // PAGE) for n in kv_lens], width, n_pages, rng)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    pool = make_pool(n_pages, gen)
    q = torch.randn((B, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    err = 0.0
    for window in (0, 512):
        out = pa.paged_decode_attention(q, pool, table, lens, 3, window)
        ref = pa.paged_decode_attention_plain(q, pool, table, lens, 3, window)
        what = f"paged_decode_attention disagg B={B} window={window}"
        err = max(err, agree(what, out, ref, p_rounding(pool[3, 1])))
    ms = cuda_ms(lambda i: pa.paged_decode_attention(q, pool, table, lens, i % LAYERS), 64)
    dev_ms = device_ms(lambda i: pa.paged_decode_attention(q, pool, table, lens, i % LAYERS))
    plain_ms = cuda_ms(
        lambda i: pa.paged_decode_attention_plain(q, pool, table, lens, i % LAYERS), 8
    )
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
    pool = make_pool(n_pages, g32, torch.float32, 4)
    q = torch.randn((B, HQ, D), generator=g32, device="cuda")
    agree(f"paged_decode_attention disagg B={B} window=0",
          pa.paged_decode_attention(q, pool, table, lens, 3),
          pa.paged_decode_attention_plain(q, pool, table, lens, 3))
    del pool
    return dict(
        name="paged_decode_attention/disagg", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="dynamo_tpu/ops/paged_attention.py:124",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms, device_ms=dev_ms,
    )


def short_prefill_tick(shorts: List[int], lanes: int, budget: int = 512) -> Tuple[
        List[int], List[int]]:
    """The decode worker's second packed tick over its short prompts, by
    the mixed budget: the first tick packed whole prompts up to ``budget``
    tokens and a chunk of the next one; in the second, those whole ones
    decode a row each, the chunked one goes on, the rest follow (whole,
    then a chunk) in what is left.  Lanes past the shorts are idle.
    Returns each lane's base and fresh rows."""
    left, done = budget, []
    for n in shorts:  # tick 1
        take = min(n, left)
        done.append(take)
        left -= take
    bases, q_lens = [], []
    left = budget - sum(1 for n, t in zip(shorts, done) if t == n)
    for n, t in zip(shorts, done):  # tick 2
        if t == n:
            bases.append(n)
            q_lens.append(1)
            continue
        take = min(n - t, max(left, 0))
        bases.append(t)
        q_lens.append(take)
        left -= take
    pad = lanes - len(shorts)
    return bases + [0] * pad, q_lens + [0] * pad


def check_disagg_packed(ra, bucketing, rng, gen) -> Dict[str, object]:
    # kernel 5 at the decode worker's 16 lanes: its decode rows (the row),
    # then a tick of its short prompts' local prefill (checked only)
    dec_bases, _ = disagg_decode_lanes()
    shorts, _ = disagg_lengths()
    B, width = len(dec_bases), 2048 // PAGE
    n_pages = B * width + 1
    i32 = dict(dtype=torch.int32, device="cuda")
    err = 0.0
    for case, (bases, q_lens) in (
        ("decode rows", (dec_bases, [1] * B)),
        ("short prefill", short_prefill_tick(shorts, B)),
    ):
        live = [b for b, n in enumerate(q_lens) if n > 0]
        s_max = bucketing.pow2_bucket(max(q_lens))
        seg_off = np.cumsum([0] + q_lens[:-1])
        Np = bucketing.packed_axis_len(s_max, int(seg_off[live[-1]]), sum(q_lens))
        need = [-(-(b + n) // PAGE) for b, n in zip(bases, q_lens)]
        table = lane_tables(need, width, n_pages, rng)
        args = [torch.tensor(x, **i32) for x in (bases, seg_off.tolist(), q_lens)]

        def check(pool, q, k, v) -> float:
            e = 0.0
            for window in (0, 512):
                lane = (q, k, v, pool, table, *args)
                out = ra.packed_ragged_attention(*lane, s_max, 3, window)
                ref = ra.packed_ragged_attention_plain(*lane, 3, window)
                what = f"packed_ragged_attention disagg {case} B={B} window={window} Np={Np}"
                e = max(e, agree(what, out, ref, ragged_p_rounding(pool, None, v)))
            return e

        pool = make_pool(n_pages, gen)
        q, k, v = (torch.randn((Np, h, D), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (HQ, HKV, HKV))
        err = max(err, check(pool, q, k, v))
        if case == "decode rows":
            lane = (q, k, v, pool, table, *args)
            ms = cuda_ms(lambda i: ra.packed_ragged_attention(*lane, s_max, i % LAYERS), 64)
            plain_ms = cuda_ms(lambda i: ra.packed_ragged_attention_plain(*lane, i % LAYERS), 4)
            segs = [slice(o, o + n) for o, n in zip(seg_off.tolist(), q_lens)]
            padded = sdpa_lanes(pool, table, bases, [(q[s], k[s], v[s]) for s in segs], s_max)
            library_ms = cuda_ms(lambda i: sdpa_padded(*padded), 64)
            del padded
            keys_seen = sum(bs * n + n * (n + 1) // 2 for bs, n in zip(bases, q_lens))
            bytes_moved = (
                B * HQ * D * 2 + 2 * B * HKV * D * 2  # q, fresh K and V rows read
                + Np * HQ * D * 2  # the whole output written
                + table.numel() * 4 + 3 * B * 4
                + sum(bases) * 2 * HKV * D * 2  # each resident K and V row once
            )
            flops = 4.0 * keys_seen * HQ * D
            bound_ms, bound_by = bound(bytes_moved, flops)
        del pool
        g32 = f32_generator()
        pool = make_pool(n_pages, g32, torch.float32, 4)
        check(pool, *(torch.randn((Np, h, D), generator=g32, device="cuda")
                      for h in (HQ, HKV, HKV)))
        del pool
    return dict(
        name="packed_ragged_attention/disagg", route="cuda",
        source="dynamo_tpu_torch/csrc/packed_ragged_attention.cu",
        replaces="dynamo_tpu/ops/ragged_attention.py:527",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
    )


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
# phase 2b: every head geometry the kernels take
# ---------------------------------------------------------------------------

GEOM_GROUPS = tuple(range(1, 9))
GEOM_HEAD_DIMS = (64, 96, 128, 256)
GEOM_HKV, GEOM_PAGE = 2, 16
# the small shapes of each geometry's checks: decode lanes (a full table, a
# partial one, one position, an idle lane), ragged lanes (two decode rows,
# a chunk from position 0, a chunk over a 64-token prefix), a bucket of
# full prefill lanes, suffixes over a gathered prefix
GEOM_DECODE = dict(kv_lens=[256, 77, 1, 0], width=16, window=50)
GEOM_RAGGED = dict(bases=[150, 37, 0, 64], q_lens=[1, 1, 70, 23], width=16, window=40)
GEOM_FLASH = dict(T=96, lens=[96, 33], window=30)
GEOM_PREFIX = dict(T=48, Kp=64, offsets=[64, 17], lens=[48, 5], window=30)


def geometry_case(pa, fp, ra, bucketing, d: int, group: int, dtype, rng, gen) -> Dict[str, float]:
    """One geometry (Hkv = 2 KV heads of ``group`` query heads each, head
    dim ``d``) in one dtype: each of the seven entries against its plain
    version, with and without a window; returns the largest error of each."""
    hkv, hq, page = GEOM_HKV, GEOM_HKV * group, GEOM_PAGE
    i32 = dict(dtype=torch.int32, device="cuda")

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def pr(*vs) -> float:  # the bf16 kernels' P-rounding bound over the V rows read
        return p_rounding(torch.cat([v.flatten() for v in vs]))

    errs: Dict[str, float] = {}

    def note(name: str, out, ref, bound: float) -> None:
        what = f"{name} D={d} Hq={hq} Hkv={hkv}"
        errs[name] = max(errs.get(name, 0.0), agree(what, out, ref, bound, quiet=True))

    layer = 1
    dc = GEOM_DECODE
    n_pages = len(dc["kv_lens"]) * dc["width"] + 1
    pool = rand(2, 2, n_pages, page, hkv, d)
    table = lane_tables([-(-n // page) for n in dc["kv_lens"]], dc["width"], n_pages, rng)
    lens = torch.tensor(dc["kv_lens"], **i32)
    q = rand(len(dc["kv_lens"]), hq, d)
    for window in (0, dc["window"]):
        note("paged_decode_attention",
             pa.paged_decode_attention(q, pool, table, lens, layer, window),
             pa.paged_decode_attention_plain(q, pool, table, lens, layer, window),
             pr(pool[layer, 1]))

    rc = GEOM_RAGGED
    bases, q_lens = rc["bases"], rc["q_lens"]
    B = len(bases)
    n_pages = B * rc["width"] + 1
    pool = rand(2, 2, n_pages, page, hkv, d)
    table = lane_tables([-(-(b + n) // page) for b, n in zip(bases, q_lens)], rc["width"],
                        n_pages, rng)
    base_t, ql_t = torch.tensor(bases, **i32), torch.tensor(q_lens, **i32)
    s_max = bucketing.pow2_bucket(max(q_lens))
    seg_off = np.cumsum([0] + q_lens[:-1])
    Np = bucketing.packed_axis_len(s_max, int(seg_off[-1]), sum(q_lens))
    off_t = torch.tensor(seg_off.tolist(), **i32)
    pq, ps = int8_pool(pool)
    deq = dequantized(pq[layer, 1], ps[layer, 1], dtype)
    packed = (rand(Np, hq, d), rand(Np, hkv, d), rand(Np, hkv, d))
    rect = (rand(B, s_max, hq, d), rand(B, s_max, hkv, d), rand(B, s_max, hkv, d))
    for window in (0, rc["window"]):
        for name, kv, scales, v_pool in (("", pool, None, pool[layer, 1]),
                                         ("_int8", pq, ps, deq)):
            args = (*packed, kv, table, base_t, off_t, ql_t)
            note(f"packed_ragged_attention{name}",
                 ra.packed_ragged_attention(*args, s_max, layer, window, scales),
                 ra.packed_ragged_attention_plain(*args, layer, window, scales),
                 pr(v_pool, packed[2]))
            args = (*rect, kv, table, base_t, ql_t, layer, window, scales)
            note(f"ragged_paged_attention{name}", ra.ragged_paged_attention(*args),
                 ra.ragged_paged_attention_plain(*args), pr(v_pool, rect[2]))

    fc = GEOM_FLASH
    T = fc["T"]
    fq, fk, fv = rand(len(fc["lens"]), T, hq, d), rand(len(fc["lens"]), T, hkv, d), \
        rand(len(fc["lens"]), T, hkv, d)
    lens = torch.tensor(fc["lens"], **i32)
    for window in (0, fc["window"]):
        note("flash_prefill_attention", fp.flash_prefill_attention(fq, fk, fv, lens, window),
             fp.flash_prefill_attention_plain(fq, fk, fv, lens, window), pr(fv))
    xc = GEOM_PREFIX
    T, Kp, B = xc["T"], xc["Kp"], len(xc["lens"])
    xq, xk, xv = rand(B, T, hq, d), rand(B, Kp + T, hkv, d), rand(B, Kp + T, hkv, d)
    offset, lens = torch.tensor(xc["offsets"], **i32), torch.tensor(xc["lens"], **i32)
    for window in (0, xc["window"]):
        note("flash_prefix_prefill_attention",
             fp.flash_prefix_prefill_attention(xq, xk, xv, offset, lens, window),
             fp.flash_prefix_prefill_attention_plain(xq, xk, xv, offset, lens, window), pr(xv))
    return errs


def check_geometries(pa, fp, ra, bucketing) -> int:
    """Every entry x dtype x GQA group 1..8 x D in GEOM_HEAD_DIMS against
    its plain version at small shapes, the existing tolerances (F32_TOL;
    BF16_ATOL + BF16_RTOL |ref| + the P-rounding bound).  Prints one line
    per geometry (each entry's largest error in bf16 and f32); returns the
    number of comparisons."""
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    t0 = time.perf_counter()
    n = 0
    short = {"paged_decode_attention": "k1", "flash_prefill_attention": "k2",
             "flash_prefix_prefill_attention": "k3", "ragged_paged_attention": "k4",
             "ragged_paged_attention_int8": "k4q", "packed_ragged_attention": "k5",
             "packed_ragged_attention_int8": "k5q"}
    print(f"kernels: geometry rows give each entry's max_abs_err ({short})")
    for d in GEOM_HEAD_DIMS:
        for group in GEOM_GROUPS:
            parts = []
            for dtype in (torch.bfloat16, torch.float32):
                errs = geometry_case(pa, fp, ra, bucketing, d, group, dtype, rng, gen)
                n += 2 * len(errs)
                parts.append(str(dtype)[6:] + " " + " ".join(
                    f"{short[k]}={errs[k]:.2e}" for k in short))
            print(f"kernels: geometry D={d} group={group} Hq={GEOM_HKV * group} "
                  f"Hkv={GEOM_HKV}: {'; '.join(parts)}")
    torch.cuda.synchronize()
    print(f"kernels: geometries: {n} comparisons over {len(GEOM_HEAD_DIMS)} head dims x "
          f"{len(GEOM_GROUPS)} groups x 2 dtypes x 7 entries in "
          f"{time.perf_counter() - t0:.3f} s")
    return n


# the new geometries' timed rows: (model, Hq, Hkv, D, window) and the
# kernels timed at serve's shapes for each
GEOM_MODELS = {
    "llama3_70b": ((64, 8, 128, 0), ("paged_decode_attention", "packed_ragged_attention")),
    "gemma_7b": ((16, 16, 256, 0), ("paged_decode_attention", "flash_prefill_attention",
                                    "packed_ragged_attention")),
    "phi3_mini": ((32, 32, 96, 2047), ("paged_decode_attention", "flash_prefill_attention",
                                       "packed_ragged_attention")),
}
GEOM_LAYERS = 8  # pool layers the timing rotates over (K/V cold in L2)


def geometry_row(kind: str, model: str, geom, pa, fp, ra, bucketing, rng, gen) -> Dict[str, object]:
    """One kernel timed at serve's shapes at a model's head geometry:
    checked against its plain version (bf16), its CUDA-event time, its
    plain version's, one SDPA call's on the same (gathered) operands, and
    the bound from this run's inputs."""
    hq, hkv, d, window = geom
    i32 = dict(dtype=torch.int32, device="cuda")
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    what = f"{kind}/{model} Hq={hq} Hkv={hkv} D={d} window={window}"
    if kind == "paged_decode_attention":
        kv_lens = [2048, 1791, 1500, 1203, 1024, 640, 257, 33]
        B, width = len(kv_lens), 2048 // PAGE
        n_pages = B * width + 1
        pool = rand(GEOM_LAYERS, 2, n_pages, PAGE, hkv, d)
        table = lane_tables([-(-n // PAGE) for n in kv_lens], width, n_pages, rng)
        lens = torch.tensor(kv_lens, **i32)
        q = rand(B, hq, d)
        err = agree(what, pa.paged_decode_attention(q, pool, table, lens, 3, window),
                    pa.paged_decode_attention_plain(q, pool, table, lens, 3, window),
                    p_rounding(pool[3, 1]))
        call = lambda i: pa.paged_decode_attention(q, pool, table, lens, i % GEOM_LAYERS, window)  # noqa: E731
        ms, dev_ms = cuda_ms(call, 64), device_ms(call)
        plain_ms = cuda_ms(lambda i: pa.paged_decode_attention_plain(
            q, pool, table, lens, i % GEOM_LAYERS, window), 8)
        T = width * PAGE
        k = pool[0, 0][table.long()].reshape(B, T, hkv, d).repeat_interleave(hq // hkv, 2)
        v = pool[0, 1][table.long()].reshape(B, T, hkv, d).repeat_interleave(hq // hkv, 2)
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        idx = torch.arange(T, device="cuda")[None, :]
        mask = idx < lens[:, None].long()
        if window > 0:
            mask &= idx >= lens[:, None].long() - window
        mask = mask[:, None, None, :]
        library_ms = cuda_ms(lambda i: sdpa_padded(q[:, :, None, :], k, v, mask), 64)
        live = sum(min(n, window) if window > 0 else n for n in kv_lens)
        bytes_moved = 2 * B * hq * d * 2 + live * hkv * d * 2 * 2 + table.numel() * 4 + B * 4
        flops = 4.0 * live * hq * d
        extra = dict(device_ms=dev_ms)
        source, replaces = "paged_decode_attention.cu", "dynamo_tpu/ops/paged_attention.py:124"
        del pool, k, v
    elif kind == "flash_prefill_attention":
        B, T, n = 1, 2048, 1200
        lens = torch.tensor([n], **i32)
        q, k, v = rand(B, T, hq, d), rand(B, T, hkv, d), rand(B, T, hkv, d)
        err = agree(what, fp.flash_prefill_attention(q, k, v, lens, window),
                    fp.flash_prefill_attention_plain(q, k, v, lens, window), p_rounding(v))
        ms = cuda_ms(lambda i: fp.flash_prefill_attention(q, k, v, lens, window), 16)
        plain_ms = cuda_ms(lambda i: fp.flash_prefill_attention_plain(q, k, v, lens, window), 4)
        r = torch.arange(n, device="cuda")[:, None]
        c = torch.arange(n, device="cuda")[None, :]
        mask = (c <= r) & ((r - c < window) if window > 0 else True)
        rep = hq // hkv
        kh = k[0, :n].repeat_interleave(rep, 1).transpose(0, 1)[None].contiguous()
        vh = v[0, :n].repeat_interleave(rep, 1).transpose(0, 1)[None].contiguous()
        qh = q[:, :n].transpose(1, 2).contiguous()
        library_ms = cuda_ms(lambda i: sdpa_padded(qh, kh, vh, mask[None, None]), 16)
        pairs = sum(min(i + 1, window) if window > 0 else i + 1 for i in range(n))
        bytes_moved = n * hq * d * 2 + 2 * n * hkv * d * 2 + B * T * hq * d * 2 + B * 4
        flops = 4.0 * hq * d * pairs
        extra = {}
        source, replaces = "flash_prefill.cu", "dynamo_tpu/ops/flash_prefill.py:125"
    else:
        bases = [2047, 1790, 1499, 1202, 640, 256, 32, 1024]
        q_lens = [1, 1, 1, 1, 1, 1, 1, 505]
        B, width = len(bases), 2048 // PAGE
        n_pages = B * width + 1
        s_max = bucketing.pow2_bucket(max(q_lens))
        seg_off = np.cumsum([0] + q_lens[:-1])
        Np = bucketing.packed_axis_len(s_max, int(seg_off[-1]), sum(q_lens))
        pool = rand(GEOM_LAYERS, 2, n_pages, PAGE, hkv, d)
        table = lane_tables([-(-(b + n) // PAGE) for b, n in zip(bases, q_lens)], width,
                            n_pages, rng)
        base_t, ql_t = torch.tensor(bases, **i32), torch.tensor(q_lens, **i32)
        off_t = torch.tensor(seg_off.tolist(), **i32)
        q, k, v = rand(Np, hq, d), rand(Np, hkv, d), rand(Np, hkv, d)
        args = (q, k, v, pool, table, base_t, off_t, ql_t)
        err = agree(what, ra.packed_ragged_attention(*args, s_max, 3, window),
                    ra.packed_ragged_attention_plain(*args, 3, window),
                    p_rounding(torch.cat([pool[3, 1].flatten(), v.flatten()])))
        ms = cuda_ms(lambda i: ra.packed_ragged_attention(
            *args, s_max, i % GEOM_LAYERS, window), 32)
        plain_ms = cuda_ms(lambda i: ra.packed_ragged_attention_plain(
            *args, i % GEOM_LAYERS, window), 4)
        segs = [slice(o, o + n) for o, n in zip(seg_off.tolist(), q_lens)]
        padded = sdpa_lanes(pool, table, bases, [(q[sl], k[sl], v[sl]) for sl in segs], s_max,
                            window)
        library_ms = cuda_ms(lambda i: sdpa_padded(*padded), 32)
        del padded
        rows = sum(q_lens)
        # keys each row attends (window cut) and the prefix positions read
        pairs = sum(min(bs + r + 1, window) if window > 0 else bs + r + 1
                    for bs, n in zip(bases, q_lens) for r in range(n))
        prefix = sum(bs - max(0, bs - window + 1) if window > 0 else bs for bs in bases)
        bytes_moved = (rows * hq * d * 2 + 2 * rows * hkv * d * 2 + Np * hq * d * 2
                       + table.numel() * 4 + 3 * B * 4 + 2 * prefix * hkv * d * 2)
        flops = 4.0 * pairs * hq * d
        extra = {}
        source, replaces = ("packed_ragged_attention.cu",
                            "dynamo_tpu/ops/ragged_attention.py:527")
        del pool
    bound_ms, bound_by = bound(bytes_moved, flops)
    return dict(
        name=f"{kind}/{model}", route="cuda", source=f"dynamo_tpu_torch/csrc/{source}",
        replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, tflops=flops / ms / 1e9,
        bound_share=bound_ms / ms, **extra,
    )


def geometry_rows(pa, fp, ra, bucketing, models=None) -> List[Dict[str, object]]:
    rng = np.random.default_rng(6)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows = []
    for model, (geom, kinds) in (models or GEOM_MODELS).items():
        for kind in kinds:
            rows.append(geometry_row(kind, model, geom, pa, fp, ra, bucketing, rng, gen))
            gc.collect()
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# serving through generate()
# ---------------------------------------------------------------------------


async def serve(
    engine, batches: List[List[dict]], between: Callable[[int], None] = None,
    before_stop: Callable[[], None] = None,
) -> List[dict]:
    """Serve each batch of requests concurrently, one batch after the
    other (``between(i)`` runs before batch ``i`` > 0 starts); returns per
    request its tokens, finish reason, frame times, time to first token,
    top logprobs, the frames' prompt logprobs and the finish item's
    speculation stats.  The engine stops after (``before_stop()`` runs
    just before, on the engine's loop: reads of a sharded engine's ranks)."""
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
        if before_stop is not None:
            before_stop()
        await engine.stop()
    return results


def serve_cold_warm(engine, primer: List[dict], reqs: List[dict], hook=None, before_stop=None):
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
    res = asyncio.run(serve(engine, [primer, reqs, reqs], between, before_stop))
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
        ) + stage_layers(engine) * engine.pp_microbatches,
        "flash_prefix_prefill_attention": layers * (
            engine.prefill_dispatches["suffix"] + d.get("verify", 0)
        ),
        "paged_decode_attention": 0 if q else layers * steps,
        "gathered_decode": layers * steps if q else 0,
    }


def stage_layers(engine) -> int:
    """The layers of one pipeline stage of a pp engine (0 for any other):
    each runs kernel 2 once a microbatch of a pipeline prefill."""
    mesh = engine.mesh
    return engine.model_cfg.num_layers // mesh.pp if mesh is not None and mesh.pp > 1 else 0


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


async def http_call(port: int, method: str, path: str, body=None,
                    headers=None) -> Tuple[int, bytes]:
    """One HTTP/1.1 request with ``Connection: close`` to 127.0.0.1:port
    (a Content-Length body back)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = b"" if body is None else json.dumps(body).encode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n{extra}"
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


# -- serve-prof: the observability plane ----------------------------------------

# serve-prof (a)'s runs: DYN_MULTISTEP, and whether the tick profiler is armed
PROF_MODES = {
    "DYN_MULTISTEP=0": ("0", False),
    "DYN_MULTISTEP=4": ("4", False),
    "adaptive": ("adaptive", False),
    "adaptive, profiled": ("adaptive", True),
}
# serve-prof (b)'s SLO targets, in the DYN_SLO grammar
PROF_SLO = "ttft=2s,itl=200ms,e2e=60s"


def check_ticks(what: str, recs, counted: Dict[str, int]) -> Dict[str, int]:
    """Every tick's phases sum to its wall within 10%, and the ticks'
    dispatches by kind equal ``counted`` (the engine's own counters over
    the window, tick kinds only); returns the ticks' dispatches."""
    from dynamo_tpu_torch.engine.engine import TICK_KINDS

    if not recs:
        fail(f"{what}: no tick records")
    by_kind: Dict[str, int] = {}
    for r in recs:
        total = sum(r.phases.values())
        if abs(total - r.wall_s) > 0.1 * r.wall_s:
            fail(f"{what}: tick {r.idx}'s phases sum to {total:.6f} s, its wall "
                 f"{r.wall_s:.6f} s: {r.to_dict()}")
        for k, n in r.dispatches.items():
            by_kind[k] = by_kind.get(k, 0) + n
    want = {k: n for k, n in counted.items() if k in TICK_KINDS and n}
    if by_kind != want:
        fail(f"{what}: the ticks' dispatches {by_kind} differ from the engine's {want}")
    return by_kind


def prof_reference(ref: Dict[str, object]) -> None:
    """(a) The reference phase's f32 model on the card and on the CPU under
    each of ``PROF_MODES``, the compile sentry armed: streams card == CPU
    == the reference phase's; pinned to 4, only K 1 and 4; on the card the
    sentry's graph events equal ``graph_captures`` and raise nothing;
    profiled, the ticks hold the phase and dispatch invariants."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime import compile_sentry, profiling

    cfg, params, batches = ref["cfg"], ref["params"], ref["batches"]
    prof = profiling.profiler
    env = os.environ.get("DYN_MULTISTEP")
    armed = compile_sentry.arm(True)
    try:
        for label, (value, profiled) in PROF_MODES.items():
            os.environ["DYN_MULTISTEP"] = value
            streams = {}
            for dev in ("cuda", "cpu"):
                compile_sentry.reset()
                prof.clear()
                if profiled:
                    prof.enable()
                eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**ref["ecfg"]),
                                  device=dev)
                try:
                    streams[dev] = [r["tokens"] for r in asyncio.run(serve(eng, batches))]
                finally:
                    prof.disable()
                if dev != "cuda":
                    continue
                events = {k: n for k, n in compile_sentry.counts().items()
                          if k != compile_sentry.KERNEL_BUILD}
                line = (f"serve-prof: (a) {label}: dispatches_by_k="
                        f"{dict(sorted(eng.dispatches_by_k.items()))} graph_captures="
                        f"{eng.graph_captures} sentry={events}")
                if sum(events.values()) != eng.graph_captures or not eng.graph_captures:
                    fail(f"serve-prof (a) {label}: sentry events {events}, "
                         f"graph_captures {eng.graph_captures}")
                if value == "4" and set(eng.dispatches_by_k) != {1, 4}:
                    fail(f"serve-prof (a) {label}: K {eng.dispatches_by_k}, want 1 and 4")
                if value == "0" and set(eng.dispatches_by_k) - {1}:
                    fail(f"serve-prof (a) {label}: K {eng.dispatches_by_k} with multistep off")
                if profiled:
                    recs = prof.records()
                    check_ticks(f"serve-prof (a) {label}", recs, eng.dispatches)
                    line += f" ticks={len(recs)}"
                print(line)
            if streams["cuda"] != streams["cpu"]:
                fail(f"serve-prof (a) {label}: card streams {streams['cuda']} differ from "
                     f"the CPU's {streams['cpu']}")
            if streams["cuda"] != ref["streams"]:
                fail(f"serve-prof (a) {label}: streams differ from the reference phase's")
        print(f"serve-prof: (a) {len(PROF_MODES)} runs: card streams == CPU streams == the "
              f"reference phase's; sentry events == graph captures, none over budget")
    finally:
        compile_sentry.arm(armed)
        compile_sentry.reset()
        prof.disable()
        prof.clear()
        if env is None:
            os.environ.pop("DYN_MULTISTEP", None)
        else:
            os.environ["DYN_MULTISTEP"] = env


def bench_tok_s(report) -> float:
    """A batch's generated tokens over its client wall, unrounded."""
    return sum(r.output_tokens for r in report.results if r.ok) / report.wall_s


def merged_busy(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, overlapping intervals merged into disjoint busy spans."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_trace_report(path: str, t_req: float, duration_s: float, recs, card: str) -> None:
    """Read a ``torch.profiler`` trace of the server: it must hold kernel
    5's and kernel 1's launches by name.  Prints the device's busy share
    of the window (the union of kernel spans over first kernel start to
    last kernel end), the host threads whose ops it recorded, whether its
    clock aligns with the tick records' and, aligned, the five longest
    device-idle gaps with the tick phase under way at each."""
    from dynamo_tpu_torch.runtime import tracing

    with open(path) as fh:
        doc = json.load(fh)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    events = doc.get("traceEvents") or []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = [e["name"] for e in kernels]
    n5 = sum("ragged" in n for n in names)
    n1 = sum("paged_decode" in n for n in names)
    print(f"serve-prof: (b) device trace: {len(kernels)} kernels, packed ragged "
          f"(kernel 5) {n5}, paged decode (kernel 1) {n1}")
    if not n5 or not n1:
        fail(f"serve-prof (b): the device trace lacks kernel 5 ({n5}) or kernel 1 ({n1}): "
             f"{sorted(set(names))[:20]}")
    spans = [((e["ts"] + base_us) * 1e-6, (e["ts"] + e.get("dur", 0.0) + base_us) * 1e-6)
             for e in kernels]
    busy = merged_busy(spans)
    t0, t1 = busy[0][0], busy[-1][1]
    busy_s = sum(b - a for a, b in busy)
    cpu_tids: Dict[object, int] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            cpu_tids[e.get("tid")] = cpu_tids.get(e.get("tid"), 0) + 1
    print(f"serve-prof: (b) device busy share {busy_s / (t1 - t0):.4f} of the kernels' "
          f"window {t1 - t0:.6f} s ({busy_s / duration_s:.4f} of the {duration_s} s capture); "
          f"host ops recorded on {len(cpu_tids)} thread(s) {sorted(cpu_tids.values())} "
          f"on {card}")
    # the kernels' clock: wall seconds (baseTimeNanoseconds + ts); the
    # ticks': monotonic + the tracing module's wall offset
    aligned = t_req - 0.5 <= t0 and t1 <= t_req + duration_s + 30.0
    ticks = [(r.start_s + tracing._MONO_TO_WALL, r) for r in recs]
    overlap = [r for s, r in ticks if s <= t1 and s + r.wall_s >= t0]
    print(f"serve-prof: (b) clocks: kernels from {t0 - t_req:+.6f} s to {t1 - t_req:+.6f} s "
          f"of the capture request; {len(overlap)} tick records overlap them; aligned: "
          f"{aligned and bool(overlap)}")
    if not (aligned and overlap):
        return
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    for length, a, b in gaps[:5]:
        mid = (a + b) / 2
        under = "no tick (the loop between ticks or idle)"
        for s, r in ticks:
            phase = r.phase_at(mid - s)
            if phase is not None:
                under = f"tick {r.idx} phase {phase} ({sorted(r.dispatches.items())})"
                break
        print(f"serve-prof: (b) device idle {length * 1e3:.3f} ms at {a - t0:.6f} s: {under}")


async def prof_http(engine, tok, primer, batch, tap, tmp: str, card: str) -> Dict[str, object]:
    """(b) through the HTTP service: see ``serve_prof_phase``."""
    from dynamo_tpu_torch.bench_serving import run_bench
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime import profiling, tracing
    from dynamo_tpu_torch.runtime.pipeline import link

    pipe = link(OpenAIPreprocessor("m", tok), Backend(tok), tap)
    manager = ModelManager()
    manager.add_completion_model("m", pipe)
    service = HttpService(manager, port=0)
    await service.start()
    host, port = service.address
    prof = profiling.profiler
    out: Dict[str, object] = {}

    async def run(what: str, reqs: List[dict]):
        rep = await run_bench(host, port, "m", bench_items(reqs), concurrency=len(reqs))
        check_http_results(f"serve-prof (b) {what}", [rep], [reqs])
        return rep

    async def call(method: str, path: str, body=None, headers=None):
        status, raw = await http_call(port, method, path, body, headers)
        if status not in (200, 504):
            fail(f"serve-prof (b): {method} {path} answered {status}: {raw[:300]!r}")
        return status, json.loads(raw)

    try:
        await run("primer", primer)
        out["cold"] = await run("cold", batch)
        out["warm"] = await run("warm", batch)
        # the profiled warm batch, between two unprofiled ones
        before = dict(engine.dispatches)
        await call("POST", "/profile/ticks", {"enabled": True, "clear": True})
        out["profiled"] = await run("profiled", batch)
        _, out["ticks"] = await call("GET", "/profile/ticks")
        out["records"] = prof.records()
        await call("POST", "/profile/ticks", {"enabled": False})
        out["window"] = {k: n - before.get(k, 0) for k, n in engine.dispatches.items()}
        out["warm2"] = await run("warm again", batch)
        # a device trace over more warm batches, ticks and spans recorded
        tracing.collector.clear()
        tracing.collector.enable()
        prof.clear()
        prof.enable()
        log_dir = os.path.join(tmp, "device-trace")
        t_req = time.time()
        capture = asyncio.ensure_future(
            call("POST", "/profile/device", {"duration_s": 1.0, "log_dir": log_dir})
        )
        # one warm batch during the capture (the card runs it slower:
        # CUPTI records every kernel)
        t_batch = time.perf_counter()
        await run("traced", batch)
        t_batch = time.perf_counter() - t_batch
        status, dev = await capture
        prof.disable()
        if status != 200 or not dev.get("ok"):
            fail(f"serve-prof (b): POST /profile/device answered {status}: {dev}")
        out["device"] = (dev, t_req, t_batch, time.time() - t_req, prof.records())
        # one request's spans: the mixed prefill dispatch must be there
        rid = list(tap.frames)[-1]
        status, trace = await call("GET", f"/trace/{rid}")
        tracing.collector.disable()
        names = [(s["name"], (s.get("attrs") or {}).get("mixed")) for s in trace["spans"]]
        if ("engine.prefill_dispatch", True) not in names:
            fail(f"serve-prof (b): GET /trace/{rid} has no mixed engine.prefill_dispatch: {names}")
        out["trace"] = names
        # a deadline of 1 ms: a 504 whose flight-recorder snapshot holds
        # the tick ring, the engine's state and the deadline violation
        status, body = await call(
            "POST", "/v1/completions",
            {"model": "m", "prompt": batch[0]["token_ids"], "max_tokens": 64},
            {"X-Request-Deadline-S": "0.001"},
        )
        fid = (body.get("error") or {}).get("flightrec")
        if status != 504 or not fid:
            fail(f"serve-prof (b): the 1 ms deadline answered {status}: {body}")
        _, snap = await call("GET", f"/debug/flightrec/{fid}")
        causes = [(v["kind"], v["cause"]) for v in snap["slo_violations"]]
        if not snap["ticks"] or "engine" not in snap["state"] or ("e2e", "deadline") not in causes:
            fail(f"serve-prof (b): snapshot {fid}: {len(snap['ticks'])} ticks, state "
                 f"{list(snap['state'])}, violations {causes}")
        out["snapshot"] = (fid, snap)
        status, raw = await http_call(port, "GET", "/metrics")
        kinds = sorted(set(re.findall(r'dynamo_slo_attainment\{[^}]*kind="(\w+)"', raw.decode())))
        if status != 200 or not kinds:
            fail(f"serve-prof (b): /metrics has no dynamo_slo_attainment series")
        out["slo_kinds"] = kinds
    finally:
        prof.disable()
        tracing.collector.disable()
        await service.stop()
        await engine.stop()
    return out


def serve_prof_phase(ref: Dict[str, object], card: str) -> None:
    """(a) ``prof_reference``; (b) Llama-3-8B at full width and depth,
    bf16, serve's weights and traffic through the in-process HTTP service,
    under ``PROF_SLO``: the primer, the batch cold, warm, then warm with
    the tick profiler armed by ``POST /profile/ticks`` (its phase shares,
    host occupancy, dispatch gaps and dispatches by kind printed from
    ``GET /profile/ticks``; every tick's phases sum to its wall within
    10%, its dispatches equal the engine's counters over the window), warm
    unprofiled again, then warm batches while ``POST /profile/device``
    takes a 1 s device trace (kernels 5 and 1 in it by name; the busy
    share and, where the clocks align, the longest idle gaps with the tick
    phase under way), ``GET /trace/{id}`` (a mixed
    ``engine.prefill_dispatch``), and a request with a 1 ms deadline (a
    504 and its flight-recorder snapshot); the launch invariants over the
    whole run.  (c) rides serve-http's CLI process (``prof_cli``)."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer
    from dynamo_tpu_torch.runtime import profiling, slo

    t0 = time.perf_counter()
    prof_reference(ref)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-prof-")
    try:
        big = os.path.join(tmp, "llama3")
        os.makedirs(big)
        write_tokenizer(big, 128000, 256)
        tok8 = Tokenizer.from_model_dir(big)
        cfg8 = ModelConfig.llama3_8b()
        primer, batch = serve_requests(cfg8.vocab_size)
        eng8 = TorchEngine.random_init(cfg8, EngineConfig(num_pages=1024), seed=0)
        tap = Tap(eng8)
        slo.tracker.configure(PROF_SLO)
        reset_launches()
        try:
            res = asyncio.run(prof_http(eng8, tok8, primer, batch, tap, tmp, card))
        finally:
            slo.tracker.disable()
            # the ring's records must not steer later engines' multistep K
            profiling.profiler.clear()
        counted = read_launches()
        check_launch_invariants("serve-prof (b)", eng8, counted)
        summ = res["ticks"]["summary"]
        window = check_ticks("serve-prof (b) profiled warm batch", res["records"], res["window"])
        wall = summ["wall_s"]
        shares = {k: round(v / wall, 4) for k, v in summ["phase_totals_s"].items()}
        print(f"serve-prof: (b) profiled warm batch: {summ['ticks']} ticks, wall {wall} s, "
              f"phase shares {shares}, host occupancy {summ['host_occupancy']}, dispatch gap "
              f"p50 {summ['gap_p50_ms']} ms p95 {summ['gap_p95_ms']} ms, dispatches {window} "
              f"on {card}")
        tok_s = {k: bench_tok_s(res[k]) for k in ("cold", "warm", "profiled", "warm2")}
        print(f"serve-prof: (b) tok_s cold {tok_s['cold']:.3f}, warm unprofiled "
              f"{tok_s['warm']:.3f}, warm profiled {tok_s['profiled']:.3f}, warm unprofiled "
              f"again {tok_s['warm2']:.3f} on {card}")
        dev, t_req, t_batch, t_capture, recs = res["device"]
        print(f"serve-prof: (b) POST /profile/device: {dev} answered in {t_capture:.3f} s; "
              f"the warm batch beside it took {t_batch:.3f} s on {card}")
        device_trace_report(
            os.path.join(dev["log_dir"], profiling.DEVICE_TRACE_FILE), t_req,
            dev["duration_s"], recs, card,
        )
        fid, snap = res["snapshot"]
        causes: Dict[str, int] = {}
        for v in snap["slo_violations"]:
            key = f"{v['kind']}/{v['cause']}"
            causes[key] = causes.get(key, 0) + 1
        print(f"serve-prof: (b) GET /trace: spans {sorted(set(n for n, _ in res['trace']))}; "
              f"the 1 ms deadline: 504 with flightrec {fid}: {len(snap['ticks'])} ticks, "
              f"engine state {snap['state']['engine']}, recent violations {causes}; /metrics "
              f"dynamo_slo_attainment kinds {res['slo_kinds']}")
        print(f"serve-prof: (b) launches {counted} dispatches={dict(eng8.dispatches)}")
        del eng8, tap, res
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve-prof: {time.perf_counter() - t0:.3f} s")


def prof_cli(tmp: str, port: int, card: str) -> None:
    """serve-prof (c): ``python -m dynamo_tpu_torch profile URL --watch 3
    --device 1 --json OUT`` against serve-http's ``run in=http out=torch``
    process, with ``cli_requests()`` traffic until it exits: exit code 0,
    the device trace captured, ``engine.tick`` rows in its Chrome trace."""
    out = os.path.join(tmp, "cli-profile.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch", "profile", f"http://127.0.0.1:{port}",
         "--watch", "3", "--device", "1", "--json", out],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        async def traffic() -> int:
            rounds = 0
            while proc.poll() is None:
                await ask_texts(port, "serve-prof (c)")
                rounds += 1
            return rounds

        rounds = asyncio.run(traffic())
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or "device trace captured to" not in text:
        fail(f"serve-prof (c): profile exited {proc.returncode}: {text[-3000:]}")
    with open(out) as fh:
        events = json.load(fh)["traceEvents"]
    rows = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    ticks = sum(e["name"] == "tick" for e in events)
    if "engine.tick" not in rows or not ticks:
        fail(f"serve-prof (c): the profile's Chrome trace has no engine.tick rows: {rows}")
    print(f"serve-prof: (c) profile --watch 3 --device 1 over {rounds} rounds of traffic: "
          f"exit 0, {ticks} tick rows; its output: {text.strip().splitlines()} on {card}")


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


# ---------------------------------------------------------------------------
# phase 10b: serve-chaos, the engine's chaos sites at full width
# ---------------------------------------------------------------------------


def free_pages_back(what: str, engine) -> None:
    """Every page of a stopped engine's pool is free again (the free list
    and the evictable prefix cache), as before its first request."""
    pool = engine.sched.pool
    if pool.free_pages != pool.num_pages - 1:
        fail(f"{what}: {pool.num_pages - 1 - pool.free_pages} pages still held")


def fallback_series(engine) -> Dict[str, float]:
    """The chaos fallbacks' ``dynamo_kv_*`` samples of an engine."""
    return {k: v for k, v in kv_series(engine).items()
            if k.startswith(("dynamo_kv_offload_copy_failures", "dynamo_kv_swap_fallbacks",
                             "dynamo_kv_onboard_fallbacks"))}


def add_launches(total: Dict[str, int], counted: Dict[str, int]) -> None:
    for k, n in counted.items():
        total[k] = total.get(k, 0) + n


def chaos_tiers(params, card: str, launches: Dict[str, int]) -> None:
    """(a) Llama-3-8B, bf16, ``EngineConfig(num_pages=320,
    host_offload_blocks=640)`` (a ring that holds every block the rounds
    evict): round 1 (4 requests on 4 1024-token
    prefixes, 16 new tokens), round 2 (4 other prefixes: their admissions
    evict round 1's blocks into the host ring), round 3 (round 1 again:
    its prefixes onboard from G2).  Unarmed, then with every eviction's
    copy failing (``offload.copy_fail=1:match=evict/``: nothing lands in
    G2, round 3's G2 hits fall to 0, ``copy_fails`` == the firings), then
    with ``onboard.truncate=1`` armed for round 3 (every admission with
    tier hits recomputes its prefix in place: the firings == those
    admissions == ``onboard_fallbacks{truncate}``).  Every request
    finishes, the launch invariants hold, and every page is free after."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime import faults
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    cfg = ModelConfig.llama3_8b()
    V = cfg.vocab_size
    rng = np.random.default_rng(21)
    rounds = [[request(np.concatenate([rng.integers(1, V, 1024), rng.integers(1, V, 16)]), 16)
               for _ in range(4)] for _ in range(2)]
    rounds.append(rounds[0])
    legs = {
        "unarmed": (None, None),
        "evict copy-fail": ("seed=1;offload.copy_fail=1:match=evict/", 0),
        "prefix truncate": ("seed=1;onboard.truncate=1", 2),
    }
    inj = faults.injector
    base = None
    for leg, (spec, arm_at) in legs.items():
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=320, host_offload_blocks=640),
                             metrics_registry=MetricsRegistry())
        oe = engine.offload_engine
        onboards = []
        apply_onboards = engine._apply_onboards

        def counting_apply(seq, apply_onboards=apply_onboards, onboards=onboards):
            onboards.append(len(seq.pending_onboard))
            apply_onboards(seq)

        engine._apply_onboards = counting_apply
        state = {}

        def between(i: int, engine=engine, oe=oe, spec=spec, arm_at=arm_at, state=state) -> None:
            oe.drain()
            if i == 2:
                state["hits"] = oe.tier_hits["host"]
                state["ring"] = len(engine.offload)
                onboards.clear()
            if spec is not None and i == arm_at:
                inj.configure(spec)

        if spec is not None and arm_at == 0:
            inj.configure(spec)
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = asyncio.run(serve(engine, rounds, between))
            fired = {s: inj.fire_count(s) for s in ("offload.copy_fail", "onboard.truncate")}
        finally:
            inj.disable()
        wall = time.perf_counter() - t0
        counted = read_launches()
        check_launch_invariants(f"serve-chaos: (a) {leg}", engine, counted)
        add_launches(launches, counted)
        for j, r in enumerate(res):
            if r["finish"] != "length" or len(r["tokens"]) != 16:
                fail(f"serve-chaos: (a) {leg} request {j}: {len(r['tokens'])} tokens, "
                     f"finish {r['finish']}")
        free_pages_back(f"serve-chaos: (a) {leg}", engine)
        hits3 = oe.tier_hits["host"] - state["hits"]
        series = fallback_series(engine)
        round3 = [r["tokens"] for r in res[8:]]
        line = (f"serve-chaos: (a) {leg} fired={fired} copy_fails={oe.copy_fails} "
                f"onboard_fallbacks={oe.onboard_fallbacks} ring_blocks_after_round2="
                f"{state['ring']} round3_g2_hits={hits3} admissions_with_tier_hits="
                f"{len(onboards)} ({sum(onboards)} blocks) series={series} wall_s={wall:.3f}")
        if leg == "unarmed":
            check_no_fallback("serve-chaos: (a) unarmed", engine)
            if not hits3 or not onboards:
                fail("serve-chaos: (a) unarmed: round 3 onboarded nothing from G2")
            base = dict(hits=hits3, streams=round3)
        elif leg == "evict copy-fail":
            n = fired["offload.copy_fail"]
            if not n or oe.copy_fails != n or state["ring"] or hits3 or onboards:
                fail(f"serve-chaos: (a) {leg}: {line}")
            if series.get("dynamo_kv_offload_copy_failures_total") != n:
                fail(f"serve-chaos: (a) {leg}: copy failure series {series}, {n} firings")
            line += f"; round 3's G2 hits fell from {base['hits']} to {hits3}"
        else:
            n = fired["onboard.truncate"]
            if not n or n != len(onboards) or oe.onboard_fallbacks != n or series.get(
                    'dynamo_kv_onboard_fallbacks_total{cause="truncate"}') != n:
                fail(f"serve-chaos: (a) {leg}: {line}")
            if oe.onboard_detail.get("prefix", [0])[0]:
                fail(f"serve-chaos: (a) {leg}: a truncated onboard scattered its blocks")
        same = sum(a == b for a, b in zip(round3, base["streams"]))
        print(f"{line}; round 3 greedy streams equal to unarmed's: {same} of 4 on {card}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def chaos_swap(params, card: str, launches: Dict[str, int]) -> None:
    """(b) Llama-3-8B, bf16: 8 lanes of 256-token prompts and 128 new
    tokens over ``num_pages=160`` with ``host_offload_blocks=512`` (the
    swap pressure of serve-kvbm (c), shorter), the serial loop: every swap snapshot's copy
    failing (``offload.copy_fail=1:match=swap/``: no preemption swaps,
    ``swap_fallbacks{copy_fail}`` == ``copy_fails`` == the firings), then
    every swap restore truncated (``onboard.truncate=1:match=swap/``: no
    swap-in, ``swap_fallbacks{truncate}`` == the firings == the swapped
    victims).  Every victim is recomputed: every request finishes with its
    128 tokens, and every page is free after."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime import faults
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    cfg = ModelConfig.llama3_8b()
    rng = np.random.default_rng(13)
    reqs = [request(rng.integers(1, cfg.vocab_size, 256), 128) for _ in range(8)]
    inj = faults.injector
    for leg, spec, site, cause in (
        ("swap copy-fail", "seed=3;offload.copy_fail=1:match=swap/", "offload.copy_fail",
         "copy_fail"),
        ("swap-restore truncate", "seed=3;onboard.truncate=1:match=swap/", "onboard.truncate",
         "truncate"),
    ):
        # the serial loop: a preemption then always finds its victim's
        # state host-visible, so each one is offered to swap_out
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=160, host_offload_blocks=512,
                                                       async_dispatch=False),
                             metrics_registry=MetricsRegistry())
        oe = engine.offload_engine
        free0 = engine.sched.pool.free_pages
        inj.configure(spec)
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = asyncio.run(serve(engine, [reqs]))
            fired = inj.fire_count(site)
        finally:
            inj.disable()
        wall = time.perf_counter() - t0
        counted = read_launches()
        check_launch_invariants(f"serve-chaos: (b) {leg}", engine, counted)
        add_launches(launches, counted)
        for j, r in enumerate(res):
            if r["finish"] != "length" or len(r["tokens"]) != 128:
                fail(f"serve-chaos: (b) {leg} request {j}: {len(r['tokens'])} tokens")
        series = fallback_series(engine)
        by_cause = series.get(f'dynamo_kv_swap_fallbacks_total{{cause="{cause}"}}', 0.0)
        sched = engine.sched
        line = (f"serve-chaos: (b) {leg} fired={fired} preempt_swap={sched.preempt_swap} "
                f"preempt_recompute={sched.preempt_recompute} swap_ins={oe.swap_ins} "
                f"swap_fallbacks={oe.swap_fallbacks} copy_fails={oe.copy_fails} "
                f"series={series} free_pages {free0} -> {sched.pool.free_pages} "
                f"wall_s={wall:.3f} on {card}")
        if cause == "copy_fail":
            ok = (fired and sched.preempt_swap == 0 and sched.preempt_recompute >= fired
                  and oe.copy_fails == oe.swap_fallbacks == by_cause == fired)
        else:
            ok = (fired and oe.swap_ins == 0 and sched.preempt_swap == fired
                  and oe.swap_fallbacks == by_cause == fired and not oe.copy_fails)
        if not ok or oe._swap_used:
            fail(f"{line}: the fallbacks do not add up")
        free_pages_back(f"serve-chaos: (b) {leg}", engine)
        print(line)
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def chaos_spec(params, served: Dict[str, object], card: str,
               launches: Dict[str, int]) -> None:
    """(c) ``spec.draft_corrupt=1`` on serve-a45's oracle runs (serve's
    primer and batch, every lane drafting serve's plain streams, 4 drafts),
    folded (kernel 5) and with ``fold_spec_verify=False`` (kernel 3): every
    draft corrupted, so nothing is accepted, and every request finishes
    with its 64 tokens.  Against serve's spec-off streams of the same batch:
    the greedy streams that stay equal, and at each first divergence the
    top-2 logprobs (bf16 near-ties part streams run at other shapes;
    identity is held in f32 on the CPU)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime import faults
    from dynamo_tpu_torch.spec import register_drafter

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    plain = served["streams"][: len(batch)]
    pairs = [(r["token_ids"], t) for r, t in zip(batch, plain)]
    register_drafter("chaos-oracle", lambda: StreamOracle(pairs))
    with_top2 = [dict(r, sampling_options=dict(r["sampling_options"], logprobs=2))
                 for r in batch]
    greedy = [i for i, r in enumerate(batch) if not r["sampling_options"].get("temperature")]
    inj = faults.injector
    for leg, kw in (("folded", {}), ("fold-off", dict(fold_spec_verify=False))):
        engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
        inj.configure("seed=7;spec.draft_corrupt=1")
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = asyncio.run(serve(engine, [speculating(primer, "chaos-oracle"),
                                             speculating(with_top2, "chaos-oracle")]))
            fired = inj.fire_count("spec.draft_corrupt")
        finally:
            inj.disable()
        wall = time.perf_counter() - t0
        counted = read_launches()
        check_launch_invariants(f"serve-chaos: (c) {leg}", engine, counted)
        add_launches(launches, counted)
        check_streams(f"serve-chaos (c) {leg}", res[1:], cfg.vocab_size)
        line = spec_line(engine)
        drafted, accepted = engine.spec_drafted, engine.spec_accepted
        standalone = engine.dispatches.get("verify", 0)
        folded = engine._fold_spec
        free_pages_back(f"serve-chaos: (c) {leg}", engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if not fired or not drafted or accepted:
            fail(f"serve-chaos: (c) {leg}: fired={fired} {line}")
        if folded == bool(standalone):
            fail(f"serve-chaos: (c) {leg}: {standalone} standalone verifies, folded={folded}")
        got = [res[1 + i]["tokens"] for i in greedy]
        print(f"serve-chaos: (c) {leg} fired={fired} {line} wall_s={wall:.3f} on {card}")
        print(f"serve-chaos: (c) {leg} greedy streams against serve's spec-off: "
              f"{first_divergence(got, [plain[i] for i in greedy])}")
        for i in greedy:
            a, b, top = res[1 + i]["tokens"], plain[i], res[1 + i]["top"]
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if j is not None:
                gap = None
                if j < len(top) and len(top[j]) >= 2:
                    gap = abs(top[j][0][1] - top[j][1][1])
                print(f"serve-chaos: (c) {leg} request {i} parts at token {j}: spec-off's "
                      f"{b[j]}, here {a[j]}; top-2 logprobs there {top[j] if j < len(top) else None}"
                      f" (gap {gap})")


def serve_chaos_phase(params, served: Dict[str, object], card: str) -> None:
    """serve-chaos: the three engine chaos sites armed through
    ``runtime.faults.injector`` at Llama-3-8B width: (a) ``chaos_tiers``,
    (b) ``chaos_swap``, (c) ``chaos_spec``, each leg's launch invariants
    held.  A failed check fails the run."""
    t0 = time.perf_counter()
    launches: Dict[str, int] = {}
    chaos_tiers(params, card, launches)
    chaos_swap(params, card, launches)
    chaos_spec(params, served, card, launches)
    print(f"serve-chaos: launches over its seven legs {launches}")
    print(f"serve-chaos: phase {time.perf_counter() - t0:.3f} s")


# -- serve-planner: the planner over a decode pool of torch workers ---------------

PLANNER_ISLS = [128, 512, 2048]
PLANNER_BATCHES = [1, 4, 8]
POOL_PAGES = 256


def recommend_rule(prof, ttft_slo, itl_slo) -> Dict[str, object]:
    """``SlaProfile.recommend``'s rule worked out from the table: the
    largest ISL whose TTFT meets its SLO, the largest batch whose ITL
    meets its SLO and that batch's rate (None where nothing meets it)."""
    isl = max((i for i, v in prof.ttft_ms.items() if ttft_slo is None or v <= ttft_slo),
              default=None)
    batch = max((b for b, v in prof.itl_ms.items() if itl_slo is None or v <= itl_slo),
                default=None)
    return {"max_isl_within_ttft_slo": isl, "max_batch_within_itl_slo": batch,
            "throughput_at_max_batch": None if batch is None else prof.tok_s[batch]}


def planner_profile(params, card: str) -> Tuple[object, Dict[str, int]]:
    """(a) ``SlaProfiler`` over ``TorchEngine(llama3_8b, params,
    EngineConfig(num_pages=1024))``: TTFT of cold prompts of 128, 512 and
    2048 tokens, ITL and tok/s of 1, 4 and 8 streams of 64 tokens.  Every
    number finite and positive, ``recommend`` equal to the rule worked out
    here for a pair that admits everything and one between the batch-4 and
    batch-8 ITL, and the launch invariants held."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.planner.profile_sla import SlaProfiler
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    cfg = ModelConfig.llama3_8b()
    engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024),
                         metrics_registry=MetricsRegistry())

    async def go():
        try:
            return await SlaProfiler(engine, vocab_size=cfg.vocab_size).profile(
                isls=PLANNER_ISLS, batches=PLANNER_BATCHES, osl=64)
        finally:
            await engine.stop()

    reset_launches()
    t0 = time.perf_counter()
    prof = asyncio.run(go())
    wall = time.perf_counter() - t0
    counted = read_launches()
    check_launch_invariants("serve-planner: (a)", engine, counted)
    for name, table, keys in (("ttft_ms", prof.ttft_ms, PLANNER_ISLS),
                              ("itl_ms", prof.itl_ms, PLANNER_BATCHES),
                              ("tok_s", prof.tok_s, PLANNER_BATCHES)):
        if sorted(table) != keys or not all(math.isfinite(v) and v > 0 for v in table.values()):
            fail(f"serve-planner: (a) {name} {table}")
    pairs = [(max(prof.ttft_ms.values()), max(prof.itl_ms.values())),
             ((prof.ttft_ms[512] + prof.ttft_ms[2048]) / 2,
              (prof.itl_ms[4] + prof.itl_ms[8]) / 2)]
    for ttft_slo, itl_slo in pairs:
        got, want = prof.recommend(ttft_slo, itl_slo), recommend_rule(prof, ttft_slo, itl_slo)
        print(f"serve-planner: (a) recommend(ttft {ttft_slo:.3f} ms, itl {itl_slo:.3f} ms) "
              f"= {got}")
        if got != want:
            fail(f"serve-planner: (a) recommend {got}, the rule gives {want}")
    print(f"serve-planner: (a) Llama-3-8B TTFT ms by ISL {prof.to_dict()['ttft_ms']}, "
          f"ITL ms by batch {prof.to_dict()['itl_ms']}, tok/s by batch "
          f"{prof.to_dict()['tok_s']} (unrounded: {prof.ttft_ms} {prof.itl_ms} "
          f"{prof.tok_s}); wall {wall:.3f} s; {loop_line(engine, wall)} on {card}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return prof, counted


class PoolWorker:
    """serve-planner (b)'s worker handle, the in-process twin of a decode
    worker process: a ``TorchEngine`` over the shared weights with a pool
    of its own, its series on a private registry and a
    ``TelemetryPublisher`` into the fleet observatory.  ``drain`` waits,
    bounded, until the engine holds no active or waiting request; ``stop``
    stops the publisher, then the engine, and lets the engine go, so its
    pool's memory returns to the card."""

    def __init__(self, worker_id: int, cfg, params, obs) -> None:
        from dynamo_tpu_torch.engine.config import EngineConfig
        from dynamo_tpu_torch.engine.engine import TorchEngine
        from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
        from dynamo_tpu_torch.runtime.telemetry import TelemetryPublisher

        self.worker_id = worker_id
        self.registry = MetricsRegistry()
        self.engine = TorchEngine(cfg, params, EngineConfig(num_pages=POOL_PAGES),
                                  metrics_registry=self.registry)
        self.pool_bytes = self.engine.kv.pool_bytes
        self.publisher = TelemetryPublisher(worker_id=worker_id, role="decode",
                                            registry=self.registry, interval_s=0.1,
                                            sink=obs.ingest)
        # what the stopped engine leaves behind for the phase's checks
        self.expected: Dict[str, int] = {}
        self.pages_held = None
        self.drained = None

    async def start(self) -> None:
        await self.engine.start()
        await self.publisher.publish_once()
        self.publisher.start()

    def idle(self) -> bool:
        sched = self.engine.sched
        return sched.num_active == 0 and sched.num_waiting == 0

    async def drain(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while not self.idle():
            if time.monotonic() > deadline:
                self.drained = False
                return False
            await asyncio.sleep(0.01)
        self.drained = True
        return True

    async def stop(self) -> None:
        await self.publisher.stop()
        engine = self.engine
        await engine.stop()
        self.expected = expected_launches(engine)
        pool = engine.sched.pool
        self.pages_held = pool.num_pages - 1 - pool.free_pages
        self.engine = None
        del engine, pool
        gc.collect()


async def pool_stream(worker: PoolWorker, req: dict, out: List[dict]) -> None:
    """One request on a pool worker; appends its tokens, finish reason and
    frame times (an error frame fails the run) and records its TTFT and
    per-token ITL with the SLO tracker."""
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime import slo
    from dynamo_tpu_torch.runtime.engine import Context

    t0 = time.perf_counter()
    ctx = Context.new(PreprocessedRequest.from_dict(req))
    stream = await worker.engine.generate(ctx)
    tokens: List[int] = []
    frames: List[Tuple[float, int]] = []
    finish = None
    async for item in stream:
        if item.is_error():
            fail(f"serve-planner: (b) worker {worker.worker_id}: {item.error_message()}")
        data = item.data or {}
        got = data.get("token_ids") or []
        if got:
            now = time.perf_counter()
            if frames:
                for _ in got:
                    slo.tracker.record_itl((now - frames[-1][0]) / len(got))
            else:
                slo.tracker.record_ttft(ctx.id, now - t0)
            frames.append((now, len(got)))
            tokens += got
        finish = data.get("finish_reason") or finish
    out.append(dict(worker=worker.worker_id, tokens=tokens, finish=finish, frames=frames))


async def planner_pool(cfg, params, tmp: str) -> Dict[str, object]:
    """(b)'s traffic and rounds: see :func:`serve_planner_phase`."""
    from dynamo_tpu_torch.fleet import FleetObservatory
    from dynamo_tpu_torch.llm.kv_router import DefaultWorkerSelector, OverlapScores
    from dynamo_tpu_torch.llm.kv_router.scheduler import ProcessedEndpoints
    from dynamo_tpu_torch.planner import LocalConnector, Planner, PlannerConfig
    from dynamo_tpu_torch.planner.planner import fleet_metrics_source
    from dynamo_tpu_torch.runtime import slo
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, default_registry

    obs = FleetObservatory(MetricsRegistry())
    workers: List[PoolWorker] = []
    cold: Dict[int, float] = {}

    async def make_worker() -> PoolWorker:
        t0 = time.perf_counter()
        w = PoolWorker(len(workers) + 1, cfg, params, obs)
        await w.start()
        cold[w.worker_id] = time.perf_counter() - t0
        workers.append(w)
        return w

    named: List[PoolWorker] = []
    pick = obs.victim_source()

    def victim(kind: str, handles: List[PoolWorker]) -> PoolWorker:
        named.append(pick(kind, handles))
        return named[-1]

    reg = default_registry()

    def series(name: str, **labels) -> float:
        return reg.sample(name, labels) or 0.0

    base = {a: series("dynamo_planner_adjustments", kind="decode", action=a)
            for a in ("up", "down")}
    log = os.path.join(tmp, "adjustments.jsonl")
    conn = LocalConnector({"decode": make_worker}, victim_source=victim, drain_timeout_s=5.0)
    await conn.add_worker("decode")
    planner = Planner(
        conn, fleet_metrics_source(obs),
        cfg=PlannerConfig(kv_load_scale_up=0.8, kv_load_scale_down=0.3,
                          min_decode_workers=1, max_decode_workers=3,
                          decode_grace_periods=1, adjustment_log_path=log),
        quarantine_source=obs.quarantine_source(),
        on_adjustment=lambda adj: obs.note_adjustment(
            adj.kind, adj.action, adj.reason, adj.count_before),
    )
    sizes: List[Tuple[float, int]] = []
    rounds: List[str] = []

    def loads() -> Dict[int, float]:
        return {w: round(m.gpu_cache_usage_perc, 4)
                for w, m in sorted(obs.forward_pass_metrics().items())}

    async def step() -> None:
        line = (f"round {len(rounds) + 1}: loads {loads()} slo attainment ttft "
                f"{slo.tracker.attainment('ttft')} itl {slo.tracker.attainment('itl')}")
        await asyncio.wait_for(planner.step(), 120.0)
        a = planner.adjustments[-1]
        rounds.append(f"{line} -> {a.kind} {a.action} from {a.count_before} ({a.reason})")
        print(f"serve-planner: (b) {rounds[-1]}", flush=True)
        sizes.append((series("dynamo_planner_pool_size", kind="decode"),
                      conn.worker_count("decode")))

    async def wait_for(what: str, ready: Callable[[], bool], limit_s: float) -> float:
        t0 = time.perf_counter()
        while not ready():
            if time.perf_counter() - t0 > limit_s:
                fail(f"serve-planner: (b) {what} not within {limit_s:.0f} s: loads {loads()}")
            await asyncio.sleep(0.02)
        return time.perf_counter() - t0

    V = cfg.vocab_size
    rng = np.random.default_rng(19)
    batches = [[request(rng.integers(1, V, 400), 256) for _ in range(8)] for _ in range(2)]
    out: List[dict] = []
    tasks: List[asyncio.Task] = []
    t_all = time.perf_counter()
    try:
        first = workers[0]
        tasks += [asyncio.create_task(pool_stream(first, r, out)) for r in batches[0]]
        hot = await wait_for("worker 1's KV load >= 0.8", lambda: loads().get(1, 0.0) >= 0.8,
                             300.0)
        if out:
            fail("serve-planner: (b) a stream ended before worker 1's load reached 0.8")
        await step()
        second = workers[1] if len(workers) > 1 else None
        if second is None:
            fail(f"serve-planner: (b) no scale-up at load {loads()}: {planner.adjustments}")
        print(f"serve-planner: (b) worker 1 at KV load >= 0.8 after {hot:.3f} s; worker 2's "
              f"cold start (construction, start, first snapshot) {cold[2]:.3f} s")
        sel = DefaultWorkerSelector(quarantine=obs.quarantine_source())
        endpoints = ProcessedEndpoints(endpoints=obs.forward_pass_metrics())
        placed = [sel.select_worker(endpoints, OverlapScores(), len(r["token_ids"]), 16)[0]
                  for r in batches[1]]
        print(f"serve-planner: (b) the selector placed the second batch on workers {placed}")
        if placed != [2] * 8:
            fail(f"serve-planner: (b) the second batch went to {placed}, not the new worker")
        tasks += [asyncio.create_task(pool_stream(second, r, out)) for r in batches[1]]
        await asyncio.wait_for(asyncio.gather(*tasks), 600.0)
        wall = time.perf_counter() - t_all
        calm = await wait_for("both loads <= 0.3",
                              lambda: len(loads()) == 2 and max(loads().values()) <= 0.3, 60.0)
        print(f"serve-planner: (b) both loads <= 0.3 {calm:.3f} s after the last stream; "
              f"worker 2's graph captures {second.engine.graph_captures} "
              f"({second.engine.graphs.capture_ms:.3f} ms)")
        alloc = torch.cuda.memory_allocated()
        await step()  # the grace round
        await step()  # the scale-down
        freed = alloc - torch.cuda.memory_allocated()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.wait_for(planner.stop(), 60.0)
    survivors = list(conn.workers["decode"])
    for w in survivors:
        await w.stop()
    return dict(out=out, planner=planner, conn=conn, workers=workers, named=named,
                survivors=survivors, sizes=sizes, log=log, base=base, freed=freed,
                wall=wall, obs=obs, series=series)


def serve_planner_phase(params, card: str) -> Dict[str, object]:
    """serve-planner (a) and (b) at Llama-3-8B width on serve-kvbm's
    weights: (a) :func:`planner_profile`; (b) a decode pool that the
    planner scales: ``LocalConnector`` over :class:`PoolWorker`\\ s of
    ``POOL_PAGES`` pages each, the observatory's victim source,
    ``drain_timeout_s=5.0``; the planner reads the observatory
    (``fleet_metrics_source``), scales on KV load (up at 0.8, down at 0.3,
    1 to 3 workers, grace 1), excludes its quarantine and notes each
    decision in its plan; its rounds are stepped here.  8 greedy streams
    (400-token prompts, 256 new tokens) open on worker 1; once its snapshot
    shows KV load >= 0.8 a round must scale up (1 -> 2); 8 more, placed
    by ``DefaultWorkerSelector`` over the observatory's metrics, must land
    on worker 2; once every stream ended with its 256 tokens and both
    snapshots show load <= 0.3, a grace round, then a round that must
    scale down (2 -> 1), the victim the observatory names drained before
    it stops.  Held: no refused drain, the planner's counter and pool
    gauge, the JSONL log, the observatory's plan, the launch invariants
    over both engines, every page free on the survivor, and the card's
    allocated memory down by at least the victim's pool.  The SLO
    tracker's attainment (targets from (a)'s table) and each round's
    loads are printed.  Returns the launches of (a) and (b) and their
    seconds."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.runtime import slo

    t0 = time.perf_counter()
    prof, launches = planner_profile(params, card)
    t_a = time.perf_counter() - t0
    cfg = ModelConfig.llama3_8b()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-planner-")
    spec = f"ttft={prof.ttft_ms[512]:.3f}ms,itl={prof.itl_ms[8]:.3f}ms"
    slo.tracker.configure(spec)
    reset_launches()
    try:
        res = asyncio.run(planner_pool(cfg, params, tmp))
        with open(res["log"]) as f:
            logged = [json.loads(line) for line in f.read().splitlines()]
    finally:
        slo.tracker.disable()
        shutil.rmtree(tmp, ignore_errors=True)
    counted = read_launches()
    planner, conn, workers = res["planner"], res["conn"], res["workers"]
    for i, r in enumerate(res["out"]):
        if len(r["tokens"]) != 256 or r["finish"] != "length":
            fail(f"serve-planner: (b) stream {i} on worker {r['worker']}: "
                 f"{len(r['tokens'])} tokens, finish {r['finish']}")
    if len(res["out"]) != 16:
        fail(f"serve-planner: (b) {len(res['out'])} streams ended, not 16")
    made = [(a.kind, a.action, a.count_before) for a in planner.adjustments
            if a.action != "hold"]
    if made != [("decode", "up", 1), ("decode", "down", 2)]:
        fail(f"serve-planner: (b) decisions {made}")
    if conn.forced_kills:
        fail(f"serve-planner: (b) {conn.forced_kills} drains refused")
    for action in ("up", "down"):
        n = res["series"]("dynamo_planner_adjustments", kind="decode", action=action)
        if n - res["base"][action] != 1:
            fail(f"serve-planner: (b) dynamo_planner_adjustments{{decode,{action}}} moved "
                 f"by {n - res['base'][action]}")
    if any(g != n for g, n in res["sizes"]):
        fail(f"serve-planner: (b) pool gauge against the connector's count {res['sizes']}")
    want_log = [{"kind": a.kind, "action": a.action, "reason": a.reason,
                 "count_before": a.count_before, "no_op": False,
                 **({"evidence": a.evidence} if a.evidence is not None else {})}
                for a in planner.adjustments]
    if [{k: v for k, v in rec.items() if k != "ts"} for rec in logged] != want_log:
        fail(f"serve-planner: (b) the JSONL log {logged} is not the decisions {want_log}")
    plan = res["obs"].summary()["plan"].get("decode", {})
    last = [a for a in planner.adjustments if a.action != "hold"][-1]
    if (plan.get("action"), plan.get("reason"), plan.get("count_before")) != (
            last.action, last.reason, last.count_before):
        fail(f"serve-planner: (b) the observatory's plan {plan}, the last decision {last}")
    victim = res["named"][-1] if res["named"] else None
    stopped = [w for w in workers if w not in res["survivors"]]
    if stopped != [victim] or not victim.drained:
        fail(f"serve-planner: (b) stopped {[w.worker_id for w in stopped]}, the observatory "
             f"named {[w.worker_id for w in res['named']]}, drained {victim and victim.drained}")
    want = {k: sum(w.expected[k] for w in workers) for k in counted}
    print(f"serve-planner: (b) launch invariants over {len(workers)} engines: counted "
          f"{counted} expected {want}")
    if counted != want:
        fail(f"serve-planner: (b) launches {counted} differ from the dispatches' {want}")
    for name in ("packed_ragged_attention", "paged_decode_attention"):
        if counted[name] <= 0:
            fail(f"serve-planner: (b) {name} never launched")
    for w in workers:
        if w.pages_held:
            fail(f"serve-planner: (b) worker {w.worker_id}: {w.pages_held} pages still held")
    if res["freed"] < victim.pool_bytes:
        fail(f"serve-planner: (b) stopping worker {victim.worker_id} freed {res['freed']} "
             f"bytes, less than its pool's {victim.pool_bytes}")
    tok = sum(len(r["tokens"]) for r in res["out"])
    print(f"serve-planner: (b) decisions {made}, victim worker {victim.worker_id} (drained), "
          f"forced_kills {conn.forced_kills}, {res['freed'] / 2**30:.3f} GiB freed (its pool "
          f"{victim.pool_bytes / 2**30:.3f} GiB), pool gauge by round "
          f"{[g for g, _ in res['sizes']]}, plan {plan}; 16 streams, {tok} tokens in "
          f"{res['wall']:.3f} s ({tok / res['wall']:.3f} tok/s) on {card}")
    add_launches(launches, counted)
    seconds = time.perf_counter() - t0
    print(f"serve-planner: (a) {t_a:.3f} s, (b) {seconds - t_a:.3f} s")
    return {"launches": launches, "seconds": seconds}


def planner_cli(ckpt, card: str) -> float:
    """serve-planner (c): ``python -m dynamo_tpu_torch profile-sla --out
    torch`` over ``ckpt`` (a 2-layer Llama-3-8B-width checkpoint), then
    ``--out mocker``, each a subprocess with a time limit: exit code 0, one
    JSON object with ``profile`` and ``recommendation``, the recommendation
    the rule applied to the printed table.  Returns its seconds."""
    from types import SimpleNamespace

    t0 = time.perf_counter()
    for out in ("torch", "mocker"):
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch", "profile-sla", "--out", out,
             "--model-path", ckpt[0], "--isl", "128,512", "--batch", "1,4", "--osl", "32"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "DYN_LOG": "warning"},
        )
        if proc.returncode != 0:
            fail(f"serve-planner: (c) profile-sla --out {out} exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        try:
            doc = json.loads(proc.stdout)
        except ValueError:
            fail(f"serve-planner: (c) profile-sla --out {out} printed {proc.stdout[-2000:]!r}")
        if set(doc) != {"profile", "recommendation"}:
            fail(f"serve-planner: (c) profile-sla --out {out} printed keys {sorted(doc)}")
        table = SimpleNamespace(**{k: {int(n): v for n, v in doc["profile"][k].items()}
                                   for k in ("ttft_ms", "itl_ms", "tok_s")})
        want = recommend_rule(table, None, None)
        got = doc["recommendation"]
        if (sorted(table.ttft_ms) != [128, 512] or sorted(table.itl_ms) != [1, 4]
                or {k: got[k] for k in ("max_isl_within_ttft_slo", "max_batch_within_itl_slo")}
                != {k: want[k] for k in ("max_isl_within_ttft_slo", "max_batch_within_itl_slo")}
                or abs(got["throughput_at_max_batch"] - want["throughput_at_max_batch"]) > 0.05):
            fail(f"serve-planner: (c) --out {out}: {doc}, the rule gives {want}")
        print(f"serve-planner: (c) profile-sla --out {out}: {json.dumps(doc)} in "
              f"{time.perf_counter() - t1:.3f} s on {card}")
    return time.perf_counter() - t0


# -- serve-admit: KV-budget admission at router blocks of 4 pages ----------------

# the engine of (b): 16-token pages, 64-token router blocks (4 pages a
# block), 256 pages (512 MiB of Llama-3-8B KV), admission against
# int(255 * 0.9) = 229 predicted pages with a 0.5 s fairness floor
ADMIT_ENGINE = dict(page_size=16, block_size=64, num_pages=256,
                    kv_admit_budget="util=0.9,floor_s=0.5,skips=4")
# (a)'s small f32 model: the same shape of traffic on a pool tight enough
# that admission blocks
ADMIT_SMALL = dict(num_pages=24, mixed_token_budget=32, max_seq_len=256, page_size=16,
                   block_size=64, kv_admit_budget="util=0.9,floor_s=0.5,skips=4")


def admit_requests(vocab: int, short_len=(150, 251), short_new=256, long_len=1900,
                   long_new=64, shared=128) -> Tuple[List[dict], int]:
    """12 shorts (prompts of 150 to 250 tokens that open with one
    ``shared``-token system prompt, 256 new tokens each) and one long
    request (1900 prompt tokens, 64 new) queued after the first six shorts,
    all greedy with top-2 logprobs.  Returns the requests and the long
    one's index."""
    rng = np.random.default_rng(21)
    system = rng.integers(1, vocab, shared)
    shorts = [request(np.concatenate([system, rng.integers(1, vocab, int(n) - shared)]),
                      short_new, logprobs=2)
              for n in rng.integers(*short_len, 12)]
    long = request(rng.integers(1, vocab, long_len), long_new, logprobs=2)
    return shorts[:6] + [long] + shorts[6:], 6


async def admit_serve(engine, rounds: List[List[dict]]) -> List[dict]:
    """Serve each round's requests, enqueued in list order, the rounds one
    after the other; per request: tokens, finish reason, top logprobs,
    TTFT, and its admission (the start of the planning pass that admitted
    it, and its cached prompt tokens), read by wrapping the scheduler's
    planner and admission on this engine."""
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    sched = engine.sched
    admitted: Dict[str, Tuple[float, int, float]] = {}
    pass_t = [0.0]
    plan, try_admit = sched.plan, sched._try_admit

    def timed_plan():
        pass_t[0] = time.monotonic()
        return plan()

    def record(seq, tick_plan, slot):
        ok = try_admit(seq, tick_plan, slot)
        if ok and seq.request_id not in admitted:
            admitted[seq.request_id] = (pass_t[0], seq.cached_prompt_tokens, seq.arrival_s)
        return ok

    sched.plan, sched._try_admit = timed_plan, record

    async def read(ctx, stream, t0) -> dict:
        tokens, top, finish, first = [], [], None, None
        async for item in stream:
            if item.is_error():
                raise RuntimeError(item.error_message())
            data = item.data or {}
            got = data.get("token_ids") or []
            if got and first is None:
                first = time.perf_counter()
            tokens += got
            top += data.get("top_logprobs") or []
            finish = data.get("finish_reason") or finish
        return dict(id=ctx.id, tokens=tokens, top=top, finish=finish,
                    ttft=first - t0 if first else float("nan"), end=time.perf_counter())

    out: List[dict] = []
    try:
        for reqs in rounds:
            t0 = time.perf_counter()
            started = []
            for r in reqs:  # enqueued in order: generate() enqueues before it yields
                ctx = Context.new(PreprocessedRequest.from_dict(r))
                started.append((ctx, await engine.generate(ctx)))
            res = await asyncio.gather(*[read(c, s, t0) for c, s in started])
            wall = max(r["end"] for r in res) - t0
            for r in res:
                r["wall"] = wall
                r["admit_t"], r["cached"], r["arrival"] = admitted.get(r["id"], (None,) * 3)
            out.append(res)
    finally:
        await engine.stop()
    return out


def admit_order_check(what: str, res: List[dict], long_i: int, floor_s: float) -> None:
    """The long request admits; no short queued behind it is admitted by a
    planning pass that began after it aged past ``floor_s`` and before the
    pass that admitted it."""
    long = res[long_i]
    if long["admit_t"] is None:
        fail(f"{what}: the long request was never admitted")
    arrival = long["arrival"]
    aged = arrival + floor_s
    jumped = [i for i, r in enumerate(res[long_i + 1:], long_i + 1)
              if r["admit_t"] is not None and aged < r["admit_t"] < long["admit_t"]]
    if jumped:
        fail(f"{what}: shorts {jumped} admitted past the aged long request "
             f"(aged at +{floor_s} s, admitted at +{long['admit_t'] - arrival:.3f} s)")


def admit_small(ref: Dict[str, object], card: str) -> None:
    """(a) The small f32 model, card against CPU, at router blocks of 4
    pages: the admission batch with KV-budget admission on and off, in the
    pipelined and the serial loop, gives the CPU's greedy streams (the CPU
    serves it serially with admission off)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg, params = ref["cfg"], ref["params"]
    reqs, long_i = admit_requests(cfg.vocab_size, short_len=(70, 91), short_new=48,
                                  long_len=160, long_new=16, shared=64)

    def run(dev, budget, async_dispatch):
        kw = dict(ADMIT_SMALL, kv_admit_budget=budget, async_dispatch=async_dispatch)
        eng = TorchEngine(cfg, params_on(params, dev), EngineConfig(**kw), device=dev)
        res = asyncio.run(admit_serve(eng, [reqs]))[0]
        return [r["tokens"] for r in res], eng.sched.admit_blocked

    want, _ = run("cpu", None, False)
    if [len(t) for t in want] != [r["stop_conditions"]["max_tokens"] for r in reqs]:
        fail("serve-admit (a): the CPU's streams end early")
    blocked = {}
    for budget in (ADMIT_SMALL["kv_admit_budget"], None):
        for async_dispatch in (True, False):
            got, blocked[(budget, async_dispatch)] = run("cuda", budget, async_dispatch)
            if got != want:
                fail(f"serve-admit (a) admission {budget} async={async_dispatch}: card "
                     f"streams {got} differ from the CPU's {want}")
    armed = [n for (b, _a), n in blocked.items() if b is not None]
    if min(armed) < 1:
        fail(f"serve-admit (a): admission never blocked the head ({blocked})")
    print(f"serve-admit: (a) small f32 model at block 64 = 4 pages: {len(reqs)} greedy "
          f"streams == CPU with admission on and off, pipelined and serial; head blocked "
          f"{armed} times on {card}")


def admit_divergence(run: List[dict], twin: List[dict]) -> str:
    """Streams equal to the admission-off twin's, and at each first
    divergence the top-2 logprob gaps of both runs, which must include one
    within one bf16 step at the logits' magnitude (``onboard_agreement``)."""
    same, notes = 0, []
    step = bf16_step(4.85)
    for i, (a, b) in enumerate(zip(run, twin)):
        if a["tokens"] == b["tokens"]:
            same += 1
            continue
        j = next((j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y),
                 min(len(a["tokens"]), len(b["tokens"])))
        gaps = []
        for r in (a, b):
            t = r["top"][j] if j < len(r["top"]) else None
            if not t or len(t) < 2:
                fail(f"serve-admit (b): stream {i} has no top-2 logprobs at token {j}")
            gaps.append(t[0][1] - t[1][1])
        if min(gaps) > step:
            fail(f"serve-admit (b): stream {i} leaves the admission-off twin at token {j} "
                 f"with top-2 gaps {gaps}, above one bf16 step {step}")
        notes.append(f"stream {i} token {j} gaps {round(gaps[0], 5)}/{round(gaps[1], 5)} "
                     f"({min(gaps) / step:.1f} steps)")
    return f"{same} of {len(twin)} streams equal the twin's; first divergences: {notes or 'none'}"


def serve_admit_phase(ref: Dict[str, object], params, card: str) -> Dict[str, int]:
    """serve-admit: KV-budget admission at router blocks of 4 pages.  (a)
    :func:`admit_small`; (b) Llama-3-8B at full width and depth on
    serve-kvbm's bf16 weights, ``ADMIT_ENGINE``, pipelined and packed: the
    admission batch (:func:`admit_requests`), cold and then warm on the
    same engine.  Every request ends at its ``max_tokens``; the long
    request is blocked, shorts pass it, and once it ages none passes it
    until it admits; the launch invariants of kernels 5 and 1 are exact;
    KV events come in 64-token blocks of 4 pages; the warm round's prompts
    reuse whole blocks; no page is held after.  The same batch with
    admission off is reported against it (first divergences within one
    bf16 step of the top-2 logprobs).  Returns (b)'s launches."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.scheduler import parse_kv_admit_spec
    from dynamo_tpu_torch.tokens.hashing import hash_blocks

    t0 = time.perf_counter()
    admit_small(ref, card)
    cfg = ModelConfig.llama3_8b()
    reqs, long_i = admit_requests(cfg.vocab_size)
    floor_s = parse_kv_admit_spec(ADMIT_ENGINE["kv_admit_budget"]).floor_s
    torch.cuda.reset_peak_memory_stats()
    engine = TorchEngine(cfg, params, EngineConfig(**ADMIT_ENGINE))
    events: List[dict] = []
    engine.kv_event_sink = events.append
    reset_launches()
    t1 = time.perf_counter()
    cold, warm = asyncio.run(admit_serve(engine, [reqs, reqs]))
    counted = read_launches()
    check_launch_invariants("serve-admit (b)", engine, counted)
    for name in ("packed_ragged_attention", "paged_decode_attention"):
        if counted[name] <= 0:
            fail(f"serve-admit (b): {name} never launched")
    peak = torch.cuda.max_memory_allocated() / 2**30
    sched = engine.sched
    skips, blocked = sched.admit_skips, sched.admit_blocked
    held = engine.kv.allocator.used_pages
    ppb = engine.kv.allocator.pages_per_block
    for what, res in (("cold", cold), ("warm", warm)):
        for i, (r, q) in enumerate(zip(res, reqs)):
            want = q["stop_conditions"]["max_tokens"]
            if len(r["tokens"]) != want or r["finish"] != "length":
                fail(f"serve-admit (b) {what} request {i}: {len(r['tokens'])} tokens of "
                     f"{want}, finish {r['finish']}")
            if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
                fail(f"serve-admit (b) {what} request {i}: token out of range")
    if blocked < 1 or skips < 1:
        fail(f"serve-admit (b): admit_blocked {blocked}, admit_skips {skips}")
    admit_order_check("serve-admit (b) cold", cold, long_i, floor_s)
    stored = {b["sequence_hash"] for e in events if e["type"] == "stored" for b in e["blocks"]}
    for i, q in enumerate(reqs):
        want = set(hash_blocks(q["token_ids"], 64)[1])
        if not want <= stored:
            fail(f"serve-admit (b): request {i}'s 64-token blocks are not all in the KV "
                 f"events ({len(want - stored)} of {len(want)} missing)")
    if ppb != 4 or sched.block_size != 64:
        fail(f"serve-admit (b): {ppb} pages a block of {sched.block_size} tokens")
    # the warm round's shorts reuse at least the system prompt's two blocks
    cached = [r["cached"] for r in warm]
    if any(c is None or c % 64 for c in cached) or min(
            c for i, c in enumerate(cached) if i != long_i) < 128:
        fail(f"serve-admit (b): the warm round's cached prompt tokens {cached}")
    if held:
        fail(f"serve-admit (b): {held} pages still held after the phase")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    twin_engine = TorchEngine(cfg, params, EngineConfig(**dict(ADMIT_ENGINE, kv_admit_budget=None)))
    twin = asyncio.run(admit_serve(twin_engine, [reqs]))[0]
    del twin_engine
    gc.collect()
    torch.cuda.empty_cache()
    agreement = admit_divergence(cold, twin)

    def tok_s(res):
        return sum(len(r["tokens"]) for r in res) / res[0]["wall"]

    def ttft(res, idx):
        return [round(res[i]["ttft"] * 1e3, 3) for i in idx]

    shorts = [i for i in range(len(reqs)) if i != long_i]
    long_wait = cold[long_i]["admit_t"] - cold[long_i]["arrival"]
    print(f"serve-admit: (b) Llama-3-8B bf16, block 64 = {ppb} pages, {sched.allocator.num_pages}"
          f" pages, budget {ADMIT_ENGINE['kv_admit_budget']}: admit_skips={skips} "
          f"admit_blocked={blocked}; the long request admitted after {long_wait:.3f} s; "
          f"cold tok_s={tok_s(cold):.3f} warm tok_s={tok_s(warm):.3f}; TTFT ms long "
          f"cold {ttft(cold, [long_i])} warm {ttft(warm, [long_i])}, shorts cold "
          f"{ttft(cold, shorts)} warm {ttft(warm, shorts)}; warm cached prompt tokens "
          f"{cached}; {len(stored)} 64-token blocks stored; peak_mem_gib={peak:.3f}; "
          f"{time.perf_counter() - t1:.3f} s on {card}")
    print(f"serve-admit: (b) against admission off: {agreement}")
    print(f"serve-admit: launches of kernels 5 and 1 {{'packed_ragged_attention': "
          f"{counted['packed_ragged_attention']}, 'paged_decode_attention': "
          f"{counted['paged_decode_attention']}}}; phase {time.perf_counter() - t0:.3f} s "
          f"on {card}")
    return counted


def serve_kvbm_phase(ref: Dict[str, object], served: Dict[str, object], card: str
                     ) -> Dict[str, object]:
    """serve-kvbm: (a) ``kvbm_reference``, then at Llama-3-8B width from
    random bf16 weights of seed 0: (b) ``kvbm_tiers``, (c) ``kvbm_swap``,
    (d) ``kvbm_int8``; then serve-chaos, serve-planner (a) and (b) and
    serve-admit on the same weights.  Returns serve-planner's launches and
    seconds, and serve-admit's launches under ``admit``."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model import init_params

    kvbm_reference(ref)
    cfg = ModelConfig.llama3_8b()
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    kvbm_tiers(params, card)
    kvbm_swap(params, card)
    kvbm_int8(params, card)
    serve_chaos_phase(params, served, card)
    planner = serve_planner_phase(params, card)
    planner["admit"] = serve_admit_phase(ref, params, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return planner


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


# the checkpoint phases' config.json: Llama-3-8B's widths, 2 layers
CKPT_CONFIG = {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
               "intermediate_size": 14336, "num_hidden_layers": 2,
               "num_attention_heads": 32, "num_key_value_heads": 8,
               "rope_theta": 500000.0, "max_position_embeddings": 8192,
               "rms_norm_eps": 1e-5}


def write_cli_checkpoint(tmp: str, what: str):
    """A checkpoint directory at Llama-3-8B width with 2 layers
    (``config.json``, ``model.safetensors`` from this script's writer, a
    byte-level tokenizer of 128256 ids), random bf16 weights of seed 5;
    returns its path, config, the weights as numpy arrays and the
    tokenizer."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    path = os.path.join(tmp, "ckpt")
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(CKPT_CONFIG, f)
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
    print(f"{what} weights made in {t1 - t0:.3f} s, model.safetensors "
          f"{size / 2**30:.3f} GiB written in {time.perf_counter() - t1:.3f} s")
    return path, cfg, arrays, Tokenizer.from_model_dir(path)


def cli_requests() -> Tuple[List[dict], dict]:
    """The checkpoint phases' greedy requests: three token-id completions
    and one chat."""
    rng = np.random.default_rng(5)
    reqs = [request(rng.integers(1, 128000, n), 16) for n in (5, 40, 300)]
    chat = {"model": "ckpt", "max_tokens": 16,
            "messages": [{"role": "user", "content": "Hello from the port! Ça va?"}]}
    return reqs, chat


async def ask_texts(port: int, what: str, requests=None) -> List[str]:
    """``requests`` (token-id completions and a chat; ``cli_requests()``
    by default) one at a time against the front end on ``port``; returns
    the texts."""
    from dynamo_tpu_torch.bench_serving import run_bench

    reqs, chat = requests or cli_requests()
    out = []
    for req in reqs:
        rep = await run_bench("127.0.0.1", port, chat["model"], bench_items([req]),
                              concurrency=1, stream=False)
        check_http_results(what, [rep], [[req]])
        out.append(rep.results[0].text)
    status, body = await http_call(port, "POST", "/v1/chat/completions", chat)
    if status != 200:
        fail(f"{what}: chat answered {status}: {body[:300]!r}")
    doc = json.loads(body)
    out.append(doc["choices"][0]["message"]["content"])
    return out


def in_process_texts(cfg, arrays, tok, what: str) -> List[str]:
    """``cli_requests()`` through an in-process engine built from the
    checkpoint's numpy arrays (``params_from_numpy``) behind the HTTP
    service, launch invariants held."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.pipeline import link

    engine = TorchEngine(cfg, params_from_numpy(arrays, cfg, device="cuda"), EngineConfig())

    async def serve_in_process() -> List[str]:
        pipe = link(OpenAIPreprocessor("ckpt", tok), Backend(tok), engine)
        manager = ModelManager()
        manager.add_completion_model("ckpt", pipe)
        manager.add_chat_model("ckpt", pipe)
        service = HttpService(manager, port=0)
        await service.start()
        try:
            return await ask_texts(service.address[1], what)
        finally:
            await service.stop()
            await engine.stop()

    reset_launches()
    texts = asyncio.run(serve_in_process())
    check_launch_invariants(f"{what} in process", engine, read_launches())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return texts


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Proc:
    """A ``python -m dynamo_tpu_torch`` subprocess with its output in a log
    file.  ``running`` holds those not yet ended, whose logs ``fail``
    prints."""

    running: List["Proc"] = []

    def __init__(self, tmp: str, name: str, *args: str, env=None) -> None:
        self.name = name
        self.log_path = os.path.join(tmp, f"{name}.log")
        with open(self.log_path, "w") as log_file:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch", *args],
                cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT, text=True,
                env=None if env is None else {**os.environ, **env},
            )
        Proc.running.append(self)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def check_alive(self) -> None:
        if self.proc.poll() is not None:
            fail(f"{self.name} exited with {self.proc.returncode}: {self.log()[-3000:]}")

    def interrupt(self, what: str) -> None:
        """SIGINT, which must end it with exit code 0 within 120 s."""
        import signal

        self.proc.send_signal(signal.SIGINT)
        self.proc.wait(timeout=120)
        Proc.running.remove(self)
        if self.proc.returncode != 0:
            fail(f"{what}: {self.name} exited with {self.proc.returncode} on SIGINT: "
                 f"{self.log()[-3000:]}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self in Proc.running:
            Proc.running.remove(self)


def wait_http(port: int, path: str, ready: Callable[[bytes], bool], procs: List["Proc"],
              what: str, limit_s: float = 300.0) -> float:
    """Poll ``GET path`` on ``port`` until ``ready(body)``; fails when a
    process exits first or after ``limit_s``.  Returns the seconds taken."""
    t0 = time.perf_counter()
    while True:
        for p in procs:
            p.check_alive()
        if time.perf_counter() - t0 > limit_s:
            fail(f"{what}: {path} not ready within {limit_s:.0f} s")
        try:
            status, body = asyncio.run(http_call(port, "GET", path))
            if status == 200 and ready(body):
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.25)


def cli_phase(tmp: str, card: str) -> Tuple[List[str], List[str]]:
    """Write a checkpoint at Llama-3-8B width with 2 layers, serve it with
    ``python -m dynamo_tpu_torch run in=http out=torch`` in a subprocess
    (SIGINT must end it with exit code 0) and with an in-process engine
    built from the same numpy arrays through ``params_from_numpy``, the
    same greedy requests one at a time; returns both sets of texts."""
    path, cfg, arrays, tok = write_cli_checkpoint(tmp, "serve-http: (c)")
    port = free_port()
    cli = Proc(tmp, "cli", "run", "in=http", "out=torch", "--model-path", path,
               "--port", str(port))
    try:
        up = wait_http(port, "/health", lambda body: True, [cli], "serve-http (c)")
        cli_texts = asyncio.run(ask_texts(port, "serve-http (c)"))
        prof_cli(tmp, port, card)
        cli.interrupt("serve-http (c)")
        print(f"serve-http: (c) CLI healthy after {up:.3f} s, exit code {cli.proc.returncode}; "
              f"its output: {cli.log().strip().splitlines()[:3]}")
    finally:
        cli.kill()
    direct_texts = in_process_texts(cfg, arrays, tok, "serve-http (c)")
    return cli_texts, direct_texts


# -- serve-dyn: the distributed runtime ------------------------------------------


class DynCluster:
    """A loopback ``HubServer``, one worker per engine -- each on its own
    ``DistributedRuntime``, set up as ``run in=dyn out=torch`` sets it up
    (``cli.serve_worker``: the generate and embed endpoints, the KV event
    and load-metrics publishers, the model's registration) -- and the front
    end of ``run in=http out=dyn`` (``ModelWatcher`` over ``HttpService``)
    with ``--router-mode``'s pipeline: the KV router's factory for ``kv``,
    else ``PushRouter`` in that mode, and the front end's fleet observatory
    (``observatory``: the router's quarantine and link prices, ``/fleet``),
    fed by the telemetry snapshots :meth:`publish_telemetry` sends over the
    hub.  The front end's runtime also subscribes to the router's hit-rate
    events."""

    async def start(self, engines, model_dir: str, router_mode: str, lease_ttl=None):
        from dynamo_tpu_torch.cli import kv_engine_factory
        from dynamo_tpu_torch.fleet import FleetObservatory
        from dynamo_tpu_torch.http.service import HttpService, ModelManager
        from dynamo_tpu_torch.llm.discovery import ModelWatcher
        from dynamo_tpu_torch.runtime.component import DistributedRuntime, RouterMode
        from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
        from dynamo_tpu_torch.runtime.transports.hub import HubServer

        self.engines = []
        self.hub = HubServer(host="127.0.0.1")
        host, port = await self.hub.start()
        self.addr = f"{host}:{port}"
        self.model_dir = model_dir
        # serve-onboard's workers move bulk KV on this one loop: leases of
        # LEASE_TTL_S outlast a loop kept busy (as serve-disagg's do)
        self.lease_ttl = lease_ttl
        self.workers, self.pubs, self.telemetry = [], [], {}
        for engine in engines:
            await self.add(engine)
        addr = self.addr
        self.front = await DistributedRuntime.detached(addr)
        self.manager = ModelManager()
        self.factory = None
        self.observatory = FleetObservatory(MetricsRegistry())
        if router_mode == "kv":
            self.factory = kv_engine_factory(self.front, observatory=self.observatory)
            self.watcher = ModelWatcher(self.front, self.manager, engine_factory=self.factory)
        else:
            self.watcher = ModelWatcher(self.front, self.manager,
                                        router_mode=RouterMode(router_mode))
        await self.watcher.start()
        await self.observatory.start(self.front.namespace("dynamo"))
        self.hit_rate = await self.front.namespace("dynamo").subscribe("kv-hit-rate")
        self.service = HttpService(self.manager, port=0, observatory=self.observatory)
        await self.service.start()
        self.port = self.service.address[1]
        t0 = time.perf_counter()
        while not self.manager.list_models() or (
            self.factory is not None
            and len(self.factory.choosers["m"].scheduler.workers.endpoints) < len(engines)
        ):
            if time.perf_counter() - t0 > 60:
                fail("serve-dyn: the model or its workers' load metrics never reached "
                     "the front end")
            await asyncio.sleep(0.05)
        return self

    async def add(self, engine) -> None:
        """One more worker, set up as ``run in=dyn out=torch`` sets it up
        (``cli.serve_worker``); ``pubs`` holds its ``ServedWorker``."""
        from dynamo_tpu_torch.cli import serve_worker
        from dynamo_tpu_torch.runtime.component import DistributedRuntime

        kw = {} if self.lease_ttl is None else {"lease_ttl": self.lease_ttl}
        rt = await DistributedRuntime.detached(self.addr, **kw)
        _, pub = await serve_worker(rt, engine, "dyn://dynamo.backend.generate",
                                    self.model_dir, "m")
        self.engines.append(engine)
        self.workers.append(rt)
        self.pubs.append(pub)

    async def leave(self, i: int) -> None:
        """Worker ``i`` leaves as a worker process stopping does: its
        publishers close, its engine stops, its runtime shuts down (its
        leases revoked)."""
        await self.pubs[i].close()
        await self.engines[i].stop()
        await self.workers[i].shutdown()
        self.pubs[i] = self.engines[i] = self.workers[i] = None

    async def publish_telemetry(self, i: int, role: str = "worker"):
        """Worker ``i``'s next telemetry snapshot (``run in=dyn``'s
        publisher: the process-wide transfer log drains into it) over the
        hub, once the front end's observatory has ingested it; returns the
        snapshot as the wire decodes it."""
        from dynamo_tpu_torch.runtime.telemetry import TelemetryPublisher, TelemetrySnapshot

        rt = self.workers[i]
        pub = self.telemetry.get(i)
        if pub is None:
            pub = self.telemetry[i] = TelemetryPublisher(
                rt.namespace("dynamo"), worker_id=rt.primary_lease, role=role)
        count = self.observatory.metrics.registry.sample
        seen = count("dynamo_fleet_snapshots") or 0.0
        snap = await pub.publish_once()
        t0 = time.perf_counter()
        while (count("dynamo_fleet_snapshots") or 0.0) <= seen:
            if time.perf_counter() - t0 > 30:
                fail(f"the front end's observatory never ingested worker {i}'s snapshot")
            await asyncio.sleep(0.01)
        return TelemetrySnapshot.decode(snap.encode())

    def requests_per_worker(self) -> List[int]:
        """Requests each worker's generate endpoint took."""
        return [rt.endpoint_stats["dynamo/backend/generate"].requests for rt in self.workers]

    async def hit_rate_events(self, n: int) -> List[dict]:
        return [json.loads((await asyncio.wait_for(self.hit_rate.next(), 30))[1])
                for _ in range(n)]

    async def stop(self) -> None:
        await self.hit_rate.close()
        await self.service.stop()
        await self.observatory.stop()
        await self.watcher.stop()
        await self.front.shutdown()
        for pub, engine, rt in zip(self.pubs, self.engines, self.workers):
            if rt is None:
                continue  # left already
            await pub.close()
            await engine.stop()
            await rt.shutdown()
        await self.hub.stop()


def dyn_reference(ref: Dict[str, object], tmp: str) -> None:
    """serve-dyn (a): the reference phase's f32 model as one worker on the
    card behind the KV-routed front end: its greedy ``/v1/completions``
    texts equal the reference phase's direct streams decoded (the CPU's),
    and ``/v1/embeddings`` through the distributed leg equals the worker
    engine's in-process ``embed`` within ``EMBED_TOL``."""
    from dynamo_tpu_torch.bench_serving import run_bench
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    cfg, params, batches = ref["cfg"], ref["params"], ref["batches"]
    tok_dir = os.path.join(tmp, "bytes")
    os.makedirs(tok_dir)
    write_tokenizer(tok_dir, cfg.vocab_size, 0)
    tok = Tokenizer.from_model_dir(tok_dir)
    want = [stream_text(tok, t) for t in ref["streams"]]
    eng = TorchEngine(cfg, params_on(params, "cuda"), EngineConfig(**ref["ecfg"]), device="cuda")
    embed_inputs = [r["token_ids"] for r in batches[0]]

    async def body():
        cluster = await DynCluster().start([eng], tok_dir, "kv")
        try:
            texts = []
            for batch in batches:
                rep = await run_bench("127.0.0.1", cluster.port, "m", bench_items(batch),
                                      concurrency=len(batch), stream=True)
                check_http_results("serve-dyn (a)", [rep], [batch])
                texts += [r.text for r in rep.results]
            status, raw = await http_call(cluster.port, "POST", "/v1/embeddings",
                                          {"model": "m", "input": embed_inputs})
            if status != 200:
                fail(f"serve-dyn (a): /v1/embeddings answered {status}: {raw[:300]!r}")
            served_vecs = [d["embedding"] for d in json.loads(raw)["data"]]
            direct = await eng.embed(embed_inputs)
            return texts, served_vecs, direct
        finally:
            await cluster.stop()

    reset_launches()
    texts, served_vecs, direct = asyncio.run(body())
    check_launch_invariants("serve-dyn (a)", eng, read_launches())
    if texts != want:
        fail(f"serve-dyn (a): texts {texts} differ from the decoded direct streams {want}")
    err = float(np.abs(np.array(served_vecs) - np.array(direct)).max())
    if not err <= EMBED_TOL:
        fail(f"serve-dyn (a): distributed embeddings differ from embed() by {err}")
    print(f"serve-dyn: (a) {len(texts)} requests through hub, KV router and worker on the "
          f"card: texts == decoded direct CPU streams; {len(direct)} embeddings through "
          f"the distributed leg within {err:.3e} of embed()")


def dyn_requests(vocab: int, per_prefix: int = 4, block: int = 16) -> List[Tuple[int, dict]]:
    """(prefix index, request): 4 distinct 1024-token prefixes (64 blocks of
    16, or 16 of 64), ``per_prefix`` requests each with suffixes of 1 to 16
    blocks -- each request a distinct length in blocks, which names it in
    the router's hit-rate events --, 32 new tokens, greedy."""
    rng = np.random.default_rng(12)
    prefixes = [rng.integers(1, vocab, 1024) for _ in range(4)]
    n = 4 * per_prefix
    lengths = rng.permutation(np.arange(1, n + 1) * block)
    # round 1 takes prefixes 0 to 3 in order; round 2's order is shuffled,
    # so that round robin does not happen to follow round 1's placement
    order = list(range(4)) + (4 + rng.permutation(n - 4)).tolist()
    out = []
    for k, n in zip(order, lengths):
        p = k % 4
        out.append((p, request(np.concatenate([prefixes[p], rng.integers(1, vocab, n)]), 32)))
    return out


def dyn_full_width(mode: str, tok_dir: str, card: str, block_size: Optional[int] = None,
                   per_prefix: int = 4) -> Dict[str, object]:
    """serve-dyn (b) under one router mode: two fresh Llama-3-8B workers
    (router blocks of ``block_size`` tokens, default their 16-token pages),
    round 1 (one request per prefix), then -- once, under ``kv``, the
    router's index holds round 1's prefix blocks -- round 2 (the other
    requests).  Returns the routing, hit and launch numbers, and the block
    size the model card names (the router's)."""
    from dynamo_tpu_torch.bench_serving import run_bench
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.tokens.hashing import hash_blocks

    cfg = ModelConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    engines = [TorchEngine.random_init(cfg, EngineConfig(num_pages=1024, block_size=block_size),
                                       seed=0)
               for _ in range(2)]
    block = engines[0].sched.block_size
    traffic = dyn_requests(cfg.vocab_size, per_prefix, block)
    rounds = [traffic[:4], traffic[4:]]
    out: Dict[str, object] = {}

    async def body():
        cluster = await DynCluster().start(engines, tok_dir, mode)
        try:
            reports, events = [], []
            t0 = time.perf_counter()
            for i, rnd in enumerate(rounds):
                if i == 1 and mode == "kv":
                    # round 2 goes once the index holds every prefix block
                    index = cluster.factory.choosers["m"].indexer
                    hashes = [hash_blocks(r["token_ids"][:1024], block)[1] for _, r in rnd]
                    t1 = time.perf_counter()
                    while min(max(index.find_matches(h).scores.values(), default=0)
                              for h in hashes) < 1024 // block:
                        if time.perf_counter() - t1 > 30:
                            fail("serve-dyn (b): round 1's prefix blocks never reached "
                                 "the router's index")
                        await asyncio.sleep(0.02)
                    out["index_wait_s"] = time.perf_counter() - t1
                hits_before = [e._prefix_hits for e in engines]
                per_worker_before = cluster.requests_per_worker()
                graphs_before = [(e.graph_captures, e.graphs.capture_ms) for e in engines]
                batch = [r for _, r in rnd]
                reports.append(await run_bench("127.0.0.1", cluster.port, "m",
                                               bench_items(batch), concurrency=len(batch),
                                               stream=True))
                out[f"hits_{i}"] = [e._prefix_hits - h for e, h in zip(engines, hits_before)]
                out[f"routed_{i}"] = [a - b for a, b in zip(cluster.requests_per_worker(),
                                                            per_worker_before)]
                # graphs captured during the round (new decode shapes), and
                # the host ms the captures took with their eager warm-ups
                out[f"captures_{i}"] = [
                    (e.graph_captures - n, round(e.graphs.capture_ms - ms, 3))
                    for e, (n, ms) in zip(engines, graphs_before)
                ]
                if mode == "kv":
                    events.append(await cluster.hit_rate_events(len(rnd)))
            out["wall_s"] = time.perf_counter() - t0
            out["leases"] = [rt.primary_lease for rt in cluster.workers]
            if mode == "kv":
                out["card_block"] = cluster.factory.choosers["m"].block_size
            return reports, events
        finally:
            await cluster.stop()

    reset_launches()
    reports, events = asyncio.run(body())
    out["launches"] = check_launches_over(f"serve-dyn (b) {mode}", engines, read_launches())
    for i, (rep, rnd) in enumerate(zip(reports, rounds)):
        check_http_results(f"serve-dyn (b) {mode} round {i + 1}", [rep], [[r for _, r in rnd]])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["reports"] = reports
    out["events"] = events
    out["rounds"] = rounds
    out["block"] = block
    out["dispatches"] = [dict(e.dispatches) for e in engines]
    out["loops"] = [loop_line(e, out["wall_s"]) for e in engines]
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_launches_over(what: str, engines, counted: Dict[str, int],
                        required=("packed_ragged_attention", "paged_decode_attention"),
                        ) -> Dict[str, int]:
    """The launch invariants of engines that served in one process: the
    process-wide counts equal the sum of what each engine's dispatches
    imply, and the ``required`` kernels (5 and 1) launched."""
    want = {k: sum(expected_launches(e)[k] for e in engines) for k in counted}
    print(f"{what} launch invariants over {len(engines)} engines: counted {counted} "
          f"expected {want}")
    if counted != want:
        fail(f"{what}: launches {counted} differ from the dispatches' {want}")
    for name in required:
        if counted[name] <= 0:
            fail(f"{what}: {name} never launched")
    return counted


def dyn_check_kv(res: Dict[str, object]) -> int:
    """Under ``kv`` the model card names the engines' block size, every
    round-2 request went to the worker that served its prefix in round 1,
    with at least the prefix's 1024 tokens in overlap blocks routed (64 of
    16, 16 of 64), and that worker's engine counted at least 1024 cached
    prompt tokens for each.  Returns the round-2 prefix-hit blocks."""
    block, rounds, events = res["block"], res["rounds"], res["events"]
    leases = res["leases"]
    if res["card_block"] != block:
        fail(f"serve-dyn (b) kv: the card's kv_block_size {res['card_block']}, the engines' "
             f"{block}")

    def by_isl(evs, rnd) -> List[Tuple[int, dict]]:
        """(prefix, the request's hit-rate event): a request's length in
        blocks names its event."""
        out = []
        for p, r in rnd:
            isl = -(-len(r["token_ids"]) // block)
            match = [e for e in evs if e["isl_blocks"] == isl]
            if len(match) != 1:
                fail(f"serve-dyn (b) kv: {len(match)} hit-rate events of {isl} blocks")
            out.append((p, match[0]))
        return out

    holder = {p: ev["worker_id"] for p, ev in by_isl(events[0], rounds[0])}
    if sorted(holder) != [0, 1, 2, 3]:
        fail(f"serve-dyn (b) kv: round 1 holders {holder}")
    routed = [0, 0]
    for p, ev in by_isl(events[1], rounds[1]):
        if ev["worker_id"] != holder[p] or ev["overlap_blocks"] < 1024 // block:
            fail(f"serve-dyn (b) kv: a round-2 request of prefix {p} went to "
                 f"{ev['worker_id']:x} with {ev['overlap_blocks']} overlap blocks; its "
                 f"prefix's holder is {holder[p]:x}")
        routed[leases.index(ev["worker_id"])] += 1
    if routed != res["routed_1"]:
        fail(f"serve-dyn (b) kv: the router's round-2 picks {routed} differ from what the "
             f"workers took {res['routed_1']}")
    for w, (n, hits) in enumerate(zip(routed, res["hits_1"])):
        if hits < 1024 * n:
            fail(f"serve-dyn (b) kv: worker {w} counted {hits} cached prompt tokens for "
                 f"{n} round-2 requests, under 1024 each")
    return sum(res["hits_1"]) // block


def dyn_line(mode: str, res: Dict[str, object], card: str) -> str:
    """One router mode's numbers: requests per worker, round 2's prefix-hit
    blocks, client TTFT p50/p99 by round (round 1 on cold engines: their
    graphs are captured as it runs), ``tok_s`` and peak GiB."""
    ttft = []
    toks = 0
    for rep in res["reports"]:
        lat = [r.ttft_s * 1e3 for r in rep.results]
        ttft.append(f"{np.percentile(lat, 50):.3f}/{np.percentile(lat, 99):.3f}")
        toks += sum(r.usage["completion_tokens"] for r in rep.results)
    per_worker = [a + b for a, b in zip(res["routed_0"], res["routed_1"])]
    return (f"serve-dyn: (b) {mode} block={res['block']} requests_per_worker={per_worker} "
            f"round2_per_worker={res['routed_1']} round2_prefix_hit_blocks="
            f"{sum(res['hits_1']) // res['block']} ttft_p50/p99_ms round1={ttft[0]} "
            f"round2={ttft[1]} tok_s={toks / res['wall_s']:.3f} wall_s={res['wall_s']:.3f} "
            f"peak_gib={res['peak_gib']:.3f} on {card}")


def dyn_cli(tmp: str, card: str, ckpt) -> List[str]:
    """serve-dyn (c): ``hub``, ``run in=dyn out=torch`` and ``run in=http
    out=dyn --router-mode kv`` as three processes over ``ckpt``, a 2-layer
    Llama-3-8B-width checkpoint (``write_cli_checkpoint``'s): their texts
    equal an in-process engine's from the same arrays, ``llmctl list``
    names the model with one instance, and SIGINT ends each process with
    exit code 0.  Returns the in-process texts."""
    path, cfg, arrays, tok = ckpt
    hub_port, http_port = free_port(), free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    procs = []
    try:
        procs.append(Proc(tmp, "hub", "hub", "--host", "127.0.0.1", "--port", str(hub_port)))
        procs.append(Proc(tmp, "worker", "run", "in=dyn", "out=torch", "--model-path", path,
                          "--hub", hub_addr))
        procs.append(Proc(tmp, "frontend", "run", "in=http", "out=dyn", "--hub", hub_addr,
                          "--router-mode", "kv", "--port", str(http_port)))
        up = wait_http(http_port, "/v1/models", lambda b: bool(json.loads(b)["data"]), procs,
                       "serve-dyn (c)")
        texts = asyncio.run(ask_texts(http_port, "serve-dyn (c)"))
        ctl = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch", "llmctl", "--hub", hub_addr, "list"],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
        )
        if ctl.returncode != 0 or not ctl.stdout.startswith(
            "ckpt  instances=1  endpoint=dyn://dynamo.backend.generate"
        ):
            fail(f"serve-dyn (c): llmctl list answered {ctl.returncode}: {ctl.stdout!r} "
                 f"{ctl.stderr[-2000:]!r}")
        for p in reversed(procs):
            p.interrupt("serve-dyn (c)")
        print(f"serve-dyn: (c) hub, worker and front end served after {up:.3f} s; "
              f"llmctl: {ctl.stdout.strip()!r}; exit codes "
              f"{[p.proc.returncode for p in procs]} on SIGINT")
    finally:
        for p in procs:
            p.kill()
    direct = in_process_texts(cfg, arrays, tok, "serve-dyn (c)")
    if texts != direct:
        fail(f"serve-dyn (c): the processes' texts {texts} differ from the in-process "
             f"engine's {direct}")
    print(f"serve-dyn: (c) {len(texts)} requests: hub + worker + front end texts == "
          f"in-process texts")
    return direct


def serve_dyn_phase(ref: Dict[str, object], card: str, ckpt) -> List[str]:
    """The distributed runtime: (a) card against CPU, (b) two full-width
    workers behind the KV router and then round robin, (c) the CLI's three
    processes over ``ckpt``.  The temporary directory is deleted
    afterwards.  Returns (c)'s in-process texts."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-dyn-")
    try:
        t0 = time.perf_counter()
        dyn_reference(ref, tmp)
        tok_dir = os.path.join(tmp, "llama3")
        os.makedirs(tok_dir)
        write_tokenizer(tok_dir, 128000, 256)
        kv = dyn_full_width("kv", tok_dir, card)
        hit_blocks = dyn_check_kv(kv)
        print(f"serve-dyn: (b) kv: every round-2 request went to its prefix's holder with "
              f">= 64 overlap blocks; the router's index held round 1's prefixes after "
              f"{kv['index_wait_s']:.3f} s; round-2 cached prompt tokens per worker "
              f"{kv['hits_1']} ({hit_blocks} blocks)")
        print(dyn_line("kv", kv, card))
        # the block-64 leg: router blocks of 4 pages, 3 requests a prefix
        t64 = time.perf_counter()
        kv64 = dyn_full_width("kv", tok_dir, card, block_size=64, per_prefix=3)
        hit64 = dyn_check_kv(kv64)
        print(f"serve-dyn: (b) kv block 64: the card's kv_block_size {kv64['card_block']}; "
              f"every round-2 request went to its prefix's holder with >= 16 overlap blocks "
              f"of 64; round-2 cached prompt tokens per worker {kv64['hits_1']} ({hit64} "
              f"blocks of 64); launches {kv64['launches']}; "
              f"{time.perf_counter() - t64:.3f} s")
        print(dyn_line("kv block 64", kv64, card))
        rr = dyn_full_width("round_robin", tok_dir, card)
        check = [r for _, r in rr["rounds"][1]]
        print(dyn_line("round_robin", rr, card))
        print(f"serve-dyn: (b) round-2 prefix-hit blocks kv {hit_blocks} round_robin "
              f"{sum(rr['hits_1']) // rr['block']} of {len(check) * 64} possible")
        print(f"serve-dyn: (b) dispatches kv {kv['dispatches']} round_robin {rr['dispatches']}")
        for mode, res in (("kv", kv), ("round_robin", rr)):
            print(f"serve-dyn: (b) {mode} graph captures (count, host ms) per worker: "
                  f"round 1 {res['captures_0']} round 2 {res['captures_1']}")
            for w, line in enumerate(res["loops"]):
                print(f"serve-dyn: (b) {mode} worker {w} {line}")
        direct = dyn_cli(tmp, card, ckpt)
        print(f"serve-dyn: phase {time.perf_counter() - t0:.3f} s")
        return direct
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- serve-disagg: disaggregated prefill/decode ----------------------------------


def blob_digest(blob) -> str:
    """A digest of a KV blob's bytes in any form (host or device; a bf16
    tensor by its bits; an int8 pair data then scales)."""
    import hashlib

    from dynamo_tpu_torch.engine.kv_cache import QuantKV

    h = hashlib.blake2b(digest_size=16)
    for part in ((blob.q, blob.s) if isinstance(blob, QuantKV) else (blob,)):
        if isinstance(part, torch.Tensor):
            t = part.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            part = t.numpy()
        h.update(np.ascontiguousarray(part).tobytes())
    return h.hexdigest()


LEASE_TTL_S = 30.0


class DisaggPair:
    """A loopback ``HubServer`` with a decode worker and a prefill worker in
    this process, each on its own ``DistributedRuntime`` and set up as
    ``run in=dyn out=torch --disagg decode|prefill`` sets it up (the CLI's
    ``serve_disagg_decode``; a ``PrefillWorker`` on the namespace's
    queue).  Spies keep, per request, what the prefill worker exported
    (its blob, or chunked stream, and first-token row), what the decode
    engine's pool holds for the lane once the KV is in (a device copy of
    its prompt pages, taken at the commit on the dispatch stream), and the
    device time of each import scatter (CUDA events around it)."""

    async def start(self, decode, prefill, model_dir: str, max_local: int, **worker_kw):
        from dynamo_tpu_torch.cli import serve_disagg_decode
        from dynamo_tpu_torch.llm.disagg import DisaggConfig, PrefillWorker
        from dynamo_tpu_torch.runtime.component import DistributedRuntime
        from dynamo_tpu_torch.runtime.transports.hub import HubServer

        self.decode, self.prefill = decode, prefill
        self.hub = HubServer(host="127.0.0.1")
        host, port = await self.hub.start()
        addr = f"{host}:{port}"
        # one event loop carries both workers' bulk KV transfer here, where
        # a deployment gives each worker a process of its own: leases of
        # LEASE_TTL_S (the CLI's default is 5 s) outlast a loop kept busy
        self.drt = await DistributedRuntime.detached(addr, lease_ttl=LEASE_TTL_S)
        self.disagg, _, self.pub = await serve_disagg_decode(
            self.drt, decode, "dyn://dynamo.backend.generate", model_dir, "m",
            cfg=DisaggConfig(max_local_prefill_length=max_local),
        )
        self.prt = await DistributedRuntime.detached(addr, lease_ttl=LEASE_TTL_S)
        self.worker = PrefillWorker(prefill, self.prt.namespace("dynamo"), **worker_kw)
        self.exported: Dict[str, Tuple[object, List[int]]] = {}
        self.landed: Dict[str, torch.Tensor] = {}
        self.scatters: List[Tuple[object, object]] = []
        self._spy()
        await self.worker.start()
        return self

    def _spy(self) -> None:
        from dynamo_tpu_torch.engine.step import gather_block_pages

        deliver, commit = self.worker._deliver, self.decode._apply_external_commit
        chunks, blob = self.decode._apply_external_chunks, self.decode._apply_external_kv
        dec, dev = self.decode, self.decode.device

        async def spy_deliver(msg, result, export_ms=0.0):
            if not isinstance(result, Exception):
                rows = result.row if not isinstance(result, tuple) else result[1]
                self.exported[msg["request_id"]] = (
                    result[0] if isinstance(result, tuple) else result,
                    [int(x) for x in np.asarray(rows).reshape(-1)],
                )
            return await deliver(msg, result, export_ms)

        def spy_commit(seq, *args):
            ids = torch.as_tensor(dec._lane_prompt_pages(seq), device=dev)
            self.landed[seq.request_id] = gather_block_pages(dec.kv.pages, ids)
            return commit(seq, *args)

        def timed(fn):
            def run(*args):
                start = torch.cuda.Event(enable_timing=True) if dev.type == "cuda" else None
                if start is not None:
                    start.record()
                out = fn(*args)
                if start is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.scatters.append((start, end))
                return out

            return run

        self.worker._deliver = spy_deliver
        dec._apply_external_commit = spy_commit
        dec._apply_external_chunks = timed(chunks)
        dec._apply_external_kv = timed(blob)

    def scatter_ms(self) -> float:
        for _, end in self.scatters:
            end.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.scatters)

    async def exported_digests(self) -> Dict[str, str]:
        """Each request's exported blob digest (a chunked stream assembled
        from the host copies it kept)."""
        from dynamo_tpu_torch.engine.engine import KVExportStream

        out = {}
        for rid, (blob, _row) in self.exported.items():
            if isinstance(blob, KVExportStream):
                blob = await blob.assemble()
            out[rid] = blob_digest(blob)
        return out

    async def stop(self) -> None:
        await self.worker.stop()
        await self.disagg.stop_config_watch()
        await self.pub.close()
        for engine in (self.decode, self.prefill):
            await engine.stop()
        await self.drt.shutdown()
        await self.prt.shutdown()
        await self.hub.stop()


async def disagg_traffic(generate, shorts: List[dict], longs: List[dict]) -> Dict[str, object]:
    """``shorts`` start together; once every one of them streams, ``longs``
    arrive together.  Per request: its id, tokens, frame times, top
    logprobs, finish reason and submit time; and the longs' submit time."""
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    frames: Dict[str, List[Tuple[float, int]]] = {}

    async def one(key: str, req: dict) -> dict:
        ctx = Context.new(PreprocessedRequest.from_dict(req))
        t0 = time.perf_counter()
        frames[key] = []
        tokens: List[int] = []
        top: List[list] = []
        finish = None
        async for item in await generate(ctx):
            if item.is_error():
                raise RuntimeError(f"{key}: {item.error_message()}")
            data = item.data or {}
            got = data.get("token_ids") or []
            if got:
                frames[key].append((time.perf_counter(), len(got)))
                tokens += got
            top += data.get("top_logprobs") or []
            finish = data.get("finish_reason") or finish
        return dict(rid=ctx.id, tokens=tokens, frames=frames[key], top=top, finish=finish, t0=t0)

    tasks = [asyncio.ensure_future(one(f"s{i}", r)) for i, r in enumerate(shorts)]
    t1 = time.perf_counter()
    while not all(frames.get(f"s{i}") for i in range(len(shorts))):
        if time.perf_counter() - t1 > 300:
            fail("serve-disagg: the short requests never all streamed")
        await asyncio.sleep(0.005)
    t_long = time.perf_counter()
    tasks += [asyncio.ensure_future(one(f"l{i}", r)) for i, r in enumerate(longs)]
    res = await asyncio.gather(*tasks)
    return dict(short=res[: len(shorts)], long=res[len(shorts):], t_long=t_long)


def itl_gap_ms(run: Dict[str, object]) -> float:
    """The short lanes' largest gap between frames from the longs' arrival
    until the last long request's first token."""
    t_end = max(r["frames"][0][0] for r in run["long"])
    gaps = [
        b[0] - a[0]
        for r in run["short"]
        for a, b in zip(r["frames"], r["frames"][1:])
        if b[0] > run["t_long"] and a[0] < t_end
    ]
    return max(gaps, default=0.0) * 1e3


def disagg_requests(vocab: int) -> Tuple[List[dict], List[dict]]:
    """8 short prompts (16 to 256 tokens, 128 new tokens) and 8 long ones
    (1024 to 2000 tokens, 64 new), greedy with top-2 logprobs."""
    rng = np.random.default_rng(13)
    shorts = [request(rng.integers(1, vocab, n), 128, logprobs=2)
              for n in rng.integers(16, 257, 8)]
    longs = [request(rng.integers(1, vocab, n), 64, logprobs=2)
             for n in rng.integers(1024, 2001, 8)]
    return shorts, longs


def check_disagg_run(what: str, pair: DisaggPair, run, n_remote: int, path: str,
                     chunks: int = 0) -> None:
    """Placement, paths and the first tokens of a disaggregated run: the
    decode worker shipped ``n_remote`` prompts and prefilled the rest
    itself, every delivery took ``path`` (with ``chunks`` chunks each on
    the chunked wire), and each remote lane's first token is the one the
    prefill worker sampled."""
    reqs = run["short"] + run["long"]
    d, w = pair.disagg, pair.worker
    if (d.remote_prefills, d.local_prefills) != (n_remote, len(reqs) - n_remote):
        fail(f"{what}: {d.remote_prefills} remote and {d.local_prefills} local prefills, "
             f"not {n_remote} and {len(reqs) - n_remote}")
    rows = list(w.delivery_stats)
    if len(rows) != n_remote or any(r["path"] != path for r in rows):
        fail(f"{what}: deliveries {[r['path'] for r in rows]}, not {n_remote} by {path}")
    if any(r.get("chunks", 0) != chunks for r in rows):
        fail(f"{what}: chunks per delivery {[r.get('chunks') for r in rows]}, not {chunks}")
    by_rid = {r["rid"]: r for r in reqs}
    if set(pair.exported) - set(by_rid) or len(pair.exported) != n_remote:
        fail(f"{what}: {len(pair.exported)} exports for {n_remote} remote requests")
    for rid, (_blob, row) in pair.exported.items():
        if by_rid[rid]["tokens"][0] != row[0]:
            fail(f"{what}: request {rid}'s first token {by_rid[rid]['tokens'][0]} is not the "
                 f"prefill worker's sample {row[0]}")


async def check_landed(what: str, pair: DisaggPair, quantize: bool = False) -> int:
    """Every remote lane's prompt pages in the decode pool equal, bit for
    bit, the blob the prefill worker exported (its int8 quantization by
    the shared rule when the decode pool is int8 and the prefiller dense).
    Returns the bytes compared."""
    from dynamo_tpu_torch.engine.engine import KVExportStream
    from dynamo_tpu_torch.engine.kv_cache import host_view, quantize_kv_blob

    nbytes = 0
    if set(pair.landed) != set(pair.exported):
        fail(f"{what}: pages landed for {len(pair.landed)} of {len(pair.exported)} exports")
    for rid, (blob, _row) in pair.exported.items():
        if isinstance(blob, KVExportStream):
            blob = await blob.assemble()
        if quantize:
            if isinstance(blob, torch.Tensor):
                blob = host_view(blob.cpu())
            blob = quantize_kv_blob(blob)
        want, got = blob_digest(blob), blob_digest(pair.landed[rid])
        if want != got:
            fail(f"{what}: request {rid}'s pages in the decode pool differ from its export "
                 f"(blake2b {got} against {want})")
        nbytes += pair.landed[rid].nbytes
    return nbytes


# the small model's disaggregated configs: PrefillWorker options, and the
# decode pool's dtype (the prefiller's pool is dense).  An int8 decode
# worker runs classic ticks, as its reference does: int8 rounding may move
# a token between the mixed and the classic paths
DISAGG_SMALL = {
    "device handoff": (dict(), None),
    "chunked wire, 2 layers a chunk": (dict(allow_local=False, layers_per_chunk=2), None),
    "chunked wire, 1 layer a chunk": (dict(allow_local=False, layers_per_chunk=1), None),
    "monolithic wire": (dict(allow_local=False, chunked=False), None),
    "int8 decode pool, chunked wire": (dict(allow_local=False, layers_per_chunk=2), "int8"),
    "int8 decode pool, device handoff": (dict(), "int8"),
}


def disagg_small(tmp: str) -> None:
    """serve-disagg (a): a 3-layer f32 model, a decode and a prefill worker
    on the card, ``max_local_prefill_length`` 32 under three of six
    prompts; under each of ``DISAGG_SMALL`` the greedy streams equal the
    CPU's aggregated engine (``mixed_batching=False``: the export's
    full-prompt dispatch; int8 pool when the decode pool is) exactly, and
    every remote lane's pages equal its export (its quantization into an
    int8 pool) bit for bit."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2, num_layers=3)
    ecfg = dict(num_pages=64, max_seq_len=256)
    params = init_params(cfg, 7, torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(7)
    shorts = [request(rng.integers(1, cfg.vocab_size, n), 16) for n in (5, 12, 30)]
    longs = [request(rng.integers(1, cfg.vocab_size, n), 16) for n in (60, 97, 150)]
    tok_dir = os.path.join(tmp, "small")
    os.makedirs(tok_dir)
    write_tokenizer(tok_dir, cfg.vocab_size, 0)
    want = {}
    for pool in (None, "int8"):
        eng = TorchEngine(cfg, params, EngineConfig(**ecfg, mixed_batching=False, kv_dtype=pool),
                          device="cpu")
        want[pool] = [r["tokens"] for r in asyncio.run(serve(eng, [shorts + longs]))]
    card_params = params_on(params, "cuda")
    for name, (kw, pool) in DISAGG_SMALL.items():
        decode = TorchEngine(cfg, card_params, EngineConfig(
            **ecfg, kv_dtype=pool, mixed_batching=pool is None), device="cuda")
        prefill = TorchEngine(cfg, card_params, EngineConfig(**ecfg), device="cuda")

        async def body():
            pair = await DisaggPair().start(decode, prefill, tok_dir, 32, **kw)
            try:
                run = await disagg_traffic(pair.disagg.generate, shorts, longs)
                path = "device" if kw.get("allow_local", True) else "wire"
                chunks = -(-cfg.num_layers // kw["layers_per_chunk"]) if "layers_per_chunk" in kw else 0
                check_disagg_run(f"serve-disagg (a) {name}", pair, run, len(longs), path, chunks)
            finally:
                await pair.stop()
            nbytes = await check_landed(f"serve-disagg (a) {name}", pair, quantize=pool == "int8")
            return run, nbytes

        reset_launches()
        run, nbytes = asyncio.run(body())
        counted = check_small_launches(f"serve-disagg (a) {name}", decode, prefill,
                                       read_launches())
        got = [r["tokens"] for r in run["short"] + run["long"]]
        if got != want[pool]:
            fail(f"serve-disagg (a) {name}: card streams {got} differ from the CPU's aggregated "
                 f"{want[pool]}")
        print(f"serve-disagg: (a) {name}: {len(got)} streams == the CPU's aggregated engine's; "
              f"{len(longs)} remote lanes' pages == their exports ({nbytes} bytes); "
              f"launches {counted}")


def check_small_launches(what: str, decode, prefill, counted: Dict[str, int]) -> Dict[str, int]:
    """serve-disagg (a)'s launch invariants over both engines, and the
    kernels of the decode worker's path launched: kernels 5 and 1 on a
    mixed dense pool, the gathered decode on a classic int8 one (its local
    prompts by kernel 2), and kernel 2 for the exports."""
    counted = check_launches_over(what, [decode, prefill], counted, required=())
    if decode.kv.quantized:
        need = ["gathered_decode"]
    else:
        need = ["packed_ragged_attention", "paged_decode_attention"]
    if prefill.dispatches.get("export", 0) < 1:
        fail(f"{what}: the prefill worker ran no export dispatch")
    for name in need + ["flash_prefill_attention"]:
        if counted[name] <= 0:
            fail(f"{what}: {name} never launched")
    return {k: n for k, n in counted.items() if n}


class ThreadSampler:
    """A sampling profile of this process's Python threads: every
    ``interval`` seconds a thread of its own reads each thread's stack
    (``sys._current_frames``) and charges the time since the last sample to
    where the thread stands -- idle (the event loop in ``select``/``poll``,
    a pool worker or a waiter blocked on its queue or lock), or busy in the
    innermost frame of this repository's code (else the innermost frame).
    A thread that holds the GIL in one long C call delays the sample that
    follows; ``max_gap_ms`` is the longest such delay."""

    IDLE = {"select", "poll", "_worker", "wait", "get", "_wait_for_tstate_lock", "sleep"}

    def __init__(self, interval: float = 0.01) -> None:
        import threading

        self.interval = interval
        self.main = threading.get_ident()
        self.busy: Dict[Tuple[str, str], float] = {}
        self.idle = {"loop": 0.0, "other": 0.0}
        self.max_gap = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _where(self, frame) -> str:
        leaf = frame
        while frame is not None:
            path = frame.f_code.co_filename
            if os.sep + "dynamo_tpu_torch" + os.sep in path:
                return f"{os.path.basename(path)}:{frame.f_code.co_name}"
            frame = frame.f_back
        return f"{os.path.basename(leaf.f_code.co_filename)}:{leaf.f_code.co_name}"

    def _run(self) -> None:
        import threading

        own = threading.get_ident()
        last = time.perf_counter()
        while not self._stop.wait(self.interval):
            now = time.perf_counter()
            dt, last = now - last, now
            self.max_gap = max(self.max_gap, dt)
            for ident, frame in sys._current_frames().items():
                if ident == own:
                    continue
                role = "loop" if ident == self.main else "other"
                if frame.f_code.co_name in self.IDLE:
                    self.idle[role] += dt
                    continue
                key = (role, self._where(frame))
                self.busy[key] = self.busy.get(key, 0.0) + dt

    def __enter__(self) -> "ThreadSampler":
        self.t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.wall = time.perf_counter() - self.t0

    def line(self, top: int = 8) -> str:
        """The event loop's busy share of the wall, and the places that
        took the most thread time (``loop`` or ``other`` thread), each as
        a share of the wall."""
        loop_busy = sum(t for (role, _), t in self.busy.items() if role == "loop")
        ranked = sorted(self.busy.items(), key=lambda kv: -kv[1])[:top]
        where = ", ".join(f"{role} {w} {t / self.wall:.4f}" for (role, w), t in ranked)
        return (f"event loop busy {loop_busy / self.wall:.4f} idle "
                f"{self.idle['loop'] / self.wall:.4f} of {self.wall:.3f} s; max sample gap "
                f"{self.max_gap * 1e3:.3f} ms; most time: {where}")


def drain_links() -> None:
    """Empty this process's transfer log (the telemetry plane's)."""
    from dynamo_tpu_torch.runtime import telemetry

    telemetry.transfers.drain()


def snapshot_links(worker_id: int, role: str) -> List[dict]:
    """The transfer samples this process's next telemetry snapshot carries
    (the process-wide log drains into it), read back through the wire
    codec."""
    from dynamo_tpu_torch.runtime import telemetry

    snap = telemetry.snapshot_from_registry(worker_id=worker_id, role=role, refresh_slo=False)
    return telemetry.TelemetrySnapshot.decode(snap.encode()).transfers


def check_links(what: str, samples: List[dict], src: int, dst: int, count: int,
                nbytes: int, wall: float) -> str:
    """The snapshot's samples of the link ``src -> dst``: ``count`` of them,
    ``nbytes`` in all (the bytes the phase moved), none slower than the
    phase's wall, and no sample of another link."""
    mine = [t for t in samples if (t["src"], t["dst"]) == (src, dst)]
    total = sum(t["bytes"] for t in mine)
    slowest = max((t["seconds"] for t in mine), default=0.0)
    line = (f"telemetry link samples {src}->{dst} {len(mine)} (moves {count}) "
            f"bytes {total} (moved {nbytes}) slowest_s {slowest:.6f} <= wall_s {wall:.3f}")
    if len(mine) != count or total != nbytes or slowest > wall or len(mine) != len(samples):
        fail(f"{what}: {line}; the snapshot's samples {samples[:8]}")
    return line


def disagg_full_width(mode: str, worker_kw: dict, tok_dir: str, shorts, longs,
                      layers: int) -> Dict[str, object]:
    """serve-disagg (b) on one transfer path: fresh decode and prefill
    engines at Llama-3-8B's widths and ``layers`` of its layers (random
    weights of seed 0 each), the traffic of ``disagg_traffic``; placement,
    first tokens, landed pages and the launch invariants over both engines
    held.  Returns the run and its numbers."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    decode, prefill = (
        TorchEngine.random_init(cfg, EngineConfig(num_pages=1024, max_batch_size=16), seed=0)
        for _ in range(2)
    )
    what = f"serve-disagg (b) {mode}"
    path = "device" if worker_kw.get("allow_local", True) else "wire"
    chunks = 0
    if path == "wire" and worker_kw.get("chunked", True):
        chunks = len(layer_spans(cfg.num_layers, worker_kw.get("layers_per_chunk")))

    async def body():
        pair = await DisaggPair().start(decode, prefill, tok_dir, 512, **worker_kw)
        try:
            drain_links()
            t0 = time.perf_counter()
            with ThreadSampler() as sampler:
                run = await disagg_traffic(pair.disagg.generate, shorts, longs)
            run["wall"] = time.perf_counter() - t0
            run["threads"] = sampler.line()
            check_disagg_run(what, pair, run, len(longs), path, chunks)
            run["scatter_ms"] = pair.scatter_ms()
            run["stats"] = pair.worker.transfer_stats()
            run["rows"] = list(pair.worker.delivery_stats)
            # the wire deliveries' link samples, in the prefill worker's
            # next telemetry snapshot (a device handoff records none)
            wire = [r for r in run["rows"] if r["path"] == "wire"]
            run["links"] = check_links(
                what, snapshot_links(pair.prt.primary_lease, "prefill"),
                pair.prt.primary_lease, pair.drt.primary_lease, len(wire),
                sum(r["bytes"] for r in wire), run["wall"])
        finally:
            await pair.stop()
        # after the stop: hashing GBs must not stall the runtimes' leases
        run["landed_bytes"] = await check_landed(what, pair)
        return run

    reset_launches()
    run = asyncio.run(body())
    counted = check_launches_over(what, [decode, prefill], read_launches())
    exports = prefill.dispatches.get("export", 0)
    full = decode.prefill_dispatches["full"] + prefill.prefill_dispatches["full"]
    if exports < 1 or full != exports or (
        counted["flash_prefill_attention"] != cfg.num_layers * exports
    ):
        fail(f"{what}: flash prefill launched {counted['flash_prefill_attention']} times over "
             f"{exports} export dispatches and {full} full-prompt dispatches")
    run.update(
        launches=counted, exports=exports, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        export_spans=prefill.dispatch_spans().get("export"),
        dispatches=[dict(decode.dispatches), dict(prefill.dispatches)],
        loops=[loop_line(e, run["wall"]) for e in (decode, prefill)],
    )
    for kind, n in (("short", 128), ("long", 64)):
        for r in run[kind]:
            if r["finish"] != "length" or len(r["tokens"]) != n:
                fail(f"{what}: request {r['rid']} ended {r['finish']} after "
                     f"{len(r['tokens'])} of {n} tokens")
    del decode, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return run


def layer_spans(num_layers: int, per_chunk) -> List[Tuple[int, int]]:
    from dynamo_tpu_torch.engine.kv_cache import layer_chunk_spans

    return layer_chunk_spans(num_layers, per_chunk, 8)


def disagg_twin(shorts, longs, layers: int) -> Dict[str, object]:
    """The same traffic on one aggregated engine of the legs' depth with
    ``mixed_batching=False`` (full-prompt prefill dispatches, the export's
    site)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b(num_layers=layers)
    engine = TorchEngine.random_init(
        cfg, EngineConfig(num_pages=1024, max_batch_size=16, mixed_batching=False), seed=0)

    async def body():
        try:
            t0 = time.perf_counter()
            run = await disagg_traffic(engine.generate, shorts, longs)
            run["wall"] = time.perf_counter() - t0
            return run
        finally:
            await engine.stop()

    reset_launches()
    run = asyncio.run(body())
    check_launch_invariants("serve-disagg (b) twin", engine, read_launches())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return run


def twin_agreement(run, twin) -> str:
    """How many lanes equal the twin's, and at each first divergence the
    top-2 logprob gap on both sides."""
    lanes = run["short"] + run["long"]
    ref = twin["short"] + twin["long"]
    same, notes = 0, []
    for i, (a, b) in enumerate(zip(lanes, ref)):
        if a["tokens"] == b["tokens"]:
            same += 1
            continue
        j = next(j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y)

        def gap(r):
            t = r["top"][j] if j < len(r["top"]) else None
            return round(t[0][1] - t[1][1], 5) if t and len(t) > 1 else None

        notes.append(f"lane {i} token {j} gap {gap(a)} (twin {gap(b)})")
    return f"{same} of {len(ref)} lanes equal the twin's; first divergences: {notes or 'none'}"


def ttft_ms(reqs) -> Tuple[float, float]:
    lat = [(r["frames"][0][0] - r["t0"]) * 1e3 for r in reqs]
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def disagg_line(mode: str, run, twin, card: str) -> str:
    """One transfer path's numbers."""
    rows = run["rows"]
    nbytes = sum(r["bytes"] for r in rows)
    scatter = (f"{nbytes / run['scatter_ms'] / 1e6:.3f}" if run["scatter_ms"] > 0
               else "not measured")
    if mode == "device handoff":
        rate = f"GB/s={scatter} (the decode side's scatters, device time)"
    else:
        rate = (f"GB/s={nbytes / sum(r['deliver_ms'] for r in rows) / 1e6:.3f} (upload to ack) "
                f"decode-side scatter GB/s={scatter}")
    p50, p99 = ttft_ms(run["long"])
    tp50, tp99 = ttft_ms(twin["long"])
    return (f"serve-disagg: (b) {mode} long TTFT ms p50/p99 {p50:.3f}/{p99:.3f} (twin "
            f"{tp50:.3f}/{tp99:.3f}) short max ITL gap ms while the longs arrive "
            f"{itl_gap_ms(run):.3f} (twin {itl_gap_ms(twin):.3f}) bytes/delivery="
            f"{nbytes // len(rows)} {rate} wall_s={run['wall']:.3f} (twin {twin['wall']:.3f}) "
            f"export dispatches={run['exports']} spans={run['export_spans']} "
            f"peak_gib={run['peak_gib']:.3f} on {card}")


def disagg_cli(tmp: str, card: str, ckpt, direct: List[str]) -> None:
    """serve-disagg (c): ``hub``, ``run in=dyn out=torch --disagg decode``
    (``--max-local-prefill-length 32``), ``--disagg prefill`` and ``run
    in=http out=dyn`` as four processes over serve-dyn's 2-layer
    checkpoint: their texts equal the in-process engine's, the prompts
    over 32 tokens (of 40 and 300) are the ones the prefill worker's log
    names, ``disagg-conf --max-local-prefill-length 100000`` turns the next
    one local, and SIGINT ends each process with exit code 0."""
    path = ckpt[0]
    hub_port, http_port = free_port(), free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    procs = []

    def shipped(p) -> List[int]:
        return [int(n) for n in re.findall(r"prefilled (\d+) tokens for", p.log())]

    def deliveries(p) -> List[Tuple[int, str, int, float]]:
        return [(int(n), path, int(b), float(ms)) for n, path, b, ms in re.findall(
            r"prefilled (\d+) tokens for .*?: (\w+) (\d+) bytes in ([\d.]+) ms", p.log())]

    try:
        procs.append(Proc(tmp, "disagg-hub", "hub", "--host", "127.0.0.1", "--port", str(hub_port)))
        procs.append(Proc(tmp, "disagg-decode", "run", "in=dyn", "out=torch", "--model-path",
                          path, "--hub", hub_addr, "--disagg", "decode",
                          "--max-local-prefill-length", "32"))
        procs.append(Proc(tmp, "disagg-prefill", "run", "in=dyn", "out=torch", "--model-path",
                          path, "--hub", hub_addr, "--disagg", "prefill"))
        procs.append(Proc(tmp, "disagg-frontend", "run", "in=http", "out=dyn", "--hub", hub_addr,
                          "--port", str(http_port)))
        prefill = procs[2]
        up = wait_http(http_port, "/v1/models", lambda b: bool(json.loads(b)["data"]), procs,
                       "serve-disagg (c)")
        while "prefill worker consuming" not in prefill.log():
            prefill.check_alive()
            time.sleep(0.25)
        texts = asyncio.run(ask_texts(http_port, "serve-disagg (c)"))
        lengths = shipped(prefill)
        rates = [f"{n} tokens {path} {b} bytes {ms:.3f} ms {b / ms / 1e6:.4f} GB/s"
                 for n, path, b, ms in deliveries(prefill)]
        if len(rates) != len(lengths):
            fail(f"serve-disagg (c): {len(rates)} delivery records for {len(lengths)} prefills")
        print(f"serve-disagg: (c) deliveries between processes: {rates}")
        if not {40, 300} <= set(lengths) or min(lengths) <= 32:
            fail(f"serve-disagg (c): the prefill worker prefilled prompts of {lengths} tokens, "
                 f"not the 40- and 300-token ones and those over 32 only")
        conf = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch", "disagg-conf", "--hub", hub_addr,
             "--max-local-prefill-length", "100000"],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
        )
        if conf.returncode != 0:
            fail(f"serve-disagg (c): disagg-conf answered {conf.returncode}: {conf.stderr[-2000:]}")
        long_req = cli_requests()[0][2]
        for _ in range(20):
            before = len(shipped(prefill))
            again = asyncio.run(ask_one(http_port, long_req))
            if again != direct[2]:
                fail(f"serve-disagg (c): the 300-token prompt's text {again!r} differs from "
                     f"{direct[2]!r}")
            if len(shipped(prefill)) == before:
                break
            time.sleep(0.2)
        else:
            fail("serve-disagg (c): disagg-conf never turned the 300-token prompt local")
        for p in reversed(procs):
            p.interrupt("serve-disagg (c)")
        print(f"serve-disagg: (c) hub, decode and prefill workers and front end served after "
              f"{up:.3f} s; prefilled remotely: prompts of {lengths} tokens; after disagg-conf: "
              f"local; exit codes {[p.proc.returncode for p in procs]} on SIGINT")
    finally:
        for p in procs:
            p.kill()
    if texts != direct:
        fail(f"serve-disagg (c): the processes' texts {texts} differ from the in-process "
             f"engine's {direct}")
    print(f"serve-disagg: (c) {len(texts)} requests: texts == in-process texts")


async def ask_one(port: int, req: dict) -> str:
    from dynamo_tpu_torch.bench_serving import run_bench

    rep = await run_bench("127.0.0.1", port, "ckpt", bench_items([req]), concurrency=1,
                          stream=False)
    check_http_results("serve-disagg (c)", [rep], [[req]])
    return rep.results[0].text


# serve-disagg (b)'s transfer paths: PrefillWorker options
DISAGG_PATHS = {
    "device handoff": dict(),
    "chunked wire": dict(allow_local=False),
    "monolithic wire": dict(allow_local=False, chunked=False),
}
# the layers of Llama-3-8B each path runs at: the device handoff at full
# depth; the host-bound wire legs (and serve-onboard (b)'s), whose bytes and
# seconds move with the layer count, at a quarter of it (the chunked wire
# still ships 8 layer chunks: one layer each)
WIRE_LAYERS = 8
DISAGG_LAYERS = {"device handoff": 32, "chunked wire": WIRE_LAYERS,
                 "monolithic wire": WIRE_LAYERS}


def serve_disagg_phase(card: str, ckpt, direct: List[str]) -> Dict[str, int]:
    """Disaggregated prefill/decode: (a) card against CPU, (b) full width on
    three transfer paths beside an aggregated twin, (c) the CLI's four
    processes.  Returns the kernels' launches over (b)'s three runs."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import ModelConfig

    tmp = tempfile.mkdtemp(prefix="chip-smoke-disagg-")
    try:
        t0 = time.perf_counter()
        disagg_small(tmp)
        tok_dir = os.path.join(tmp, "llama3")
        os.makedirs(tok_dir)
        write_tokenizer(tok_dir, 128000, 256)
        shorts, longs = disagg_requests(ModelConfig.llama3_8b().vocab_size)
        runs, leg_s = {}, {}
        for mode, kw in DISAGG_PATHS.items():
            t_leg = time.perf_counter()
            runs[mode] = disagg_full_width(mode, kw, tok_dir, shorts, longs, DISAGG_LAYERS[mode])
            leg_s[mode] = time.perf_counter() - t_leg
        twins = {}
        for layers in sorted(set(DISAGG_LAYERS.values())):
            t_leg = time.perf_counter()
            twins[layers] = disagg_twin(shorts, longs, layers)
            leg_s[f"twin at {layers} layers"] = time.perf_counter() - t_leg
        print(f"serve-disagg: (b) legs' seconds {({k: round(v, 3) for k, v in leg_s.items()})} "
              f"at layers {DISAGG_LAYERS} on {card}")
        launches: Dict[str, int] = {}
        for mode, run in runs.items():
            twin = twins[DISAGG_LAYERS[mode]]
            print(disagg_line(mode, run, twin, card))
            print(f"serve-disagg: (b) {mode} greedy agreement: {twin_agreement(run, twin)}")
            print(f"serve-disagg: (b) {mode} transfer_stats {run['stats']}")
            print(f"serve-disagg: (b) {mode} {run['landed_bytes']} bytes of remote lanes' pages "
                  f"== their exports; launches {run['launches']}; dispatches (decode, prefill) "
                  f"{run['dispatches']}")
            for w, line in zip(("decode", "prefill"), run["loops"]):
                print(f"serve-disagg: (b) {mode} {w} worker {line}")
            print(f"serve-disagg: (b) {mode} threads: {run['threads']}")
            print(f"serve-disagg: (b) {mode} {run['links']}")
            print(f"serve-disagg: (b) {mode} deliveries (bytes, deliver_ms): "
                  f"{[(r['bytes'], round(r['deliver_ms'], 3)) for r in run['rows']]}")
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n
        wire = [[r["tokens"] for r in runs[m]["short"] + runs[m]["long"]]
                for m in DISAGG_PATHS if DISAGG_LAYERS[m] == WIRE_LAYERS]
        print(f"serve-disagg: (b) the two wire paths' streams agree: "
              f"{all(s == wire[0] for s in wire)}")
        disagg_cli(tmp, card, ckpt, direct)
        print(f"serve-disagg: phase {time.perf_counter() - t0:.3f} s")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- serve-onboard: cross-worker prefix onboarding and the G4 tier ---------------


async def stream_traffic(send, reqs: List[dict], donor=None) -> List[dict]:
    """``reqs`` at once through ``send`` (a context -> response stream
    call: a worker's served endpoint, or the front end's router), each with
    ``donor`` as its ``DONOR_META_KEY`` metadata.  Per request: tokens,
    finish reason, top logprobs, submit time and frame times."""
    from dynamo_tpu_torch.llm.prefix_onboard import DONOR_META_KEY
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(req: dict) -> dict:
        ctx = Context.new(dict(req))
        if donor is not None:
            ctx.metadata[DONOR_META_KEY] = dict(donor)
        t0 = time.perf_counter()
        stream = await send(ctx)
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
        return dict(tokens=tokens, finish=finish, top=top, t0=t0, frames=frames)

    return list(await asyncio.wait_for(asyncio.gather(*[one(r) for r in reqs]), 600))


async def generate_router(cluster, n: int):
    """A ``PushRouter`` on the front end's runtime over the workers'
    generate endpoint, once it knows ``n`` instances."""
    from dynamo_tpu_torch.runtime.component import PushRouter

    client = await cluster.front.namespace("dynamo").component("backend").endpoint(
        "generate").client()
    t0 = time.perf_counter()
    while len(client.instances) < n:
        if time.perf_counter() - t0 > 60:
            fail(f"serve-onboard: {len(client.instances)} of {n} generate instances discovered")
        await asyncio.sleep(0.05)
    return PushRouter(client)


def decision_counts() -> Dict[str, float]:
    """The KV router's ``dynamo_kv_router_decisions`` by cause."""
    from dynamo_tpu_torch.runtime import metrics as rtm

    out = {}
    for line in rtm.default_registry().render()[0].decode().splitlines():
        m = re.match(r'dynamo_kv_router_decisions_total\{cause="(\w+)"\} (\S+)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def bf16_step(x: float) -> float:
    """One bf16 step (8 significant bits) at ``x``'s magnitude."""
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0**-126))) - 7)


def onboard_agreement(what: str, run: List[dict], twin: List[dict]) -> str:
    """Lanes equal to the recompute twin's, and at each first divergence
    the top-2 logprob gap on both sides, also in bf16 steps at the logits'
    magnitude (the largest of a random-weight model's 128256 logits is
    near 4.85, whose step is 1/32).  Reported, not held: the twin computes
    the prefix's KV in other batches than the donor did, and bf16 rows
    move with the dispatch around them (serve-a45, serve-disagg)."""
    same, notes = 0, []
    for i, (a, b) in enumerate(zip(run, twin)):
        if a["tokens"] == b["tokens"]:
            same += 1
            continue
        j = next((j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y),
                 min(len(a["tokens"]), len(b["tokens"])))
        gaps = []
        for r in (a, b):
            t = r["top"][j] if j < len(r["top"]) else None
            if not t or len(t) < 2:
                fail(f"{what}: lane {i} has no top-2 logprobs at its first divergence {j}")
            gap = t[0][1] - t[1][1]
            gaps.append(f"{round(gap, 5)} ({gap / bf16_step(4.85):.1f} steps)")
        notes.append(f"lane {i} token {j} gap {gaps[0]} (twin {gaps[1]})")
    return f"{same} of {len(twin)} lanes equal the twin's; first divergences: {notes or 'none'}"


def check_no_fetch_failure(what: str, engines) -> None:
    """No onboard fetch failed, no G4 fetch failed and no offload copy
    failed or fell back, on any engine (a fallback to recompute is the
    reference's semantics, and here it fails the leg)."""
    for e, pub in engines:
        oe = e.offload_engine
        bad = dict(failed_fetches=pub.onboard.failed_fetches if pub.onboard else 0,
                   copy_fails=oe.copy_fails, onboard_fallbacks=oe.onboard_fallbacks,
                   swap_fallbacks=oe.swap_fallbacks,
                   g4_fetch_fails=sum((oe.remote.fetch_fails if oe.remote else {}).values()))
        if any(bad.values()):
            fail(f"{what}: fallbacks counted {bad}")


def onboard_small(ref: Dict[str, object], tmp: str) -> None:
    """serve-onboard (a): the reference phase's f32 model, a donor and an
    importer on the card, each with ``host_offload_blocks=8``, behind a
    loopback hub: the importer onboards a 2-block prefix from the donor
    through ``kv_export``, then a fresh importer the same blocks from an
    ``InMemoryBlobStore``; their greedy streams equal a plain CPU
    engine's, each onboards the 2 blocks asked for and fails no fetch."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.prefix_onboard import PrefixOnboardEngine
    from dynamo_tpu_torch.offload import BlockMeta, InMemoryBlobStore, RemoteTier
    from dynamo_tpu_torch.tokens.hashing import hash_blocks

    cfg, params = ref["cfg"], ref["params"]
    ecfg = dict(ref["ecfg"], host_offload_blocks=8)
    shared = ref["batches"][0][1]["token_ids"][:40]
    donor_req, req = request(shared + [5, 6], 16), request(shared + [9], 16)
    _, hashes = hash_blocks(req["token_ids"], 16)
    cpu = TorchEngine(cfg, params, EngineConfig(**ref["ecfg"]), device="cpu")
    want = asyncio.run(serve(cpu, [[req]]))[0]["tokens"]
    tok_dir = os.path.join(tmp, "small")
    os.makedirs(tok_dir)
    write_tokenizer(tok_dir, cfg.vocab_size, 0)
    card_params = params_on(params, "cuda")
    donor, importer, remote = (
        TorchEngine(cfg, card_params, EngineConfig(**ecfg), device="cuda") for _ in range(3))
    store = InMemoryBlobStore()

    async def body():
        cluster = await DynCluster().start([donor, importer], tok_dir, "kv")
        try:
            router = await generate_router(cluster, 2)
            lease = cluster.workers[0].primary_lease
            await stream_traffic(lambda c: router.direct(c, lease), [donor_req])
            got = await stream_traffic(
                lambda c: router.direct(c, cluster.workers[1].primary_lease), [req],
                donor={"instance": lease, "blocks": 2})
            exported = await donor.export_blocks(hashes[:2])
            onboard = cluster.pubs[1].onboard
            peer = (got[0]["tokens"], onboard.onboarded_blocks, onboard.failed_fetches)
            check_no_fetch_failure("serve-onboard (a) peer",
                                   [(donor, cluster.pubs[0]), (importer, cluster.pubs[1])])
        finally:
            await cluster.stop()
        # the same blocks from the G4 store: frames the donor exported
        tier = RemoteTier(store)
        for h, blob, meta in exported:
            tier.submit_put(h, blob, BlockMeta.from_dict(meta)).result()
        tier.close()
        remote.offload_engine.attach_remote(store)
        ob = PrefixOnboardEngine(remote, None, "backend", engine=remote)
        try:
            got2 = await stream_traffic(ob.generate, [req],
                                        donor={"instance": -1, "blocks": 2, "source": "remote"})
        finally:
            await remote.stop()
        return peer, (got2[0]["tokens"], ob.onboarded_blocks, ob.failed_fetches)

    for name, (tokens, onboarded, failed) in zip(("kv_export", "InMemoryBlobStore"),
                                                 asyncio.run(body())):
        if tokens != want or onboarded != 2 or failed:
            fail(f"serve-onboard (a) {name}: stream {tokens} (the CPU's {want}), "
                 f"{onboarded} blocks onboarded of 2, {failed} failed fetches")
        print(f"serve-onboard: (a) {name}: 2 blocks onboarded, no failed fetch, "
              f"card stream == the CPU's plain engine's")


ONBOARD_ENGINE = dict(num_pages=1024, host_offload_blocks=512)


def onboard_requests(vocab: int, seed: int) -> Tuple[List[dict], List[dict], List[dict]]:
    """4 distinct 1024-token prefixes (64 blocks of 16): the donor's
    requests (a prefix each, 64 new tokens), the importer's (a prefix and
    a suffix of 16 to 256 tokens, 64 new, greedy, top-2 logprobs) and a
    routed round's (other suffixes)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, 1024) for _ in range(4)]
    donor = [request(p, 64) for p in prefixes]
    own = [request(np.concatenate([p, rng.integers(1, vocab, n)]), 64, logprobs=2)
           for p, n in zip(prefixes, rng.integers(16, 257, 4))]
    routed = [request(np.concatenate([p, rng.integers(1, vocab, n)]), 16)
              for p, n in zip(prefixes, rng.integers(16, 257, 4))]
    return donor, own, routed


def prefix_hashes(reqs: List[dict]) -> List[int]:
    """The 64 prefix blocks' sequence hashes of each request, chained."""
    from dynamo_tpu_torch.tokens.hashing import hash_blocks

    return [h for r in reqs for h in hash_blocks(r["token_ids"][:1024], 16)[1]]


def page_digest(parts) -> str:
    """``blob_digest`` of ``prefix_pages``' copy of one block (a dense
    pool's tensor; an int8 pool's data and scales)."""
    from dynamo_tpu_torch.engine.kv_cache import QuantKV

    return blob_digest(parts[0] if len(parts) == 1 else QuantKV(*parts))


def fetch_line(onboard) -> str:
    """Blocks, bytes and GB/s of each fetch the importer logged (the
    ``kv_export`` stream's or the G4 fetches' wall, per request)."""
    rows = list(onboard.fetch_log)
    rates = [f"{b / s / 1e9:.4f}" for _src, _n, b, s in rows]
    return (f"blocks {sum(n for _s, n, _b, _t in rows)} bytes {sum(b for _s, _n, b, _t in rows)} "
            f"per request GB/s {rates} (walls s {[round(t, 3) for *_x, t in rows]})")


def onboard_twin(tok_dir: str, reqs: List[dict], routed: bool) -> List[dict]:
    """The recompute twin: a cold worker with no donor hint serves
    ``reqs`` the way its leg's importer got them (straight to its endpoint,
    or through the front end's router)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    engine = TorchEngine.random_init(ModelConfig.llama3_8b(num_layers=WIRE_LAYERS),
                                     EngineConfig(**ONBOARD_ENGINE), seed=0)

    async def body():
        cluster = await DynCluster().start([engine], tok_dir, "kv", lease_ttl=LEASE_TTL_S)
        try:
            if routed:
                return await stream_traffic(cluster.factory.push_routers["m"].generate, reqs)
            router = await generate_router(cluster, 1)
            lease = cluster.workers[0].primary_lease
            return await stream_traffic(lambda c: router.direct(c, lease), reqs)
        finally:
            await cluster.stop()

    reset_launches()
    run = asyncio.run(body())
    check_launch_invariants("serve-onboard (b) twin", engine, read_launches())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return run


def onboard_peer(tok_dir: str) -> Dict[str, object]:
    """serve-onboard (b)'s peer leg: worker A serves 4 prefixes; cold
    worker B is sent 4 requests on them straight to its endpoint with A as
    their donor (64 blocks), then one round goes through the front end's
    router.  B's onboarded pages must equal A's, block by block."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b(num_layers=WIRE_LAYERS)
    donor_reqs, reqs, routed = onboard_requests(cfg.vocab_size, 14)
    hashes = prefix_hashes(reqs)
    torch.cuda.reset_peak_memory_stats()
    a, b = (TorchEngine.random_init(cfg, EngineConfig(**ONBOARD_ENGINE), seed=0)
            for _ in range(2))
    what = "serve-onboard (b) peer"
    out: Dict[str, object] = {}

    async def body():
        cluster = await DynCluster().start([a, b], tok_dir, "kv", lease_ttl=LEASE_TTL_S)
        try:
            router = await generate_router(cluster, 2)
            la, lb = (rt.primary_lease for rt in cluster.workers)
            await stream_traffic(lambda c: router.direct(c, la), donor_reqs)
            hits = b._prefix_hits
            t0 = time.perf_counter()
            with ThreadSampler() as sampler:
                out["run"] = await stream_traffic(lambda c: router.direct(c, lb), reqs,
                                                  donor={"instance": la, "blocks": 64})
            out["wall"] = time.perf_counter() - t0
            out["threads"] = sampler.line()
            out["hits"] = b._prefix_hits - hits
            onboard = cluster.pubs[1].onboard
            out["onboarded"], out["fetch"] = onboard.onboarded_blocks, fetch_line(onboard)
            check_no_fetch_failure(what, list(zip(cluster.engines, cluster.pubs)))
            before = decision_counts()
            await stream_traffic(cluster.factory.push_routers["m"].generate, routed)
            after = decision_counts()
            out["decisions"] = {k: after[k] - before.get(k, 0.0) for k in after
                                if after[k] != before.get(k, 0.0)}
            out["pages"] = [prefix_pages(e, hashes) for e in (a, b)]
        finally:
            await cluster.stop()

    reset_launches()
    asyncio.run(body())
    out["launches"] = check_launches_over(what, [a, b], read_launches())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    donor_pages, pages = out.pop("pages")
    if len(pages) != len(hashes) or len(donor_pages) != len(hashes):
        fail(f"{what}: {len(pages)} and {len(donor_pages)} of {len(hashes)} prefix blocks "
             f"resident on the importer and the donor")
    differ = [h for h in hashes if page_digest(pages[h]) != page_digest(donor_pages[h])]
    if differ or out["onboarded"] != len(hashes) or out["hits"] < 1024 * len(reqs):
        fail(f"{what}: {len(differ)} blocks differ from the donor's, {out['onboarded']} "
             f"onboarded of {len(hashes)}, {out['hits']} cached prompt tokens")
    out["nbytes"] = sum(t.numel() * t.element_size() for h in hashes for t in pages[h])
    out["reqs"] = reqs
    return out


def onboard_g4(tok_dir: str) -> Dict[str, object]:
    """serve-onboard (b)'s G4 leg: worker A' (160 pages) serves 4 prefixes
    and churn, its evicted blocks mirrored into the hub's blob store; A'
    drains; cold worker B' joins (so the model stays registered and its
    router keeps its index) and A' leaves; B' then gets requests on those
    prefixes through the front end's router, which stamps the G4 store as
    their donor, and fetches them over ``HubBlobClient``.  B''s onboarded
    pages must equal A''s host blobs (the mirrored ones), block by block.

    The front end's observatory reads A''s and B''s telemetry snapshots
    (over the hub): after the fetches both G4 links have samples, as many
    as the tier's puts and fetches.  The routed round's gate priced each
    fetch by the prior (the G4 -> B' link had no samples yet); a gate
    round then routes a fifth mirrored prefix to B', and its gate prices
    the fetch by the fitted link (``predict_transfer_ms`` exactly), which
    way it decides being what the run measures."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.kv_router.indexer import REMOTE_SOURCE_ID
    from dynamo_tpu_torch.offload import G4_STORE_ID

    cfg = ModelConfig.llama3_8b(num_layers=WIRE_LAYERS)
    donor_reqs, reqs, _ = onboard_requests(cfg.vocab_size, 15)
    rng = np.random.default_rng(16)
    churn = [request(rng.integers(1, cfg.vocab_size, 1900), 16) for _ in range(2)]
    hashes = prefix_hashes(reqs)
    # the gate round's prefix: mirrored with the others, never on B'
    grng = np.random.default_rng(17)
    fifth = grng.integers(1, cfg.vocab_size, 1024)
    gate_req = request(np.concatenate([fifth, grng.integers(1, cfg.vocab_size, 64)]), 16)
    gate_hashes = prefix_hashes([gate_req])
    what = "serve-onboard (b) G4"
    torch.cuda.reset_peak_memory_stats()
    a = TorchEngine.random_init(cfg, EngineConfig(num_pages=160, host_offload_blocks=512,
                                                  kv_remote="on"), seed=0)
    b = None
    out: Dict[str, object] = {}

    async def wait_for(cond, msg: str, limit: float = 60.0) -> None:
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > limit:
                fail(f"{what}: {msg}")
            await asyncio.sleep(0.05)

    async def body():
        nonlocal b
        cluster = await DynCluster().start([a], tok_dir, "kv", lease_ttl=LEASE_TTL_S)
        try:
            router = await generate_router(cluster, 1)
            lease = cluster.workers[0].primary_lease
            series = kv_series(a)
            drain_links()
            t0 = time.perf_counter()
            await stream_traffic(lambda c: router.direct(c, lease),
                                 donor_reqs + [request(fifth, 64)])
            for r in churn:
                await stream_traffic(lambda c: router.direct(c, lease), [r])
            await asyncio.to_thread(a.offload_engine.drain)
            out["publish_wall"] = time.perf_counter() - t0
            remote = a.offload_engine.remote
            # A''s puts into the store, in its next telemetry snapshot,
            # which the front end's observatory reads off the hub
            out["put_links"] = check_links(
                f"{what} puts", (await cluster.publish_telemetry(0)).transfers, lease,
                G4_STORE_ID, remote.puts, remote.store_bytes, out["publish_wall"])
            if any(a.sched.pool.is_registered(h) for h in hashes + gate_hashes) or not all(
                    remote.contains(h) for h in hashes + gate_hashes):
                fail(f"{what}: the prefixes are not all out of A' and in the G4 store")
            ring = {h: a.offload_engine.host.get_ram(h) for h in hashes + gate_hashes}
            if any(v is None for v in ring.values()):
                fail(f"{what}: A''s host ring lost prefix blocks")
            out["mirrored"] = await asyncio.to_thread(
                lambda: {h: blob_digest(blob) for h, (blob, _m) in ring.items()})
            out["store"] = (remote.puts, remote.store_bytes, remote.store_seconds)
            out["store_series"] = (series, kv_series(a))
            chooser = cluster.factory.choosers["m"]

            def advertised() -> bool:
                every = hashes + gate_hashes
                src = [chooser.indexer.holdings.prefix_sources(every[i:i + 64])
                       for i in range(0, len(every), 64)]
                return all(s.get(REMOTE_SOURCE_ID, {}).get("blocks", 0) >= 64 for s in src)

            await wait_for(advertised, "the router's index never held the G4 adverts")
            b = TorchEngine.random_init(cfg, EngineConfig(**ONBOARD_ENGINE, kv_remote="on"),
                                        seed=0)
            await cluster.add(b)
            await wait_for(lambda: cluster.workers[1].primary_lease
                           in chooser.scheduler.workers.endpoints,
                           "the router never saw the cold worker")
            gone = cluster.workers[0].primary_lease
            await cluster.leave(0)
            await wait_for(lambda: gone not in chooser.scheduler.workers.endpoints,
                           "the router kept the departed worker")
            if cluster.factory.choosers["m"] is not chooser or not advertised():
                fail(f"{what}: the router dropped the G4 adverts with their publisher")
            series = kv_series(b)
            before = decision_counts()
            hits = b._prefix_hits
            b_lease, b_remote = cluster.workers[1].primary_lease, b.offload_engine.remote
            obs, push = cluster.observatory, cluster.factory.push_routers["m"]
            if obs.predict_transfer_ms(1 << 20, G4_STORE_ID, b_lease) is not None:
                fail(f"{what}: the observatory priced the G4 -> B' link before any fetch")
            logged = len(push.decisions_log)
            drain_links()
            t0 = time.perf_counter()
            with ThreadSampler() as sampler:
                out["run"] = await stream_traffic(push.generate, reqs)
            out["wall"] = time.perf_counter() - t0
            out["threads"] = sampler.line()
            after = decision_counts()
            out["decisions"] = {k: after[k] - before.get(k, 0.0) for k in after
                                if after[k] != before.get(k, 0.0)}
            out["hits"] = b._prefix_hits - hits
            # no sample of the G4 -> B' link yet: each fetch priced by the prior
            rows = push.decisions_log[logged:]
            prior = [r["ship_bytes"] / (push._gbps * 1e9) * 1e3 for r in rows]
            if len(rows) != len(reqs) or [r["pred_fetch_ms"] for r in rows] != prior:
                fail(f"{what}: the routed round's gate rows {rows}, not the prior's {prior}")
            out["routed_gate"] = rows
            out["fetch_links"] = check_links(
                f"{what} fetches", (await cluster.publish_telemetry(1)).transfers,
                G4_STORE_ID, b_lease, b_remote.fetches, b_remote.fetch_bytes, out["wall"])
            # both G4 links fitted from the snapshots, a sample a move
            links = {(r["src"], r["dst"]): r for r in obs.link_table()}
            put_link, fetch_link = links.get((lease, G4_STORE_ID)), links.get((G4_STORE_ID, b_lease))
            if (put_link is None or fetch_link is None or put_link["samples"] != remote.puts
                    or fetch_link["samples"] != b_remote.fetches
                    or not fetch_link["bandwidth_bytes_per_s"]):
                fail(f"{what}: the observatory's links {obs.link_table()}, puts {remote.puts}, "
                     f"fetches {b_remote.fetches}")
            out["links"] = (put_link, fetch_link)
            onboard = cluster.pubs[1].onboard
            out["onboarded"], out["fetch"] = onboard.onboarded_blocks, fetch_line(onboard)
            out["fetch_series"] = (series, kv_series(b))
            check_no_fetch_failure(what, [(b, cluster.pubs[1])])
            out["pages"] = prefix_pages(b, hashes)
            # the gate round: the fifth prefix, priced by the fitted link
            before = decision_counts()
            logged, onboarded = len(push.decisions_log), onboard.onboarded_blocks
            out["gate_run"] = await stream_traffic(push.generate, [gate_req])
            after = decision_counts()
            out["gate_decisions"] = {k: after[k] - before.get(k, 0.0) for k in after
                                     if after[k] != before.get(k, 0.0)}
            rows = push.decisions_log[logged:]
            if len(rows) != 1 or rows[0]["donor"] != G4_STORE_ID:
                fail(f"{what}: the gate round's gate rows {rows}, not one G4 donor")
            row = rows[0]
            fitted = obs.predict_transfer_ms(row["ship_bytes"], G4_STORE_ID, b_lease)
            if row["pred_fetch_ms"] != fitted or fitted == row["ship_bytes"] / (
                    push._gbps * 1e9) * 1e3:
                fail(f"{what}: the gate priced the fetch at {row['pred_fetch_ms']} ms, the "
                     f"fitted link at {fitted} ms")
            out["gate_row"] = row
            fetched = onboard.onboarded_blocks - onboarded
            if (row["decision"] == "fetch") != (fetched == len(gate_hashes)) or fetched not in (
                    0, len(gate_hashes)):
                fail(f"{what}: the gate decided {row['decision']}, B' onboarded {fetched} blocks")
            if fetched:
                check_no_fetch_failure(what, [(b, cluster.pubs[1])])
                out["pages"].update(prefix_pages(b, gate_hashes))
        finally:
            await cluster.stop()

    cap = os.environ.get("DYN_HUB_BLOB_CAP")
    # the hub's store holds every mirrored block (about 0.8 GB) with room
    os.environ["DYN_HUB_BLOB_CAP"] = str(4 << 30)
    reset_launches()
    try:
        asyncio.run(body())
    finally:
        if cap is None:
            os.environ.pop("DYN_HUB_BLOB_CAP", None)
        else:
            os.environ["DYN_HUB_BLOB_CAP"] = cap
    out["launches"] = check_launches_over(what, [a, b], read_launches())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    pages = out.pop("pages")
    checked = hashes + (gate_hashes if out["gate_row"]["decision"] == "fetch" else [])
    differ = [h for h in checked if h not in pages or page_digest(pages[h]) != out["mirrored"][h]]
    if [(r["finish"], len(r["tokens"])) for r in out["gate_run"]] != [("length", 16)]:
        fail(f"{what}: the gate round's request ended "
             f"{[(r['finish'], len(r['tokens'])) for r in out['gate_run']]}")
    if out["decisions"].get("kv_remote", 0) != len(reqs):
        fail(f"{what}: the router's decisions {out['decisions']}, not {len(reqs)} kv_remote")
    if differ or out["onboarded"] != len(hashes) or out["hits"] < 1024 * len(reqs):
        fail(f"{what}: {len(differ)} blocks differ from the mirrored ones, "
             f"{out['onboarded']} onboarded of {len(hashes)}, {out['hits']} cached prompt tokens")
    out["nbytes"] = sum(t.numel() * t.element_size() for h in hashes for t in pages[h])
    out["reqs"] = reqs
    return out


def g4_rate(pair, op: str) -> str:
    """Bytes, seconds and GB/s of ``dynamo_kv_g4_*`` for one direction
    between two readings."""
    before, after = pair
    b = after.get(f'dynamo_kv_g4_bytes_total{{op="{op}"}}', 0.0) - before.get(
        f'dynamo_kv_g4_bytes_total{{op="{op}"}}', 0.0)
    s = after.get(f'dynamo_kv_g4_seconds_sum{{op="{op}"}}', 0.0) - before.get(
        f'dynamo_kv_g4_seconds_sum{{op="{op}"}}', 0.0)
    return f"g4[{op}] bytes={int(b)} s={s:.6f} gb_s={b / s / 1e9 if s > 0 else 0.0:.4f}"


def onboard_line(leg: str, res, twin, card: str) -> str:
    p50, p99 = ttft_ms(res["run"])
    tp50, tp99 = ttft_ms(twin)
    return (f"serve-onboard: (b) {leg} onboarded blocks {res['onboarded']} bytes "
            f"{res['nbytes']}; fetch {res['fetch']}; TTFT from arrival ms p50/p99 "
            f"{p50:.3f}/{p99:.3f} (recompute twin {tp50:.3f}/{tp99:.3f}); wall_s "
            f"{res['wall']:.3f}; peak_gib {res['peak_gib']:.3f}; router decisions "
            f"{res['decisions']} on {card}")


def onboard_cli(tmp: str, card: str, ckpt, direct: List[str]) -> None:
    """serve-onboard (c): ``hub``, two ``run in=dyn out=torch
    --host-offload-blocks 256 --kv-remote on`` workers and ``run in=http
    out=dyn --router-mode kv`` as four processes over the phases'
    checkpoint: both workers' ``kv_export`` endpoints are discovered, the
    texts equal the in-process engine's, and SIGINT ends each process with
    exit code 0."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    path = ckpt[0]
    hub_port, http_port = free_port(), free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    procs = []
    worker = ("run", "in=dyn", "out=torch", "--model-path", path, "--hub", hub_addr,
              "--host-offload-blocks", "256", "--kv-remote", "on")
    try:
        procs.append(Proc(tmp, "onboard-hub", "hub", "--host", "127.0.0.1", "--port",
                          str(hub_port)))
        procs.append(Proc(tmp, "onboard-worker-0", *worker))
        procs.append(Proc(tmp, "onboard-worker-1", *worker))
        procs.append(Proc(tmp, "onboard-frontend", "run", "in=http", "out=dyn", "--hub",
                          hub_addr, "--router-mode", "kv", "--port", str(http_port)))
        up = wait_http(http_port, "/v1/models", lambda b: bool(json.loads(b)["data"]), procs,
                       "serve-onboard (c)")

        async def exports() -> int:
            rt = await DistributedRuntime.detached(hub_addr)
            try:
                client = await rt.namespace("dynamo").component("backend").endpoint(
                    "kv_export").client()
                t0 = time.perf_counter()
                while len(client.instances) < 2 and time.perf_counter() - t0 < 120:
                    for p in procs:
                        p.check_alive()
                    await asyncio.sleep(0.25)
                return len(client.instances)
            finally:
                await rt.shutdown()

        found = asyncio.run(exports())
        if found != 2:
            fail(f"serve-onboard (c): {found} kv_export endpoints discovered, not 2")
        texts = asyncio.run(ask_texts(http_port, "serve-onboard (c)"))
        for p in reversed(procs):
            p.interrupt("serve-onboard (c)")
        print(f"serve-onboard: (c) hub, two workers with the offload plane and G4 and the front "
              f"end served after {up:.3f} s; kv_export endpoints discovered {found}; exit codes "
              f"{[p.proc.returncode for p in procs]} on SIGINT")
    finally:
        for p in procs:
            p.kill()
    if texts != direct:
        fail(f"serve-onboard (c): the processes' texts {texts} differ from the in-process "
             f"engine's {direct}")
    print(f"serve-onboard: (c) {len(texts)} requests: texts == in-process texts")


def serve_onboard_phase(ref: Dict[str, object], card: str, ckpt,
                        direct: List[str]) -> Dict[str, int]:
    """Cross-worker prefix onboarding and the G4 tier: (a) card against
    CPU, (b) the peer and G4 legs at full width beside their recompute
    twins, (c) the CLI's four processes.  Returns the kernels' launches
    over (b)'s two legs."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-onboard-")
    try:
        t0 = time.perf_counter()
        onboard_small(ref, tmp)
        tok_dir = os.path.join(tmp, "llama3")
        os.makedirs(tok_dir)
        write_tokenizer(tok_dir, 128000, 256)
        launches: Dict[str, int] = {}
        for leg, run in (("peer", onboard_peer), ("G4", onboard_g4)):
            t_leg = time.perf_counter()
            res = run(tok_dir)
            t_twin = time.perf_counter()
            twin = onboard_twin(tok_dir, res["reqs"], routed=leg == "G4")
            print(f"serve-onboard: (b) {leg} leg {t_twin - t_leg:.3f} s, its twin "
                  f"{time.perf_counter() - t_twin:.3f} s, at {WIRE_LAYERS} of Llama-3-8B's "
                  f"32 layers on {card}")
            for r in res["run"] + twin:
                if r["finish"] != "length" or len(r["tokens"]) != 64:
                    fail(f"serve-onboard (b) {leg}: a request ended {r['finish']} after "
                         f"{len(r['tokens'])} of 64 tokens")
            print(onboard_line(leg, res, twin, card))
            agreement = onboard_agreement(f"serve-onboard (b) {leg}", res["run"], twin)
            print(f"serve-onboard: (b) {leg} {len(res['reqs']) * 64} onboarded blocks == the "
                  f"donor's, blake2b each; cached prompt tokens {res['hits']}; greedy agreement: "
                  f"{agreement}")
            if leg == "G4":
                puts, nbytes, secs = res["store"]
                print(f"serve-onboard: (b) G4 mirrored {puts} blocks, {nbytes} bytes in "
                      f"{secs:.3f} s of puts; {g4_rate(res['store_series'], 'store')} "
                      f"{g4_rate(res['fetch_series'], 'fetch')}; publish wall "
                      f"{res['publish_wall']:.3f} s on {card}")
                print(f"serve-onboard: (b) G4 puts {res['put_links']}")
                print(f"serve-onboard: (b) G4 fetches {res['fetch_links']}")
                fits = "; ".join(
                    f"{name} {ln['samples']} samples fitted "
                    f"{ln['bandwidth_bytes_per_s'] / 1e9:.4f} GB/s + {ln['setup_ms']:.3f} ms setup"
                    for name, ln in zip(("A'->G4", "G4->B'"), res["links"]))
                print(f"serve-onboard: (b) G4 observatory links: {fits}; measured "
                      f"{g4_rate(res['store_series'], 'store')} "
                      f"{g4_rate(res['fetch_series'], 'fetch')} on {card}")
                rows = res["routed_gate"]
                print(f"serve-onboard: (b) G4 routed round's gate on the prior: decisions "
                      f"{res['decisions']}; pred_fetch_ms "
                      f"{[round(r['pred_fetch_ms'], 3) for r in rows]} vs pred_prefill_ms "
                      f"{[round(r['pred_prefill_ms'], 3) for r in rows]}")
                row = res["gate_row"]
                print(f"serve-onboard: (b) G4 gate round on the fitted link: {row['decision']}; "
                      f"pred_fetch_ms {row['pred_fetch_ms']:.3f} (the fit, "
                      f"{row['ship_bytes']} bytes) vs pred_prefill_ms "
                      f"{row['pred_prefill_ms']:.3f}; router decisions "
                      f"{res['gate_decisions']} on {card}")
            print(f"serve-onboard: (b) {leg} threads: {res['threads']}")
            print(f"serve-onboard: (b) {leg} launches {res['launches']}")
            for k, n in res["launches"].items():
                launches[k] = launches.get(k, 0) + n
        onboard_cli(tmp, card, ckpt, direct)
        print(f"serve-onboard: phase {time.perf_counter() - t0:.3f} s")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- serve-mocker: the model-free engine in a fleet -------------------------------


# worker.slow's armed delay on one mocker process: its step mean (about
# half the delay, the tick being pipelined) must stand out of a fleet whose
# torch worker steps in milliseconds for the straggler rule to flag it
MOCKER_SLOW_S = 0.15
KILL_FRAME = "mocker crashed (injected worker.kill)"


async def wait_log(proc: "Proc", text: str, what: str, limit_s: float = 300.0) -> None:
    """Until ``proc``'s log holds ``text``; fails when it exits first."""
    t0 = time.perf_counter()
    while text not in proc.log():
        proc.check_alive()
        if time.perf_counter() - t0 > limit_s:
            fail(f"{what}: {proc.name} never printed {text!r}: {proc.log()[-2000:]}")
        await asyncio.sleep(0.1)


async def fleet_ask(port: int, reqs: List[dict], what: str, stream: bool = False):
    """``reqs`` at once through the front end on ``port``; every one must
    finish with its max_tokens."""
    from dynamo_tpu_torch.bench_serving import run_bench

    rep = await run_bench("127.0.0.1", port, "ckpt", bench_items(reqs),
                          concurrency=len(reqs), stream=stream)
    check_http_results(what, [rep], [reqs])
    return rep


async def mocker_fleet(addr: str, port: int, path: str, procs: List["Proc"],
                       card: str) -> None:
    """serve-mocker's checks, against the running processes (see
    :func:`serve_mocker_phase`)."""
    from dynamo_tpu_torch.cli import serve_worker
    from dynamo_tpu_torch.fleet import FleetObservatory
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
    from dynamo_tpu_torch.protocols.common import ForwardPassMetrics
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, PushRouter
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    from dynamo_tpu_torch.runtime.telemetry import (
        TELEMETRY_TOPIC, TelemetryPublisher, TelemetrySnapshot,
    )

    what = "serve-mocker"
    await wait_log(procs[0], "hub at", what)
    rt = await DistributedRuntime.detached(addr)
    ns = rt.namespace("dynamo")
    telemetry_sub = await ns.subscribe(TELEMETRY_TOPIC)
    hit_sub = await ns.subscribe("kv-hit-rate")
    # an observatory of this process's own over the same snapshots as the
    # front end's: the step series the straggler rule is applied to
    local = FleetObservatory(MetricsRegistry())
    await local.start(ns)
    # the fourth mocker, in this process: crash() plays worker.kill on it;
    # it publishes telemetry as ``run in=dyn`` does
    crash_rt = await DistributedRuntime.detached(addr)
    vocab = Tokenizer.from_model_dir(path).vocab_size
    crash_engine = MockerEngine(MockerConfig(block_size=16, vocab_size=vocab,
                                             decode_s_per_step=0.0005),
                                registry=MetricsRegistry())
    _, crash_pub = await serve_worker(crash_rt, crash_engine, "dyn://dynamo.backend.generate",
                                      path, None, block_size=16)
    crash_lease = crash_rt.primary_lease
    crash_telemetry = TelemetryPublisher(
        crash_rt.namespace("dynamo"), worker_id=crash_lease, role="worker",
        registry=crash_engine.registry, transfer_log=crash_engine.transfer_log)
    crash_telemetry.start()
    try:
        t0 = time.perf_counter()
        client = await ns.component("backend").endpoint("generate").client()
        loads = await ns.component("backend").endpoint("load_metrics").client()
        while len(client.instances) < 4 or len(loads.instances) < 4:
            for p in procs:
                p.check_alive()
            if time.perf_counter() - t0 > 300:
                fail(f"{what}: {len(client.instances)} of 4 workers registered")
            await asyncio.sleep(0.1)
        while True:
            procs[-1].check_alive()
            with contextlib.suppress(OSError):
                status, body = await http_call(port, "GET", "/v1/models")
                if status == 200 and json.loads(body)["data"]:
                    break
            await asyncio.sleep(0.1)
        up = time.perf_counter() - t0
        # which worker is which: a mocker offers 64 lanes, the torch worker 8
        slots = {}
        for iid in client.instance_ids():
            stream = await PushRouter(loads).direct(Context.new({}), iid)
            async for item in stream:
                if item.data is not None:
                    slots[iid] = ForwardPassMetrics.from_dict(item.data).request_total_slots
        torch_ids = [i for i, n in slots.items() if n == 8]
        mocker_ids = [i for i, n in slots.items() if n == 64 and i != crash_lease]
        if len(torch_ids) != 1 or len(mocker_ids) != 2 or crash_lease not in slots:
            fail(f"{what}: workers by lanes {slots}")
        await asyncio.sleep(1.0)  # the router's scrape and index catch up

        async def hit_event() -> dict:
            return json.loads((await asyncio.wait_for(hit_sub.next(), 30))[1])

        # (b) a prefix-sharing batch: each repeat goes to its prefix's
        # holder, unless the front end's observatory has quarantined the
        # holder as a straggler (the armed mocker is one once it has
        # stepped), when it goes to another worker
        async def quarantined() -> set:
            status, body = await http_call(port, "GET", "/fleet")
            if status != 200:
                fail(f"{what} (b): GET /fleet -> {status}")
            return set(json.loads(body)["quarantined"])

        rng = np.random.default_rng(31)
        prefixes = [rng.integers(1, 128000, 256) for _ in range(4)]
        holders, served_by, placed = [], {}, []
        for p in prefixes:
            await fleet_ask(port, [request(np.concatenate([p, rng.integers(1, 128000, 8)]), 16)],
                            f"{what} (b) round 1")
            ev = await hit_event()
            holders.append(ev["worker_id"])
            placed.append(ev["worker_id"])
        await asyncio.sleep(1.0)  # every holder's stored events indexed
        overlaps, away, unsettled = [], 0, 0
        for p, holder in zip(prefixes, holders):
            for _ in range(2):
                before = await quarantined()
                await fleet_ask(port, [request(np.concatenate([p, rng.integers(1, 128000, 8)]),
                                               16)], f"{what} (b) round 2")
                ev = await hit_event()
                after = await quarantined()
                placed.append(ev["worker_id"])
                overlaps.append(ev["overlap_blocks"])
                served_by[ev["worker_id"]] = served_by.get(ev["worker_id"], 0) + 1
                if (holder in before) != (holder in after):
                    unsettled += 1  # the holder's quarantine changed meanwhile
                elif holder in before:
                    away += 1
                    if ev["worker_id"] == holder:
                        fail(f"{what} (b): a repeat went to its quarantined holder {holder}")
                elif ev["worker_id"] != holder or ev["overlap_blocks"] < 16:
                    fail(f"{what} (b): a repeat went to {ev['worker_id']} with "
                         f"{ev['overlap_blocks']} overlap blocks, its prefix's holder is {holder}")
        kinds = {i: ("torch" if i in torch_ids else "crash mocker" if i == crash_lease
                     else "mocker") for i in slots}
        print(f"serve-mocker: (b) 12 requests answered; round 1's holders "
              f"{[kinds[h] for h in holders]}; every repeat went to its holder with "
              f"overlap blocks {overlaps}, {away} of them away from a quarantined holder "
              f"({unsettled} while its quarantine changed); workers up after {up:.3f} s on "
              f"{card}")
        # (c) each process worker's telemetry snapshot, one taken after (b)
        routed = time.time()
        snaps: Dict[int, object] = {}
        t1 = time.perf_counter()
        while set(snaps) != set(torch_ids + mocker_ids):
            if time.perf_counter() - t1 > 30:
                fail(f"{what} (c): snapshots of {sorted(snaps)} only, workers "
                     f"{torch_ids + mocker_ids}")
            _, payload = await asyncio.wait_for(telemetry_sub.next(), 30)
            blob = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
            snap = TelemetrySnapshot.decode(blob)
            if snap.role != "worker" or snap.worker_id not in slots:
                fail(f"{what} (c): a snapshot names worker {snap.worker_id} role {snap.role}")
            if snap.ts >= routed and snap.worker_id != crash_lease:
                snaps[snap.worker_id] = snap
        # every token (b) streamed from a process worker is in its counters
        streamed = 16 * sum(1 for w in placed if w != crash_lease)
        if sum(s.tokens_generated for s in snaps.values()) != streamed:
            fail(f"{what} (c): the snapshots count "
                 f"{sum(s.tokens_generated for s in snaps.values())} tokens, (b) streamed "
                 f"{streamed} from the process workers")
        print("serve-mocker: (c) telemetry snapshots decoded: " + ", ".join(
            f"{kinds[i]} {i:x} role={s.role} seq={s.seq} tokens_generated={s.tokens_generated} "
            f"kv_pages_total={s.kv_pages_total}" for i, s in snaps.items()))
        # (d) worker.slow: the same request straight to each mocker process
        per_token, prompts = {}, {}
        for iid in mocker_ids:
            req = request(rng.integers(1, 128000, 64), 32)
            prompts[iid] = req["token_ids"]
            t2 = time.perf_counter()
            out = await stream_traffic(lambda c, iid=iid: PushRouter(client).direct(c, iid), [req])
            per_token[iid] = (time.perf_counter() - t2) / 32 * 1e3
            if len(out[0]["tokens"]) != 32:
                fail(f"{what} (d): {len(out[0]['tokens'])} of 32 tokens")
        slow, fast = max(per_token.values()), min(per_token.values())
        print(f"serve-mocker: (d) worker.slow armed at {MOCKER_SLOW_S * 1e3:.1f} ms a tick on one "
              f"mocker: ms per token slow {slow:.3f} fast {fast:.3f} (the pipelined tick keeps "
              f"two generations in flight: half the delay a token)")
        # the armed mocker's tokens come slower by about half its delay,
        # over what the unarmed one's round trips through the host cost
        if slow - fast < 0.4 * MOCKER_SLOW_S * 1e3:
            fail(f"{what} (d): the armed mocker is not slowed by its delay: {per_token}")
        await mocker_observatory(port, addr, local, client, slots, kinds,
                                 max(per_token, key=per_token.get), prompts, rng, hit_event,
                                 card)
        # (e) crash() on the in-process mocker, holding prefix Q, mid-stream
        q = rng.integers(1, 128000, 256)
        await stream_traffic(lambda c: PushRouter(client).direct(c, crash_lease),
                             [request(np.concatenate([q, [7]]), 1)])
        await asyncio.sleep(1.0)
        reqs = ([request(np.concatenate([q, rng.integers(1, 128000, 8)]), 512) for _ in range(3)]
                + [request(rng.integers(1, 128000, 40), 16) for _ in range(3)])
        from dynamo_tpu_torch.bench_serving import run_bench

        bench = asyncio.ensure_future(run_bench("127.0.0.1", port, "ckpt", bench_items(reqs),
                                                concurrency=len(reqs), stream=True))
        t3 = time.perf_counter()
        while not crash_engine.running or not all(
                s.num_generated > 1 for s in crash_engine.running.values()):
            if time.perf_counter() - t3 > 60 or bench.done():
                fail(f"{what} (e): the crash mocker never streamed its lanes")
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.05)
        held = len(crash_engine.running) + len(crash_engine._waiting_list)
        await crash_engine.crash()
        rep = await asyncio.wait_for(bench, 300)
        failed = [r for r in rep.results if not r.ok]
        served = [(r.finish_reason, r.output_tokens) for r in rep.results if r.ok]
        want = {(("length", 512) if i < 3 else ("length", 16)) for i in range(6)}
        bad = [r.error for r in failed if KILL_FRAME not in r.error]
        if len(failed) != held or bad or any(s not in want for s in served):
            fail(f"{what} (e): {held} lanes on the crashed mocker, {len(failed)} errors "
                 f"{[r.error for r in failed]}, served {served}")
        print(f"serve-mocker: (e) crash() with {held} lanes in flight: {len(failed)} requests "
              f"got the error frame {KILL_FRAME!r}, the front end served the other "
              f"{len(served)} to their full length {served}")
    finally:
        await crash_telemetry.stop(final=False)
        await crash_pub.close()
        await crash_engine.stop()
        await crash_rt.shutdown()
        await local.stop()
        await telemetry_sub.close()
        await hit_sub.close()
        await rt.shutdown()


def straggler_rule(means: Dict[int, float], obs) -> set:
    """The workers the fleet observatory's straggler rule flags for these
    step means: at least ``straggler_min_workers`` of them, above
    ``straggler_min_ratio`` x the median and ``straggler_z`` robust
    deviations (MAD-scaled, floored at 2% of the median) above it."""
    import statistics

    if len(means) < obs.straggler_min_workers:
        return set()
    median = statistics.median(means.values())
    mad = statistics.median(abs(v - median) for v in means.values())
    sigma = max(mad / 0.6745, 0.02 * median, 1e-9)
    return {w for w, m in means.items()
            if median > 0 and m > obs.straggler_min_ratio * median
            and (m - median) / sigma > obs.straggler_z}


async def mocker_observatory(port: int, addr: str, local, client, slots: Dict[int, int],
                             kinds: Dict[int, str], slow_id: int, prompts: Dict[int, list],
                             rng, hit_event, card: str) -> None:
    """serve-mocker (f): the front end's fleet observatory.  ``GET /fleet``
    lists the four workers; its stragglers are the rule's over the step
    means of the same snapshots (``local``, this process's observatory),
    the slowed mocker among them and quarantined; a batch on the slowed
    mocker's prefix goes elsewhere; ``GET /fleet/metrics`` holds the
    fleet families; ``fleet --once --json`` and ``metrics`` name the same
    workers."""
    from dynamo_tpu_torch.runtime.component import PushRouter

    what = "serve-mocker (f)"
    t0 = time.perf_counter()
    # every worker steps (the process mockers did in (d)); for the torch
    # worker this request is the warm-up of the window's shape (its graph
    # captures and cold dispatches land here)
    for iid in [i for i in slots if kinds[i] != "mocker"]:
        await stream_traffic(lambda c, iid=iid: PushRouter(client).direct(c, iid),
                             [request(rng.integers(1, 128000, 64), 16)])
    # once the warm-up's steps are in the series, the torch worker's window
    # fills with the steps of the same shape warm: one request per
    # telemetry interval until the window holds only their points
    await asyncio.sleep(2.5)
    for tid in [i for i in slots if kinds[i] == "torch"]:
        for _ in range(local.straggler_window):
            seen = len((local.worker_series(tid) or {}).get("step_ms", []))
            await stream_traffic(lambda c, tid=tid: PushRouter(client).direct(c, tid),
                                 [request(rng.integers(1, 128000, 64), 16)])
            t1 = time.perf_counter()
            while len((local.worker_series(tid) or {}).get("step_ms", [])) <= seen:
                if time.perf_counter() - t1 > 10:
                    fail(f"{what}: no telemetry step point of the torch worker {tid:x}")
                await asyncio.sleep(0.05)
    # then two telemetry intervals of no traffic: both observatories hold
    # every step
    await asyncio.sleep(2.5)
    status, body = await http_call(port, "GET", "/fleet")
    doc = json.loads(body)
    rows = {w["worker_id"]: w for w in doc.get("workers", [])}
    if status != 200 or {i: w["role"] for i, w in rows.items()} != {i: "worker" for i in slots}:
        fail(f"{what}: GET /fleet -> {status}, workers {sorted(rows)} of {sorted(slots)}: "
             f"{body[:500]!r}")
    means, windows = {}, {}
    for wid in slots:
        steps = [v for _, v in (local.worker_series(wid) or {}).get("step_ms", [])]
        last = rows[wid]["step_ms"]
        if not steps or last != round(steps[-1], 3):
            fail(f"{what}: worker {wid:x}'s steps {steps[-3:]} here, {last} on /fleet")
        window = steps[-local.straggler_window:]
        windows[wid] = [round(v, 3) for v in window]
        means[wid] = sum(window) / len(window)
    flagged = straggler_rule(means, local)
    print("serve-mocker: (f) step means ms " + ", ".join(
        f"{kinds[w]} {w:x} {m:.3f}" for w, m in means.items())
        + f"; /fleet stragglers {[kinds[w] for w in doc['stragglers']]} quarantined "
        f"{[kinds[w] for w in doc['quarantined']]} on {card}")
    print("serve-mocker: (f) the windows' step points ms " + "; ".join(
        f"{kinds[w]} {w:x} {v}" for w, v in windows.items()) + f" on {card}")
    if flagged != set(local.stragglers) or flagged != set(doc["stragglers"]):
        fail(f"{what}: the rule flags {sorted(flagged)}, this process's observatory "
             f"{local.stragglers}, the front end's {doc['stragglers']} (means {means})")
    if slow_id not in flagged or slow_id not in doc["quarantined"]:
        fail(f"{what}: the slowed mocker {slow_id:x} flagged {sorted(flagged)}, quarantined "
             f"{doc['quarantined']} (means {means})")
    if any(kinds[w] == "torch" for w in flagged):
        print("serve-mocker: (f) the torch worker is flagged too")
    # while quarantined, a batch on its prefix goes elsewhere
    batch = [request(np.concatenate([prompts[slow_id], rng.integers(1, 128000, 8)]), 8)
             for _ in range(4)]
    await fleet_ask(port, batch, f"{what} quarantine batch")
    placed = [(await hit_event())["worker_id"] for _ in batch]
    if slow_id in placed:
        fail(f"{what}: the quarantined mocker took {placed.count(slow_id)} of the batch")
    status, body = await http_call(port, "GET", "/fleet/metrics")
    text = body.decode()
    families = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            values[key] = float(val)
    need = {f"dynamo_fleet_{f}" for f in ("workers", "tokens_per_s", "kv_pressure",
                                            "queue_depth", "slo_attainment", "stragglers",
                                            "quarantined")}
    if (status != 200 or not need <= families
            or values.get('dynamo_fleet_workers{role="worker"}') != 4.0
            or values.get("dynamo_fleet_quarantined", 0.0) < 1.0):
        fail(f"{what}: GET /fleet/metrics -> {status}: {text[:1500]}")
    # the fleet subcommand, a process of its own
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch", "fleet", "--hub", addr, "--once", "--json",
        "--interval", "2.5", cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), 60)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    listed = {w["worker_id"] for w in json.loads(out or b"{}").get("workers", [])}
    if proc.returncode != 0 or listed != set(slots):
        fail(f"{what}: fleet --once --json exited {proc.returncode}, workers {sorted(listed)}: "
             f"{err.decode()[-2000:]}")
    # the metrics component: its slots are the four workers'
    import tempfile

    mport, tmp = free_port(), tempfile.mkdtemp(prefix="chip-smoke-metrics-")
    metrics = Proc(tmp, "metrics", "metrics", "--hub", addr, "--host", "127.0.0.1",
                   "--port", str(mport))
    try:
        want = sum(slots.values())
        t1 = time.perf_counter()
        while True:
            metrics.check_alive()
            with contextlib.suppress(OSError):
                status, body = await http_call(mport, "GET", "/metrics")
                got = re.search(rb'llm_requests_total_slots\{component="backend"\} (\S+)', body)
                if status == 200 and got and float(got.group(1)) == want:
                    break
            if time.perf_counter() - t1 > 60:
                fail(f"{what}: the metrics component never counted {want} slots: "
                     f"{metrics.log()[-2000:]}")
            await asyncio.sleep(0.2)
        await asyncio.to_thread(metrics.interrupt, what)
    finally:
        metrics.kill()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve-mocker: (f) GET /fleet lists {len(rows)} workers (roles "
          f"{sorted({w['role'] for w in rows.values()})}); stragglers "
          f"{[f'{w:x}' for w in sorted(flagged)]} == the rule's; the slowed mocker {slow_id:x} "
          f"quarantined, the batch on its prefix went to {[kinds[w] for w in placed]}; "
          f"/fleet/metrics holds the {len(need)} fleet families; fleet --once --json "
          f"and metrics ({want} slots) name the same {len(listed)} workers, exit codes 0; "
          f"{time.perf_counter() - t0:.3f} s")


def serve_mocker_phase(card: str, ckpt) -> None:
    """serve-mocker, on the card's host: ``hub``, two ``run in=dyn
    out=mocker`` workers (the second with ``DYN_FAULTS`` arming
    ``worker.slow``), one ``run in=dyn out=torch`` worker over ``ckpt`` (a
    2-layer Llama-3-8B-width checkpoint) and ``run in=http out=dyn
    --router-mode kv`` as five processes, and a fourth mocker worker in this
    process (``cli.serve_worker``, with its telemetry publisher).  (b) a
    prefix-sharing batch: every request answers, every repeat goes to its
    prefix's holder, or away from it while the front end's observatory
    has it quarantined; (c) each process worker's telemetry snapshot
    decodes and names its worker id and role; (d) the armed mocker's
    tokens come slower by its delay; (f) the front end's fleet observatory
    (:func:`mocker_observatory`); (e) ``crash()`` on the in-process mocker
    mid-stream: its lanes get the kill frame, the front end serves the
    rest.  SIGINT ends each process with exit code 0."""
    import shutil
    import tempfile

    path = ckpt[0]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mocker-")
    hub_port, http_port = free_port(), free_port()
    addr = f"127.0.0.1:{hub_port}"
    t0 = time.perf_counter()
    procs = []
    try:
        procs.append(Proc(tmp, "hub", "hub", "--host", "127.0.0.1", "--port", str(hub_port)))
        for name, env in (("mocker", None),
                          ("mocker-slow", {"DYN_FAULTS": f"seed=5;worker.slow=1:delay={MOCKER_SLOW_S}"})):
            procs.append(Proc(tmp, name, "run", "in=dyn", "out=mocker", "--model-path", path,
                              "--hub", addr, env=env))
        procs.append(Proc(tmp, "torch-worker", "run", "in=dyn", "out=torch", "--model-path",
                          path, "--hub", addr))
        procs.append(Proc(tmp, "frontend", "run", "in=http", "out=dyn", "--hub", addr,
                          "--router-mode", "kv", "--port", str(http_port)))
        asyncio.run(mocker_fleet(addr, http_port, path, procs, card))
        for p in reversed(procs):
            p.interrupt("serve-mocker")
        print(f"serve-mocker: exit codes {[p.proc.returncode for p in procs]} on SIGINT")
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve-mocker: phase {time.perf_counter() - t0:.3f} s")


# -- serve-moe: the Mixtral family -------------------------------------------------

# (a)'s small f32 MoE model: E = 4, K = 2 (K * cf >= E: nothing can drop)
MOE_SMALL = dict(head_dim=64, num_heads=4, num_kv_heads=2, num_layers=2,
                 num_experts=4, num_experts_per_tok=2)
# f32 logprobs, card against CPU: the attention kernels' f32 sums in
# another order than the plain versions' (F32_TOL on an output) and the
# expert products' GEMMs, carried through two layers and a log-softmax
MOE_LOGPROB_TOL = 1e-3
# bf16 sparse against dense dispatch where nothing drops: both run each
# expert's products as bf16 GEMMs with f32 sums, then combine; the dense
# combine weighs all E experts' rounded outputs (E - K of them by 0) in a
# bf16 einsum, the sparse one sums K weighted rows.  Each output is a sum
# of K rounded products, so the two may differ by a few bf16 steps of the
# larger term: |sparse - dense| <= MOE_BF16_RTOL * max|dense| (2^-6, four
# steps of 2^-8 relative)
MOE_BF16_RTOL = 2.0**-6
# (b): Mixtral-8x7B at 16 of its 32 layers (bf16: the card holds about 47
# GB of weights, the whole model is about 93 GB)
MOE_LAYERS = 16
# (d)'s checkpoint: small width, Mixtral's E and K, 2 layers
MOE_CKPT_CONFIG = {"model_type": "mixtral", "hidden_size": 256, "intermediate_size": 512,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 64, "num_local_experts": 8,
                   "num_experts_per_tok": 2, "rope_theta": 1000000.0,
                   "max_position_embeddings": 4096, "rms_norm_eps": 1e-5}
MOE_CHAT_TEMPLATE = (
    "{% for message in messages %}[INST] {{ message['content'] }} [/INST]{% endfor %}"
)


def top_err(a, b) -> float:
    """The largest logprob difference between two top-logprob structures
    of the same shape, or inf where their ids or shapes differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return math.inf
        return max((top_err(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return math.inf
        return max((top_err(x, y) for x, y in zip(a, b)), default=0.0)
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b))
    return 0.0 if a == b else math.inf


def moe_small(ref: Dict[str, object], card: str) -> None:
    """(a) A small f32 MoE model served on the card (kernels) and on the
    CPU (plain versions) from the same weights, the reference phase's
    batches with top-2 logprobs, under the default, classic and rectangle
    configs: equal greedy streams, logprobs within MOE_LOGPROB_TOL; and
    the dispatch itself card against CPU on 40 rows."""
    from dynamo_tpu_torch.engine import model as moe_model
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(**MOE_SMALL)
    params = init_params(cfg, 4, torch.device("cpu"), torch.float32)
    lp = {n: w[0] for n, w in params["layers"].items()}
    x = torch.randn(40, cfg.hidden_size, generator=torch.Generator().manual_seed(4))
    cpu_out = moe_model._moe_mlp(lp, x, cfg)
    card_out = moe_model._moe_mlp(params_on(lp, "cuda"), x.cuda(), cfg).cpu()
    err = (card_out - cpu_out).abs().max().item()
    if err > F32_TOL:
        fail(f"serve-moe (a): _moe_mlp card against CPU {err:.3e} > {F32_TOL:.0e}")
    batches = [[dict(r, sampling_options=dict(r["sampling_options"], logprobs=2)) for r in b]
               for b in ref["batches"]]
    want = [r["stop_conditions"]["max_tokens"] for b in batches for r in b]
    for name in ("default", "classic", "rectangle"):
        kw = REFERENCE_CONFIGS[name]
        out = {}
        for dev in ("cuda", "cpu"):
            eng = TorchEngine(cfg, params_on(params, dev),
                              EngineConfig(**ref["ecfg"], **kw), device=dev)
            out[dev] = asyncio.run(serve(eng, batches))
        streams = {dev: [r["tokens"] for r in res] for dev, res in out.items()}
        if streams["cuda"] != streams["cpu"]:
            fail(f"serve-moe (a) {name}: card streams {streams['cuda']} != cpu {streams['cpu']}")
        if [len(t) for t in streams["cuda"]] != want:
            fail(f"serve-moe (a) {name}: streams end early")
        if any(len(r["top"]) != len(r["tokens"]) for r in out["cuda"] + out["cpu"]):
            fail(f"serve-moe (a) {name}: a stream lacks its top-2 logprobs")
        lp_err = max(top_err(a["top"], b["top"]) for a, b in zip(out["cuda"], out["cpu"]))
        if not lp_err <= MOE_LOGPROB_TOL:
            fail(f"serve-moe (a) {name}: top-2 logprobs card against CPU {lp_err:.3e}")
        print(f"serve-moe: (a) {name} {sum(want)} greedy tokens card == CPU, top-2 logprob "
              f"max err {lp_err:.3e} (tol {MOE_LOGPROB_TOL:.0e}); _moe_mlp card against "
              f"CPU {err:.3e} on {card}")


def card_holders(top: int = 6) -> str:
    """Who holds the card's allocated bytes: the allocator's snapshot by
    memory pool (a CUDA graph's private pool has a pool id other than (0,
    0)), and the largest live CUDA tensors the garbage collector reaches,
    each with the chain of what refers to it (type names, a dict's first
    keys)."""
    by_pool: Dict[Tuple[int, int], int] = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        used = sum(b["size"] for b in seg["blocks"] if b["state"] == "active_allocated")
        by_pool[pool] = by_pool.get(pool, 0) + used
    seen, tensors = set(), []
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            ptr = o.untyped_storage().data_ptr()
            if ptr not in seen:
                seen.add(ptr)
                tensors.append(o)
    tensors.sort(key=lambda t: -t.untyped_storage().nbytes())
    skip = {id(tensors)}

    def name(o) -> str:
        if isinstance(o, dict):
            return f"dict{list(o)[:4]}"
        return type(o).__qualname__

    rows = []
    for t in tensors[:top]:
        chain, o = [], t
        for _ in range(4):
            refs = [r for r in gc.get_referrers(o)
                    if id(r) not in skip and not isinstance(r, (list, type(sys._getframe())))]
            if not refs:
                break
            o = refs[0]
            chain.append(name(o))
        rows.append(f"{tuple(t.shape)} {t.dtype} {t.untyped_storage().nbytes() / 2**20:.1f} MiB "
                    f"<- {' <- '.join(chain) or '?'}")
    pools = {str(k): round(v / 2**30, 3) for k, v in by_pool.items() if v}
    live = sum(t.untyped_storage().nbytes() for t in tensors) / 2**30
    return (f"allocated GiB by pool {pools}; {len(tensors)} live CUDA tensors reached, "
            f"{live:.3f} GiB; largest: {rows}")


def assert_card_free(what: str, plan, phase: str = "serve-moe") -> int:
    """Free the earlier phases' tensors; the card must have room for the
    plan's params, KV, scratch and dequantization.  Returns the bytes
    still allocated; above 0.1 GiB it prints who holds them."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    need = plan.param_bytes + plan.kv_bytes + plan.scratch_bytes + plan.dequant_bytes
    print(f"{phase}: {what} before: {held / 2**30:.3f} GiB still allocated, "
          f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB free, the plan needs "
          f"{need / 2**30:.3f}")
    if held > 0.1 * 2**30:
        print(f"{phase}: {what} still allocated: {card_holders()}")
    if free < need:
        fail(f"{phase} {what}: {held / 2**30:.3f} GiB still held, {free / 2**30:.3f} GiB "
             f"free, {need / 2**30:.3f} GiB needed")
    return held


def moe_dense_check(params, cfg, card: str) -> None:
    """``_moe_mlp`` against ``_moe_mlp_dense`` on layer 0 of the served
    weights, at a decode N (8) and a prefill N (512), with cf = E / K so
    that nothing drops."""
    from dynamo_tpu_torch.engine import model as moe_model

    dropless = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts
                                   / cfg.num_experts_per_tok)
    lp = {n: w[0] for n, w in params["layers"].items()}
    dev = lp["router"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for n in (8, 512):
        x = torch.randn(n, cfg.hidden_size, device=dev, generator=gen).to(lp["router"].dtype)
        sparse = moe_model._moe_mlp(lp, x, dropless).float()
        dense = moe_model._moe_mlp_dense(lp, x, dropless).float()
        err = (sparse - dense).abs().max().item()
        bound = MOE_BF16_RTOL * dense.abs().max().item()
        print(f"serve-moe: (b) _moe_mlp against _moe_mlp_dense at N={n}: max err {err:.4e} "
              f"(bound {bound:.4e}, max |dense| {dense.abs().max().item():.4e}) on {card}")
        if not err <= bound:
            fail(f"serve-moe (b): _moe_mlp differs from _moe_mlp_dense at N={n}: {err} > {bound}")


def moe_run_line(what: str, engine, res, wall, warm, wall_w, peak_gib: float,
                 drops: Tuple[int, int], card: str) -> None:
    st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
    share = drops[1] / drops[0] if drops[0] else float("nan")
    print(f"serve-moe: {what} wall_s={wall:.3f} tok_s={st['tok_s']:.3f} "
          f"decode_phase_tok_s={st['dec']:.3f} ttft_ms="
          f"{[round(r['ttft'] * 1e3, 3) for r in res[1:]]} peak_mem_gib={peak_gib:.3f} (above "
          f"the phase's start) "
          f"dispatches_by_k={dict(engine.dispatches_by_k)} on {card}")
    print(f"serve-moe: {what} warm wall_s={wall_w:.3f} tok_s={st_w['tok_s']:.3f} "
          f"decode_phase_tok_s={st_w['dec']:.3f} ttft_ms="
          f"{[round(r['ttft'] * 1e3, 3) for r in warm]} dropped {drops[1]} of {drops[0]} "
          f"assignments (share {share:.6f}) on {card}")


def moe_serve(engine, primer, batch, max_tokens: int, what: str, card: str, base: int):
    """One served run, cold then warm, with the drop counter on: streams
    checked, launch invariants held; returns the streams, the kernels'
    launches, the warm batch's dropped assignments and the peak bytes
    above ``base`` (what the card held before the phase made its
    weights: tensors earlier phases left are not this run's)."""
    from dynamo_tpu_torch.engine.model import moe_counts

    def read() -> Tuple[int, int]:
        torch.cuda.synchronize()  # the engine's streams too
        return moe_counts(engine.device)

    at_warm = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, wall, warm, wall_w, marks = serve_cold_warm(
        engine, primer, batch, hook=lambda: at_warm.update(n=read())
    )
    counted = read_launches()
    end = read()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check_launch_invariants(f"serve-moe: {what}", engine, counted)
    for i, r in enumerate(res[1:] + warm):
        if len(r["tokens"]) != max_tokens or r["finish"] != "length":
            fail(f"serve-moe {what} request {i}: {len(r['tokens'])} tokens, finish {r['finish']}")
    drops = (end[0] - at_warm["n"][0], end[1] - at_warm["n"][1])
    moe_run_line(what, engine, res, wall, warm, wall_w, peak_gib, drops, card)
    print(f"serve-moe: {what} {loop_line(engine, wall + wall_w)}")
    return dict(streams=[r["tokens"] for r in res[1:] + warm], launches=counted,
                drops=drops, peak_gib=peak_gib)


def moe_width(card: str) -> Dict[str, int]:
    """(b) Mixtral-8x7B's widths at 16 layers, bf16, random weights of
    seed 0 made once: the memory plan's ``param_bytes`` against the bytes
    the card allocated for them; sparse against dense dispatch; then
    serve's primer and batch (pipelined, 8 lanes, page 16, 1024 pages),
    cold and warm, at the preset's cf = 2 with the warm batch's dropped
    share; and at cf = E / K, where no assignment can drop, the pipelined
    loop against the serial one (at cf = 2 a row's output depends on the
    rows it is dispatched with, and the two loops dispatch lanes that have
    finished differently).  Returns the preset run's launches."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.memory_plan import plan_memory
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.mixtral_8x7b(num_layers=MOE_LAYERS)
    plan = plan_memory(cfg, num_pages=1024)
    if not plan.fits:
        fail(f"serve-moe (b): the plan does not fit: {plan}")
    before = assert_card_free("(b)", plan)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - before
    print(f"serve-moe: (b) Mixtral-8x7B widths, {MOE_LAYERS} layers, bf16: weights "
          f"{weights} bytes ({weights / 2**30:.3f} GiB) made in {init_s:.3f} s; plan "
          f"param_bytes {plan.param_bytes}, kv {plan.kv_bytes}, scratch {plan.scratch_bytes} "
          f"on {card}")
    if weights != plan.param_bytes:
        fail(f"serve-moe (b): the card holds {weights} weight bytes, the plan {plan.param_bytes}")
    moe_dense_check(params, cfg, card)
    primer, batch = serve_requests(cfg.vocab_size)
    dropless = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts
                                   / cfg.num_experts_per_tok)
    runs = []
    for what, model_cfg, pipelined in (("(b) cf=2 pipelined", cfg, True),
                                        ("(b) cf=4 pipelined", dropless, True),
                                        ("(b) cf=4 serial", dropless, False)):
        engine = TorchEngine(model_cfg, params, EngineConfig(num_pages=1024,
                                                             async_dispatch=pipelined))
        runs.append(moe_serve(engine, primer, batch, 64, what, card, before))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    preset, runs = runs[0], runs[1:]
    if runs[1]["streams"] != runs[0]["streams"]:
        fail("serve-moe (b): at cf=4 the serial loop's streams differ from the pipelined loop's")
    if runs[0]["drops"][1] or runs[1]["drops"][1]:
        fail(f"serve-moe (b): cf=4 dropped assignments: {runs[0]['drops']}, {runs[1]['drops']}")
    same = sum(a == b for a, b in zip(preset["streams"], runs[0]["streams"]))
    print(f"serve-moe: (b) cf=4 pipelined == serial ({len(runs[0]['streams'])} streams); "
          f"cf=2 streams equal to cf=4's: {same} of {len(runs[0]['streams'])} (reported: drops "
          f"at cf=2 move rows)")
    for name in ("packed_ragged_attention", "paged_decode_attention"):
        if preset["launches"][name] <= 0:
            fail(f"serve-moe (b): {name} never launched")
    del params
    return {k: preset["launches"][k] for k in ("packed_ragged_attention", "paged_decode_attention")}


def moe_int8(card: str) -> Dict[str, int]:
    """(c) The whole Mixtral-8x7B, 32 layers, int8 weights made and
    quantized one layer at a time (``TorchEngine.random_init`` under
    ``quantize="int8"``): 8 requests of 32 new tokens, cold then warm;
    peak memory under the card's and within the plan's int8 figure (params,
    KV, scratch and the dequantization transient)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.memory_plan import plan_memory
    from dynamo_tpu_torch.engine.quant import QuantizedTensor, weight_bytes

    cfg = ModelConfig.mixtral_8x7b()
    plan = plan_memory(cfg, quantize="int8", num_pages=1024)
    base = assert_card_free("(c)", plan)
    total = plan.hbm_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024, quantize="int8"), seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    held = weight_bytes(engine.params)
    if not isinstance(engine.params["layers"]["w_gate"], QuantizedTensor) or held != plan.param_bytes:
        fail(f"serve-moe (c): int8 weights hold {held} bytes, the plan {plan.param_bytes}")
    print(f"serve-moe: (c) Mixtral-8x7B, 32 layers, int8 weights {held / 2**30:.3f} GiB "
          f"(plan {plan.param_bytes / 2**30:.3f}) made layer by layer in {init_s:.3f} s, "
          f"init peak {init_peak / 2**30:.3f} GiB on {card}")
    primer, batch = serve_requests(cfg.vocab_size)
    batch = [dict(r, stop_conditions={"max_tokens": 32}) for r in batch]
    run = moe_serve(engine, primer, batch, 32, "(c) int8 pipelined", card, base)
    bound = plan.param_bytes + plan.kv_bytes + plan.scratch_bytes + plan.dequant_bytes
    print(f"serve-moe: (c) peak {run['peak_gib']:.3f} GiB above the phase's start against the "
          f"plan's params + kv + scratch + dequant {bound / 2**30:.3f} GiB and the card's "
          f"{total / 2**30:.3f} GiB")
    if run["peak_gib"] * 2**30 > min(bound, total - base):
        fail(f"serve-moe (c): peak {run['peak_gib']:.3f} GiB over the plan's "
             f"{bound / 2**30:.3f} GiB or the card's")
    del engine
    return {k: run["launches"][k] for k in ("packed_ragged_attention", "paged_decode_attention")}


def write_sentencepiece_tokenizer(path: str) -> int:
    """A SentencePiece-style ``tokenizer.json`` of the older published
    form (Llama 2, Mistral, Mixtral): ``<unk>``, ``<s>``, ``</s>``, the
    byte tokens ``<0x80>`` to ``<0xFF>`` (every non-ASCII character falls
    back to them; ASCII is in the alphabet), ``▁``, printable ASCII, tab
    and newline, then ``▁`` words of one to three lowercase letters merged
    character by character (about 10900 ids, so that a random model's
    stream holds few byte tokens: a run of them that is not UTF-8 is
    refused by the incremental decode, as by the Rust core's);
    normalizer ``Prepend("▁")`` + ``Replace(" ", "▁")``, BPE with
    ``byte_fallback``, decoder ``Replace`` / ``ByteFallback`` / ``Fuse`` /
    ``Strip``; and a ``tokenizer_config.json``.  Returns the vocabulary
    size."""
    import itertools
    import string

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(128, 256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in ["▁", "\t", "\n"] + [chr(c) for c in range(33, 127)]:
        vocab[c] = len(vocab)
    merges: List[List[str]] = []
    letters = string.ascii_lowercase
    words = itertools.chain(
        letters, ("".join(p) for p in itertools.product(letters, repeat=2)),
        itertools.islice(("".join(p) for p in itertools.product(letters, repeat=3)), 10000),
    )
    for w in ("▁" + w for w in words):
        a, b = w[:-1], w[-1]
        merges.append([a, b])
        vocab[w] = len(vocab)
    added = [{"id": i, "content": s, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, s in enumerate(("<unk>", "<s>", "</s>"))]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>",
                   "chat_template": MOE_CHAT_TEMPLATE}, f)
    return len(vocab)


def write_moe_checkpoint(tmp: str) -> str:
    """(d)'s checkpoint: ``config.json`` (Mixtral layout at small width),
    the SentencePiece-style tokenizer, and ``model.safetensors`` under
    Mixtral's names (``block_sparse_moe.gate``, ``experts.{e}.w1/w3/w2``)
    from random bf16 weights of seed 7."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model import init_params

    path = os.path.join(tmp, "mixtral")
    os.makedirs(path)
    vocab = write_sentencepiece_tokenizer(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(MOE_CKPT_CONFIG, vocab_size=vocab), f)
    cfg = ModelConfig.from_pretrained(path)
    p = init_params(cfg, 7, torch.device("cuda"), torch.bfloat16)
    lay = {n: w.float().cpu().numpy() for n, w in p["layers"].items()}
    H, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    tensors = {
        "model.embed_tokens.weight": ((V, H), lambda: p["embed"].float().cpu().numpy()),
        "model.norm.weight": ((H,), lambda: p["final_norm"].float().cpu().numpy()),
        "lm_head.weight": ((V, H), lambda: p["lm_head"].float().cpu().numpy().T),
    }
    attn = {"wq": ("self_attn.q_proj", (q, H)), "wk": ("self_attn.k_proj", (kv, H)),
            "wv": ("self_attn.v_proj", (kv, H)), "wo": ("self_attn.o_proj", (H, q))}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for key, (name, shape) in attn.items():
            tensors[pre + name + ".weight"] = (shape, lambda k=key, i=i: lay[k][i].T)
        tensors[pre + "block_sparse_moe.gate.weight"] = (
            (cfg.num_experts, H), lambda i=i: lay["router"][i].T)
        for e in range(cfg.num_experts):
            for key, w, shape in (("w_gate", "w1", (I, H)), ("w_up", "w3", (I, H)),
                                  ("w_down", "w2", (H, I))):
                tensors[pre + f"block_sparse_moe.experts.{e}.{w}.weight"] = (
                    shape, lambda k=key, i=i, e=e: lay[k][i, e].T)
        tensors[pre + "input_layernorm.weight"] = ((H,), lambda i=i: lay["input_norm"][i])
        tensors[pre + "post_attention_layernorm.weight"] = (
            (H,), lambda i=i: lay["post_norm"][i])
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    del p
    return path


def moe_cli_requests(vocab: int) -> Tuple[List[dict], dict]:
    """(d)'s greedy requests: three token-id completions and a chat whose
    text falls back to bytes."""
    rng = np.random.default_rng(9)
    reqs = [request(rng.integers(3, vocab, n), 16) for n in (5, 40, 300)]
    chat = {"model": "mixtral", "max_tokens": 16,
            "messages": [{"role": "user", "content": "Hello from the port! Ça va? 😀 日本"}]}
    return reqs, chat


def moe_cli(tmp: str, card: str) -> None:
    """(d) ``python -m dynamo_tpu_torch run in=http out=torch --model-path
    DIR`` over a Mixtral-layout checkpoint with a SentencePiece-style
    tokenizer, in a subprocess (SIGINT ends it with exit code 0), against
    an in-process engine loaded from the same directory
    (``TorchEngine.from_pretrained``) behind the HTTP service: the same
    texts."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer
    from dynamo_tpu_torch.runtime.pipeline import link

    path = write_moe_checkpoint(tmp)
    tok = Tokenizer.from_model_dir(path)
    vocab = tok.vocab_size
    port = free_port()
    cli = Proc(tmp, "moe-cli", "run", "in=http", "out=torch", "--model-path", path,
               "--model-name", "mixtral", "--port", str(port))
    try:
        up = wait_http(port, "/health", lambda body: True, [cli], "serve-moe (d)")
        cli_texts = asyncio.run(ask_texts(port, "serve-moe (d)", moe_cli_requests(vocab)))
        cli.interrupt("serve-moe (d)")
    finally:
        cli.kill()
    engine = TorchEngine.from_pretrained(path)
    if not engine.model_cfg.is_moe or engine.model_cfg.num_experts != 8:
        fail(f"serve-moe (d): the checkpoint loaded as {engine.model_cfg}")

    async def in_process() -> List[str]:
        pipe = link(OpenAIPreprocessor("mixtral", tok), Backend(tok), engine)
        manager = ModelManager()
        manager.add_completion_model("mixtral", pipe)
        manager.add_chat_model("mixtral", pipe)
        service = HttpService(manager, port=0)
        await service.start()
        try:
            return await ask_texts(service.address[1], "serve-moe (d) in process",
                                   moe_cli_requests(vocab))
        finally:
            await service.stop()
            await engine.stop()

    reset_launches()
    direct = asyncio.run(in_process())
    check_launch_invariants("serve-moe: (d) in process", engine, read_launches())
    del engine
    print(f"serve-moe: (d) CLI healthy after {up:.3f} s, exit code 0; texts "
          f"{[t[:40] for t in cli_texts]} on {card}")
    if cli_texts != direct:
        fail(f"serve-moe (d): the CLI's texts {cli_texts} differ from the in-process "
             f"engine's {direct}")
    if not all(cli_texts):
        fail(f"serve-moe (d): an empty text: {cli_texts}")


def serve_moe_phase(ref: Dict[str, object], card: str) -> Dict[str, Dict[str, int]]:
    """The Mixtral family: (a) card against CPU on a small f32 MoE model,
    (b) Mixtral-8x7B's widths at 16 layers in bf16, (c) the whole model
    in int8, (d) the CLI on a Mixtral-layout checkpoint.  Returns (b)'s
    and (c)'s launches of kernels 5 and 1."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    moe_small(ref, card)
    width = moe_width(card)
    whole = moe_int8(card)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-moe-")
    try:
        moe_cli(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve-moe: phase {time.perf_counter() - t0:.3f} s; launches (b) {width}, "
          f"(c) {whole} on {card}")
    return {"b": width, "c": whole}


# ---------------------------------------------------------------------------
# serve-geometry: the head geometries beyond Llama-3-8B's
# ---------------------------------------------------------------------------

# (a): small f32 models at the head counts and head dims of published
# checkpoints (hidden 128, 2 layers): group 1 (Llama-2-7B), 3 (Llama-3.2-3B),
# 7 (Qwen2-7B, its qkv bias), 8 (Llama-3-70B), D 96 (Phi-3-mini, a window
# shorter than the longest prompt) and D 256 (Gemma-7B, its GELU, offset
# norm and scaled embeddings)
GEOM_SMALL = {
    "group1-32-32-128": dict(num_heads=32, num_kv_heads=32, head_dim=128),
    "group3-24-8-128": dict(num_heads=24, num_kv_heads=8, head_dim=128),
    "group7-28-4-128": dict(num_heads=28, num_kv_heads=4, head_dim=128, attention_bias=True),
    "group8-64-8-128": dict(num_heads=64, num_kv_heads=8, head_dim=128),
    "d96-32-32-96": dict(num_heads=32, num_kv_heads=32, head_dim=96, sliding_window=32),
    "d256-16-16-256": dict(num_heads=16, num_kv_heads=16, head_dim=256,
                           hidden_act="gelu_tanh", rms_norm_offset=True,
                           scale_embeddings=True, tie_word_embeddings=True),
}
# (b): Llama-3-70B at 16 of its 80 layers in bf16 (about 29 GiB of weights)
GEOM_70B_LAYERS = 16
# (d): the published config.json values of three checkpoints, served at
# GEOM_WIDTH_LAYERS layers in bf16
GEOM_HF_CONFIGS = {
    "qwen2_7b": {"model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
                 "intermediate_size": 18944, "num_hidden_layers": 28,
                 "num_attention_heads": 28, "num_key_value_heads": 4,
                 "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
                 "max_position_embeddings": 131072, "use_sliding_window": False},
    "gemma_7b": {"model_type": "gemma", "vocab_size": 256000, "hidden_size": 3072,
                 "intermediate_size": 24576, "num_hidden_layers": 28,
                 "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256,
                 "hidden_activation": "gelu_pytorch_tanh", "rope_theta": 10000.0,
                 "rms_norm_eps": 1e-6, "max_position_embeddings": 8192,
                 "tie_word_embeddings": True},
    "phi3_mini": {"model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
                  "intermediate_size": 8192, "num_hidden_layers": 32,
                  "num_attention_heads": 32, "num_key_value_heads": 32,
                  "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                  "max_position_embeddings": 4096, "sliding_window": 2047},
}
GEOM_WIDTH_LAYERS = 2


def geometry_small(ref: Dict[str, object], card: str) -> None:
    """(a) Each small model on the card and on the CPU from the same f32
    weights, under the default config and over the int8 pool: identical
    greedy streams of the reference phase's first batch."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    batch = [dict(r, stop_conditions={"max_tokens": 12}) for r in ref["batches"][0][:3]]
    for name, over in GEOM_SMALL.items():
        cfg = ModelConfig.tiny(hidden_size=128, intermediate_size=256, num_layers=2, **over)
        params = init_params(cfg, 4, torch.device("cpu"), torch.float32)
        for kv in ("dense", "int8"):
            ecfg = EngineConfig(**ref["ecfg"], **({"kv_dtype": "int8"} if kv == "int8" else {}))
            streams = {}
            for dev in ("cuda", "cpu"):
                eng = TorchEngine(cfg, params_on(params, dev), ecfg, device=dev)
                streams[dev] = [r["tokens"] for r in asyncio.run(serve(eng, [batch]))]
            print(f"serve-geometry: (a) {name} {kv} card {streams['cuda']}")
            if streams["cuda"] != streams["cpu"]:
                fail(f"serve-geometry (a) {name} {kv}: card {streams['cuda']} != cpu "
                     f"{streams['cpu']}")
            if [len(t) for t in streams["cuda"]] != [12] * len(batch):
                fail(f"serve-geometry (a) {name} {kv}: streams end early")


def geometry_serve(engine, primer, batch, max_tokens: int, what: str, card: str,
                   base: int, phase: str = "serve-geometry") -> Dict[str, object]:
    """One served run, cold then warm: every stream ends with its
    ``max_tokens``, the launch invariants hold; prints tok/s, the
    decode-phase rate, TTFT and the peak above ``base``."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, wall, warm, wall_w, marks = serve_cold_warm(engine, primer, batch)
    counted = read_launches()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check_launch_invariants(f"{phase}: {what}", engine, counted)
    for i, r in enumerate(res[1:] + warm):
        if len(r["tokens"]) != max_tokens or r["finish"] != "length":
            fail(f"{phase} {what} request {i}: {len(r['tokens'])} tokens, "
                 f"finish {r['finish']}")
    st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
    print(f"{phase}: {what} wall_s={wall:.3f} tok_s={st['tok_s']:.3f} "
          f"decode_phase_tok_s={st['dec']:.3f} ttft_ms="
          f"{[round(r['ttft'] * 1e3, 3) for r in res[1:]]} peak_mem_gib={peak_gib:.3f} "
          f"(above the run's start) dispatches_by_k={dict(engine.dispatches_by_k)} on {card}")
    print(f"{phase}: {what} warm wall_s={wall_w:.3f} tok_s={st_w['tok_s']:.3f} "
          f"decode_phase_tok_s={st_w['dec']:.3f} ttft_ms="
          f"{[round(r['ttft'] * 1e3, 3) for r in warm]} on {card}")
    print(f"{phase}: {what} {loop_line(engine, wall + wall_w)}")
    return dict(launches=counted, peak_gib=peak_gib, tok_s=st["tok_s"],
                tok_s_warm=st_w["tok_s"])


def geometry_70b(card: str) -> Dict[str, int]:
    """(b) Llama-3-70B's widths at GEOM_70B_LAYERS layers, bf16, random
    weights of seed 0, ``EngineConfig(num_pages=1024)``: the plan printed,
    serve's primer and batch cold and warm.  Returns its launches."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.memory_plan import plan_memory

    cfg = ModelConfig.llama3_70b(num_layers=GEOM_70B_LAYERS)
    plan = plan_memory(cfg, num_pages=1024)
    print(f"serve-geometry: (b) Llama-3-70B, {GEOM_70B_LAYERS} layers, bf16: plan params "
          f"{plan.param_bytes / 2**30:.3f} GiB, kv {plan.kv_bytes / 2**30:.3f}, scratch "
          f"{plan.scratch_bytes / 2**30:.3f}, reserve {plan.reserve_bytes / 2**30:.3f}, whole "
          f"{plan.total_bytes / 2**30:.3f} of {plan.hbm_bytes / 2**30:.3f} GiB, fits {plan.fits}")
    if not plan.fits:
        fail(f"serve-geometry (b): the plan does not fit: {plan}")
    base = assert_card_free("(b)", plan, "serve-geometry")
    t0 = time.perf_counter()
    engine = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024), seed=0)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    print(f"serve-geometry: (b) made in {time.perf_counter() - t0:.3f} s: "
          f"{weights / 2**30:.3f} GiB allocated (plan params + kv "
          f"{(plan.param_bytes + plan.kv_bytes) / 2**30:.3f}) on {card}")
    primer, batch = serve_requests(cfg.vocab_size)
    run = geometry_serve(engine, primer, batch, 64, "(b) Llama-3-70B 16 layers", card, base)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def geometry_70b_int8(card: str) -> Dict[str, int]:
    """(c) The whole Llama-3-70B, 80 layers, int8 weights made and
    quantized one layer at a time, ``EngineConfig(num_pages=256,
    max_batch_size=4, quantize="int8")``: the plan printed, four of serve's
    requests with 16 new tokens, cold and warm; the peak under the card's
    memory and the plan's params + KV + scratch + dequantization."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.memory_plan import plan_memory
    from dynamo_tpu_torch.engine.quant import weight_bytes

    cfg = ModelConfig.llama3_70b()
    plan = plan_memory(cfg, quantize="int8", num_pages=256, max_batch_size=4)
    print(f"serve-geometry: (c) Llama-3-70B, 80 layers, int8 weights: plan params "
          f"{plan.param_bytes / 2**30:.3f} GiB, kv {plan.kv_bytes / 2**30:.3f}, scratch "
          f"{plan.scratch_bytes / 2**30:.3f}, dequant {plan.dequant_bytes / 2**30:.3f}, reserve "
          f"{plan.reserve_bytes / 2**30:.3f}, whole {plan.total_bytes / 2**30:.3f} of "
          f"{plan.hbm_bytes / 2**30:.3f} GiB, fits {plan.fits}")
    if not plan.fits:
        fail(f"serve-geometry (c): the plan does not fit: {plan}")
    base = assert_card_free("(c)", plan, "serve-geometry")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchEngine.random_init(
        cfg, EngineConfig(num_pages=256, max_batch_size=4, quantize="int8"), seed=0
    )
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - base
    held = weight_bytes(engine.params)
    print(f"serve-geometry: (c) int8 weights {held / 2**30:.3f} GiB (plan "
          f"{plan.param_bytes / 2**30:.3f}) made layer by layer in "
          f"{time.perf_counter() - t0:.3f} s, init peak {init_peak / 2**30:.3f} GiB on {card}")
    if held != plan.param_bytes:
        fail(f"serve-geometry (c): int8 weights hold {held} bytes, the plan {plan.param_bytes}")
    primer, batch = serve_requests(cfg.vocab_size)
    primer = [request(r["token_ids"][:64], 4) for r in primer]
    batch = [dict(r, stop_conditions={"max_tokens": 16}) for r in batch[2:6]]
    run = geometry_serve(engine, primer, batch, 16, "(c) Llama-3-70B 80 layers int8", card, base)
    bound = plan.param_bytes + plan.kv_bytes + plan.scratch_bytes + plan.dequant_bytes
    total = plan.hbm_bytes
    print(f"serve-geometry: (c) peak {run['peak_gib']:.3f} GiB above the phase's start against "
          f"the plan's params + kv + scratch + dequant {bound / 2**30:.3f} GiB and the card's "
          f"{total / 2**30:.3f} GiB")
    if run["peak_gib"] * 2**30 > min(bound, total - base):
        fail(f"serve-geometry (c): peak {run['peak_gib']:.3f} GiB over the plan's "
             f"{bound / 2**30:.3f} GiB or the card's")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def geometry_widths(card: str) -> Dict[str, Dict[str, int]]:
    """(d) Qwen2-7B, Gemma-7B and Phi-3-mini from their published
    config.json values at GEOM_WIDTH_LAYERS layers, bf16, random weights of
    seed 0, ``EngineConfig(num_pages=1024)``: serve's batch once under the
    default config and once classic (``mixed_batching=False``, whose full
    prefills launch kernel 2), 32 new tokens a request; every stream ends
    with them and the launch invariants hold.  Returns each model's
    launches (kernels 1 and 5 of the default run, 2 of the classic)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    out = {}
    for name, hf in GEOM_HF_CONFIGS.items():
        cfg = ModelConfig.from_hf_config(dict(hf, num_hidden_layers=GEOM_WIDTH_LAYERS))
        params = init_params(cfg, 0, torch.device("cuda"), torch.bfloat16)
        _, batch = serve_requests(cfg.vocab_size)
        batch = [dict(r, stop_conditions={"max_tokens": 32}) for r in batch]
        counted = {}
        for what, kw in (("default", {}), ("classic", dict(mixed_batching=False))):
            engine = TorchEngine(cfg, params, EngineConfig(num_pages=1024, **kw))
            reset_launches()
            t0 = time.perf_counter()
            res = asyncio.run(serve(engine, [batch]))
            wall = time.perf_counter() - t0
            counted[what] = read_launches()
            check_launch_invariants(f"serve-geometry: (d) {name} {what}", engine,
                                    counted[what])
            for i, r in enumerate(res):
                if len(r["tokens"]) != 32 or r["finish"] != "length":
                    fail(f"serve-geometry (d) {name} {what} request {i}: "
                         f"{len(r['tokens'])} tokens, finish {r['finish']}")
            print(f"serve-geometry: (d) {name} {what} Hq={cfg.num_heads} "
                  f"Hkv={cfg.num_kv_heads} D={cfg.head_dim} window={cfg.sliding_window} "
                  f"{GEOM_WIDTH_LAYERS} layers: wall_s={wall:.3f} "
                  f"tok_s={sum(len(r['tokens']) for r in res) / wall:.3f} on {card}")
            del engine
        out[name] = {
            "paged_decode_attention": counted["default"]["paged_decode_attention"],
            "packed_ragged_attention": counted["default"]["packed_ragged_attention"],
            "flash_prefill_attention": counted["classic"]["flash_prefill_attention"],
        }
        for kernel, n in out[name].items():
            if n <= 0:
                fail(f"serve-geometry (d) {name}: {kernel} never launched")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_geometry_phase(ref: Dict[str, object], card: str) -> Dict[str, Dict[str, int]]:
    """The head geometries beyond Llama-3-8B's: (a) small f32 models card
    against CPU, (b) Llama-3-70B's widths at 16 layers in bf16, (c) the
    whole Llama-3-70B with int8 weights, (d) Qwen2-7B, Gemma-7B and
    Phi-3-mini at two layers.  Returns each model's launches of the kernels
    its timed rows measure."""
    t0 = time.perf_counter()
    geometry_small(ref, card)
    t_a = time.perf_counter()
    b = geometry_70b(card)
    t_b = time.perf_counter()
    c = geometry_70b_int8(card)
    t_c = time.perf_counter()
    widths = geometry_widths(card)
    t_d = time.perf_counter()
    print(f"serve-geometry: phase {t_d - t0:.3f} s ((a) {t_a - t0:.3f}, (b) {t_b - t_a:.3f}, "
          f"(c) {t_c - t_b:.3f}, (d) {t_d - t_c:.3f}); launches (b) "
          f"{ {k: b[k] for k in ('packed_ragged_attention', 'paged_decode_attention')} }, (c) "
          f"{ {k: c[k] for k in ('packed_ragged_attention', 'paged_decode_attention')} }, "
          f"(d) {widths} on {card}")
    for kernel in ("packed_ragged_attention", "paged_decode_attention"):
        if b[kernel] <= 0 or c[kernel] <= 0:
            fail(f"serve-geometry: {kernel} never launched at Llama-3-70B's geometry")
    return {"llama3_70b": b, **widths}


# ---------------------------------------------------------------------------
# serve-gguf: GGUF checkpoints, the Unigram tokenizer and eval
# ---------------------------------------------------------------------------

# ggml tensor types (ggml.h) and their (elements, bytes) per block
GGUF_F32, GGUF_F16, GGUF_Q4_0, GGUF_Q8_0, GGUF_BF16 = 0, 1, 2, 8, 30
GGUF_BLOCKS = {GGUF_Q4_0: (32, 18), GGUF_Q8_0: (32, 34)}
GGUF_PLAIN = {GGUF_F32: torch.float32, GGUF_F16: torch.float16, GGUF_BF16: torch.bfloat16}
GGUF_ALIGN = 32
# tensor kind -> (the port's leaf, whether the leaf is the [in, out] transpose)
GGUF_LEAVES = {
    "token_embd": ("embed", False), "output": ("lm_head", True),
    "output_norm": ("final_norm", False), "attn_q": ("wq", True), "attn_k": ("wk", True),
    "attn_v": ("wv", True), "attn_output": ("wo", True), "ffn_gate": ("w_gate", True),
    "ffn_up": ("w_up", True), "ffn_down": ("w_down", True),
    "attn_norm": ("input_norm", False), "ffn_norm": ("post_norm", False),
}
# (a): each kind in another type, so each file carries the five
GGUF_SMALL_TYPES = {
    "spm": {"token_embd": GGUF_F16, "output": GGUF_Q8_0, "output_norm": GGUF_F32,
            "attn_q": GGUF_Q8_0, "attn_k": GGUF_Q4_0, "attn_v": GGUF_BF16,
            "attn_output": GGUF_F32, "ffn_gate": GGUF_Q4_0, "ffn_up": GGUF_Q8_0,
            "ffn_down": GGUF_F16, "attn_norm": GGUF_F32, "ffn_norm": GGUF_BF16},
    # tied: no output tensor
    "gpt2": {"token_embd": GGUF_BF16, "output_norm": GGUF_F16, "attn_q": GGUF_Q4_0,
             "attn_k": GGUF_Q8_0, "attn_v": GGUF_F16, "attn_output": GGUF_BF16,
             "ffn_gate": GGUF_Q8_0, "ffn_up": GGUF_Q4_0, "ffn_down": GGUF_F32,
             "attn_norm": GGUF_F32, "ffn_norm": GGUF_F32},
}
# (b): the usual Q4_0 file -- a Q4_0 trunk and token_embd, a Q8_0 output,
# F32 norms
GGUF_Q4_TYPES = dict({k: GGUF_Q4_0 for k in GGUF_LEAVES}, output=GGUF_Q8_0,
                     output_norm=GGUF_F32, attn_norm=GGUF_F32, ffn_norm=GGUF_F32)
# (c): a Q8_0 trunk, an F16 token_embd
GGUF_Q8_TYPES = dict({k: GGUF_Q8_0 for k in GGUF_LEAVES}, token_embd=GGUF_F16,
                     output_norm=GGUF_F32, attn_norm=GGUF_F32, ffn_norm=GGUF_F32)
MISTRAL_TEMPLATE = (
    "{% for message in messages %}{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}{% else %}"
    "{{ message['content'] + eos_token }}{% endif %}{% endfor %}"
)
GGUF_EVAL_WINDOWS = (512, 2048)
# (c): Llama-3-8B's widths at 4 of its 32 layers
GGUF_8B_LAYERS = 4
# card against CPU: f32 eval sums in another order (tiled attention, GEMM
# blocking), some 1e-6 relative
GGUF_EVAL_RTOL = 1e-4
# the echo scoring and eval's first window: two routes through kernel 2 in
# bf16, at other GEMM shapes
GGUF_ECHO_RTOL = 1e-2
# the eval CLI against in-process eval, both in bf16 on the card (the CLI
# prints 4 decimals)
GGUF_CLI_RTOL = 1e-3


def gguf_nbytes(gtype: int, shape: Tuple[int, ...]) -> int:
    n = math.prod(shape)
    if gtype in GGUF_BLOCKS:
        per, nbytes = GGUF_BLOCKS[gtype]
        return n // per * nbytes
    return n * GGUF_PLAIN[gtype].itemsize


def gguf_value(v) -> bytes:
    """A metadata value: bool, u32, f32, string, or an array of strings,
    f32s or u32s (the types ``tests/test_gguf.py``'s writer uses)."""
    def s(txt: str) -> bytes:
        b = txt.encode()
        return struct.pack("<Q", len(b)) + b

    if isinstance(v, bool):
        return struct.pack("<IB", 7, int(v))
    if isinstance(v, int):
        return struct.pack("<II", 4, v)
    if isinstance(v, float):
        return struct.pack("<If", 6, v)
    if isinstance(v, str):
        return struct.pack("<I", 8) + s(v)
    if v and isinstance(v[0], float):
        return struct.pack("<IIQ", 9, 6, len(v)) + np.asarray(v, "<f4").tobytes()
    if v and isinstance(v[0], int):
        return struct.pack("<IIQ", 9, 4, len(v)) + np.asarray(v, "<u4").tobytes()
    return struct.pack("<IIQ", 9, 8, len(v)) + b"".join(s(x) for x in v)


def write_gguf(path: str, meta: Dict[str, object],
               tensors: List[Tuple[str, Tuple[int, ...], int]],
               make: Callable[[str], bytes]) -> int:
    """A GGUF v3 file streamed tensor by tensor: the header, metadata and
    tensor infos (``(name, numpy shape, ggml type)``, offsets from the
    types' sizes), then each tensor's bytes as ``make(name)`` gives them,
    each padded to ``GGUF_ALIGN``.  Returns the file's bytes."""
    head = [struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(meta))]
    for k, v in meta.items():
        head.append(struct.pack("<Q", len(k.encode())) + k.encode() + gguf_value(v))
    offset = 0
    for name, shape, gtype in tensors:
        dims = tuple(reversed(shape))  # ggml ne: the contiguous dim first
        head.append(struct.pack("<Q", len(name.encode())) + name.encode()
                    + struct.pack(f"<I{len(dims)}QIQ", len(dims), *dims, gtype, offset))
        size = gguf_nbytes(gtype, shape)
        offset += size + (-size) % GGUF_ALIGN
    blob = b"".join(head)
    with open(path, "wb") as f:
        f.write(blob + b"\0" * ((-len(blob)) % GGUF_ALIGN))
        for name, shape, gtype in tensors:
            raw = make(name)
            if len(raw) != gguf_nbytes(gtype, shape):
                fail(f"serve-gguf: {name} made {len(raw)} bytes, not {gguf_nbytes(gtype, shape)}")
            f.write(raw + b"\0" * ((-len(raw)) % GGUF_ALIGN))
        return f.tell()


def gguf_quantize(w: torch.Tensor, gtype: int) -> Tuple[bytes, torch.Tensor]:
    """``w`` (f32 on the card, rows of the file's layout) in ``gtype``:
    its bytes, and the f32 values a reader must get back (``dequant(quant(
    w))``, from the blocks' own scales and ints).  Q8_0 and Q4_0 in
    ``tests/test_gguf.py``'s llama.cpp layout (Q4_0: byte j holds elements
    j low and j + 16 high)."""
    if gtype in GGUF_PLAIN:
        t = w.to(GGUF_PLAIN[gtype]).contiguous()
        return t.view(torch.uint8).cpu().numpy().tobytes(), t.float()
    blk = w.float().reshape(-1, 32)
    if gtype == GGUF_Q8_0:
        d = blk.abs().amax(1, keepdim=True) / 127.0
        q = torch.where(d > 0, torch.round(blk / d), torch.zeros_like(blk))
        d16 = d.to(torch.float16)
        body = q.to(torch.int8).view(torch.uint8)
        vals = q
    else:
        i = blk.abs().argmax(1, keepdim=True)
        d = blk.gather(1, i) / -8.0
        inv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
        q = torch.clamp(torch.round(blk * inv + 8.0), 0, 15).to(torch.uint8)
        d16 = d.to(torch.float16)
        body = q[:, :16] | (q[:, 16:] << 4)
        vals = q.float() - 8.0
    raw = torch.cat([d16.view(torch.uint8), body], dim=1)
    return raw.cpu().numpy().tobytes(), (vals * d16.float()).reshape(w.shape)


def gguf_permute_rope(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """convert_hf_to_gguf's q/k row permutation (HF -> GGUF layout)."""
    out, inn = w.shape
    return w.reshape(n_head, 2, out // n_head // 2, inn).transpose(1, 2).reshape(out, inn)


def gguf_layout(cfg, tied: bool) -> List[Tuple[str, str, int, Tuple[int, ...]]]:
    """Every tensor of a llama GGUF of ``cfg``: (name, kind, layer, HF
    shape)."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out = [("token_embd.weight", "token_embd", -1, (V, H)),
           ("output_norm.weight", "output_norm", -1, (H,))]
    if not tied:
        out.append(("output.weight", "output", -1, (V, H)))
    shapes = {"attn_q": (q, H), "attn_k": (kv, H), "attn_v": (kv, H), "attn_output": (H, q),
              "ffn_gate": (I, H), "ffn_up": (I, H), "ffn_down": (H, I),
              "attn_norm": (H,), "ffn_norm": (H,)}
    for i in range(cfg.num_layers):
        out += [(f"blk.{i}.{kind}.weight", kind, i, shape) for kind, shape in shapes.items()]
    return out


def gguf_weight(seed: int, index: int, kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """Tensor ``index``'s seeded f32 weight on the card, in HF layout:
    normal over 1/sqrt(fan_in) for the projections, 0.02 for the
    embedding, 1 + 0.05 normal for the norms."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed * 100003 + index)
    w = torch.randn(shape, generator=gen, device="cuda")
    if len(shape) == 1:
        return 1.0 + 0.05 * w
    return w * (0.02 if kind == "token_embd" else 1.0 / math.sqrt(shape[1]))


def write_gguf_model(path: str, cfg, types: Dict[str, int], meta: Dict[str, object],
                     seed: int, tied: bool = False) -> int:
    """A llama GGUF of ``cfg`` from seeded weights, quantized on the card
    tensor by tensor into ``path`` (q/k rows permuted as llama.cpp's
    converter does), with ``meta`` (the tokenizer's keys) beside the
    architecture's.  Returns the file's bytes."""
    layout = gguf_layout(cfg, tied)
    meta = {
        "general.architecture": "llama", "general.alignment": GGUF_ALIGN,
        "llama.vocab_size": cfg.vocab_size, "llama.embedding_length": cfg.hidden_size,
        "llama.feed_forward_length": cfg.intermediate_size,
        "llama.block_count": cfg.num_layers, "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.key_length": cfg.head_dim,
        "llama.rope.freq_base": float(cfg.rope_theta),
        "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        "llama.context_length": cfg.max_position, **meta,
    }
    index = {name: (k, kind, shape) for k, (name, kind, _, shape) in enumerate(layout)}

    def make(name: str) -> bytes:
        k, kind, shape = index[name]
        w = gguf_weight(seed, k, kind, shape)
        if kind in ("attn_q", "attn_k"):
            heads = cfg.num_heads if kind == "attn_q" else cfg.num_kv_heads
            w = gguf_permute_rope(w, heads)
        return gguf_quantize(w, types[kind])[0]

    return write_gguf(path, meta, [(n, shape, types[kind]) for n, kind, _, shape in layout], make)


def check_gguf_leaves(what: str, params, cfg, types: Dict[str, int], seed: int,
                      tied: bool = False) -> int:
    """Every leaf of ``params`` (loaded from ``write_gguf_model``'s file)
    equals ``dequant(quant(w))`` of the seeded weights, computed here in
    memory and cast to the leaf's dtype, bit for bit.  Returns the leaves
    checked."""
    n = 0
    for k, (name, kind, layer, shape) in enumerate(gguf_layout(cfg, tied)):
        leaf, transposed = GGUF_LEAVES[kind]
        got = params[leaf] if layer < 0 else params["layers"][leaf][layer]
        want = gguf_quantize(gguf_weight(seed, k, kind, shape), types[kind])[1]
        want = (want.T if transposed else want).to(got.dtype)
        if got.shape != want.shape or not torch.equal(got, want):
            bad = (got.float() != want.float()).sum().item() if got.shape == want.shape else "all"
            fail(f"serve-gguf {what}: {name} ({leaf}) differs from dequant(quant(w)) in "
                 f"{bad} elements")
        n += 1
    return n


def readme_text() -> str:
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        return f.read()


def spm_tokenizer_meta(text: str, n_pieces: int) -> Dict[str, object]:
    """A ``llama`` (SentencePiece) GGUF tokenizer of ``n_pieces`` pieces:
    ``<unk>``, ``<s>``, ``</s>``, the 256 ``<0xNN>`` byte pieces, ``▁`` and
    the characters of ``text``, then ``▁``-led word prefixes and in-word
    substrings of ``text`` (2 to 8 characters) by frequency, scored by log
    frequency; a ``[INST]`` chat template."""
    counts: Dict[str, int] = {}
    for word in text.split():
        w = "▁" + word
        for i in range(len(w)):
            for j in range(i + 2, min(len(w), i + 8) + 1):
                counts[w[i:j]] = counts.get(w[i:j], 0) + 1
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    seen = set(pieces)
    scores = [0.0] * len(pieces)
    total = sum(counts.values())
    for c in ["▁"] + sorted({c for c in text if not c.isspace()}):
        if c not in seen and len(pieces) < n_pieces:
            seen.add(c)
            pieces.append(c)
            scores.append(-20.0)
    for piece, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(pieces) >= n_pieces:
            break
        if piece not in seen:
            seen.add(piece)
            pieces.append(piece)
            scores.append(math.log(c / total))
    if len(pieces) != n_pieces:
        fail(f"serve-gguf: the text gives {len(pieces)} pieces, not {n_pieces}")
    return {
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": pieces,
        "tokenizer.ggml.scores": scores, "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2, "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.add_bos_token": True, "tokenizer.chat_template": MISTRAL_TEMPLATE,
    }


def gpt2_tokenizer_meta(tmp: str, ordinary: int, specials: int) -> Dict[str, object]:
    """A ``gpt2`` GGUF tokenizer converted from ``write_tokenizer``'s
    byte-level BPE: its tokens by id, its merges as ``"a b"``, bos
    ``<|begin_of_text|>``, eos ``<|eot_id|>``, its chat template."""
    d = os.path.join(tmp, f"bpe-{ordinary}")
    os.makedirs(d)
    write_tokenizer(d, ordinary, specials)
    with open(os.path.join(d, "tokenizer.json")) as f:
        spec = json.load(f)
    tokens = [""] * (ordinary + specials)
    for t, i in spec["model"]["vocab"].items():
        tokens[i] = t
    for a in spec["added_tokens"]:
        tokens[a["id"]] = a["content"]
    return {
        "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.merges": [f"{a} {b}" for a, b in spec["model"]["merges"]],
        "tokenizer.ggml.bos_token_id": tokens.index("<|begin_of_text|>"),
        "tokenizer.ggml.eos_token_id": tokens.index("<|eot_id|>"),
        "tokenizer.chat_template": CHAT_TEMPLATE,
    }


def gguf_eval(what: str, params, cfg, ids: List[int], window: int) -> Dict[str, object]:
    """``evaluate_perplexity`` on the card with the launch counts reset:
    kernel 2 launches once per layer per scored window and no other kernel
    launches.  Returns the result, its seconds and kernel 2's launches."""
    from dynamo_tpu_torch.llm.evaluate import evaluate_perplexity

    n_windows = sum(1 for s in range(0, len(ids), window) if len(ids[s:s + window]) >= 2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate_perplexity(params, cfg, ids, window=window)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counted = read_launches()
    want = {k: 0 for k in counted}
    want["flash_prefill_attention"] = cfg.num_layers * n_windows
    if counted != want:
        fail(f"serve-gguf {what}: eval at window {window} launched {counted}, expected {want}")
    if not (math.isfinite(res["avg_nll"]) and res["tokens_scored"] == len(ids) - n_windows):
        fail(f"serve-gguf {what}: eval at window {window} gave {res}")
    return dict(res, seconds=secs, launches=counted["flash_prefill_attention"],
                windows=n_windows)


def gguf_small(ref: Dict[str, object], tmp: str, card: str) -> None:
    """(a) A SentencePiece (``llama``) and a ``gpt2`` GGUF of small f32
    models (D 64, group 2; between them F32, F16, BF16, Q8_0 and Q4_0
    tensors, the second tied): the dequantized params on the card equal
    the CPU's bit for bit, the greedy streams of the default config are
    identical, ``evaluate_perplexity`` agrees within GGUF_EVAL_RTOL."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.gguf import load_gguf_params
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    text = readme_text()
    small = dict(hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
                 num_kv_heads=2, head_dim=64, max_position=512, dtype="float32")
    for name, tok_meta in (("spm", spm_tokenizer_meta(text, 800)),
                           ("gpt2", gpt2_tokenizer_meta(tmp, 1024, 16))):
        tied = name == "gpt2"
        cfg = ModelConfig.tiny(vocab_size=len(tok_meta["tokenizer.ggml.tokens"]),
                               tie_word_embeddings=tied, **small)
        path = os.path.join(tmp, f"small-{name}.gguf")
        write_gguf_model(path, cfg, GGUF_SMALL_TYPES[name], tok_meta, seed=11, tied=tied)
        cfg = dataclasses.replace(ModelConfig.from_pretrained(path), dtype="float32")
        params = {dev: load_gguf_params(path, cfg, dev) for dev in ("cuda", "cpu")}
        n = check_gguf_leaves(f"(a) {name}", params["cuda"], cfg, GGUF_SMALL_TYPES[name],
                              seed=11, tied=tied)
        for key, t in params["cpu"].items():
            pairs = t.items() if isinstance(t, dict) else [(key, t)]
            for k, v in pairs:
                got = params["cuda"]["layers"][k] if isinstance(t, dict) else params["cuda"][k]
                if not torch.equal(got.cpu(), v):
                    fail(f"serve-gguf (a) {name}: {k} on the card differs from the CPU's")
        streams = {}
        for dev in ("cuda", "cpu"):
            eng = TorchEngine(cfg, params[dev], EngineConfig(**ref["ecfg"]), device=dev)
            streams[dev] = [r["tokens"] for r in asyncio.run(serve(eng, ref["batches"][:1]))]
        if streams["cuda"] != streams["cpu"]:
            fail(f"serve-gguf (a) {name}: card streams {streams['cuda']} != cpu {streams['cpu']}")
        ids = Tokenizer.from_model_dir(path).encode(text[:6000])
        card_eval = gguf_eval(f"(a) {name}", params["cuda"], cfg, ids, 64)
        from dynamo_tpu_torch.llm.evaluate import evaluate_perplexity

        cpu_eval = evaluate_perplexity(params["cpu"], cfg, ids, window=64)
        rel = abs(card_eval["avg_nll"] - cpu_eval["avg_nll"]) / abs(cpu_eval["avg_nll"])
        print(f"serve-gguf: (a) {name} {os.path.getsize(path)} bytes, {n} leaves equal "
              f"dequant(quant(w)) and card == CPU bit for bit; streams equal; eval "
              f"{len(ids)} tokens window 64: card avg_nll {card_eval['avg_nll']:.6f} cpu "
              f"{cpu_eval['avg_nll']:.6f} rel {rel:.3e}, kernel 2 launches "
              f"{card_eval['launches']} on {card}")
        if rel > GGUF_EVAL_RTOL or card_eval["tokens_scored"] != cpu_eval["tokens_scored"]:
            fail(f"serve-gguf (a) {name}: card eval {card_eval} differs from the CPU's {cpu_eval}")
        os.remove(path)


def gguf_echo_nll(engine_params, cfg, ids: List[int]) -> float:
    """The sum of ``-prompt_logprobs`` of an echo request over ``ids`` (one
    prompt-scoring dispatch, kernel 2 once per layer), on an engine over
    ``engine_params`` whose ``max_seq_len`` holds the prompt."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    engine = TorchEngine(cfg, engine_params, EngineConfig(num_pages=512, max_seq_len=4096))
    reset_launches()
    res = asyncio.run(serve(engine, [[dict(request(ids, 1), prompt_logprobs=0)]]))[0]
    check_launch_invariants("serve-gguf: (b) echo", engine, read_launches())
    del engine
    if len(res["plp"]) != 1 or [e[0] for e in res["plp"][0]] != ids:
        fail(f"serve-gguf (b): the echo's prompt logprobs do not cover its {len(ids)} ids")
    return -sum(e[1] for e in res["plp"][0][1:])


def gguf_mistral(tmp: str, served: Dict[str, object], card: str) -> Dict[int, int]:
    """(b) Mistral-7B-Instruct-v0.2's widths at full depth from a Q4_0
    file (``GGUF_Q4_TYPES``) with a 32000-piece SentencePiece tokenizer
    drawn from README.md: every leaf of ``TorchEngine.from_pretrained(file)``
    equals ``dequant(quant(w))`` bit for bit; serve's traffic cold and
    warm; ``evaluate_perplexity`` over README.md at each window of
    GGUF_EVAL_WINDOWS, whose first window's NLL equals an echo request's
    within GGUF_ECHO_RTOL.  Returns kernel 2's launches per window."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.memory_plan import plan_memory
    from dynamo_tpu_torch.llm.evaluate import window_nll
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    text = readme_text()
    tok_meta = spm_tokenizer_meta(text, 32000)
    path = os.path.join(tmp, "mistral-7b-instruct-v0.2.Q4_0.gguf")
    # HF mistralai/Mistral-7B-Instruct-v0.2 config.json, as llama.cpp's
    # converter writes it into the metadata (the norm epsilon an f32 there)
    want_cfg = ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
        num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=1e6,
        rms_norm_eps=float(np.float32(1e-5)), max_position=32768)
    t0 = time.perf_counter()
    size = write_gguf_model(path, want_cfg, GGUF_Q4_TYPES, tok_meta, seed=7)
    write_s = time.perf_counter() - t0
    cfg = ModelConfig.from_pretrained(path)
    if cfg != want_cfg:
        fail(f"serve-gguf (b): the file's config {cfg} is not Mistral-7B's {want_cfg}")
    plan = plan_memory(cfg, num_pages=1024)
    base = assert_card_free("(b)", plan, "serve-gguf")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchEngine.from_pretrained(path, EngineConfig(num_pages=1024))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n = check_gguf_leaves("(b)", engine.params, cfg, GGUF_Q4_TYPES, seed=7)
    print(f"serve-gguf: (b) Mistral-7B-Instruct-v0.2 widths, 32 layers, Q4_0 file "
          f"{size / 1e9:.3f} GB written in {write_s:.3f} s; from_pretrained {load_s:.3f} s "
          f"({size / 1e9 / load_s:.3f} GB/s of file, warm page cache), peak "
          f"{load_peak:.3f} GiB above the phase's start (plan params "
          f"{plan.param_bytes / 2**30:.3f}); {n} leaves equal dequant(quant(w)) bit for bit "
          f"on {card}")
    primer, batch = serve_requests(cfg.vocab_size)
    run = geometry_serve(engine, primer, batch, 64, "(b) Mistral-7B Q4_0", card, base,
                         phase="serve-gguf")
    print(f"serve-gguf: (b) tok_s cold {run['tok_s']:.3f} warm {run['tok_s_warm']:.3f} "
          f"beside serve's (Llama-3-8B bf16) warm {served['tok_s_warm']:.3f} on {card}")
    for kernel in ("packed_ragged_attention", "paged_decode_attention"):
        if run["launches"][kernel] <= 0:
            fail(f"serve-gguf (b): {kernel} never launched")
    params = engine.params
    del engine
    gc.collect()
    tok = Tokenizer.from_model_dir(path)
    if tok.chat_template != MISTRAL_TEMPLATE or tok.eos_token_ids != [2]:
        fail("serve-gguf (b): the GGUF tokenizer lost its chat template or eos")
    t0 = time.perf_counter()
    ids = tok.encode(text)
    tok_s = time.perf_counter() - t0
    launches = {}
    for window in GGUF_EVAL_WINDOWS:
        ev = gguf_eval("(b)", params, cfg, ids, window)
        launches[window] = ev["launches"]
        first = ids[:window]
        buf = torch.tensor([first], dtype=torch.long, device="cuda")
        nll = float(window_nll(params, cfg, buf, len(first)))
        echo = gguf_echo_nll(params, cfg, first)
        rel = abs(nll - echo) / abs(echo)
        print(f"serve-gguf: (b) eval README.md ({len(text)} characters, {len(ids)} tokens "
              f"encoded in {tok_s:.3f} s) window {window}: perplexity "
              f"{ev['perplexity']:.4f} avg_nll {ev['avg_nll']:.6f} over "
              f"{ev['tokens_scored']} tokens in {ev['seconds']:.3f} s "
              f"({ev['tokens_scored'] / ev['seconds']:.3f} tokens/s), {ev['windows']} windows, "
              f"kernel 2 launches {ev['launches']} ({cfg.num_layers} per window); first "
              f"window NLL {nll:.4f} against the echo request's {echo:.4f} (rel {rel:.3e}) "
              f"on {card}")
        if rel > GGUF_ECHO_RTOL:
            fail(f"serve-gguf (b): window {window}'s first NLL {nll} differs from the echo's "
                 f"{echo} by {rel:.3e}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(path)
    return launches


def gguf_cli_eval(proc: "Proc", what: str) -> Dict[str, object]:
    """The JSON line an ``eval`` process printed, once it exited 0."""
    proc.proc.wait(timeout=600)
    Proc.running.remove(proc)
    if proc.proc.returncode != 0:
        fail(f"serve-gguf (c): {what} exited with {proc.proc.returncode}: {proc.log()[-3000:]}")
    lines = [ln for ln in proc.log().splitlines() if ln.startswith('{"perplexity"')]
    if len(lines) != 1:
        fail(f"serve-gguf (c): {what} printed {len(lines)} JSON lines: {proc.log()[-2000:]}")
    return json.loads(lines[0])


def gguf_cli(tmp: str, card: str) -> None:
    """(c) Llama-3-8B's widths at GGUF_8B_LAYERS layers from a Q8_0 file
    with a 128256-token ``gpt2`` tokenizer and a chat template: ``run
    in=http out=torch --model-path FILE.gguf`` answers chat requests
    through the file's template (``length``, exact usage); ``eval
    --model-path DIR --text-file README.md --window 512``, bare and with
    ``--quantize int8``, each print their JSON line, the bare one within
    GGUF_CLI_RTOL of in-process ``evaluate_perplexity``.  The three
    processes run side by side."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.weights import load_checkpoint_params
    from dynamo_tpu_torch.llm.evaluate import evaluate_perplexity
    from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    d = os.path.join(tmp, "llama3-8b-gguf")
    os.makedirs(d)
    path = os.path.join(d, "model.gguf")
    cfg = ModelConfig.llama3_8b(num_layers=GGUF_8B_LAYERS)
    t0 = time.perf_counter()
    size = write_gguf_model(path, cfg, GGUF_Q8_TYPES, gpt2_tokenizer_meta(tmp, 128000, 256),
                            seed=8)
    write_s = time.perf_counter() - t0
    readme = os.path.join(ROOT, "README.md")
    port = free_port()
    t0 = time.perf_counter()
    server = Proc(tmp, "gguf-run", "run", "in=http", "out=torch", "--model-path", path,
                  "--model-name", "gguf", "--port", str(port))
    evals = {q: Proc(tmp, f"gguf-eval-{q}", "eval", "--model-path", d, "--text-file", readme,
                     "--window", "512", *(["--quantize", q] if q != "bare" else []))
             for q in ("bare", "int8")}
    try:
        up = wait_http(port, "/health", lambda body: True, [server], "serve-gguf (c)")
        tok = Tokenizer.from_model_dir(path)
        chats = [[{"role": "user", "content": "Hello from a GGUF file! Ça va? 😀"}],
                 [{"role": "user", "content": "Summarize the port."},
                  {"role": "assistant", "content": "It serves."},
                  {"role": "user", "content": "And evaluates?"}]]
        usages = []
        for messages in chats:
            body = {"model": "gguf", "max_tokens": 12, "ignore_eos": True, "messages": messages}
            status, raw = asyncio.run(http_call(port, "POST", "/v1/chat/completions", body))
            if status != 200:
                fail(f"serve-gguf (c): chat answered {status}: {raw[:300]!r}")
            doc = json.loads(raw)
            usage = doc["usage"]
            prompt = len(tok.encode(PromptFormatter(tok).render(messages)))
            if (doc["choices"][0]["finish_reason"] != "length"
                    or usage["completion_tokens"] != 12 or usage["prompt_tokens"] != prompt):
                fail(f"serve-gguf (c): chat finished {doc['choices'][0]['finish_reason']} "
                     f"with usage {usage}, expected 12 completion and {prompt} prompt tokens")
            usages.append(usage)
        server.interrupt("serve-gguf (c)")
        outs = {q: gguf_cli_eval(p, f"eval {q}") for q, p in evals.items()}
    finally:
        server.kill()
        for p in evals.values():
            p.kill()
    cli_s = time.perf_counter() - t0
    params = load_checkpoint_params(d, ModelConfig.from_pretrained(d))
    with open(readme, encoding="utf-8") as f:
        ids = Tokenizer.from_model_dir(d).encode(f.read())
    mine = evaluate_perplexity(params, ModelConfig.from_pretrained(d), ids, window=512)
    del params
    rel = abs(outs["bare"]["perplexity"] - mine["perplexity"]) / mine["perplexity"]
    print(f"serve-gguf: (c) Llama-3-8B widths, {GGUF_8B_LAYERS} layers, Q8_0 file "
          f"{size / 1e9:.3f} GB written in {write_s:.3f} s; run in=http healthy after "
          f"{up:.3f} s, chats end length with usage {usages}, exit code 0 on SIGINT; eval "
          f"{json.dumps(outs['bare'])} / {json.dumps(outs['int8'])}; in process perplexity "
          f"{mine['perplexity']:.4f} (rel {rel:.3e}); the three processes {cli_s:.3f} s "
          f"on {card}")
    if rel > GGUF_CLI_RTOL or outs["bare"]["tokens_scored"] != mine["tokens_scored"]:
        fail(f"serve-gguf (c): the eval CLI's {outs['bare']} differs from in-process {mine}")
    if outs["int8"]["quantize"] != "int8" or not math.isfinite(outs["int8"]["perplexity"]):
        fail(f"serve-gguf (c): the int8 eval printed {outs['int8']}")
    gc.collect()
    torch.cuda.empty_cache()


def serve_gguf_phase(ref: Dict[str, object], served: Dict[str, object],
                     card: str) -> Dict[int, int]:
    """GGUF checkpoints: (a) small f32 models card against CPU, (b)
    Mistral-7B-Instruct-v0.2's widths from a Q4_0 file, served and
    evaluated, (c) the CLI's ``run`` and ``eval`` on a Llama-3-8B-width
    Q8_0 file.  The files are written into a temporary directory and
    removed.  Returns (b)'s kernel 2 launches per eval window."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-gguf-")
    t0 = time.perf_counter()
    try:
        gguf_small(ref, tmp, card)
        t_a = time.perf_counter()
        launches = gguf_mistral(tmp, served, card)
        t_b = time.perf_counter()
        gguf_cli(tmp, card)
        t_c = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve-gguf: phase {t_c - t0:.3f} s ((a) {t_a - t0:.3f}, (b) {t_b - t_a:.3f}, "
          f"(c) {t_c - t_b:.3f}); kernel 2 launches per eval window {launches} on {card}")
    return launches


# ---------------------------------------------------------------------------
# serve-tp: tensor and expert parallelism (parallel/)
# ---------------------------------------------------------------------------

# (c): Mixtral-8x7B's widths at serve-moe (b)'s 16 layers, ep = 2
TP_MOE_LAYERS = MOE_LAYERS
# (a)'s pools against one card's (``tp_pools_match``): on an NVIDIA H100
# 80GB HBM3 at 700.00 W this phase read f32 pools within 0.89e-6 of the
# largest value and, in the int8 pool, 58 of 258048 values one step off
# with row scales within 4.7e-4
TP_POOL_TOL = 5e-6
TP_INT8_SHARE = 5e-3
TP_INT8_SCALE = 2e-3
# kernels 1 and 5 at a rank of Llama-3-8B at tp = 2: 16 query heads, 4 kv
# heads, D 128 (the rows serve-tp (b)'s launches go with)
TP_RANK_GEOM = {"llama3_8b_tp2_rank": ((16, 4, 128, 0), ("paged_decode_attention",
                                                         "packed_ragged_attention"))}


def tp_grid(mesh_cfg, what: str, phase: str = "serve-tp"):
    """Start a grid's follower ranks and the leader's mesh, every rank on
    this card over gloo: the one mesh of the package's that takes CUDA
    tensors over gloo, built here to hold the ranks against one card (the
    package runs NCCL ranks, one card each, where there are enough cards).
    Gloo's collectives are not captured, so an engine that shards its
    trunk over it runs eagerly.  The followers serve every engine built on
    the mesh until ``tp_end``.  Returns ``(mesh, ranks, backend)``."""
    from dynamo_tpu_torch.parallel.launch import grid_spec, leader_mesh, start_local_ranks

    n = mesh_cfg.num_devices
    t0 = time.perf_counter()
    ranks = start_local_ranks(mesh_cfg, grid_spec(mesh_cfg, ["cuda:0"] * n, "gloo"))
    mesh = leader_mesh(mesh_cfg, ranks.spec, ranks)
    axes = " ".join(f"{a}={getattr(mesh_cfg, a)}" for a in ("tp", "ep", "sp", "pp")
                    if getattr(mesh_cfg, a) > 1)
    print(f"{phase}: {what} grid {axes}: backend gloo ({n} ranks on one card); formed in "
          f"{time.perf_counter() - t0:.3f} s")
    return mesh, ranks, "gloo"


def tp_end(grid) -> None:
    """Dismiss a grid's followers and wait for them."""
    from dynamo_tpu_torch.parallel.launch import dismiss

    mesh, ranks, _ = grid
    dismiss(mesh)
    mesh.close()
    ranks.join()


def tp_reads(engine, out: Dict[str, object], pools: bool = False):
    """A ``before_stop`` that keeps the ranks' counters (and pools)."""

    def read() -> None:
        out["stats"] = engine.rank_stats()
        if pools:
            out["pools"] = engine.rank_pools()
        if engine.mesh is not None:
            out["sent"] = dict(engine.params.mirror.sent)

    return read


def tp_rank_launches(stats) -> List[Dict[str, int]]:
    return [dict(s["launches"], gathered_decode=s["gathered_decode_calls"]) for s in stats]


def tp_check_ranks(what: str, engine, stats) -> None:
    """Every rank's kernel launches equal what the leader's dispatches
    imply; every rank made the same collectives; per rank, graph captures
    and replays printed."""
    want = expected_launches(engine)
    for s, got in zip(stats, tp_rank_launches(stats)):
        got = {k: got.get(k, 0) for k in want}
        print(f"serve-tp: {what} rank {s['rank']}: launches {got} (expected {want}); "
              f"collectives {s['collectives']}; graphs {s['graphs']}; moe drops {s['moe_drops']}")
        if got != want:
            fail(f"serve-tp {what} rank {s['rank']}: launches {got} differ from the "
                 f"leader's dispatches' {want}")
    if len({json.dumps(s["collectives"], sort_keys=True) for s in stats}) != 1:
        fail(f"serve-tp {what}: the ranks' collectives differ: {[s['collectives'] for s in stats]}")
    graphs = [s["graphs"] for s in stats]
    if any(g != {"captures": 0, "replays": 0} for g in graphs):
        fail(f"serve-tp {what}: a gloo mesh runs eagerly, yet the ranks count graphs {graphs}")


def tp_pools_match(what: str, one, ranks, tp: int) -> None:
    """Every rank's pool against the one-card pool's head slice (page 0,
    the trash page, aside).  f32: within TP_POOL_TOL of the largest
    magnitude (the all-reduces sum partial products in another order,
    and the rank's GEMMs are narrower).  int8: a value that lands a hair
    from a rounding boundary may round the other way on a rank, and the
    step it moves feeds the later layers, so the data may be one step off
    in at most TP_INT8_SHARE of the elements and the row scales within
    TP_INT8_SCALE relative; the streams must still be equal."""
    if isinstance(one, tuple):
        q1, s1 = one
        w = q1.shape[4] // tp
        for r, (q, s) in enumerate(ranks):
            dq = (q[:, :, 1:].int() - q1[:, :, 1:, :, r * w:(r + 1) * w].int()).abs()
            ds = ((s[:, :, 1:] - s1[:, :, 1:]).abs() / s1[:, :, 1:].abs().clamp(min=1e-30)).max()
            print(f"serve-tp: {what} rank {r} int8 pool: data off by {int(dq.max())} at most "
                  f"({int((dq > 0).sum())} of {dq.numel()}), scales within {float(ds):.3e}")
            if int(dq.max()) > 1 or int((dq > 0).sum()) > TP_INT8_SHARE * dq.numel() or (
                float(ds) > TP_INT8_SCALE
            ):
                fail(f"serve-tp {what} rank {r}: the int8 pool differs from one card's")
        return
    w = one.shape[4] // tp
    for r, p in enumerate(ranks):
        want = one[:, :, 1:, :, r * w:(r + 1) * w].float()
        d = float((p[:, :, 1:].float() - want).abs().max())
        scale = float(want.abs().max())
        print(f"serve-tp: {what} rank {r} pool: max |diff| {d:.3e} against max |value| {scale:.3e}")
        if d > TP_POOL_TOL * scale:
            fail(f"serve-tp {what} rank {r}: the pool differs from one card's head slice by {d}")


def tp_small(ref: Dict[str, object], axis: str, grid_ranks, card: str) -> None:
    """(a) Small f32 models, two ranks: tp = 2 under the default, classic
    and rectangle configs, the int8 pool and int8 weights, and ep = 2 on a
    small MoE at cf = E / K; each against one card (streams, pools) and the
    CPU (streams); at a binding capacity (cf = 0.5) every rank counts one
    card's drops.  The legs of ``axis`` ("tp" or "ep"), on its grid."""
    from dynamo_tpu_torch.engine import model as tmodel
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    cfg, params, batches = ref["cfg"], ref["params"], ref["batches"]
    moe = dataclasses.replace(cfg, num_experts=4, num_experts_per_tok=2, moe_capacity_factor=2.0)
    moe_params = init_params(moe, 4, torch.device("cpu"), torch.float32)
    legs = {
        **{name: (cfg, params, REFERENCE_CONFIGS[name], MeshConfig(tp=2))
           for name in ("default", "classic", "rectangle")},
        "int8-pool": (cfg, params, dict(kv_dtype="int8"), MeshConfig(tp=2)),
        "int8-weights": (cfg, params, dict(quantize="int8"), MeshConfig(tp=2)),
        "moe-ep2": (moe, moe_params, {}, MeshConfig(ep=2)),
        "moe-ep2-binding": (dataclasses.replace(moe, moe_capacity_factor=0.5), moe_params, {},
                            MeshConfig(ep=2)),
    }
    for name, (mcfg, mparams, kw, grid) in legs.items():
        if getattr(grid, axis) == 1:
            continue
        ecfg = EngineConfig(**ref["ecfg"], **kw)
        cpu = asyncio.run(serve(TorchEngine(mcfg, mparams, ecfg, device="cpu"), batches))
        one = TorchEngine(mcfg, params_on(mparams, "cuda"), ecfg, device="cuda")
        tmodel.moe_counts(torch.device("cuda"), reset=True)
        reset_launches()
        kept: Dict[str, object] = {}
        card_one = asyncio.run(serve(one, batches, before_stop=tp_reads(one, kept, pools=True)))
        check_launch_invariants(f"serve-tp: (a) {name} one card", one, read_launches())
        torch.cuda.synchronize()
        drops = tmodel.moe_counts(torch.device("cuda"), reset=True)[1]
        pool1 = kept["pools"][0]
        del one
        mesh, _, backend = grid_ranks
        eng = TorchEngine(mcfg, params_on(mparams, "cuda"), ecfg, device="cuda", mesh=mesh)
        eng.reset_rank_stats()
        got = asyncio.run(serve(eng, batches, before_stop=tp_reads(eng, kept, pools=True)))
        stats, pools = kept["stats"], kept["pools"]
        tp_check_ranks(f"(a) {name}", eng, stats)
        streams = [r["tokens"] for r in got]
        print(f"serve-tp: (a) {name}: {first_divergence(streams, [r['tokens'] for r in card_one])} "
              f"(one card); {first_divergence(streams, [r['tokens'] for r in cpu])} (CPU); "
              f"backend {backend} on {card}")
        if streams != [r["tokens"] for r in card_one]:
            fail(f"serve-tp (a) {name}: streams differ from one card's")
        if "int8" not in name and streams != [r["tokens"] for r in cpu]:
            fail(f"serve-tp (a) {name}: streams differ from the CPU's")
        if grid.tp > 1:
            tp_pools_match(f"(a) {name}", pool1, pools, grid.tp)
        rank_drops = [s["moe_drops"] for s in stats]
        print(f"serve-tp: (a) {name}: dropped assignments one card {drops}, ranks {rank_drops}")
        if mcfg.is_moe and rank_drops != [drops] * len(stats):
            fail(f"serve-tp (a) {name}: drops {rank_drops} differ from one card's {drops}")
        if name == "moe-ep2" and drops:
            fail(f"serve-tp (a) moe-ep2: {drops} assignments dropped at cf = E / K")
        if name == "moe-ep2-binding" and not drops:
            fail("serve-tp (a) moe-ep2-binding: no assignment dropped at cf = 0.5")
        gc.collect()
        torch.cuda.empty_cache()


def tp_near_ties(what: str, res: List[dict], plain: List[List[int]], greedy: List[bool]) -> str:
    """Where each stream first parts from the one-card run's; a greedy
    lane may part only at a bf16 near tie of this run's two best tokens
    (their logprobs within one bf16 step: BF16_ATOL + BF16_RTOL x the
    larger magnitude)."""
    notes = []
    for i, (r, want) in enumerate(zip(res, plain)):
        j = next((j for j, (a, b) in enumerate(zip(r["tokens"], want)) if a != b), None)
        if j is None:
            continue
        top = r["top"][j] if j < len(r["top"]) else None
        notes.append(f"request {i} token {j} (top-2 logprobs {top})")
        if greedy[i]:
            lps = sorted((float(v) for v in dict(top).values()) if isinstance(top, dict)
                         else [float(t[1]) for t in top], reverse=True) if top else []
            if len(lps) < 2 or lps[0] - lps[1] > BF16_ATOL + BF16_RTOL * max(map(abs, lps[:2])):
                fail(f"serve-tp {what}: greedy request {i} parts from one card at token {j} "
                     f"away from a bf16 near tie (top-2 logprobs {top})")
    same = sum(r["tokens"] == p for r, p in zip(res, plain))
    return f"{same} of {len(plain)} equal one card's; parted at {notes or 'none'}"


def tp_llama(served: Dict[str, object], grid, card: str) -> Dict[str, int]:
    """(b) Llama-3-8B at full width and depth, bf16, tp = 2, serve's
    weights (seed 0) and traffic, cold then warm, top-2 logprobs asked
    for: every request ends with its max_tokens; per rank the launch
    invariants and 2 all-reduces a layer and 2 all-gathers a trunk pass;
    where streams part from serve run 0's.  Returns the leader rank's
    launches of kernels 1 and 5."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b()
    ecfg = EngineConfig(num_pages=1024)
    primer, batch = serve_requests(cfg.vocab_size)
    batch = [dict(r, sampling_options=dict(r["sampling_options"], logprobs=2)) for r in batch]
    mesh, _, backend = grid
    t0 = time.perf_counter()
    eng = TorchEngine.random_init(cfg, ecfg, seed=0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng.reset_rank_stats()
    sent0 = dict(eng.params.mirror.sent)
    kept: Dict[str, object] = {}
    res, wall, warm, wall_w, _marks = serve_cold_warm(eng, primer, batch,
                                                      before_stop=tp_reads(eng, kept))
    stats = kept["stats"]
    sent = {k: v - sent0.get(k, 0) for k, v in kept["sent"].items()}
    tp_check_ranks("(b)", eng, stats)
    out = res[1:]
    check_streams("serve-tp (b)", out, cfg.vocab_size)
    check_streams("serve-tp (b) warm", warm, cfg.vocab_size)
    trunks, heads = sent.get("trunk", 0), sent.get("logits", 0)
    for s in stats:
        c = s["collectives"]
        print(f"serve-tp: (b) rank {s['rank']}: {c.get('all_reduce', 0)} all-reduces, "
              f"{c.get('all_gather', 0)} all-gathers over {trunks} trunk passes "
              f"({heads} head projections) of {cfg.num_layers} layers; peak "
              f"{s.get('peak_bytes', 0) / 2**30:.3f} GiB")
        if c.get("all_reduce", 0) != 2 * cfg.num_layers * trunks:
            fail(f"serve-tp (b) rank {s['rank']}: {c.get('all_reduce')} all-reduces, not 2 a "
                 f"layer over {trunks} trunk passes")
        if heads != trunks or c.get("all_gather", 0) != 2 * trunks:
            fail(f"serve-tp (b) rank {s['rank']}: {c.get('all_gather')} all-gathers over "
                 f"{trunks} trunk passes and {heads} head projections, not 2 a pass")
    st, st_w = served_stats(res, wall), served_stats(warm, wall_w, primed=False)
    greedy = [not r["sampling_options"].get("temperature") for r in batch] * 2
    parted = tp_near_ties("(b)", out + warm, served["streams"], greedy)
    print(f"serve-tp: (b) Llama-3-8B tp=2 bf16 32 layers: init {init_s:.3f} s; cold wall "
          f"{wall:.3f} s tok_s={st['tok_s']:.3f} decode_phase_tok_s={st['dec']:.3f} ttft_ms="
          f"{[round(r['ttft'] * 1e3, 3) for r in out]}; warm wall {wall_w:.3f} s "
          f"tok_s={st_w['tok_s']:.3f} decode_phase_tok_s={st_w['dec']:.3f} ttft_ms="
          f"{[round(r['ttft'] * 1e3, 3) for r in warm]}; streams: {parted}; backend {backend} "
          f"on {card}")
    mine = tp_rank_launches(stats)[0]
    return {k: mine[k] for k in ("paged_decode_attention", "packed_ragged_attention")}


def tp_mixtral(grid, card: str) -> None:
    """(c) Mixtral-8x7B's widths at 16 of 32 layers, bf16, ep = 2 at cf =
    4 (seed 0: serve-moe (b)'s weights), serve's traffic cold then warm:
    nothing dropped on either rank; each rank holds half of the experts'
    bytes of one card's plan (serve-moe (b) holds exactly the plan's)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.memory_plan import plan_memory

    cfg = ModelConfig.mixtral_8x7b(num_layers=TP_MOE_LAYERS, moe_capacity_factor=4.0)
    ecfg = EngineConfig(num_pages=1024)
    # the plan's bytes of each leaf do not depend on the card's size
    plan = plan_memory(cfg, num_pages=1024, hbm_bytes=2**40)
    experts = sum(plan.detail[f"layers/{k}"] for k in ("w_gate", "w_up", "w_down"))
    primer, batch = serve_requests(cfg.vocab_size)
    mesh, _, backend = grid
    eng = TorchEngine.random_init(cfg, ecfg, seed=0, device="cuda", mesh=mesh)
    eng.reset_rank_stats()
    kept: Dict[str, object] = {}
    res, wall, warm, wall_w, _marks = serve_cold_warm(eng, primer, batch,
                                                      before_stop=tp_reads(eng, kept))
    stats = kept["stats"]
    tp_check_ranks("(c)", eng, stats)
    check_streams("serve-tp (c)", res[1:], cfg.vocab_size)
    check_streams("serve-tp (c) warm", warm, cfg.vocab_size)
    st_w = served_stats(warm, wall_w, primed=False)
    for s in stats:
        print(f"serve-tp: (c) rank {s['rank']}: expert bytes {s['expert_bytes']} (one card's "
              f"plan {experts}), dropped {s['moe_drops']}, peak "
              f"{s.get('peak_bytes', 0) / 2**30:.3f} GiB")
        if s["moe_drops"]:
            fail(f"serve-tp (c) rank {s['rank']}: {s['moe_drops']} assignments dropped at cf = 4")
        if 2 * s["expert_bytes"] != experts:
            fail(f"serve-tp (c) rank {s['rank']}: {s['expert_bytes']} expert bytes, not half of "
                 f"{experts}")
    print(f"serve-tp: (c) Mixtral-8x7B widths, {TP_MOE_LAYERS} layers, bf16, ep=2: cold wall "
          f"{wall:.3f} s; warm wall {wall_w:.3f} s tok_s={st_w['tok_s']:.3f} "
          f"decode_phase_tok_s={st_w['dec']:.3f}; backend {backend} on {card}")


def tp_cli(ckpt, card: str) -> None:
    """(d) The CLI: ``run in=http out=torch --dp 2`` is refused by name;
    with one card, ``--tp 2``, ``--sp 2`` and ``--pp 2`` are refused by
    JAX's "mesh needs 2 devices, have 1" (NCCL ranks take a card each;
    ``chip_multi.py`` serves them on four)."""
    base = ("run", "in=http", "out=torch", "--model-path", ckpt[0], "--num-pages", "128")
    cards = torch.cuda.device_count()
    refusals = {"--dp": ("--dp", "2")}
    if cards < 2:
        refusals.update({f"--tp 2 --ep 1: mesh needs 2 devices, have {cards}": ("--tp", "2"),
                         f"--sp 2: mesh needs 2 devices, have {cards}": ("--sp", "2"),
                         f"--pp 2: mesh needs 2 devices, have {cards}": ("--pp", "2")})
    procs = {want: subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch", *base, *argv],
                                    cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for want, argv in refusals.items()}
    for want, p in procs.items():
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.wait(timeout=30)
            fail(f"serve-tp (d): {refusals[want]} did not end")
        print(f"serve-tp: (d) {' '.join(refusals[want])}: exit {p.returncode}: "
              f"{err.strip().splitlines()[-1] if err.strip() else ''}")
        if p.returncode == 0 or want not in err:
            fail(f"serve-tp (d): {refusals[want]} not refused by name: {err[-2000:]}")
    print(f"serve-tp: (d) {len(refusals)} refusals with {cards} card(s) on {card}")


def serve_tp_phase(ref: Dict[str, object], served: Dict[str, object], card: str
                   ) -> Dict[str, int]:
    """serve-tp (a) to (c) (module docstring); (d) runs with the CLI
    checkpoint (``tp_cli``).  Returns (b)'s leader-rank launches of kernels
    1 and 5."""
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    t0 = time.perf_counter()
    # two grids of two ranks, one after the other (a process holds one
    # mesh at a time), each serving its legs' engines one by one
    grid = tp_grid(MeshConfig(tp=2), "tp")
    try:
        tp_small(ref, "tp", grid, card)
        ta = time.perf_counter()
        llama = tp_llama(served, grid, card)
        tb = time.perf_counter()
    finally:
        tp_end(grid)
    gc.collect()
    torch.cuda.empty_cache()
    grid = tp_grid(MeshConfig(ep=2), "ep")
    try:
        tc = time.perf_counter()
        tp_small(ref, "ep", grid, card)
        td = time.perf_counter()
        tp_mixtral(grid, card)
        te = time.perf_counter()
    finally:
        tp_end(grid)
    print(f"serve-tp: phase (a) to (c) {te - t0:.3f} s ((a) {ta - t0 + td - tc:.3f}, "
          f"(b) {tb - ta:.3f}, (c) {te - td:.3f}); launches (b), leader rank {llama} on {card}")
    return llama


# -- serve-sp-pp: ring (sp) and pipeline (pp) prefills -----------------------------

# pools against one card's prefill of the same prompts, as (layer 0's max
# |diff| over max |value|, every layer's max |diff| over max |value|, mean
# |diff| over mean |value|).  (a), f32: within the JAX tests' own bound for
# the ring and the pipeline against the plain prefill (1e-4).  (b), bf16:
# layer 0's K/V are the projections of the embeddings, which GEMMs over
# other row counts may round one bf16 step apart; the deeper layers part as
# bf16 rows that round apart in one layer feed the next (two correct bf16
# paths read a mean of 1.39e-2 apart at tp = 4 over 16 of Llama-3-70B's
# layers and 1.52e-2 for the ring over Llama-3-8B's 32, on an NVIDIA H100
# 80GB HBM3 at 700.00 W), while a wrong head, page or layer moves values
# by their own size
SPPP_F32_BOUNDS = (1e-4, 1e-4, 1e-4)
SPPP_BF16_BOUNDS = (2.0**-7, 2.0**-4, 2.0**-4)
# kernel 2 at one microbatch of a pipeline stage: Llama-3-8B's 32/8/128,
# the first microbatch of (b)'s pool-check prefill (two lanes of its 2048
# bucket)
PP_STAGE_FLASH = dict(T=2048, lens=[1100, 1500])


def check_pp_stage_flash(fp, gen) -> Dict[str, object]:
    """Kernel 2 at a pipeline stage's microbatch (``PP_STAGE_FLASH``)
    against its plain version, its time, one SDPA call's on the same
    operands and the bound from this run's lengths."""
    T, lens_l = PP_STAGE_FLASH["T"], PP_STAGE_FLASH["lens"]
    B = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")

    def rand(h):
        return torch.randn((B, T, h, D), generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = rand(HQ), rand(HKV), rand(HKV)
    err = agree("flash_prefill_attention pp stage", fp.flash_prefill_attention(q, k, v, lens),
                fp.flash_prefill_attention_plain(q, k, v, lens), p_rounding(v))
    ms = cuda_ms(lambda i: fp.flash_prefill_attention(q, k, v, lens), 32)
    plain_ms = cuda_ms(lambda i: fp.flash_prefill_attention_plain(q, k, v, lens), 4)
    idx = torch.arange(T, device="cuda")
    mask = (idx[None, :] <= idx[:, None])[None, None] & (idx[None, None, None, :] < lens[:, None, None, None])
    rep = HQ // HKV
    kh = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda i: sdpa_padded(qh, kh, vh, mask), 32)
    pairs = sum(n * (n + 1) // 2 for n in lens_l)
    rows = sum(lens_l)
    bytes_moved = rows * HQ * D * 2 + 2 * rows * HKV * D * 2 + B * T * HQ * D * 2 + B * 4
    flops = 4.0 * HQ * D * pairs
    bound_ms, bound_by = bound(bytes_moved, flops)
    return dict(
        name="flash_prefill_attention/pp_stage", route="cuda",
        source="dynamo_tpu_torch/csrc/flash_prefill.cu",
        replaces="dynamo_tpu/ops/flash_prefill.py:125",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
    )


def sppp_check_ranks(what: str, engine, stats) -> None:
    """The leader's launches equal its dispatches' (its pipeline stage's
    kernel 2 included); a ring follower launches nothing, a pipeline
    follower kernel 2 once per stage layer per microbatch and nothing
    else; neither captures a graph."""
    want = expected_launches(engine)
    follower = {k: 0 for k in want}
    follower["flash_prefill_attention"] = stage_layers(engine) * engine.pp_microbatches
    for s, got in zip(stats, tp_rank_launches(stats)):
        exp = want if s["rank"] == 0 else follower
        got = {k: got.get(k, 0) for k in exp}
        print(f"serve-sp-pp: {what} rank {s['rank']}: launches {got} (expected {exp}); "
              f"collectives {s['collectives']}; graphs {s['graphs']}")
        if got != exp:
            fail(f"serve-sp-pp {what} rank {s['rank']}: launches {got}, expected {exp}")
        if s["rank"] and s["graphs"] != {"captures": 0, "replays": 0}:
            fail(f"serve-sp-pp {what} rank {s['rank']}: a follower counts graphs {s['graphs']}")


def sppp_routed(what: str, engine, axis: str) -> int:
    routed = engine.sp_prefills if axis == "sp" else engine.pp_prefills
    if routed < 1:
        fail(f"serve-sp-pp {what}: no full prefill went through the {axis} path")
    return routed


def sppp_small_pages(ref: Dict[str, object]) -> torch.Tensor:
    """One card's (kernel 2's) prompt pages of (a)'s batches, in f32."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    reqs = [r for batch in ref["batches"] for r in batch]
    one = TorchEngine(ref["cfg"], params_on(ref["params"], "cuda"),
                      EngineConfig(**ref["ecfg"], mixed_batching=False), device="cuda")
    kept: Dict[str, object] = {}
    asyncio.run(serve(one, ref["batches"],
                      before_stop=lambda: kept.update(pool=sppp_prompt_pages(one, reqs))))
    return kept["pool"]


def sppp_small(ref: Dict[str, object], axis: str, grid, want_pages, card: str) -> None:
    """(a) The reference phase's small f32 model at sp = 2 or at pp = 2
    (gloo ranks on this card): the CPU's greedy streams, under the
    default config (mixed batching pinned off by the mesh), penalized lanes
    included; the prompt pages one card's (``want_pages``) within
    ``SPPP_F32_BOUNDS``; full prefills routed; the launch invariants on
    each rank."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg, params, batches = ref["cfg"], ref["params"], ref["batches"]
    mesh, _, backend = grid
    eng = TorchEngine(cfg, params_on(params, "cuda"), EngineConfig(**ref["ecfg"]),
                      device="cuda", mesh=mesh)
    eng.reset_rank_stats()
    kept: Dict[str, object] = {}
    reads = tp_reads(eng, kept)

    def before_stop() -> None:
        reads()
        kept["pages"] = sppp_prompt_pages(eng, [r for batch in batches for r in batch])

    got = asyncio.run(serve(eng, batches, before_stop=before_stop))
    streams = [r["tokens"] for r in got]
    pools = sppp_pool_check(f"(a) {axis}", kept["pages"], want_pages, SPPP_F32_BOUNDS)
    print(f"serve-sp-pp: (a) {axis}=2: {first_divergence(streams, ref['streams'])} (CPU); "
          f"routed {sppp_routed(f'(a) {axis}', eng, axis)} full prefills; prompt pages {pools}; "
          f"graph captures {eng.graph_captures} replays {eng.graph_replays}; backend {backend} "
          f"on {card}")
    if streams != ref["streams"]:
        fail(f"serve-sp-pp (a) {axis}=2: streams differ from the CPU's")
    sppp_check_ranks(f"(a) {axis}", eng, kept["stats"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def sppp_pool_check(what: str, got, want, bounds=SPPP_BF16_BOUNDS) -> str:
    """Pool pages ``[L, 2, pages, ...]`` against one card's, within
    ``bounds`` (layer 0, whose K/V no attention output reaches; every
    layer's max; every layer's mean)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    worst, mean = float(d.max()) / float(w.abs().max()), float(d.mean()) / float(w.abs().mean())
    first = float(d[0].max()) / float(w[0].abs().max())
    line = (f"layer 0 max |diff| {first:.3e} of max |value|; all layers max |diff| {worst:.3e} "
            f"of max |value|, mean |diff| {mean:.3e} of mean |value| (bounds "
            f"{', '.join(f'{b:.3e}' for b in bounds)})")
    if any(v > b for v, b in zip((first, worst, mean), bounds)):
        fail(f"serve-sp-pp {what}: the pool differs from one card's prefill: {line}")
    return line


def sppp_pool_requests(vocab: int) -> List[dict]:
    """(b)'s pool-check batch: four prompts no other request shares, one
    token each (their prefills alone write the pool)."""
    rng = np.random.default_rng(21)
    # one bucket (2048): one prefill of 4 lanes, the pipeline's 2
    # microbatches of 2
    return [request(rng.integers(1, vocab, n), 1) for n in (1100, 1500, 1300, 1900)]


def sppp_prompt_pages(engine, reqs: List[dict]) -> torch.Tensor:
    """The pages of ``reqs``' whole prompt blocks in ``engine``'s pool, in
    prompt order (each block once), on the host ``[L, 2, blocks, page,
    Hkv, D]``: the rows
    of prompt positions alone (past a lane's length the flash prefill
    writes zero attention rows where the ring attends the prompt, so
    those rows' later layers differ by design)."""
    from dynamo_tpu_torch.tokens.hashing import hash_blocks

    # a block that several prompts share appears once
    hashes = list(dict.fromkeys(
        h for r in reqs for h in hash_blocks(r["token_ids"], engine.cfg.page_size)[1]))
    pages = prefix_pages(engine, hashes)
    if len(pages) != len(hashes):
        fail(f"serve-sp-pp: {len(pages)} of {len(hashes)} prompt blocks held in the pool")
    return torch.cat([pages[h][0] for h in hashes], dim=2)


def sppp_one_card_pool():
    """One card's prefill of (b)'s pool-check batch (Llama-3-8B, serve's
    weights, the classic path): its prompt pages on the host."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b()
    reqs = sppp_pool_requests(cfg.vocab_size)
    one = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024, mixed_batching=False),
                                  seed=0, device="cuda")
    kept: Dict[str, object] = {}
    asyncio.run(serve(one, [reqs],
                      before_stop=lambda: kept.update(pool=sppp_prompt_pages(one, reqs))))
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return kept["pool"]


def sppp_llama(served: Dict[str, object], axis: str, grid, want_pool, card: str) -> int:
    """(b) Llama-3-8B at full width and depth, bf16, serve's weights (seed
    0) on every rank, at sp = 2 or at pp = 2 over gloo on this card: the
    pool-check batch's pool against one card's prefill of it
    (``want_pool``); serve's primer and batch with top-2 logprobs, cold
    then warm, every request ending with its 64 tokens, where streams part
    from serve run 0's a greedy lane only at a bf16 near tie; full
    prefills routed; the launch invariants on each rank.  Returns the
    leader's kernel-2 launches."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = ModelConfig.llama3_8b()
    primer, batch = serve_requests(cfg.vocab_size)
    batch = [dict(r, sampling_options=dict(r["sampling_options"], logprobs=2)) for r in batch]
    pool_reqs = sppp_pool_requests(cfg.vocab_size)
    greedy = [not r["sampling_options"].get("temperature") for r in batch] * 2
    mesh, _, backend = grid
    t0 = time.perf_counter()
    eng = TorchEngine.random_init(cfg, EngineConfig(num_pages=1024), seed=0, device="cuda",
                                  mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng.reset_rank_stats()
    kept: Dict[str, object] = {}
    marks: Dict[str, object] = {}

    def between(i: int) -> None:
        if i == 1:
            marks["pool"] = sppp_prompt_pages(eng, pool_reqs)
        if i == 3:
            marks["t"] = time.perf_counter()

    t0 = time.perf_counter()
    res = asyncio.run(serve(eng, [pool_reqs, primer, batch, batch], between,
                            tp_reads(eng, kept)))
    n = len(pool_reqs)
    cold, warm = res[n:n + 1 + len(batch)], res[n + 1 + len(batch):]
    wall, wall_w = marks["t"] - t0, max(r["frames"][-1][0] for r in warm) - marks["t"]
    stats = kept["stats"]
    sppp_check_ranks(f"(b) {axis}", eng, stats)
    check_streams(f"serve-sp-pp (b) {axis}", cold[1:], cfg.vocab_size)
    check_streams(f"serve-sp-pp (b) {axis} warm", warm, cfg.vocab_size)
    pools = sppp_pool_check(f"(b) {axis}", marks.pop("pool"), want_pool)
    parted = tp_near_ties(f"(b) {axis}", cold[1:] + warm, served["streams"], greedy)
    st, st_w = served_stats(cold, wall), served_stats(warm, wall_w, primed=False)
    for s in stats:
        print(f"serve-sp-pp: (b) {axis} rank {s['rank']}: sent the leader "
              f"{s['collectives'].get('to_leader_bytes', 0)} bytes; peak "
              f"{s.get('peak_bytes', 0) / 2**30:.3f} GiB")
    print(f"serve-sp-pp: (b) Llama-3-8B {axis}=2 bf16 32 layers: init {init_s:.3f} s; "
          f"routed {sppp_routed(f'(b) {axis}', eng, axis)} full prefills "
          f"(microbatches {eng.pp_microbatches}); pool {pools}; cold wall {wall:.3f} s "
          f"tok_s={st['tok_s']:.3f} ttft_ms={[round(r['ttft'] * 1e3, 3) for r in cold[1:]]}; "
          f"warm wall {wall_w:.3f} s tok_s={st_w['tok_s']:.3f} decode_phase_tok_s="
          f"{st_w['dec']:.3f} ttft_ms={[round(r['ttft'] * 1e3, 3) for r in warm]}; graph "
          f"captures {eng.graph_captures} replays {sum(eng.graph_replays.values())}; streams: "
          f"{parted}; backend {backend} on {card}")
    flash = tp_rank_launches(stats)[0]["flash_prefill_attention"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return flash


def serve_sp_pp_phase(ref: Dict[str, object], served: Dict[str, object], card: str
                      ) -> Dict[str, int]:
    """serve-sp-pp (a) and (b) (module docstring): one grid a prefill
    axis, one after the other, each serving its legs' engines one by one.
    Returns (b)'s pipeline-leader launches of kernel 2."""
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    t0 = time.perf_counter()
    small_pages, want_pool = sppp_small_pages(ref), sppp_one_card_pool()
    times = {"one card": time.perf_counter() - t0}
    launches = {}
    for axis in ("sp", "pp"):
        grid = tp_grid(MeshConfig(**{axis: 2}), axis, "serve-sp-pp")
        try:
            ta = time.perf_counter()
            sppp_small(ref, axis, grid, small_pages, card)
            tb = time.perf_counter()
            launches[axis] = sppp_llama(served, axis, grid, want_pool, card)
            times[f"(a) {axis}"], times[f"(b) {axis}"] = tb - ta, time.perf_counter() - tb
        finally:
            tp_end(grid)
    print(f"serve-sp-pp: phase {time.perf_counter() - t0:.3f} s "
          f"({ {k: round(v, 3) for k, v in times.items()} }) on {card}")
    return {"flash_prefill_attention": launches["pp"]}


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


def held_after(phase: str) -> None:
    """The bytes still allocated on the card once a phase has ended."""
    gc.collect()
    print(f"memory: after {phase}: {torch.cuda.memory_allocated() / 2**30:.3f} GiB still "
          f"allocated")


def main() -> None:
    t_all = time.perf_counter()
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
        # one instantiation per head dim (64, 96, 128, 256), the group at
        # run time; the ragged kernel's for the dense and the int8 pool
        (pa.KERNEL, "paged_decode_tc_kernel", "paged_decode_kernel", 4),
        (fp.KERNEL, "flash_tc_kernel", "flash_kernel", 4),
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
    # serve-disagg's shapes: the export batch, the decode worker's 16 lanes
    rows += [check_export_flash(fp, bucketing, gen), check_disagg_decode(pa, rng, gen),
             check_disagg_packed(ra, bucketing, rng, gen)]
    check_quantize_rule()
    check_geometries(pa, fp, ra, bucketing)
    rows += geometry_rows(pa, fp, ra, bucketing)
    rows += geometry_rows(pa, fp, ra, bucketing, TP_RANK_GEOM)
    # kernel 2 at eval's windows (serve-gguf (b))
    rows += [check_eval_flash(fp, gen, T) for T in GGUF_EVAL_WINDOWS]
    # kernel 2 at a pipeline stage's microbatch (serve-sp-pp (b))
    rows.append(check_pp_stage_flash(fp, gen))
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
    held_after("serve")
    classic, classic_walls = serve_classic_phase(kernels, card)
    held_after("serve-classic")
    quant, quant_walls = serve_int8_phase(kernels, card)
    held_after("serve-int8")
    http_launches = serve_http_phase(ref, served, card)
    print(f"serve-http: launches on the HTTP path {http_launches}")
    held_after("serve-http")
    serve_prof_phase(ref, card)
    held_after("serve-prof")
    a3 = serve_a3_phase(ref, card)
    print(f"serve-a3: flash prefill launches {a3['launches']}")
    held_after("serve-a3")
    a45 = serve_a45_phase(ref, served, card)
    held_after("serve-a45")
    planner = serve_kvbm_phase(ref, served, card)
    held_after("serve-kvbm, serve-chaos, serve-planner (a, b) and serve-admit")
    # serve-dyn's, serve-disagg's and serve-onboard's (c), and serve-mocker's
    # torch worker, serve one checkpoint
    import shutil
    import tempfile

    ckpt_tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        ckpt = write_cli_checkpoint(ckpt_tmp, "serve-dyn, serve-disagg and serve-onboard: (c)")
        direct = serve_dyn_phase(ref, card, ckpt)
        held_after("serve-dyn")
        disagg = serve_disagg_phase(card, ckpt, direct)
        held_after("serve-disagg")
        onboard = serve_onboard_phase(ref, card, ckpt, direct)
        print(f"serve-onboard: launches over (b)'s two legs {onboard}")
        held_after("serve-onboard")
        serve_mocker_phase(card, ckpt)
        held_after("serve-mocker")
        t_tp_cli = time.perf_counter()
        tp_cli(ckpt, card)
        t_tp_cli = time.perf_counter() - t_tp_cli
        planner_s = planner_cli(ckpt, card)
        print(f"serve-planner: (c) {planner_s:.3f} s; phase {planner['seconds'] + planner_s:.3f} s; "
              f"launches of (a) and (b) {planner['launches']}")
        del ckpt
    finally:
        shutil.rmtree(ckpt_tmp, ignore_errors=True)
    serve_moe_phase(ref, card)
    held_after("serve-moe")
    geometry = serve_geometry_phase(ref, card)
    held_after("serve-geometry")
    gguf = serve_gguf_phase(ref, served, card)
    held_after("serve-gguf")
    t_tp = time.perf_counter()
    tp_launches = serve_tp_phase(ref, served, card)
    held_after("serve-tp")
    print(f"serve-tp: phase {time.perf_counter() - t_tp + t_tp_cli:.3f} s ((d) {t_tp_cli:.3f}) "
          f"on {card}")
    sppp = serve_sp_pp_phase(ref, served, card)
    held_after("serve-sp-pp")
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
        # serve-disagg's runs: kernel 2 on the prefill worker, 1 and 5 on
        # the decode worker
        "flash_prefill_attention/export": disagg["flash_prefill_attention"],
        "paged_decode_attention/disagg": disagg["paged_decode_attention"],
        "packed_ragged_attention/disagg": disagg["packed_ragged_attention"],
    }
    # the new geometries' rows: from serve-geometry's runs
    for model, (_, kinds) in GEOM_MODELS.items():
        for kernel in kinds:
            launches[f"{kernel}/{model}"] = geometry[model][kernel]
    # eval's windows: serve-gguf (b)'s runs over README.md
    for T in GGUF_EVAL_WINDOWS:
        launches[f"flash_prefill_attention/eval-{T}"] = gguf[T]
    # a rank of Llama-3-8B at tp = 2: serve-tp (b)'s leader rank (every
    # rank launches as many: checked there)
    for model, (_, kinds) in TP_RANK_GEOM.items():
        for kernel in kinds:
            launches[f"{kernel}/{model}"] = tp_launches[kernel]
    # the pipeline leader's stage in serve-sp-pp (b)
    launches["flash_prefill_attention/pp_stage"] = sppp["flash_prefill_attention"]
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"chip_smoke: whole run {time.perf_counter() - t_all:.3f} s on {card}")
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
