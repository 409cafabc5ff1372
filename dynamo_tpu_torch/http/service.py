"""OpenAI-compatible HTTP service: routes + per-model engine registry.

Reference parity: lib/llm/src/http/service/service_v2.rs:51-133 (HttpService
+ state), openai.rs:123,277 (completions / chat completions handlers with
SSE streaming), discovery/model_manager.rs (ModelManager: engines keyed by
model name, added/removed dynamically by the discovery watcher).

An entry's engine is an AsyncEngine taking Context[ChatCompletionRequest]
(or CompletionRequest) and yielding Annotated[openai-chunk-dict] -- here
``link(OpenAIPreprocessor, Backend, TorchEngine)``.

The JAX package's service for the PyTorch engine: chat, completions,
embeddings, models, health, live and metrics, with the admission bound,
per-request deadlines, request templates, SSE and aggregated bodies; the
request trace (``/trace/{id}``), the tick profiler (``/profile/ticks``),
the device trace (``/profile/device``) and the flight recorder
(``/debug/flightrec``).  A deadline's 504 body and SSE error frame carry
the flight-recorder snapshot taken at the expiry.  With a fleet
observatory attached, ``/fleet`` serves its cluster summary and
``/fleet/metrics`` the ``dynamo_fleet_*`` families; both answer 503
without one.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import AsyncIterator, Dict, Optional

from ..protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    EmbeddingRequest,
    OpenAIError,
    SSE_DONE,
    aggregate_chat,
    aggregate_completion,
    embedding_response,
    sse_encode,
    sse_error,
)
from ..runtime import metrics as rtmetrics
from ..runtime import profiling, slo, tracing
from ..runtime.engine import (
    DEADLINE_EXCEEDED_MSG,
    Annotated,
    AsyncEngine,
    Context,
    DeadlineExceededError,
    as_response_stream,
)
from .metrics import ServiceMetrics
from .server import HttpServer, Request, Response

logger = logging.getLogger("dynamo.http.service")


def _bears_token(data: dict) -> bool:
    """True when an OpenAI chunk carries generated text (TTFT/ITL must not
    count the synthetic role-priming chat chunk)."""
    for c in data.get("choices") or []:
        if (c.get("delta") or {}).get("content"):
            return True
        if c.get("text"):
            return True
    return False


def sse_annotation(name: str, comment) -> bytes:
    """Named SSE event for Annotated annotation envelopes."""
    import json as _json

    payload = _json.dumps({"comment": comment or []}, separators=(",", ":"))
    return f"event: {name}\ndata: {payload}\n\n".encode()


class ModelNotFound(OpenAIError):
    def __init__(self, model: str) -> None:
        super().__init__(f"model '{model}' not found", code=404)


class AdmissionControl:
    """Frontend load shedding: bound concurrently-admitted requests.

    Past ``max_inflight`` (0 = unbounded; env ``DYN_HTTP_MAX_INFLIGHT``)
    new requests are rejected with 503 + ``Retry-After`` (env
    ``DYN_HTTP_RETRY_AFTER_S``) *before* any parsing or engine work --
    overload sheds at the cheapest possible point instead of growing an
    unbounded queue whose every entry will miss its SLO anyway."""

    def __init__(
        self,
        max_inflight: Optional[int] = None,
        retry_after_s: Optional[float] = None,
    ) -> None:
        if max_inflight is None:
            max_inflight = int(os.environ.get("DYN_HTTP_MAX_INFLIGHT", "0"))
        if retry_after_s is None:
            retry_after_s = float(os.environ.get("DYN_HTTP_RETRY_AFTER_S", "1"))
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s
        self.inflight = 0

    def try_acquire(self) -> bool:
        if 0 < self.max_inflight <= self.inflight:
            return False
        self.inflight += 1
        return True

    def release(self) -> None:
        self.inflight = max(0, self.inflight - 1)


class ModelManager:
    """Engines per model name, per endpoint type (chat / completion /
    embedding)."""

    def __init__(self) -> None:
        self._chat: Dict[str, AsyncEngine] = {}
        self._completion: Dict[str, AsyncEngine] = {}
        self._embedding: Dict[str, AsyncEngine] = {}

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def add_embedding_model(self, name: str, engine: AsyncEngine) -> None:
        self._embedding[name] = engine

    def remove_model(self, name: str) -> None:
        self._chat.pop(name, None)
        self._completion.pop(name, None)
        self._embedding.pop(name, None)

    def chat_engine(self, name: str) -> AsyncEngine:
        try:
            return self._chat[name]
        except KeyError:
            raise ModelNotFound(name) from None

    def completion_engine(self, name: str) -> AsyncEngine:
        try:
            return self._completion[name]
        except KeyError:
            raise ModelNotFound(name) from None

    def embedding_engine(self, name: str) -> AsyncEngine:
        try:
            return self._embedding[name]
        except KeyError:
            raise ModelNotFound(name) from None

    def list_models(self) -> list:
        names = sorted(set(self._chat) | set(self._completion) | set(self._embedding))
        return [
            {"id": n, "object": "model", "owned_by": "dynamo-tpu"} for n in names
        ]

    @property
    def is_empty(self) -> bool:
        return not self._chat and not self._completion and not self._embedding


class HttpService:
    """The OpenAI frontend: /v1/chat/completions, /v1/completions,
    /v1/embeddings, /v1/models, /health, /live, /metrics, and the
    observability routes."""

    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics_prefix: str = "dynamo",
        template=None,  # Optional[RequestTemplate]: body defaults
        max_inflight: Optional[int] = None,  # admission bound (None = env)
        default_deadline_s: Optional[float] = None,  # None = env / no deadline
        observatory=None,  # Optional[FleetObservatory]: /fleet surface
    ) -> None:
        self.manager = manager or ModelManager()
        self.observatory = observatory
        self.template = template
        self.admission = AdmissionControl(max_inflight)
        if default_deadline_s is None:
            env_dl = float(os.environ.get("DYN_DEADLINE_S", "0"))
            default_deadline_s = env_dl if env_dl > 0 else None
        self.default_deadline_s = default_deadline_s
        self.metrics = ServiceMetrics(prefix=metrics_prefix)
        self.server = HttpServer(host, port)
        self.server.route("POST", "/v1/chat/completions", self._chat)
        self.server.route("POST", "/v1/completions", self._completions)
        self.server.route("POST", "/v1/embeddings", self._embeddings)
        self.server.route("GET", "/v1/models", self._models)
        self.server.route("GET", "/health", self._health)
        self.server.route("GET", "/live", self._health)
        self.server.route("GET", "/metrics", self._metrics)
        self.server.route_prefix("GET", "/trace/", self._trace)
        # the performance-observability plane (runtime/profiling.py): the
        # tick ring and its live switch, a bounded device trace, and the
        # flight recorder's snapshots
        self.server.route("GET", "/profile/ticks", self._profile_ticks)
        self.server.route("POST", "/profile/ticks", self._profile_ticks_post)
        self.server.route("POST", "/profile/device", self._profile_device)
        self.server.route("GET", "/debug/flightrec", self._flightrec_list)
        self.server.route_prefix("GET", "/debug/flightrec/", self._flightrec_get)
        # fleet observatory surface (fleet/observatory.py): cluster summary
        # and the dynamo_fleet_* exposition, 503 until an observatory is wired
        self.server.route("GET", "/fleet", self._fleet)
        self.server.route("GET", "/fleet/metrics", self._fleet_metrics)

    @property
    def address(self) -> tuple:
        return self.server.address

    @property
    def url(self) -> str:
        host, port = self.server.address
        return f"http://{host}:{port}"

    async def start(self) -> None:
        await self.server.start()
        logger.info("http service listening on %s", self.url)

    async def stop(self) -> None:
        await self.server.stop()

    # -- handlers ------------------------------------------------------------

    async def _fleet(self, req: Request) -> Response:
        """GET /fleet: the observatory's cluster summary -- per-worker
        rows, role-aggregated totals, the learned link table, stragglers."""
        if self.observatory is None:
            return Response.json(
                {"error": {"message": "no fleet observatory attached"}}, 503
            )
        return Response.json(self.observatory.summary())

    async def _fleet_metrics(self, req: Request) -> Response:
        """GET /fleet/metrics: only the ``dynamo_fleet_*`` families, for
        scrapers that want cluster rollups without per-process series."""
        if self.observatory is None:
            return Response.json(
                {"error": {"message": "no fleet observatory attached"}}, 503
            )
        body, content_type = self.observatory.render()
        return Response(200, {"Content-Type": content_type}, body)

    async def _health(self, req: Request) -> Response:
        return Response.json(
            {"status": "healthy", "models": [m["id"] for m in self.manager.list_models()]}
        )

    async def _models(self, req: Request) -> Response:
        return Response.json({"object": "list", "data": self.manager.list_models()})

    async def _metrics(self, req: Request) -> Response:
        # one scrape surface: the service's private HTTP-layer families plus
        # the process-wide runtime registry (disjoint family names); stale
        # SLO windows age out of the attainment gauges first
        slo.tracker.refresh_gauges()
        body, content_type = self.metrics.render()
        runtime_body, _ = rtmetrics.render_default()
        return Response(200, {"Content-Type": content_type}, body + runtime_body)

    async def _trace(self, req: Request) -> Response:
        """GET /trace/{request_id}: this process's spans for one request,
        plus the Chrome-trace export (the cross-process timeline is the
        ``trace`` CLI's job)."""
        rid = req.path[len("/trace/"):].strip("/")
        if not rid:
            return Response.json(
                {"error": {"message": "usage: /trace/{request_id}"}}, 400
            )
        spans = [s.to_dict() for s in tracing.collector.get(rid)]
        if not spans:
            return Response.json(
                {"error": {"message": f"no spans for request {rid!r}"}}, 404
            )
        return Response.json(
            {
                "request_id": rid,
                "spans": spans,
                "chrome_trace": tracing.chrome_trace(spans),
            }
        )

    async def _profile_ticks(self, req: Request) -> Response:
        """GET /profile/ticks: the tick profiler's ring, its summary and a
        Chrome-trace export merged with this process's request spans."""
        prof = profiling.profiler
        spans = tracing.collector.dump() if tracing.collector.enabled else []
        return Response.json(
            {
                "enabled": prof.enabled,
                "summary": prof.summary(),
                "ticks": [r.to_dict() for r in prof.records()],
                "chrome_trace": prof.chrome_trace(spans),
            }
        )

    async def _profile_ticks_post(self, req: Request) -> Response:
        """POST /profile/ticks {"enabled": true|false, "clear": bool}:
        arm or disarm tick profiling on a live server."""
        body = req.json() or {}
        if not isinstance(body, dict):
            return Response.json(
                {"error": {"message": "body must be a JSON object"}}, 400
            )
        prof = profiling.profiler
        if body.get("clear"):
            prof.clear()
        if "enabled" in body:
            if body["enabled"]:
                prof.enable()
            else:
                prof.disable()
        return Response.json({"enabled": prof.enabled})

    async def _profile_device(self, req: Request) -> Response:
        """POST /profile/device {"duration_s": 1.0, "log_dir": "..."}: a
        bounded ``torch.profiler`` capture; ``ok=false`` and the reason,
        with 503, when it cannot be taken."""
        body = req.json() or {}
        if not isinstance(body, dict):
            return Response.json(
                {"error": {"message": "body must be a JSON object"}}, 400
            )
        try:
            duration = float(body.get("duration_s", 1.0))
        except (TypeError, ValueError):
            return Response.json(
                {"error": {"message": "duration_s must be a number"}}, 400
            )
        result = await profiling.capture_device_trace(
            duration, body.get("log_dir")
        )
        return Response.json(result, 200 if result.get("ok") else 503)

    async def _flightrec_list(self, req: Request) -> Response:
        return Response.json(
            {"snapshots": profiling.flight_recorder.list()}
        )

    async def _flightrec_get(self, req: Request) -> Response:
        snap_id = req.path[len("/debug/flightrec/"):].strip("/")
        snap = profiling.flight_recorder.get(snap_id)
        if snap is None:
            return Response.json(
                {"error": {"message": f"no flight-recorder snapshot {snap_id!r}"}},
                404,
            )
        return Response.json(snap)

    def _shed(self, endpoint: str) -> Response:
        """Admission-control rejection: 503 + Retry-After, counted."""
        self.metrics.sheds.labels(endpoint).inc()
        if slo.tracker.enabled:
            slo.tracker.record_shed()
        resp = Response.json(
            {
                "error": {
                    "message": "server overloaded, retry later",
                    "type": "overloaded_error",
                }
            },
            503,
        )
        resp.headers["Retry-After"] = (
            f"{self.admission.retry_after_s:g}"
        )
        return resp

    def _deadline_expired(self, request: Context, rsp=None) -> str:
        """One deadline-expiry bookkeeping site for every 504 path: SLO
        violation with cause=deadline, a flight-recorder snapshot, and the
        snapshot id stamped onto the request span.  Returns the id the
        error frame/body carries."""
        # the violation first: the dump must carry its own trigger
        if slo.tracker.enabled:
            slo.tracker.record_deadline(request.id)
        fid = profiling.flight_recorder.snapshot(
            "deadline_expired", request_id=request.id
        )
        if rsp is not None:
            rsp.set(deadline_expired=True, flightrec_id=fid)
        return fid

    @staticmethod
    def _deadline_body(fid: str) -> dict:
        return {
            "error": {
                "message": DEADLINE_EXCEEDED_MSG,
                "type": "timeout_error",
                "flightrec": fid,
            }
        }

    def _request_deadline(self, req: Request) -> Optional[float]:
        """Per-request deadline budget in seconds: the
        ``X-Request-Deadline-S`` header, else the service default
        (``DYN_DEADLINE_S``), else None (no deadline)."""
        raw = req.headers.get("x-request-deadline-s")
        if raw:
            try:
                return float(raw)
            except ValueError:
                logger.warning("ignoring bad X-Request-Deadline-S %r", raw)
        return self.default_deadline_s

    def _count_rejected(self, body: Optional[dict], endpoint: str) -> None:
        """Count a rejected request, labelling with the model name only when
        it is actually served: client-supplied junk names must not mint
        unbounded label series."""
        raw = body.get("model") if body else None
        known = {m["id"] for m in self.manager.list_models()}
        self.metrics.requests_total.labels(
            raw if raw in known else "unknown", endpoint, "rejected"
        ).inc()

    async def _chat(self, req: Request) -> Response:
        return await self._serve(req, chat=True)

    async def _completions(self, req: Request) -> Response:
        return await self._serve(req, chat=False)

    async def _embeddings(self, req: Request) -> Response:
        """/v1/embeddings: one aggregated response, no streaming."""
        endpoint = "embeddings"
        if not self.admission.try_acquire():
            return self._shed(endpoint)
        try:
            body = req.json()
            if not isinstance(body, dict):
                raise OpenAIError("request body must be a JSON object")
            if self.template is not None and self.template.model is not None:
                body.setdefault("model", self.template.model)
            parsed = EmbeddingRequest.from_dict(body)
            engine = self.manager.embedding_engine(parsed.model)
        except OpenAIError as e:
            self.admission.release()
            self._count_rejected(body if isinstance(body, dict) else None, endpoint)
            return Response.json(e.to_body(), e.code)
        except BaseException:
            self.admission.release()
            raise

        request = Context.new(parsed)
        guard = self.metrics.guard(parsed.model, endpoint, request.id)
        guard.on_finish = self.admission.release
        try:
            with guard, tracing.span(
                "http.request", request.id, component="http",
                bind=True, endpoint=endpoint, model=parsed.model,
            ):
                stream = await as_response_stream(engine, request)
                vectors, prompt_tokens = None, 0
                async for item in stream:
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    if item.is_error():
                        raise RuntimeError(item.error_message() or "engine error")
                    data = item.data or {}
                    if "embeddings" in data:
                        vectors = data["embeddings"]
                        prompt_tokens = int(data.get("prompt_tokens", 0))
                if vectors is None:
                    raise RuntimeError("embedding engine returned no vectors")
                guard.mark_ok()
                resp = Response.json(
                    embedding_response(parsed.model, vectors, prompt_tokens)
                )
                resp.headers.setdefault("X-Request-Id", request.id)
                return resp
        except OpenAIError as e:
            # the guard's __exit__ already finished it with status=error
            return Response.json(e.to_body(), e.code)
        except Exception as e:
            logger.exception("embedding request failed")
            return Response.json(
                {"error": {"message": str(e), "type": "server_error"}}, 500
            )

    async def _serve(self, req: Request, chat: bool) -> Response:
        endpoint = "chat_completions" if chat else "completions"
        # shed BEFORE parsing: overload rejection must stay O(1)
        if not self.admission.try_acquire():
            return self._shed(endpoint)
        try:
            body = req.json()
            if not isinstance(body, dict):
                raise OpenAIError("request body must be a JSON object")
            if self.template is not None:
                body = self.template.apply(body)
            parsed = (
                ChatCompletionRequest.from_dict(body)
                if chat
                else CompletionRequest.from_dict(body)
            )
            engine = (
                self.manager.chat_engine(parsed.model)
                if chat
                else self.manager.completion_engine(parsed.model)
            )
        except OpenAIError as e:
            self.admission.release()
            self._count_rejected(body if isinstance(body, dict) else None, endpoint)
            return Response.json(e.to_body(), e.code)
        except BaseException:
            self.admission.release()
            raise

        request = Context.new(parsed)
        guard = self.metrics.guard(parsed.model, endpoint, request.id)
        # Deadline budget: armed here at the edge, it rides the codec
        # headers hop by hop; the local watchdog kills the request context
        # at expiry so even an engine that never checks terminates.
        deadline_s = self._request_deadline(req)
        watchdog = None
        if deadline_s is not None:
            request.ctx.set_deadline(deadline_s)
            watchdog = asyncio.get_running_loop().call_later(
                max(deadline_s, 0.0), request.ctx.kill
            )

        def on_finish() -> None:
            self.admission.release()
            if watchdog is not None:
                watchdog.cancel()

        guard.on_finish = on_finish
        # the root span of the request's trace, bound to the request id so
        # the engine's spans link under it; it closes when the response
        # body completes, covering the whole stream
        rsp = tracing.span(
            "http.request", request.id, component="http", bind=True,
            endpoint=endpoint, model=parsed.model,
        )
        rsp.__enter__()
        try:
            stream = await as_response_stream(engine, request)
        except DeadlineExceededError as e:
            guard.mark_error()
            guard.finish()
            fid = self._deadline_expired(request, rsp)
            rsp.__exit__(type(e), e, e.__traceback__)
            return Response.json(self._deadline_body(fid), 504)
        except Exception as e:
            logger.exception("engine dispatch failed")
            guard.mark_error()
            guard.finish()
            rsp.__exit__(type(e), e, e.__traceback__)
            return Response.json(
                {"error": {"message": f"engine error: {e}", "type": "server_error"}},
                503,
            )

        if parsed.stream:
            started = [False]
            resp = Response.sse(self._sse_body(stream, request, guard, rsp, started))

            def on_close() -> None:
                # the server calls this once the connection is done with the
                # response; a body generator that was never started (the
                # client vanished before the first header byte) never runs
                # its cleanup, so this is the only path that can kill the
                # engine-side request and release the inflight gauge
                if not started[0]:
                    request.ctx.kill()
                    guard.mark_error()
                    guard.finish()
                    rsp.set(abandoned=True)
                    rsp.__exit__(None, None, None)

            resp.on_close = on_close
        else:
            resp = await self._aggregate_body(stream, request, guard, chat, rsp)
        resp.headers.setdefault("X-Request-Id", request.id)
        return resp

    async def _sse_body(
        self, stream, request: Context, guard, rsp=None, started=None
    ) -> AsyncIterator[bytes]:
        if started is not None:
            started[0] = True
        try:
            with guard:
                async for item in stream:
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    if item.is_error():
                        guard.mark_error()
                        if rsp is not None:
                            rsp.set(error=True)
                        yield sse_error(item.error_message() or "engine error")
                        return
                    if item.data is not None:
                        if _bears_token(item.data):
                            guard.token()
                        yield sse_encode(item.data)
                    elif item.event is not None:
                        # annotation envelope (formatted_prompt / token_ids
                        # ...): surface as a named SSE event
                        yield sse_annotation(item.event, item.comment)
                if request.ctx.deadline_expired():
                    # the watchdog killed the request: the stream ended
                    # because the budget ran out, not because it finished
                    guard.mark_error()
                    fid = self._deadline_expired(request, rsp)
                    yield sse_error(f"{DEADLINE_EXCEEDED_MSG} [flightrec:{fid}]")
                    return
                guard.mark_ok()
                yield SSE_DONE
        except (asyncio.CancelledError, GeneratorExit):
            # client went away mid-stream (handler cancelled, or the writer
            # failed and the generator was aclosed): kill the engine-side
            # request instead of decoding for a dead connection
            request.ctx.kill()
            if rsp is not None:
                rsp.set(abandoned=True)
            raise
        except Exception as e:
            # the guard's __exit__ already finished it with status=error
            logger.exception("stream failed")
            if rsp is not None:
                rsp.set(error=True)
            yield sse_error(str(e))
        finally:
            if rsp is not None:
                rsp.__exit__(None, None, None)

    async def _aggregate_body(
        self, stream, request: Context, guard, chat: bool, rsp=None
    ) -> Response:
        chunks = []

        def timeout_response() -> Response:
            guard.mark_error()
            fid = self._deadline_expired(request, rsp)
            return Response.json(self._deadline_body(fid), 504)

        try:
            with guard:
                async for item in stream:
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    if item.is_error():
                        msg = item.error_message() or ""
                        if msg.startswith(DEADLINE_EXCEEDED_MSG):
                            return timeout_response()
                        guard.mark_error()
                        if rsp is not None:
                            rsp.set(error=True)
                        return Response.json(
                            {
                                "error": {
                                    "message": item.error_message(),
                                    "type": "server_error",
                                }
                            },
                            500,
                        )
                    if item.data is not None:
                        if _bears_token(item.data):
                            guard.token()
                        chunks.append(item.data)
                if request.ctx.deadline_expired():
                    # watchdog-killed: the stream ended on budget expiry
                    return timeout_response()
                guard.mark_ok()
                agg = (
                    aggregate_chat(chunks) if chat
                    else aggregate_completion(chunks)
                )
                return Response.json(agg)
        except DeadlineExceededError:
            return timeout_response()
        except Exception as e:
            # the guard's __exit__ already finished it with status=error
            logger.exception("aggregation failed")
            if rsp is not None:
                rsp.set(error=True)
            return Response.json(
                {"error": {"message": str(e), "type": "server_error"}}, 500
            )
        finally:
            if rsp is not None:
                rsp.__exit__(None, None, None)
