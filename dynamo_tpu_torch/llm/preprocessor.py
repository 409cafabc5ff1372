"""OpenAIPreprocessor: OpenAI requests -> token-level requests, and engine
deltas -> OpenAI chunks on the way back.

Reference parity: lib/llm/src/preprocessor.rs:64-110 (template render +
tokenize + sampling-defaults application, ``formatted_prompt`` / ``token_ids``
annotations) and the chat-template engine under preprocessor/prompt/
(minijinja there, jinja2 here -- both execute the HF ``chat_template``
dialect: ``raise_exception``, ``tojson``, sandboxed).
"""

from __future__ import annotations

import time
from typing import Any, AsyncIterator, Dict, List, Optional, Union

import jinja2
import jinja2.sandbox

from ..protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    SpeculationOptions,
    StopConditions,
)
from ..protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    OpenAIError,
    chat_chunk,
    completion_chunk,
    new_response_id,
    usage_block,
)
from ..runtime.engine import Annotated, AsyncEngine, Context, as_response_stream
from ..runtime.pipeline import Operator
from .tokenizer import Tokenizer

# Fallback template when the tokenizer artifact carries none: the simple
# role-tagged layout (matches the reference's default for template-less
# models rather than failing the request).
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>\n{{ message['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


def _raise_exception(message: str) -> None:
    raise jinja2.exceptions.TemplateError(message)


class PromptFormatter:
    """Renders the HF ``chat_template`` for a message list."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._env = jinja2.sandbox.ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True
        )
        self._env.globals["raise_exception"] = _raise_exception
        self._env.globals["strftime_now"] = lambda fmt: time.strftime(fmt)
        template = tokenizer.chat_template or DEFAULT_CHAT_TEMPLATE
        self._template = self._env.from_string(template)
        self._bos = tokenizer.bos_token or ""
        self._eos = tokenizer.eos_token or ""

    def render(self, messages: List[Dict[str, Any]]) -> str:
        try:
            return self._template.render(
                messages=messages,
                add_generation_prompt=True,
                bos_token=self._bos,
                eos_token=self._eos,
            )
        except jinja2.exceptions.TemplateError as e:
            raise OpenAIError(f"chat template failed: {e}") from e


class OpenAIPreprocessor(Operator):
    """Forward: OpenAI request -> PreprocessedRequest.  Backward: backend
    deltas -> OpenAI chunk dicts (still wrapped in Annotated envelopes).

    The downstream engine yields dicts shaped like BackendOutput: ``text``
    (delta), ``token_ids``, ``finish_reason``.
    """

    def __init__(self, model_name: str, tokenizer: Tokenizer) -> None:
        self.model_name = model_name
        self.tokenizer = tokenizer
        self.formatter = PromptFormatter(tokenizer)

    # -- forward translation -------------------------------------------------

    def preprocess(
        self, req: Union[ChatCompletionRequest, CompletionRequest]
    ) -> PreprocessedRequest:
        if isinstance(req, ChatCompletionRequest):
            prompt = self.formatter.render(req.messages)
            token_ids = self.tokenizer.encode(prompt)
        elif isinstance(req.prompt, list):
            prompt = None
            token_ids = list(req.prompt)
        else:
            prompt = req.prompt
            token_ids = self.tokenizer.encode(prompt)
        s = req.sampling
        out = PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=StopConditions(
                max_tokens=s.max_tokens,
                stop=s.stop,
                min_tokens=s.min_tokens,
                ignore_eos=s.ignore_eos,
            ),
            sampling_options=SamplingOptions(
                temperature=s.temperature,
                top_p=s.top_p,
                top_k=s.top_k,
                frequency_penalty=s.frequency_penalty,
                presence_penalty=s.presence_penalty,
                repetition_penalty=s.repetition_penalty,
                seed=s.seed,
                logprobs=s.logprobs,
            ),
            eos_token_ids=self.tokenizer.eos_token_ids,
        )
        spec = getattr(req, "speculation", None)
        if spec:
            out.speculation = SpeculationOptions(
                enabled=spec.get("enabled", True),
                num_draft_tokens=spec.get("num_draft_tokens", 4),
                drafter=spec.get("drafter", "ngram"),
            )
        if getattr(req, "echo", False) and s.logprobs is not None:
            # legacy OpenAI echo+logprobs: the engine's verify-scoring path
            # serves per-position PROMPT logprobs alongside the completion
            out.prompt_logprobs = s.logprobs
        out.annotations = list(getattr(req, "annotations", []) or [])
        out._formatted_prompt = prompt  # for the formatted_prompt annotation
        return out

    def _format_logprobs(
        self, data: Dict[str, Any], is_chat: bool, text_off: int
    ) -> Dict[str, Any]:
        """Engine logprob payload -> OpenAI response structures.

        Chat: ``{"content": [{token, logprob, bytes, top_logprobs}]}``;
        completions: ``{tokens, token_logprobs, top_logprobs, text_offset}``
        (reference aggregator shapes, openai/completions/aggregator.rs:43).
        Token strings come from single-id detokenization; ``text_offset``
        is the offset of this chunk's first token within the emitted
        completion text (per-token offsets inside a multi-token chunk are
        approximated from the token strings' lengths -- the stop jail can
        hold back text, so exact alignment is not reconstructible in a
        stream)."""
        ids = data.get("token_ids") or []
        lps = data.get("logprobs") or []
        tops = data.get("top_logprobs")
        tok_str = [self.tokenizer.decode([t]) for t in ids]

        def top_entries(i: int):
            if tops is None or i >= len(tops):
                return None
            return [
                (self.tokenizer.decode([int(tid)]), float(tlp))
                for tid, tlp in tops[i]
            ]

        if is_chat:
            content = []
            for i, (t, lp) in enumerate(zip(tok_str, lps)):
                entry: Dict[str, Any] = {
                    "token": t,
                    "logprob": lp,
                    "bytes": list(t.encode("utf-8")),
                }
                te = top_entries(i)
                if te is not None:
                    entry["top_logprobs"] = [
                        {
                            "token": s,
                            "logprob": l,
                            "bytes": list(s.encode("utf-8")),
                        }
                        for s, l in te
                    ]
                content.append(entry)
            return {"content": content}
        offsets, off = [], text_off
        for t in tok_str:
            offsets.append(off)
            off += len(t)
        def top_map(i: int) -> Dict[str, float]:
            return self._first_wins_map(top_entries(i) or [])

        return {
            "tokens": tok_str,
            "token_logprobs": list(lps),
            "top_logprobs": (
                [top_map(i) for i in range(len(ids))]
                if tops is not None
                else None
            ),
            "text_offset": offsets,
        }

    @staticmethod
    def _first_wins_map(
        pairs, limit: Optional[int] = None
    ) -> Dict[str, float]:
        """Probability-sorted ``(token_string, logprob)`` pairs -> the
        OpenAI top_logprobs map.  Two token ids can decode to the same
        string, and the later (lower-probability) alternative must not
        overwrite the earlier one -- the ONE dedup rule shared by the
        completion and prompt logprob blocks."""
        out: Dict[str, float] = {}
        for s, l in pairs:
            if limit is not None and len(out) >= limit:
                break
            if s not in out:
                out[s] = float(l)
        return out

    def _format_prompt_logprobs(
        self, entries: List[Any], want: int
    ) -> Dict[str, Any]:
        """Engine prompt-logprob entries -> the completions logprobs block
        covering the echoed prompt.  Entries are ``[token_id, logprob|None,
        top|None]`` per prompt position (position 0 carries None, the
        OpenAI prompt-logprobs shape); offsets start at 0 because the echo
        text leads the response."""
        tokens: List[str] = []
        lps: List[Any] = []
        tops: List[Any] = []
        offsets: List[int] = []
        off = 0
        for tid, lp, top in entries:
            s = self.tokenizer.decode([int(tid)])
            tokens.append(s)
            lps.append(lp)
            if top is None or want <= 0:
                tops.append(None)
            else:
                tops.append(
                    self._first_wins_map(
                        (
                            (self.tokenizer.decode([int(alt_id)]), alt_lp)
                            for alt_id, alt_lp in top
                        ),
                        limit=want,
                    )
                )
            offsets.append(off)
            off += len(s)
        return {
            "tokens": tokens,
            "token_logprobs": lps,
            "top_logprobs": tops if want > 0 else None,
            "text_offset": offsets,
        }

    # -- Operator ------------------------------------------------------------

    async def generate(
        self, request: Context, next: AsyncEngine
    ) -> AsyncIterator[Annotated]:
        req = request.data
        is_chat = isinstance(req, ChatCompletionRequest)
        pre = self.preprocess(req)
        stream = await as_response_stream(next, request.replace(pre.to_dict()))

        rid = new_response_id("chatcmpl" if is_chat else "cmpl")
        created = int(time.time())
        model = self.model_name

        async def gen() -> AsyncIterator[Annotated]:
            # request-level annotations ride the stream ahead of data
            # (reference preprocessor.rs:61-62)
            if "formatted_prompt" in pre.annotations and pre._formatted_prompt:
                yield Annotated.from_annotation(
                    "formatted_prompt", pre._formatted_prompt
                )
            if "token_ids" in pre.annotations:
                yield Annotated.from_annotation("token_ids", pre.token_ids)
            if is_chat:
                yield Annotated.from_data(
                    chat_chunk(rid, model, created, role="assistant", content="")
                )
            completion_tokens = 0
            finish: Optional[str] = None
            text_off = 0  # running offset into the emitted completion text
            spec_stats = None  # engine-reported acceptance (finish item)
            pending_echo: Optional[str] = None
            if not is_chat and getattr(req, "echo", False):
                # OpenAI completions echo: the prompt text leads the
                # completion (its length counts into text_offset)
                prompt_text = (
                    req.prompt
                    if isinstance(req.prompt, str)
                    else self.tokenizer.decode(list(req.prompt))
                )
                if prompt_text and pre.prompt_logprobs is not None:
                    # echo+logprobs: hold the echo chunk until the engine's
                    # first item delivers the prompt logprobs that belong
                    # on it (engines without the scoring path degrade to a
                    # plain echo)
                    pending_echo = prompt_text
                elif prompt_text:
                    yield Annotated.from_data(
                        completion_chunk(
                            rid, model, created, text=prompt_text
                        )
                    )
                    text_off = len(prompt_text)
            async for item in stream:
                if not isinstance(item, Annotated):
                    item = Annotated.from_data(item)
                if item.is_error():
                    yield item
                    return
                data = item.data
                if data is None:
                    continue
                if data.get("spec") is not None:
                    spec_stats = data["spec"]
                if pending_echo is not None:
                    plp = data.get("prompt_logprobs")
                    lp_block = (
                        self._format_prompt_logprobs(
                            plp, pre.prompt_logprobs or 0
                        )
                        if plp
                        else None
                    )
                    yield Annotated.from_data(
                        completion_chunk(
                            rid, model, created, text=pending_echo,
                            logprobs=lp_block,
                        )
                    )
                    text_off = len(pending_echo)
                    pending_echo = None
                completion_tokens += len(data.get("token_ids") or [])
                text = data.get("text")
                fr = data.get("finish_reason")
                if fr:
                    from ..protocols.common import FinishReason

                    finish = FinishReason(fr).to_openai()
                # a token whose incremental detok produced no text yet (e.g.
                # a byte-level partial) must still ship its logprobs
                has_lp = (
                    data.get("logprobs") is not None
                    and data.get("token_ids")
                )
                if text or has_lp:
                    lp = (
                        self._format_logprobs(data, is_chat, text_off)
                        if has_lp
                        else None
                    )
                    text_off += len(text or "")
                    if is_chat:
                        yield Annotated.from_data(
                            chat_chunk(
                                rid, model, created, content=text or "",
                                logprobs=lp,
                            )
                        )
                    else:
                        yield Annotated.from_data(
                            completion_chunk(
                                rid, model, created, text=text or "",
                                logprobs=lp,
                            )
                        )
            if pending_echo is not None:
                # the engine produced no data items at all; still echo
                yield Annotated.from_data(
                    completion_chunk(rid, model, created, text=pending_echo)
                )
            final = (
                chat_chunk(rid, model, created, finish_reason=finish or "stop")
                if is_chat
                else completion_chunk(
                    rid, model, created, finish_reason=finish or "stop"
                )
            )
            final["usage"] = usage_block(len(pre.token_ids), completion_tokens)
            if spec_stats is not None:
                # per-choice acceptance observability: the usage extension
                # mirrors the engine's spec stats (tracing carries the same
                # numbers as the request span's spec_accept_rate attr)
                final["usage"]["speculation"] = spec_stats
            yield Annotated.from_data(final)

        return gen()
