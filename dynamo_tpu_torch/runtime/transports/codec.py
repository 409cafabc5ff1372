"""Wire framing for the control hub and the request/response plane.

Two-part frames: a small JSON header and an opaque binary payload, each
length-prefixed (u32 big-endian).  Reference parity: TwoPartCodec
(lib/runtime/src/pipeline/network/codec/two_part.rs) which frames
{RequestControlMessage, payload} the same way; re-used here for every plane
(hub RPC, request plane, response stream) instead of mixing NATS messages and
raw TCP.

Frame layout:  [u32 header_len][u32 payload_len][header JSON][payload bytes]
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

_LEN = struct.Struct(">II")

# Wire-format registry: every kind listed here must have BOTH an encoder
# (encode_*/write_* function) and a decoder (decode_*/read_* function) in
# this module -- dynalint DT006 enforces the pairing, so a new frame kind
# cannot ship half-implemented (an encoder the peer cannot parse, or a
# decoder nothing emits).  Add the kind here FIRST when growing the wire
# format; the lint failure then lists exactly what is missing.
FRAME_KINDS = ("frame", "chunk", "trace", "deadline")

# 64 MiB hard cap per frame: a corrupt length prefix should fail fast, not OOM.
MAX_FRAME = 64 * 1024 * 1024


def encode_frame(header: Dict[str, Any], payload: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if len(hdr) > MAX_FRAME or len(payload) > MAX_FRAME:
        raise ValueError("frame exceeds MAX_FRAME")
    return _LEN.pack(len(hdr), len(payload)) + hdr + payload


class TruncatedFrame(ConnectionError):
    """Connection died mid-frame: NOT a clean close."""


async def read_frame(
    reader: asyncio.StreamReader,
) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """Read one frame.

    Returns None only on clean EOF at a frame boundary; a connection torn
    mid-frame raises :class:`TruncatedFrame` so callers can distinguish
    graceful shutdown from transport failure.
    """
    try:
        prefix = await reader.readexactly(_LEN.size)
    except ConnectionResetError:
        return None
    except asyncio.IncompleteReadError as exc:
        if exc.partial:
            raise TruncatedFrame("EOF inside frame length prefix") from exc
        return None
    hdr_len, payload_len = _LEN.unpack(prefix)
    if hdr_len > MAX_FRAME or payload_len > MAX_FRAME:
        raise ValueError(f"oversized frame: hdr={hdr_len} payload={payload_len}")
    try:
        hdr_bytes = await reader.readexactly(hdr_len)
        payload = await reader.readexactly(payload_len) if payload_len else b""
    except (asyncio.IncompleteReadError, ConnectionResetError) as exc:
        raise TruncatedFrame("EOF inside frame body") from exc
    return json.loads(hdr_bytes), payload


# ---------------------------------------------------------------------------
# Trace-context header field (distributed tracing, runtime/tracing.py)
#
# The trace context -- which trace a request belongs to and which span is
# the parent of whatever the receiver opens -- rides every plane's JSON
# frame header under one reserved key.  It is optional: tracing disabled
# means the key is absent and frames are byte-identical to the untraced
# wire format (tests assert this).
# ---------------------------------------------------------------------------

TRACE_HDR_KEY = "trace"


def encode_trace_context(
    header: Dict[str, Any], wire_ctx: Optional[Dict[str, str]]
) -> Dict[str, Any]:
    """Stamp a trace context (``tracing.wire_context()`` output) into a
    frame header in place; a None context leaves the header untouched, so
    call sites need no tracing-enabled branch of their own."""
    if wire_ctx:
        header[TRACE_HDR_KEY] = wire_ctx
    return header


def decode_trace_context(header: Dict[str, Any]) -> Optional[Dict[str, str]]:
    """Inverse of :func:`encode_trace_context`: the raw wire dict
    (``{"tid": ..., "sid": ...}``) or None.  Validation/typing lives in
    ``tracing.TraceContext.from_wire`` -- the codec only carries bytes."""
    ctx = header.get(TRACE_HDR_KEY)
    return ctx if isinstance(ctx, dict) else None


# ---------------------------------------------------------------------------
# Deadline-budget header field (request recovery, runtime/engine.py)
#
# A request's remaining deadline budget rides every hop's JSON frame header
# next to the trace context, as *relative seconds remaining* -- wall clocks
# across hosts need not agree; each receiver re-anchors the budget on its
# own monotonic clock (``AsyncEngineContext.set_deadline``).  Time spent on
# the hop decrements the budget naturally.  Optional: requests without a
# deadline leave the header untouched (byte-identical wire format).
# ---------------------------------------------------------------------------

DEADLINE_HDR_KEY = "dl"


def encode_deadline_context(
    header: Dict[str, Any], remaining_s: Optional[float]
) -> Dict[str, Any]:
    """Stamp the remaining deadline budget (seconds) into a frame header in
    place; None leaves the header untouched, so call sites need no
    deadline-armed branch of their own."""
    if remaining_s is not None:
        header[DEADLINE_HDR_KEY] = round(float(remaining_s), 4)
    return header


def decode_deadline_context(header: Dict[str, Any]) -> Optional[float]:
    """Inverse of :func:`encode_deadline_context`: the remaining budget in
    seconds, or None.  Non-numeric junk decodes to None (a malformed
    header must not crash the read loop)."""
    v = header.get(DEADLINE_HDR_KEY)
    return float(v) if isinstance(v, (int, float)) else None


# ---------------------------------------------------------------------------
# Chunked binary messages (the disagg KV streaming wire format)
#
# A large binary payload split into N logical chunks rides the upload plane as
# a sequence of self-describing sub-frames, each tagged with its chunk index
# and absolute byte offset, so the receiver can (a) place bytes into a
# preallocated buffer as they land, (b) tolerate whole chunks arriving out of
# order (retried/parallel senders), and (c) reject truncated or overlapping
# streams instead of assembling garbage.  The chunk boundaries themselves are
# carried in the message header (layer spans for KV exports), not here.
# ---------------------------------------------------------------------------

CHUNK_MAGIC = 0x4B564331  # "KVC1"
_CHUNK_HDR = struct.Struct(">IIQ")  # magic, chunk index, absolute byte offset


def encode_chunk_frame(index: int, offset: int, payload) -> bytearray:
    """Frame one piece of chunk ``index`` starting at absolute ``offset``.
    ``payload`` is any bytes-like; the result is a single upload part.
    One payload copy total (pack_into + slice assign), not the two a
    bytes-concat would pay -- this sits on the bulk KV upload path."""
    out = bytearray(_CHUNK_HDR.size + len(payload))
    _CHUNK_HDR.pack_into(out, 0, CHUNK_MAGIC, index, offset)
    out[_CHUNK_HDR.size :] = payload
    return out


def iter_chunk_frames(index: int, base_offset: int, payload, chunk_bytes: int):
    """Split one chunk's payload into wire frames of at most
    ``chunk_bytes`` each, all tagged with the chunk's ``index`` and their
    absolute byte offset.  The single framing loop both KV emitters
    (disagg delivery, prefix-onboard export) share."""
    view = memoryview(payload)
    for off in range(0, len(view), chunk_bytes):
        yield encode_chunk_frame(
            index, base_offset + off, view[off : off + chunk_bytes]
        )


def decode_chunk_frame(frame) -> Tuple[int, int, memoryview]:
    """Inverse of :func:`encode_chunk_frame`; the payload view is zero-copy."""
    view = memoryview(frame)
    if len(view) < _CHUNK_HDR.size:
        raise ValueError("chunk frame shorter than its header")
    magic, index, offset = _CHUNK_HDR.unpack_from(view)
    if magic != CHUNK_MAGIC:
        raise ValueError(f"bad chunk magic {magic:#x}")
    return index, offset, view[_CHUNK_HDR.size :]


class ChunkAssembler:
    """Assemble chunk frames into a caller-provided buffer.

    ``bounds`` gives each chunk's [start, end) byte range in the full
    message; frames may arrive in any chunk order and a chunk may span
    several frames, but every frame must land entirely inside its chunk's
    range and never overlap previously received bytes.  ``add`` returns the
    indices of chunks the frame completed, so the consumer can act on each
    chunk (e.g. scatter a layer group) without waiting for the whole
    message; ``complete`` is the end-of-stream truncation check.
    """

    def __init__(self, buffer: memoryview, bounds: List[Tuple[int, int]]) -> None:
        total = len(buffer)
        if bounds and bounds[-1][1] != total:
            raise ValueError(
                f"chunk bounds end at {bounds[-1][1]}, buffer holds {total}"
            )
        self.buffer = buffer
        self.bounds = [(int(s), int(e)) for s, e in bounds]
        # per-chunk merged received intervals (few per chunk: senders emit
        # sequential sub-frames; out-of-order support is per whole chunk)
        self._got: List[List[Tuple[int, int]]] = [[] for _ in bounds]
        self.received_bytes = 0

    def _merge(self, idx: int, start: int, end: int) -> None:
        ivs = self._got[idx]
        for s, e in ivs:
            if start < e and s < end:
                raise ValueError(
                    f"chunk {idx}: bytes [{start},{end}) overlap [{s},{e})"
                )
        ivs.append((start, end))
        ivs.sort()
        merged = [ivs[0]]
        for s, e in ivs[1:]:
            ls, le = merged[-1]
            if s == le:
                merged[-1] = (ls, e)
            else:
                merged.append((s, e))
        self._got[idx] = merged

    def chunk_complete(self, idx: int) -> bool:
        start, end = self.bounds[idx]
        return start == end or self._got[idx] == [(start, end)]

    @property
    def complete(self) -> bool:
        return all(self.chunk_complete(i) for i in range(len(self.bounds)))

    def add(self, frame) -> List[int]:
        """Place one frame; returns chunk indices this frame completed."""
        idx, off, payload = decode_chunk_frame(frame)
        if not 0 <= idx < len(self.bounds):
            raise ValueError(f"chunk index {idx} out of range")
        start, end = self.bounds[idx]
        if off < start or off + len(payload) > end:
            raise ValueError(
                f"chunk {idx}: frame [{off},{off + len(payload)}) outside "
                f"its bounds [{start},{end})"
            )
        was_done = self.chunk_complete(idx)
        self._merge(idx, off, off + len(payload))
        self.buffer[off : off + len(payload)] = payload
        self.received_bytes += len(payload)
        if not was_done and self.chunk_complete(idx):
            return [idx]
        return []


def write_frame(
    writer: asyncio.StreamWriter, header: Dict[str, Any], payload: bytes = b""
) -> None:
    """Write one frame.  ``payload`` may be any bytes-like (memoryview
    included): it is written as its own buffer, so multi-MB uploads aren't
    copied into a concatenated frame first."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if len(hdr) > MAX_FRAME or len(payload) > MAX_FRAME:
        raise ValueError("frame exceeds MAX_FRAME")
    writer.write(_LEN.pack(len(hdr), len(payload)) + hdr)
    if len(payload):
        writer.write(payload)
