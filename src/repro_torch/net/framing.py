"""Length-prefixed binary framing for the wire transport (DESIGN.md §15).

The frontier checkpoint format IS the wire format (DESIGN.md §9/§11):
``wire_encode`` produces a JSON array of ``[seq, stamp, payload]`` records
and that string rides *inside* the frame body — framing wraps the codec, it
never replaces it. A frame is::

    [4-byte big-endian body length] [1-byte kind] [body: UTF-8 JSON object]

The kind byte separates requests from responses so a frame is
self-describing on capture (tcpdump of the smoke lane reads back with a
5-byte header decode). Bodies are one JSON object per frame — request
bodies carry ``{"id", "op", ...}``, response bodies echo the ``id`` (and,
for fetch, the ``op``/``cls``/``shard`` context so a late response can
still be parked safely).

:class:`FrameDecoder` is incremental: feed it arbitrary byte chunks
(truncated frames, many concatenated frames, single bytes) and it yields
exactly the complete frames, in order, holding partial tails until the
rest arrives. ``MAX_FRAME`` bounds a single body so a corrupt length
prefix fails loudly instead of buffering gigabytes.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator, List, Tuple

# frame kinds (the 1-byte tag after the length prefix)
KIND_REQ = 0x01
KIND_RESP = 0x02
_KINDS = (KIND_REQ, KIND_RESP)

_HEADER = struct.Struct(">IB")  # body length, kind
HEADER_SIZE = _HEADER.size

# One frame carries at most one drain batch (k envelopes of JSON-able
# payloads) or one claim/reseat batch; 64 MiB is orders of magnitude above
# any legitimate body and small enough to fail fast on a corrupt prefix.
MAX_FRAME = 64 * 1024 * 1024


class FrameError(ValueError):
    """A malformed frame: bad kind byte, oversized or negative length, or
    a body that is not valid UTF-8 JSON."""


def pack_frame(kind: int, body: dict) -> bytes:
    """One JSON body -> one wire frame (header + UTF-8 JSON bytes)."""
    if kind not in _KINDS:
        raise FrameError(f"unknown frame kind {kind!r}")
    raw = json.dumps(body, separators=(",", ":")).encode("utf-8")
    if len(raw) > MAX_FRAME:
        raise FrameError(f"frame body {len(raw)}B exceeds MAX_FRAME")
    return _HEADER.pack(len(raw), kind) + raw


def unpack_frames(data: bytes) -> List[Tuple[int, dict]]:
    """Decode a byte string that holds exactly N complete frames (test /
    capture helper; the streaming path uses :class:`FrameDecoder`)."""
    dec = FrameDecoder()
    out = list(dec.feed(data))
    if dec.pending:
        raise FrameError(f"{dec.pending}B of trailing partial frame")
    return out


class FrameDecoder:
    """Incremental frame reassembly over an arbitrary chunk stream.

    TCP is a byte stream: one ``recv`` may hold half a frame or fifty.
    ``feed`` buffers the tail across calls and yields each ``(kind, body)``
    as soon as its last byte arrives — byte-chunking is invisible above
    this layer (property-fuzzed in tests/test_net.py / test_wire_props.py).
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def pending(self) -> int:
        """Bytes buffered awaiting the rest of a frame."""
        return len(self._buf)

    def feed(self, chunk: bytes) -> Iterator[Tuple[int, dict]]:
        self._buf.extend(chunk)
        while True:
            if len(self._buf) < HEADER_SIZE:
                return
            length, kind = _HEADER.unpack_from(self._buf)
            if kind not in _KINDS:
                raise FrameError(f"unknown frame kind {kind!r}")
            if length > MAX_FRAME:
                raise FrameError(
                    f"frame length {length}B exceeds MAX_FRAME "
                    f"(corrupt prefix?)")
            end = HEADER_SIZE + length
            if len(self._buf) < end:
                return
            raw = bytes(self._buf[HEADER_SIZE:end])
            del self._buf[:end]
            try:
                body = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise FrameError(f"undecodable frame body: {exc}") from exc
            yield kind, body
