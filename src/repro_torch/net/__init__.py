"""Real multi-process wire transport for the seat protocol (DESIGN.md §15).

``framing`` — length-prefixed binary frames wrapping the ``wire_encode``
JSON codec; ``server`` — the per-host worker process (authoritative shard
queues + seat table); ``wire`` — the driver-side :class:`WireTransport`
with batched claim frames, fetch pipelining and prefetch credit.
"""

from repro_torch.net.framing import (FrameDecoder, FrameError, KIND_REQ,
                               KIND_RESP, MAX_FRAME, pack_frame,
                               unpack_frames)
from repro_torch.net.server import HostServer, HostWorker, worker_main
from repro_torch.net.wire import PeerClient, ShardProxy, WireError, WireTransport

__all__ = [
    "FrameDecoder", "FrameError", "KIND_REQ", "KIND_RESP", "MAX_FRAME",
    "pack_frame", "unpack_frames", "HostServer", "HostWorker",
    "worker_main", "PeerClient", "ShardProxy", "WireError", "WireTransport",
]
