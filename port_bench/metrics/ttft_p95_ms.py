"""ttft_p95_ms (ms, host clock, the traced run's window): the 95th
percentile, over every request whose first token fell inside the window,
of first token - submit. It reads every per-layer metric named
after it with a mix's suffix (ttft_p95_ms.chat, ...)."""

from port_bench.tails import percentile


def read(obs):
    return percentile(obs["ttft_ms"], 95)
