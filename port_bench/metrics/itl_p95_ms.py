"""itl_p95_ms (ms, host clock, the traced run's window): the 95th
percentile, over every gap between two consecutive tokens of a request both
inside the window, of the gap. A prefill and its step's decode return two
tokens at once: a gap of 0. It reads every
per-layer metric named after it with a mix's suffix (itl_p95_ms.chat, ...)."""

from port_bench.tails import percentile


def read(obs):
    return percentile(obs["itl_ms"], 95)
