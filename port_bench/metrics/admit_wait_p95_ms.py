"""admit_wait_p95_ms (ms, host clock): the 95th percentile, over the
requests whose first token fell inside the window, of submit -> the start
of the Fabric.step that returned that token: the time spent in the class
queue and the admission ring before a lane took the request."""

from port_bench.tails import percentile


def read(obs):
    return percentile(obs["admit_wait_ms"], 95)
