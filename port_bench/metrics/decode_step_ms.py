"""decode_step_ms (ms, host clock): the mean wall time of the window's
Fabric.step calls that ran a decode and no prefill."""


def read(obs):
    d = [(s["te"] - s["ts"]) * 1e3 for s in obs["steps"] if s["batch"] and not s["prefill"]]
    return sum(d) / len(d) if d else None
