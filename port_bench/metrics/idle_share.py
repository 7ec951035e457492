"""idle_share (%, device trace): 1 - the union of device operations'
intervals over the profiled slice."""


def read(obs):
    p = obs["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["slice_s"]) if p else None
