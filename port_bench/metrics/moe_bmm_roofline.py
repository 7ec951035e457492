"""moe_bmm_roofline (%, device trace): the bound of the expert products of
every forward call in the profiled slice (rooflines/moe_bmm.py) over the
device time of aten::bmm, which only the MoE block calls on this path."""

from port_bench import files


def read(obs):
    p = obs["profile"]
    if not p or p["bmm_s"] <= 0:
        return None
    roof = files.load_module("rooflines", "moe_bmm")
    b = 0.0
    for s in obs["slice_steps"]:
        b += sum(roof.bound_s(obs["cfg"], n) for n in s["prefill"])
        if s["batch"]:
            b += roof.bound_s(obs["cfg"], s["batch"])
    return 100.0 * b / p["bmm_s"] if b > 0 else None
