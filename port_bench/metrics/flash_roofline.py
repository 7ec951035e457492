"""flash_roofline (%, device trace): the bound of every prefill in the
profiled slice (rooflines/flash.py) over flash_bf16_kernel's device time."""

from port_bench import files, profiled


def read(obs):
    p = obs["profile"]
    if not p:
        return None
    t = profiled.kernel_s(p, "flash_bf16_kernel")
    roof = files.load_module("rooflines", "flash")
    b = sum(roof.bound_s(obs["cfg"], n) for s in obs["slice_steps"] for n in s["prefill"])
    return 100.0 * b / t if t > 0 and b > 0 else None
