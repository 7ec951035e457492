"""paged_roofline (%, device trace): the bound of every decode call in the
profiled slice (rooflines/paged.py) over the device time of the paged
attention kernels (paged_mma_kernel + paged_combine_kernel)."""

from port_bench import files, profiled


def read(obs):
    p = obs["profile"]
    if not p:
        return None
    t = profiled.kernel_s(p, "paged_")
    roof = files.load_module("rooflines", "paged")
    b = sum(roof.bound_s(obs["cfg"], s["batch"], s["dec_ctx"])
            for s in obs["slice_steps"] if s["batch"])
    return 100.0 * b / t if t > 0 and b > 0 else None
