"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W), and the roofline bound."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound_s(bytes_moved: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> float:
    """The least time the chip could take: the longer of the bytes at HBM
    bandwidth and the operations at ``flop_rate``."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / flop_rate)
