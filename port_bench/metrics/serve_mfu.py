"""serve_mfu (%, host clock): the model FLOPs of every prompt and output
token the window processed (``model_flops.window_flops``, by the cell's
family) over window seconds x the H100's bf16 peak."""

from port_bench import model_flops, peaks


def read(obs):
    return 100.0 * model_flops.window_flops(obs) / (obs["window_s"] * peaks.BF16_FLOP_PER_S)
