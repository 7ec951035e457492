"""serve_mfu (%, host clock): the model FLOPs of every prompt and output
token the window processed (model_flops.py) over window seconds x the
H100's bf16 peak."""

from port_bench import model_flops, peaks


def read(obs):
    flops = sum(model_flops.step_flops(obs["cfg"], s) for s in obs["steps"])
    return 100.0 * flops / (obs["window_s"] * peaks.BF16_FLOP_PER_S)
