"""gen_tok_s (tokens/s, host clock): every output token produced inside the
window over the window's seconds. A token is produced when the Fabric.step
that made it returns; the window is whole steps."""


def read(obs):
    return obs["tokens"] / obs["window_s"] if obs["window_s"] > 0 else None
