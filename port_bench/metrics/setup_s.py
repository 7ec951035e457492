"""setup_s (s, host clock): process start to the window's start: CUDA
context, the kernel library, the weights made on the device, the fabric,
and the ramp until every client's first request has its lane and first
token."""


def read(obs):
    return obs["setup_s"]
