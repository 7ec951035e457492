"""launches_per_decode_step (count, device trace): kernel launches (the
profiler's cudaLaunchKernel and cuLaunchKernel calls) inside each decode
forward call of the profiled slice (the engine's one call over every lane
a step, in its pb.decode range), averaged; the step's admission, prefills
and bookkeeping are not counted."""


def read(obs):
    p = obs["profile"]
    return p["launches_per_decode_step"] if p else None
