"""PyTorch/CUDA port of the CMP serving stack, for NVIDIA Hopper (H100).

Stands beside the JAX package ``repro`` (the reference) and imports nothing
of it: modules that never needed JAX are copied here, the rest are rewritten
in torch, and every Pallas kernel on the serving path is a CUDA kernel under
``repro_torch.kernels`` with its plain PyTorch version beside it.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; on a CPU tensor each kernel wrapper runs its plain version.
"""
