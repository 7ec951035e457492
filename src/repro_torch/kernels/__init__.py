"""Hand-written CUDA kernels for Hopper, one module each, with the plain
PyTorch version beside every kernel (``ref.py``) and model-layout wrappers
in ``ops.py``. Sources live in ``csrc/``; ``_build.py`` compiles them at
first use."""
