"""Checkpoints in the JAX package's on-disk format (see
:mod:`repro_torch.checkpoint.checkpointer`)."""
