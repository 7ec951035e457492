"""Paged-KV serving on the CMP slot pool: the engine, its KV page pool,
the paged forward and the device admission ring."""
