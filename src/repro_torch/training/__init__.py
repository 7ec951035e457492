"""Training in torch: AdamW (``optimizer``) and the fault-tolerant loop
(``train_loop``), twins of the JAX package's ``repro.training`` modules."""
