"""The host data pipeline (``pipeline``): producer threads feed a CMP queue
of training batches; a verbatim copy of the JAX package's, which never
needed JAX."""
