"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
the twins of the JAX package's ``examples/``."""
