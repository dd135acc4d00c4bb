"""Runnable examples of the port, the twins of the JAX package's
``examples/``: ``python -m stoch_gpmp_tpu_torch.examples.<name> --help``."""
