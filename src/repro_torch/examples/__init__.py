"""Entry points of the port that the JAX package keeps under ``examples/``
(``python -m repro_torch.examples.<name>``)."""
