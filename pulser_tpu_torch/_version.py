"""Package version: the JAX package's, whose wire formats this package writes."""

__version__ = "0.1.0"
