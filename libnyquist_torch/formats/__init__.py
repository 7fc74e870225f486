"""Container and codec host code of the port (JAX-free copies)."""
