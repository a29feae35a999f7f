"""numpy-only data path of the port (copies of the JAX package's modules)."""
