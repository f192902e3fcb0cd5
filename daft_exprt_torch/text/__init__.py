"""Symbol table (copy of the JAX package's)."""
