"""Cross-chip transport model (a copy of the JAX package's ``comm``)."""
