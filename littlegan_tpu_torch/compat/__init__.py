"""Interoperability with the JAX package's parameter sets."""
