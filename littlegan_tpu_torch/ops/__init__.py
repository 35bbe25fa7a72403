"""Tensor ops in the JAX package's layouts (NHWC, HWIO)."""
