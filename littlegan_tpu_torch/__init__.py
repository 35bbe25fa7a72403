"""LittleGAN in PyTorch for one NVIDIA H100: the port of ``littlegan_tpu``.

The JAX package stays the reference; this package imports neither it nor
JAX. Plain tensor code is PyTorch, and the JAX package's Pallas kernels on
the serving path are CUDA kernels written by hand for Hopper
(``csrc/``, wrapped in ``ops/cuda/``). Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
