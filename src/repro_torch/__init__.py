"""PyTorch/CUDA port of the ``repro`` package (densifying assumed-sparse
tensors, arXiv:1905.04035), targeting an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor of JAX) and mirrors its layout module for module
(``repro_torch.core.exchange`` <-> ``repro.core.exchange``).  Kernels that
the reference wrote in Pallas are hand-written CUDA here
(``repro_torch/csrc``), built at first use.
"""
