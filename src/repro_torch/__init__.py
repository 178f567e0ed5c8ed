"""PyTorch / CUDA port of the log-domain training system in ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its
layout, so each module's counterpart sits at the same path.  Tensors on a
CUDA card run the hand-written kernels of ``kernels/csrc``; tensors on the
CPU run their plain PyTorch versions, bit-exact to each other.
"""
