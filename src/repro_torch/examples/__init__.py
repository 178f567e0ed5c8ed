"""The twins of the JAX package's ``examples/`` scripts, run as modules:
``python -m repro_torch.examples.<name> [--device cpu]``.  Each has
``main(argv=None)``, the reference's flags and defaults, and ``--device``
(default ``cuda``).  ``torch.autograd`` stands where the reference takes
``jax.grad``, gloo or NCCL ranks where it emulates host devices."""
