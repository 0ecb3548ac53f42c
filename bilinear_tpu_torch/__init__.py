"""PyTorch/CUDA port of ``bilinear_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names and runs on an NVIDIA GPU (Hopper, ``sm_90a``). Every TPU
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``, with a
plain PyTorch version beside it (``ops/``). Entry points run on the card
unless the caller asks for the CPU (see ``device.resolve_device``).

This package never imports ``jax``, ``flax``, ``optax`` or ``bilinear_tpu``.
"""
