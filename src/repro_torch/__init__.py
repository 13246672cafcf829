"""PyTorch/CUDA port of the Warp-Cortex system (the JAX package ``repro``
is the reference it is held against).

The port imports ``torch`` and numpy only: never ``jax``, never ``repro``.
Its entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""
