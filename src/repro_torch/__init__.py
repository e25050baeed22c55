"""PyTorch/CUDA port of the ``repro`` serving stack (dense family).

Imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
