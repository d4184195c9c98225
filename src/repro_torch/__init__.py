"""PyTorch/CUDA port of the EdgeRAG stack (``repro`` is the JAX reference).

It imports ``torch`` and never ``jax`` or any module of ``repro``.  Entry
points run on the card (``cuda``) unless the caller passes ``device="cpu"``,
and raise without a card otherwise.
"""
