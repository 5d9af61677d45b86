"""MISO in PyTorch for an NVIDIA H100: a port of the JAX package ``repro``.

``repro_torch.api`` is the front door (``compile``, ``serve``).  The
package imports ``torch`` and never ``jax`` or ``repro``; the JAX package
stays the reference the tests hold this one against.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
