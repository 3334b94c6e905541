"""dynamo_tpu_torch — the PyTorch/CUDA port of ``dynamo_tpu``.

The JAX package beside it stays the reference: each module here has a
counterpart at the same path under ``dynamo_tpu/``, and the tests in
``tests/test_torch_*.py`` hold them against each other on the same inputs.
This package imports ``torch`` and never ``jax``, and nothing of
``dynamo_tpu``: what it needs from there it keeps as its own copy.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.
On a CUDA tensor, every kernel wrapper launches its hand-written kernel
(``csrc/``); only a tensor on the CPU takes the kernel's plain version.
"""

__version__ = "0.1.0"
