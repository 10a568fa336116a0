"""lako_tpu_torch — the PyTorch + CUDA port of lako_tpu for NVIDIA Hopper (H100).

The package mirrors ``lako_tpu``'s layout and names module for module, so each
part's JAX counterpart is at the same path under ``lako_tpu/``. It imports
``torch`` and never ``jax``, ``flax`` or ``lako_tpu``: the framework-free
modules it needs (config, tokenizer, dataset, collator) are carried as copies
that tests pin to their originals.

Every Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``). On CPU tensors
each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
