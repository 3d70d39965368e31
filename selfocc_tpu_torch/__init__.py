"""PyTorch/CUDA port of ``selfocc_tpu``.

The package mirrors the JAX package's layout (``geometry/``, ``ops/``,
``models/``, ``utils/``) so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax``/``flax``; configs, the synthetic dataset
and the numpy metric accumulators are shared with ``selfocc_tpu`` as they are
(all three are jax-free).

Hand-written Hopper kernels live in ``csrc/`` and are built on first use by
``_build.py``. Every kernel wrapper takes its plain PyTorch version for CPU
tensors and launches the kernel (or raises) for CUDA tensors.
"""
