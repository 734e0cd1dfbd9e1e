"""blasr_tpu_torch: the PyTorch/CUDA port of blasr_tpu for NVIDIA Hopper.

The package mirrors ``blasr_tpu``'s layout (``kernels/``, ``pipeline/``,
``io/``, ``dist/``, ``cli/``) so each module's counterpart is easy to find.
It imports ``torch`` and never ``jax``; the JAX-free ``blasr_tpu`` modules
(readers, index build, params, sim, native) are reused as they are.

Every function takes or returns tensors on an explicit ``device``.  The
hand-written CUDA kernels (``csrc/``) run on CUDA tensors; on CPU tensors
the same entry points run their plain PyTorch versions.
"""
