"""heal_tpu_torch — the PyTorch / CUDA port of heal_tpu.

Serves and trains the HEAL Pyramid-collaboration model (m1 PointPillars
agents) on one NVIDIA GPU: pillar encoder -> m1 backbone -> pyramid
fusion with the ego warp -> shrink -> heads -> decode + rotated NMS -> AP
(tools/inference.py), and losses -> Trainer -> optimizer
(tools/train.py).

Layout of the package mirrors ``heal_tpu/`` module for module, so each
counterpart is easy to find. The host side (datasets, anchors, numpy box
utilities, AP) is shared with ``heal_tpu`` and imported, not copied; only
the device side is ported. The two TPU (Pallas) kernels of that path are
hand-written CUDA C++ for sm_90a under ``csrc/``, built at first use by
``kernels/build.py``; kernel 2 also runs its own backward. Each wrapper
keeps a plain PyTorch version beside it, which serves CPU tensors.

This package imports torch and never jax or flax.
"""

__version__ = "0.1.0"
