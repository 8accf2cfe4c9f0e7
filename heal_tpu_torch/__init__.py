"""heal_tpu_torch — the PyTorch / CUDA port of heal_tpu.

Serves and trains the HEAL Pyramid-collaboration model on one NVIDIA
GPU: pillar encoder -> m1 backbone -> pyramid fusion with the ego warp ->
shrink -> heads -> decode + rotated NMS -> AP (tools/inference.py), and
losses -> Trainer -> optimizer (tools/train.py); and HEAL's stages 2 and
3 for new agent types, lidar (m4) and camera (m2, Lift-Splat-Shoot).

Layout of the package mirrors ``heal_tpu/`` module for module, so each
counterpart is easy to find. The numpy host side (configs, the synthetic
dataset and sample assembly, anchors and targets, box utilities, AP) is
the port's own copy of what the slice uses, under the same module names
(``utils/common_np.py`` and ``utils/rotated_iou_np.py`` hold the numpy
halves of ``heal_tpu.utils.common`` and ``rotated_iou``); tests hold its
batches equal to ``heal_tpu``'s. The two TPU (Pallas) kernels of the
path are hand-written CUDA C++ for sm_90a under ``csrc/``, built at first
use by ``kernels/build.py``; kernel 2 also runs its own backward. Each
wrapper keeps a plain PyTorch version beside it, which serves CPU
tensors.

This package imports torch and numpy, and nothing of jax, flax or
``heal_tpu``.
"""

__version__ = "0.1.0"
