"""Post-processing: decode + rotated NMS (torch).

Anchors and targets are host-side numpy and come from
``heal_tpu.postprocess.anchors`` / ``targets``, shared with the JAX package.
"""
