"""Visualization: BEV detection canvases and the 3D viewer.

The port's copy of heal_tpu/visualization (numpy on the host; matplotlib
and open3d imported where a picture is drawn), capability parity with
reference ``opencood/visualization`` (simple_vis + the BEV canvas stack):
render point clouds, prediction boxes and GT boxes to a PNG per frame
during inference (tools/inference.py ``--save_vis``).
"""
from .simple_vis import visualize
from .viewer3d import (
    Scene3D,
    color_encoding,
    visualize_inference_sample_dataloader,
    visualize_sequence,
    visualize_single_sample_output_gt,
)

__all__ = [
    "visualize",
    "Scene3D",
    "color_encoding",
    "visualize_single_sample_output_gt",
    "visualize_inference_sample_dataloader",
    "visualize_sequence",
]
