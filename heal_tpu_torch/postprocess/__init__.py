"""Post-processing: anchors and targets (host side, numpy), decode +
rotated NMS (torch)."""
