"""Stream time a frame of V2X-ViT's multi-scale window attention: the
program's spans ``v2xvit.mswin`` (each depth layer's pre-norm MSwin,
its three window branches, the split attention and the residual,
``models/fuse/v2xvit.V2XViTBlock``), summed over the layers, mean over
the device-only profiled frames."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "v2xvit.mswin")
