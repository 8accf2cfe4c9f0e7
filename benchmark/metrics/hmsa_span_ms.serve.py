"""Stream time a frame of V2X-ViT's agent attention: the program's spans
``v2xvit.hmsa`` (each depth layer's pre-norm HMSA and its residual,
``models/fuse/v2xvit.V2XViTBlock``), summed over the layers, mean over
the device-only profiled frames."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "v2xvit.hmsa")
