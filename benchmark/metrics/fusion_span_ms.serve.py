"""Stream time a frame of Pyramid Fusion: the program's span ``fusion``
(``PyramidFusion.forward_collab``), mean over the device-only profiled
frames."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "fusion")
