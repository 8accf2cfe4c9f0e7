"""Stream time a frame of every agent type's encoder: the program's spans
``encoder.<mX>`` (``ModalityBranch.forward``: PointPillars with kernel
1, SECOND, Lift-Splat-Shoot), summed over the types, mean over the
device-only profiled frames."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name.startswith("encoder."))
