"""Stream time a frame of the inputs' transfer: the program's span
``serve.inputs`` (``tools/inference.frame_inputs``, the pageable copies
of the frame's arrays), mean over the device-only profiled frames."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "serve.inputs")
