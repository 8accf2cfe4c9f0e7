"""Stream time a step of the optimizer: the program's spans
``train.optimizer`` (the zero gradients' fill, the learning rate and
Adam's step in ``Trainer``), summed, mean over the device-only profiled
steps."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "train.optimizer")
