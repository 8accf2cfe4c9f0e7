"""Stream time a step of the backward: the program's span
``train.backward`` (``loss.backward()`` in ``Trainer.gradients``), mean
over the device-only profiled steps."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "train.backward")
