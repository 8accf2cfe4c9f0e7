"""Stream time a step of the train-mode forward and loss: the program's
span ``train.forward`` (``Trainer.gradients``), mean over the
device-only profiled steps."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name == "train.forward")
