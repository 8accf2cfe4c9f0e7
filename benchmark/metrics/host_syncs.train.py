"""Host syncs a step: the program's ``host_sync.*`` counts, mean over the
device-only profiled steps."""
from benchmark.metrics import program


def read(ctx):
    return program.host_syncs(ctx)
