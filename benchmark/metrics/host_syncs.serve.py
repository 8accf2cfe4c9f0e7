"""Host syncs a frame: the program's ``host_sync.*`` counts (pageable
copies in and out, the NMS fixpoint's readbacks), mean over the
device-only profiled frames."""
from benchmark.metrics import program


def read(ctx):
    return program.host_syncs(ctx)
