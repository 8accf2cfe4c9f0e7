"""Stream time a frame of the decode, the NMS and the copy of the kept
detections to the host: the program's spans ``decode``
(``post_process_single``) and ``to_host`` (``strip_padding``), mean over
the device-only profiled frames."""
from benchmark.metrics import program


def read(ctx):
    return program.span_ms(ctx, lambda name: name in ("decode", "to_host"))
