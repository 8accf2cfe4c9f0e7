"""Host time a frame of the decode and NMS (``post_process_single``, its
host loop) and the copy of the kept boxes to the host, after the
forward has finished on the card, mean over the window."""


def read(ctx):
    return (ctx.get("stages_ms") or {}).get("decode_nms")
