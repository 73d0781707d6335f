"""enqueue_ms: the mean host milliseconds to enqueue one job, with no
synchronise, from the ``dcsbench.enqueue`` span the harness records around
the program's entry call (``FlatPipeline.forward``, the two
``Flat93Pipeline.forward`` calls, or the wire's upload and
``SessionServer.decode_wire``).  It moves audio_xrt once it passes the
card's time a job."""

SPAN = "dcsbench.enqueue"


def read(ctx):
    hit = ctx.summary["spans"].get(SPAN)
    if not hit or not hit[0]:
        return None
    count, seconds = hit
    return 1e3 * seconds / count
