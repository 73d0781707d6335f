"""entry_ms: the mean host milliseconds a job spends inside the program's
entry spans, ``dcs.flat94`` (``FlatPipeline.forward``), ``dcs.flat93``
(``Flat93Pipeline.forward``, two a job in os93.catalog) and ``dcs.session``
(``SessionServer.decode_wire``), summed over a job's calls: enqueue_ms
measured inside the program, without the harness's wire upload.  It moves
audio_xrt once it passes the card's time a job."""

SPANS = ("dcs.flat94", "dcs.flat93", "dcs.session")


def read(ctx):
    hits = [ctx.summary["spans"][n] for n in SPANS
            if n in ctx.summary["spans"]]
    if not hits or not ctx.jobs:
        return None
    return 1e3 * sum(seconds for _, seconds in hits) / ctx.jobs
