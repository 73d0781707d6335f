"""torch_ops_ms: the device milliseconds a job of the kernels, copies and
memsets that the program launches around its hand-written kernels (casts,
concatenations): the ops whose launch has a program span (``dcs.*``)
innermost, other than a ``dcs.kernel.*`` span and ``dcs.session.reduce``
(the digest's), found by correlation id (``_attribution``).  It moves
audio_xrt by the card time the program's PyTorch glue takes from a job.
Reads nothing until the trace's summary carries ``_attribution.KEYS``."""

from dcsbench.metrics import _attribution


def read(ctx):
    split = _attribution.device_split(ctx.summary)
    if split is None or not ctx.jobs:
        return None
    return 1e3 * split["torch_ops"] / ctx.jobs
