"""program_idle_ms: the milliseconds a job that the card sits idle between
the traced window's first and last device op, in stretches whose larger
part a program span (``dcs.*``) holds as the innermost span
(``_attribution``); the window's leading and trailing stretches, the loop's
start and drain, are left out.  It moves audio_xrt by the card time the
program's host code leaves unused.  Reads nothing until the trace's summary
carries ``_attribution.KEYS``."""

from dcsbench.metrics import _attribution


def read(ctx):
    seconds = _attribution.program_idle_seconds(ctx.summary)
    if seconds is None or not ctx.jobs:
        return None
    return 1e3 * seconds / ctx.jobs
