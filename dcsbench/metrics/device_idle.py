"""device_idle: the share of the traced sub-window, in %, in which no
kernel, copy or memset ran on the card (1 - busy / window)."""


def read(ctx):
    s = ctx.summary
    if not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
