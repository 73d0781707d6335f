"""session_mix94.roofline: the session mixer (up to 8 bank rows a frame at
their mixing multipliers into a frame buffer) as a share of its roofline.

Per batch of F = sessions x frames output frames over C voices and a bank
of R rows (chip_smoke.py phase 8's count): each frame's rows and mixes
(8 B a voice) read, the bank's [R, 256] int16 rows read once, [F, 512]
int32 frame buffers written; ~3 integer operations a position and voice
(multiply-add, shift)."""

from dcsbench.metrics._roofline import share

KERNELS = ("session_mix94_kernel",)


def work(inputs):
    ses = inputs.get("sessions")
    if not ses or ses["family"] != "os94":
        return None
    F, C = ses["sessions"] * ses["frames"], ses["channels"]
    return (F * C * 8 + ses["bank_rows"] * 256 * 2 + F * 512 * 4,
            3 * 256 * C * F)


def read(ctx):
    return share(ctx, KERNELS, work(ctx.inputs))
