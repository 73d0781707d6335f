"""segments94.roofline: the session wire's expansion (per-lane segments to
dense rows, mixes and volume shifts) as a share of its roofline.

Per batch of F = sessions x frames output frames over C voices
(chip_smoke.py phase 8's count): the wire read once, rows and mixes
[F, C] (8 B a voice) and the volume column [F] (4 B) written; a compare
and a multiply-add an output (3 operations a voice and frame)."""

from dcsbench.metrics._roofline import share

KERNELS = ("segments94_kernel",)


def work(inputs):
    ses = inputs.get("sessions")
    if not ses:
        return None
    F, C = ses["sessions"] * ses["frames"], ses["channels"]
    return ses["wire_bytes"] + F * C * 8 + F * 4, F * C * 3


def read(ctx):
    return share(ctx, KERNELS, work(ctx.inputs))
