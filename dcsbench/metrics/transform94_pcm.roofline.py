"""transform94_pcm.roofline: the 1994+ inverse transform, overlap resolve
and extraction to PCM as a share of its roofline.

Per frame (chip_smoke.py phase 3's count): words 0..$101 of its frame
buffer, its volume shift and its stream or session id read, 240 int32 PCM
words written; ~5,900 integer operations (three pre-passes and six radix-2
stages over 64 complex pairs, and 16 overlap blends)."""

from dcsbench.metrics._roofline import share

KERNELS = ("transform94_pcm_kernel",)


def work(inputs):
    frames = sum(w["frames"] for w in inputs.get("flat94") or [])
    ses = inputs.get("sessions")
    if ses and ses["family"] == "os94":
        frames += ses["sessions"] * ses["frames"]
    if not frames:
        return None
    return frames * (258 * 4 + 4 + 4 + 240 * 4), 5900 * frames


def read(ctx):
    return share(ctx, KERNELS, work(ctx.inputs))
