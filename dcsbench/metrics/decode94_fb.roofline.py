"""decode94_fb.roofline: the 1994+ flat decode (symbol walk, dequant and
mix into frame buffers) as a share of its roofline.

Per sweep of N frames of S streams (chip_smoke.py phase 3's count): each
frame's sid, start bit and mix (4 B each) and 16 band-type bytes read, the
streams' bytes and their 18-byte headers read once, [N, 512] int32 frame
buffers written; ~6 integer operations a decoded symbol (extract, look up,
re-centre, scale, mix multiply-add, shift)."""

from dcsbench.metrics._roofline import share

KERNELS = ("decode94_fb_kernel",)


def work(inputs):
    sweeps = inputs.get("flat94")
    if not sweeps:
        return None
    n_bytes = n_ops = 0
    for w in sweeps:
        N, S = w["frames"], w["streams"]
        n_bytes += N * (4 + 4 + 16 + 4) + w["stream_bytes"] + S * 18 \
            + N * 512 * 4
        n_ops += 6 * w["symbols"]
    return n_bytes, n_ops


def read(ctx):
    return share(ctx, KERNELS, work(ctx.inputs))
