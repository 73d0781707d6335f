"""decode93_pcm.roofline: the 1993 family's decode, transform and overlap
resolve in one kernel as a share of its roofline.

Per launch (chip_smoke.py phase 12's count): each bank row's columns read
once (frame word, stream id, kind, widths, bit offsets, chain values,
scale codes: 181 B), the streams' bytes, the per-stream band tables
(512 B), each output frame's rows and mixes, volume shift and id read, 240
int32 PCM words written; ~12 integer operations a 93 band cell (extract,
sign-extend, chain, scale, mix multiply-add), ~16 an OS93a Type-1 input
(extract, pair look-up, two rounded multiply-adds) and ~15,000 a frame for
the transform (seven radix-2 stages of 128 butterflies, the expansion, the
fix-up, the volume shift and 16 blends).

A flat sweep decodes each row once (one voice).  A session batch reads
its bank's rows (C voices a frame); its cells and inputs come from the
checked sessions' traces, scaled to the batch."""

from dcsbench.metrics._roofline import share

KERNELS = ("decode93_pcm_kernel",)


def work(inputs):
    n_bytes = n_ops = 0
    for w in inputs.get("flat93") or []:
        N, S = w["frames"], w["streams"]
        n_bytes += N * 181 + w["stream_bytes"] + S * 512 + N * 4 \
            + N * (4 + 4 + 240 * 4)
        n_ops += 12 * w["cells93"] + 16 * w["inputs93a"] + 15000 * N
    ses = inputs.get("sessions")
    if ses and ses["family"] == "os93":
        F, C = ses["sessions"] * ses["frames"], ses["channels"]
        n_bytes += ses["bank_rows"] * 181 + ses["pool_bytes"] \
            + F * C * 8 + F * (4 + 4 + 240 * 4)
        n_ops += 12 * ses["cells93"] + 16 * ses["inputs93a"] + 15000 * F
    if not n_bytes:
        return None
    return n_bytes, n_ops


def read(ctx):
    return share(ctx, KERNELS, work(ctx.inputs))
