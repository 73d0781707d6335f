"""The padded [streams, frames] model of the 1994+ catalog sweep in PyTorch +
CUDA.

Counterpart of ``dcsexplorer_tpu/models/batched.py`` (``stream_decode``,
``batch_decode``, ``SweepInputs``).  S streams of one format family, each
padded to F frames by repeating its last frame (``SweepInputs``), decode to
PCM [S, F, 240] on the flat sweep's kernels, with no kernel of their own:

1. ``decode94_fb`` over every row as one flat compact batch with
   sid = stream.  The kernel derives a row's band_type_prev from the row
   before it in the same stream.  A halo row before each stream's first row
   carries that row's band_type_prev as its band types (its own frame
   buffer is discarded), so a stream may start mid-way: a chunk of frames
   with a carried overlap state (``stream_decode``), or a frame shard
   (``parallel/sweep.py``).
2. A row equal to the row before it in its bits, band types,
   band_type_prev and mix (a pad row) has that row's frame buffer, but the
   kernel would derive another band_type_prev for it: it takes the earlier
   row's frame buffer by a gather of rows (data movement).
3. ``transform94_pcm`` over the S x F rows with sid = stream: each stream
   starts from a zero overlap state (or ``stream_decode``'s overlap0), and
   the carry flows through the pad rows as the reference's
   overlap_resolve_planar_state carries it.

So each stream's rows must be consecutive frames of it, each followed only
by copies of itself: a row that differs from the row before it has that
row's band types as its band_type_prev.  SweepInputs's arrays are so.  On
CUDA tensors the two stages are the hand-written kernels
(``ops/kernels.py``); on CPU tensors, their plain PyTorch versions.  Band
types must fit in uint8, the compact columns' type.
Bit-exact with the JAX reference on every row, pad rows included.

The host-decode hybrid (``hybrid_host_stage``, ``hybrid_batch_device``,
``hybrid_stage_device``) splits the decode the other way: the native host
runtime decodes every stream's symbols (``native.decode_dense_batch``, a
thread pool) into dense [S, F, 256] slot arrays at its own widths (value
and scale int32, frame-buffer index int16, valid uint8), which travel to
the card whole; there one ``dequant_mix_dense`` launch places them into
frame buffers and one ``transform94_pcm`` launch (sid = stream, so each
stream starts from a zero overlap state) makes the PCM.
"""

import functools

import numpy as np
import torch

from .. import native
from ..ops import band_decode as bd
from ..ops import kernels, prescan
from ..ops import transform as tf
from ..refdec import decoder as rd
from .flatsweep import _device, codec_tables, n_steps94, trace_standalone


@functools.lru_cache(maxsize=None)
def _tables(dev):
    """The codec tables on ``dev``, made once a device."""
    return {k: t.to(dev) for k, t in codec_tables().items()}


def check_band_types(band_type, band_type_prev):
    """Raise unless every band type fits in uint8 (numpy or tensors)."""
    for a in (band_type, band_type_prev):
        if a.size if isinstance(a, np.ndarray) else a.numel():
            if int(a.min()) < 0 or int(a.max()) > 255:
                raise ValueError("band types exceed uint8: the padded model "
                                 "runs on the compact columns' kernels")


def padded_pcm(stream_bytes, rel_start, headers, fmt_type, sub_type,
               band_type, band_type_prev, mix, vol_shift, n_steps,
               overlap0=None):
    """The model's three steps on tensors of one device (band types
    already checked): stream_bytes [S, L] bytes (any integer type);
    rel_start, mix, vol_shift [S, F]; headers [S, 16]; band_type(_prev)
    [S, F, 16]; overlap0 [S, 16] or None (zeros).  Returns pcm [S * F,
    240] int32 (u16 storage), and with overlap0 also each stream's last
    tail [S, 16]."""
    S, L = stream_bytes.shape
    F = rel_start.shape[1]
    dev = stream_bytes.device
    tabs = _tables(dev)
    if S * L + 8 >= kernels.MAX_POOL_BYTES:
        raise ValueError(f"{S} streams of {L} bytes: the pool takes fewer "
                         f"than 2^28")
    streams = torch.arange(S, dtype=torch.int32, device=dev)
    pool = torch.cat([stream_bytes.reshape(-1).to(torch.uint8),
                      torch.full((8,), 0xFF, dtype=torch.uint8, device=dev)])
    rs = rel_start.int()
    # decode rows [S, 1 + F]: the halo row, then the stream's rows
    start = torch.cat([rs[:, :1], rs], 1) + (streams * (8 * L))[:, None]
    bt = torch.cat([band_type_prev[:, :1], band_type], 1).to(torch.uint8)
    mix_rows = torch.cat([torch.zeros_like(mix[:, :1]), mix], 1).int()
    per_stream = lambda v: torch.full((S,), v, dtype=torch.uint8, device=dev)
    fb = bd.decode94_fb(pool, streams.repeat_interleave(F + 1),
                        start.reshape(-1), bt.reshape(-1, 16),
                        mix_rows.reshape(-1), headers.to(torch.uint8),
                        per_stream(fmt_type), per_stream(sub_type), n_steps,
                        tabs)
    # each row's frame buffer: that of the last row at or before it that
    # differs from the row before it
    same = ((rs[:, 1:] == rs[:, :-1]) & (mix[:, 1:] == mix[:, :-1])
            & (band_type[:, 1:] == band_type[:, :-1]).all(-1)
            & (band_type_prev[:, 1:] == band_type_prev[:, :-1]).all(-1))
    j = torch.arange(F, device=dev).expand(S, F)
    new = torch.cat([torch.ones_like(same[:, :1]), ~same], 1)
    src = torch.cummax(torch.where(new, j, 0), 1).values + 1 \
        + (F + 1) * streams.long()[:, None]
    return tf.transform94_pcm(fb[src.reshape(-1)],
                              vol_shift.reshape(-1).int(),
                              streams.repeat_interleave(F), tabs, overlap0)


def batch_decode(stream_bytes, rel_start, headers, fmt_type, sub_type,
                 band_type, band_type_prev, mix, vol_shift, n_steps=256):
    """Catalog sweep over a padded stream batch (tensors of one device, as
    SweepInputs.args makes them): stream_bytes [S, L]; rel_start [S, F];
    headers [S, 16]; band_type(_prev) [S, F, 16]; mix/vol_shift [S, F];
    fmt_type/sub_type one format family.  Returns pcm [S, F, 240] int32
    (u16 storage)."""
    check_band_types(band_type, band_type_prev)
    S, F = rel_start.shape
    return padded_pcm(stream_bytes, rel_start, headers, fmt_type, sub_type,
                      band_type, band_type_prev, mix, vol_shift,
                      n_steps).reshape(S, F, 240)


def stream_decode(stream_bytes, rel_start, header, fmt_type, sub_type,
                  band_type, band_type_prev, mix, vol_shift, overlap0,
                  n_steps=256):
    """Decode F consecutive frames of one stream from a carried overlap
    state: stream_bytes [L]; rel_start, mix, vol_shift [F]; header [16];
    band_type(_prev) [F, 16]; overlap0 [16].  Returns (pcm [F, 240],
    the final overlap [16]), int32 (u16 storage)."""
    check_band_types(band_type, band_type_prev)
    ov0 = overlap0.to(stream_bytes.device, torch.int32).reshape(1, 16).clone()
    pcm, last = padded_pcm(
        stream_bytes[None], rel_start[None], header[None], fmt_type,
        sub_type, band_type[None], band_type_prev[None], mix[None],
        vol_shift[None], n_steps, ov0)
    return pcm, last[0]


class SweepInputs:
    """Host-side packing of a set of streams (one 1994+ format family) into
    padded numpy arrays, each padded to the longest stream's frame count by
    repeating its last frame; the same arrays as the reference's
    SweepInputs.  The per-frame mix and volume shift come from the native
    VM trace of standalone playback (FlatSweep's)."""

    def __init__(self, streams, mixing_level=0x64, master_volume=0x67):
        idxs = [prescan.prescan94(s, 0) for s in streams]
        if not idxs or min(i.n_frames for i in idxs) < 1:
            raise ValueError("SweepInputs takes streams of one frame or more")
        if len({(i.fmt_type, i.sub_type) for i in idxs}) != 1:
            raise ValueError("SweepInputs takes streams of one format family")
        S = len(streams)
        F = max(i.n_frames for i in idxs)
        L = max(int(i.end_bit[-1] // 8) + 8 for i in idxs)
        self.n_frames = np.array([i.n_frames for i in idxs], dtype=np.int32)
        sb = np.zeros((S, L), dtype=np.int32)
        rs = np.zeros((S, F), dtype=np.int32)
        hd = np.zeros((S, 16), dtype=np.int32)
        bt = np.zeros((S, F, 16), dtype=np.int32)
        btp = np.zeros((S, F, 16), dtype=np.int32)
        mix = np.zeros((S, F), dtype=np.int32)
        vol = np.zeros((S, F), dtype=np.int32)
        for k, (s, i) in enumerate(zip(streams, idxs)):
            b = np.frombuffer(bytes(s) + b"\xff" * (L - min(L, len(s))),
                              dtype=np.uint8)[:L]
            sb[k, :b.size] = b
            n = i.n_frames
            m, v = trace_standalone(s, n, rd.OS94, mixing_level,
                                    master_volume)
            hd[k] = i.header
            # pad rows repeat the last frame
            for out, col in ((rs, i.start_bit), (bt, i.band_type),
                             (btp, i.band_type_prev), (mix, m), (vol, v)):
                out[k, :n] = col
                out[k, n:] = out[k, n - 1]
        self.fmt_type = int(idxs[0].fmt_type)
        self.sub_type = int(idxs[0].sub_type)
        self.n_steps = n_steps94(idxs)
        self.stream_bytes = sb
        self.rel_start = rs
        self.headers = hd
        self.band_type = bt
        self.band_type_prev = btp
        self.mix = mix
        self.vol_shift = vol

    def args(self, device="cuda"):
        """batch_decode's arguments, the arrays as tensors on ``device``
        (the card unless given)."""
        dev = _device(device)
        t = lambda a: torch.tensor(a, device=dev)
        return (t(self.stream_bytes), t(self.rel_start), t(self.headers),
                self.fmt_type, self.sub_type, t(self.band_type),
                t(self.band_type_prev), t(self.mix), t(self.vol_shift),
                self.n_steps)


# ----------------------------------------------------------------------
# The host-decode hybrid: native host symbol decode + device numerics

def pack_dense(results):
    """NativeDecode results -> (dense, scale, fb_idx, valid) [S, F, 256]
    numpy at the native decoder's widths (int32, int32, int16, uint8),
    each stream padded to the longest with zeros (valid 0), and the frame
    counts (a list)."""
    S = len(results)
    F = max(r.n_frames for r in results)
    dense = np.zeros((S, F, 256), dtype=np.int32)
    scale = np.zeros((S, F, 256), dtype=np.int32)
    fb_idx = np.zeros((S, F, 256), dtype=np.int16)
    valid = np.zeros((S, F, 256), dtype=np.uint8)
    for k, r in enumerate(results):
        n = r.n_frames
        dense[k, :n] = r.dense
        scale[k, :n] = r.scale
        fb_idx[k, :n] = r.fb_idx
        valid[k, :n] = r.valid
    return dense, scale, fb_idx, valid, [r.n_frames for r in results]


def hybrid_host_stage(streams):
    """The hybrid's host half for a batch of 1994+ streams: the native
    dense decode on a thread pool, packed by pack_dense.  Returns (dense,
    scale, fb_idx, valid, n_frames)."""
    return pack_dense(native.decode_dense_batch(streams))


def upload(a, dev):
    """A numpy array -> a tensor on ``dev``: on the card through pinned
    memory, enqueued without blocking the host (uint16 widens to int32, as
    packed_to_device widens it)."""
    a = np.asarray(a)
    t = torch.from_numpy(np.require(
        a.astype(np.int32) if a.dtype == np.uint16 else a,
        requirements=("C", "W")))
    return t.pin_memory().to(dev, non_blocking=True) \
        if dev.type == "cuda" else t


def hybrid_batch_device(dense, scale, fb_idx, valid, mix, vol_shift,
                        device="cuda"):
    """The hybrid's device stage over a stream batch: dense, scale, fb_idx,
    valid [S, F, 256] (hybrid_host_stage's), mix and vol_shift [S, F].
    One dequant_mix_dense over the S x F rows, then one transform94_pcm
    with sid = stream, each stream from a zero overlap state.  Tensors
    stay on their device (one for all); numpy arrays go to ``device``
    (the card unless given).  On CPU tensors the plain versions run.
    Returns pcm [S, F, 240] int32 (u16 storage)."""
    args = (dense, scale, fb_idx, valid, mix, vol_shift)
    on_dev = [a.device for a in args if isinstance(a, torch.Tensor)]
    dev = on_dev[0] if on_dev else _device(device)
    dense, scale, fb_idx, valid, mix, vol_shift = (
        a if isinstance(a, torch.Tensor) else upload(a, dev) for a in args)
    S, F = mix.shape
    fb = bd.dequant_mix_dense(
        dense.reshape(S * F, 256),
        (scale.reshape(S * F, 256), fb_idx.reshape(S * F, 256),
         valid.reshape(S * F, 256)), mix.reshape(S * F).int())
    sid = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(F)
    pcm = tf.transform94_pcm(fb, vol_shift.reshape(S * F).int(), sid,
                             _tables(dev))
    return pcm.reshape(S, F, 240)


def hybrid_stage_device(dense, scale, fb_idx, valid, mix, vol_shift,
                        device="cuda"):
    """The hybrid's device stage for one stream: dense, scale, fb_idx,
    valid [F, 256], mix and vol_shift [F] -> pcm [F, 240] int32 (u16
    storage), from a zero overlap state (hybrid_batch_device of one)."""
    return hybrid_batch_device(*(a[None] for a in (
        dense, scale, fb_idx, valid, mix, vol_shift)), device)[0]
