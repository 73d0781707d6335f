"""Flat-frame catalog sweep (1994+ family) in PyTorch + CUDA.

Counterpart of ``dcsexplorer_tpu/models/flatsweep.py``.  All frames of all
streams of a catalog share ONE flat frame axis: the stream bitstreams
concatenate into a byte pool with global per-frame bit offsets, format
type/subtype are per-frame data, and the overlap carry resets at each
stream's first frame.  The sweep runs

    host:   native prescan94 + native VM trace -> FlatSweep.pack()
    device: decode94_fb (band controls, symbol decode, dequant/mix)
            -> transform94_pcm (inverse transform, overlap resolve) -> PCM

with the device part as ``FlatPipeline`` (an ``nn.Module`` whose buffers are
the codec's constant tables).  On CUDA tensors the decode and the
transform-to-PCM run as two hand-written kernels (``ops/kernels.py``), and
no plain-torch stage of any size runs; on CPU tensors their plain
PyTorch versions run.  The host part is the port's own native runtime
(``native/``, ``ops/prescan.py``, ``vm/native_tracer.py``).  The entry
points run on the card unless the caller names another device.  Bit-exact
with the JAX reference.
"""

import numpy as np
import torch
from torch import nn

from ..format import tables as T
from ..ops import band_decode as bd
from ..ops import prescan
from ..ops import transform as tf
from ..refdec import decoder as rd
from ..utils.profiling import span
from ..vm import native_tracer as nt

SAMPLE_RATE = 31250
MIXING_LEVEL = 0x64
MASTER_VOLUME = 0x67


def codec_tables():
    """The codec's constant tables as int32 CPU tensors, derived from
    ``format/tables.py`` exactly as the reference derives them
    (band_decode.py:33-78, transform.py:23-55, 240-252).  The system has no
    learned weights: these are FlatPipeline's buffers."""
    cb_sizes = [4, 8, 32, 128, 256, 512]
    cb_base = np.zeros(7, np.int64)
    for i in range(2, 7):
        cb_base[i] = cb_base[i - 1] + cb_sizes[i - 2]
    band_group = np.array([0] * 3 + [1] * 3 + [2] * 10)
    xlat = [np.asarray(t) for t in (T.XLAT02, T.XLAT35, T.XLAT6F)]

    br = np.asarray(T.BITREV9, np.int64)
    ifft = np.asarray(T.IFFT_COEFF, np.int64)
    ovl = np.asarray(T.OVERLAP_COEFF, np.int64)
    # output k of 240 (and of the 16 overlap words) lives at storage word
    # br[2*(k//2)] + k%2; the planar index of that pair is br[..] >> 1
    ext_half = br[0:240:2] >> 1
    save_half = br[240:256:2] >> 1
    ovl_half = br[0:16:2] >> 1

    tabs = {
        "cb_flat": np.concatenate([np.asarray(T.CODEBOOKS[i])
                                   for i in range(1, 7)]),
        "maxw": np.asarray(T.MAX_BIT_WIDTH),
        "cb_base": cb_base,
        "xt_by_band": np.stack([x[:, 0] for x in xlat])[band_group],
        "xa_by_band": np.stack([x[:, 1] for x in xlat])[band_group],
        "preadj": np.stack([np.asarray(T.PREADJ0), np.asarray(T.PREADJ3)]),
        "out_count": np.asarray(T.BAND_OUTPUT_COUNT),
        "scale_mant": np.asarray(T.SCALE_MANTISSA),
        "p2_c0": ifft[br[2 + 4 * np.arange(64)]],
        "p2_c1": ifft[br[4 * np.arange(64)]],
        "sin": ifft[:128],
        "cos": ifft[128:],
        "ovl_new": ovl,
        "ovl_old": ovl[::-1],
        "ext_half": ext_half,
        "ovl_half": ovl_half,
        "save_half": save_half,
    }
    return {k: torch.tensor(np.ascontiguousarray(v).astype(np.int32))
            for k, v in tabs.items()}


def _device(device):
    """The device of an entry point.  Without a card, a CUDA device raises;
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev


def flat_pipeline(pool_u8, start_bit, header, fmt_type, sub_type, band_type,
                  band_type_prev, mix, vol_shift, stream_start, n_steps, tabs):
    """Full flat decode from the wide per-frame arrays (FlatSweep.args()):
    the plain path that mirrors the JAX flat_pipeline, band and slot
    controls -> symbols -> dequant -> transform -> overlap resolve.  The
    wide columns have no kernel, so CUDA tensors raise: FlatPipeline runs
    the compact columns through the kernels.
    Returns pcm [N, 240] int32 u16 storage."""
    if pool_u8.device.type != "cpu":
        raise ValueError("the wide columns have no CUDA kernel: run "
                         "FlatPipeline on compact_host_arrays()")
    ctl = bd.band_controls_dyn(header, fmt_type, sub_type, band_type,
                               band_type_prev, tabs)
    packed, scale, total = bd.slot_controls(ctl, tabs)
    vals = bd.decode94_symbols_plain(pool_u8, start_bit, packed, n_steps,
                                     tabs["cb_flat"])
    fb = bd.dequant_mix_plain(vals, (scale, total), mix)
    re, im = tf.transform94_planar_plain(fb, vol_shift, tabs)
    return tf.overlap_resolve_planar(re, im, stream_start, tabs)


def flat_pipeline_packed(pool_u8, sid, start_bit, bt_u8, mix_u16, vol_u8,
                         hdr_tab, fmt_tab, sub_tab, n_steps, tabs):
    """The flat sweep from the transfer-compact columns
    (FlatSweep.compact_host_arrays via packed_to_device): the stream header
    travels once per stream (hdr_tab [S, 16] + sid [N]); band_type_prev and
    stream starts derive from sid.  Returns pcm [N, 240] int32 u16
    storage."""
    fb = bd.decode94_fb(pool_u8, sid, start_bit.int(), bt_u8, mix_u16.int(),
                        hdr_tab, fmt_tab, sub_tab, n_steps, tabs)
    return tf.transform94_pcm(fb, vol_u8.int(), sid, tabs)


class FlatPipeline(nn.Module):
    """The device half of the flat sweep; ``forward`` is
    flat_pipeline_packed over the tensors of packed_to_device.  The codec
    tables are buffers, made on ``device`` (the card unless given) and
    moved by ``.to(device)``."""

    def __init__(self, device=None):
        super().__init__()
        dev = _device("cuda" if device is None else device)
        for name, t in codec_tables().items():
            self.register_buffer(name, t.to(dev))

    def forward(self, pool_u8, sid, start_bit, bt_u8, mix_u16, vol_u8,
                hdr_tab, fmt_tab, sub_tab, n_steps):
        with span("dcs.flat94"):
            return flat_pipeline_packed(pool_u8, sid, start_bit, bt_u8,
                                        mix_u16, vol_u8, hdr_tab, fmt_tab,
                                        sub_tab, n_steps,
                                        dict(self.named_buffers()))


def packed_to_device(arrays, device="cuda"):
    """FlatSweep.compact_host_arrays() (numpy) -> FlatPipeline keyword
    arguments on ``device`` (the card by default).  uint16 columns widen to
    int32 (torch has few uint16 ops); uint8 columns stay uint8; n_steps
    stays an int."""
    device = _device(device)
    out = {}
    for k, v in arrays.items():
        if k == "n_steps":
            out[k] = int(v)
            continue
        a = np.asarray(v)
        if a.dtype == np.uint16:
            a = a.astype(np.int32)
        out[k] = torch.tensor(a, device=device)
    return out


def to_int16(pcm):
    """u16-storage PCM tensor -> flat int16 numpy samples."""
    pcm = pcm.cpu().numpy().astype(np.int64)
    return (((pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16).reshape(-1)


def trace_standalone(stream, n_frames, os_version, mixing_level,
                     master_volume):
    """Per-frame (mix multiplier, volume shift) of channel 0 for standalone
    playback of ``stream`` under ``os_version``, from the native runtime
    VM."""
    tr = nt.NativeControlTracer(stream, default_volume=master_volume,
                                standalone_os=os_version)
    try:
        tr.soft_boot()
        tr.load_audio_stream(0, 0, mixing_level=mixing_level)
        _, _, out_m, out_v = tr.trace_frames(n_frames)
    finally:
        tr.close()
    return out_m[:, 0].astype(np.int32), out_v.astype(np.int32)


def reference_pcm(stream, n_frames, os_version=rd.OS94,
                  mixing_level=MIXING_LEVEL, master_volume=MASTER_VOLUME):
    """int16 PCM of one stream from the scalar reference decoder, played
    standalone under ``os_version`` as trace_standalone traces it."""
    dec = rd.ReferenceDecoder()
    dec.default_volume = master_volume
    dec.init_standalone(os_version)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(stream), mixing_level=mixing_level)
    return np.array(dec.next_samples(n_frames * 240), dtype=np.int16)


def n_steps94(idxs):
    """The symbol steps a 1994+ decode takes over streams of these
    prescan94 indexes: the most any frame's scan needs (scan_totals),
    rounded up to 8, at most 256; 8 where no stream has a frame."""
    tops = [int(prescan.scan_totals(i).max()) for i in idxs if i.n_frames]
    return min(256, (max(tops) + 7) & ~7) if tops else 8


def decode_columns94(streams, idxs, origins=None):
    """The compact decode columns of 1994+ streams (numpy), the format
    decode94_fb and decode94_bank read.  ``idxs[k]`` is prescan94's index
    of the stream that starts at byte ``origins[k]`` of ``streams[k]`` (0
    unless given).  Each stream's body, from its origin to 8 bytes past its
    last frame's end bit (to the buffer's end where it has no frames),
    enters one byte pool followed by 8 $FF bytes, and 8 more close the
    pool.  Returns pool_u8, sid [N] (each frame's stream), start_bit [N]
    int32 (bit offsets in the pool), bt [N, 16] int32 (band types at full
    width: a type-1 stream's may pass 255), hdr_tab [S, 16], fmt_tab and
    sub_tab [S] uint8, and n_steps (n_steps94)."""
    origins = [0] * len(idxs) if origins is None else origins
    bufs, start = [], []
    pos = 0
    for s, i, o in zip(streams, idxs, origins):
        end = int(i.end_bit[-1] // 8) + 8 if i.n_frames else len(s)
        body = bytes(s[o:end])              # may clamp short of `end`
        start.append((pos - o) * 8 + np.asarray(i.start_bit, np.int64))
        bufs += [body, b"\xff" * 8]
        pos += len(body) + 8
    bufs.append(b"\xff" * 8)
    bt = [np.asarray(i.band_type, np.int32).reshape(-1, 16) for i in idxs]
    return dict(
        pool_u8=np.frombuffer(b"".join(bufs), dtype=np.uint8),
        sid=np.repeat(np.arange(len(idxs)), [i.n_frames for i in idxs]),
        start_bit=(np.concatenate(start) if idxs
                   else np.zeros(0)).astype(np.int32),
        bt=np.concatenate(bt) if idxs else np.zeros((0, 16), np.int32),
        hdr_tab=np.asarray([i.header for i in idxs], np.int64)
        .reshape(-1, 16).astype(np.uint8),
        fmt_tab=np.asarray([i.fmt_type for i in idxs], np.uint8),
        sub_tab=np.asarray([i.sub_type for i in idxs], np.uint8),
        n_steps=n_steps94(idxs))


def narrow_band_types(bt):
    """Full-width band types -> the compact columns' uint8; raises where
    one does not fit."""
    if bt.size and (bt.min() < 0 or bt.max() > 255):
        raise ValueError("band types exceed uint8: use the wide args()")
    return bt.astype(np.uint8)


class FlatSweep:
    """Host-side packing of a whole catalog for the flat pipeline.

    Per catalog entry the host runs the native stream indexer (frame
    boundaries, band-type chains) and the native runtime VM trace (mixing
    multipliers, volume shifts); decode_columns94 lays out the catalog's
    decode columns.  Same columns as the reference's FlatSweep, as numpy
    arrays."""

    def __init__(self, streams, mixing_level=MIXING_LEVEL,
                 master_volume=MASTER_VOLUME):
        idxs = [prescan.prescan94(s, 0) for s in streams]
        self._cols = decode_columns94(streams, idxs)
        self.pool_u8 = self._cols["pool_u8"]
        self._btp = [np.asarray(i.band_type_prev, np.int32) for i in idxs]
        traces = [trace_standalone(s, i.n_frames, rd.OS94, mixing_level,
                                   master_volume)
                  for s, i in zip(streams, idxs)]
        self._mix = [m for m, _ in traces]
        self._vol = [v for _, v in traces]
        self.n_frames_total = int(sum(i.n_frames for i in idxs))
        self.audio_samples = self.n_frames_total * 240

    def pack(self):
        """Assemble the transfer-compact catalog columns."""
        c = self._cols
        S = len(c["fmt_tab"])
        if S >= (1 << 16):
            raise ValueError(f"{S} streams: sid is uint16")
        self.sid = c["sid"].astype(np.uint16)
        # bt: full-width band types (type-1 streams accumulate deltas mod
        # 0x10000); the compact wire narrows to uint8 and checks
        for k in ("start_bit", "bt", "hdr_tab", "fmt_tab", "sub_tab",
                  "n_steps"):
            setattr(self, k, c[k])
        cat = lambda parts: (np.concatenate(parts) if parts
                             else np.zeros(0, np.int32))
        mix = cat(self._mix)
        vol = cat(self._vol)
        if mix.size and (mix.max() >= (1 << 16) or vol.max() >= 256):
            raise ValueError("mix exceeds uint16 or volume shift uint8")
        self.mix_u16 = mix.astype(np.uint16)
        self.vol_u8 = vol.astype(np.uint8)
        return self

    def args(self):
        """The wide flat_pipeline arguments as numpy (pool as uint8): pool,
        start_bit, header, fmt, sub, bt, btp, mix, vol, stream_start,
        n_steps."""
        sid = self.sid.astype(np.int32)
        header = self.hdr_tab.astype(np.int32)[sid]
        fmt = self.fmt_tab.astype(np.int32)[sid]
        sub = self.sub_tab.astype(np.int32)[sid]
        btp = (np.concatenate(self._btp) if self._btp
               else np.zeros((0, 16), np.int32))
        sstart = (np.concatenate([[True], sid[1:] != sid[:-1]])
                  if sid.size else np.zeros(0, bool))
        return (self.pool_u8, self.start_bit, header, fmt, sub, self.bt, btp,
                self.mix_u16.astype(np.int32), self.vol_u8.astype(np.int32),
                sstart, self.n_steps)

    def compact_host_arrays(self):
        """Transfer-compact numpy columns for flat_pipeline_packed
        (requires pack())."""
        return dict(
            pool_u8=self.pool_u8,
            sid=self.sid,
            start_bit=self.start_bit,
            bt_u8=narrow_band_types(self.bt),
            mix_u16=self.mix_u16,
            vol_u8=self.vol_u8,
            hdr_tab=self.hdr_tab,
            fmt_tab=self.fmt_tab, sub_tab=self.sub_tab,
            n_steps=self.n_steps)


def run_flat(sweep, device="cuda"):
    """Decode the whole packed catalog through FlatPipeline on ``device``
    (the card by default); returns int16 PCM [N*240]."""
    pipe = FlatPipeline(device)
    return to_int16(pipe(**packed_to_device(sweep.compact_host_arrays(),
                                            device)))
