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
                         hdr_tab, fmt_tab, sub_tab, n_steps, tabs,
                         plain=False):
    """The flat sweep from the transfer-compact columns
    (FlatSweep.compact_host_arrays via packed_to_device): the stream header
    travels once per stream (hdr_tab [S, 16] + sid [N]); band_type_prev and
    stream starts derive from sid.  ``plain`` runs the plain versions of
    the kernels on any device.  Returns pcm [N, 240] int32 u16 storage."""
    decode = bd.decode94_fb_plain if plain else bd.decode94_fb
    to_pcm = tf.transform94_pcm_plain if plain else tf.transform94_pcm
    fb = decode(pool_u8, sid, start_bit.int(), bt_u8, mix_u16.int(), hdr_tab,
                fmt_tab, sub_tab, n_steps, tabs)
    return to_pcm(fb, vol_u8.int(), sid, tabs)


class FlatPipeline(nn.Module):
    """The device half of the flat sweep; ``forward`` is
    flat_pipeline_packed over the tensors of packed_to_device.  The codec
    tables are buffers, made on ``device`` (the card unless given) and
    moved by ``.to(device)``.  ``plain=True`` runs the plain PyTorch
    versions of the kernels on any device (the comparison path)."""

    def __init__(self, device=None, plain=False):
        super().__init__()
        self.plain = plain
        dev = _device("cuda" if device is None else device)
        for name, t in codec_tables().items():
            self.register_buffer(name, t.to(dev))

    def forward(self, pool_u8, sid, start_bit, bt_u8, mix_u16, vol_u8,
                hdr_tab, fmt_tab, sub_tab, n_steps):
        with span("dcs.flat94"):
            return flat_pipeline_packed(pool_u8, sid, start_bit, bt_u8,
                                        mix_u16, vol_u8, hdr_tab, fmt_tab,
                                        sub_tab, n_steps,
                                        dict(self.named_buffers()), self.plain)


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


def reference_pcm(stream, n_frames, mixing_level=MIXING_LEVEL,
                  master_volume=MASTER_VOLUME):
    """int16 PCM of one stream from the scalar reference decoder, at the
    standalone-playback settings FlatSweep traces."""
    dec = rd.ReferenceDecoder()
    dec.default_volume = master_volume
    dec.init_standalone(rd.OS94)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(stream), mixing_level=mixing_level)
    return np.array(dec.next_samples(n_frames * 240), dtype=np.int16)


class FlatSweep:
    """Host-side packing of a whole catalog for the flat pipeline.

    Per catalog entry the host runs the native stream indexer (frame
    boundaries, band-type chains) and the native runtime VM trace (mixing
    multipliers, volume shifts), then assembles the per-frame control
    arrays with vectorized numpy.  Same columns as the reference's
    FlatSweep, as numpy arrays."""

    def __init__(self, streams, mixing_level=MIXING_LEVEL,
                 master_volume=MASTER_VOLUME):
        idxs = [prescan.prescan94(s, 0) for s in streams]
        offsets = []
        bufs = []
        pos = 0
        for s, i in zip(streams, idxs):
            offsets.append(pos)
            end = int(i.end_bit[-1] // 8) + 8 if i.n_frames else len(s)
            body = bytes(s[:end])            # may clamp short of `end`
            bufs.append(body)
            bufs.append(b"\xff" * 8)
            pos += len(body) + 8
        bufs.append(b"\xff" * 8)
        self.pool_u8 = np.frombuffer(b"".join(bufs), dtype=np.uint8)

        cols = []      # per stream: dict of per-frame numpy columns
        for k, (s, i) in enumerate(zip(streams, idxs)):
            F = i.n_frames
            mixes, vols = self._trace(s, F, mixing_level, master_volume)
            cols.append(dict(
                n_frames=F,
                start_bit=(offsets[k] * 8 + i.start_bit).astype(np.int32),
                header=np.asarray(i.header, np.int32),       # [16], one row
                fmt=int(i.fmt_type), sub=int(i.sub_type),
                bt=np.asarray(i.band_type, np.int32),
                btp=np.asarray(i.band_type_prev, np.int32),
                mix=mixes, vol=vols,
                totals=np.asarray(prescan.scan_totals(i), np.int64),
            ))
        self._cols = cols
        self.n_frames_total = int(sum(c["n_frames"] for c in cols))
        self.audio_samples = self.n_frames_total * 240
        self.dense_totals = (np.concatenate([c["totals"] for c in cols])
                             if cols else np.zeros(0, np.int64))

    @staticmethod
    def _trace(stream, n_frames, mixing_level, master_volume):
        """Per-frame (mix multiplier, volume shift) of channel 0 for
        standalone playback, from the native runtime VM."""
        tr = nt.NativeControlTracer(stream, default_volume=master_volume,
                                    standalone_os=rd.OS94)
        try:
            tr.soft_boot()
            tr.load_audio_stream(0, 0, mixing_level=mixing_level)
            _, _, out_m, out_v = tr.trace_frames(n_frames)
        finally:
            tr.close()
        return out_m[:, 0].astype(np.int32), out_v.astype(np.int32)

    def pack(self):
        """Assemble the transfer-compact catalog columns."""
        cols = self._cols
        S = len(cols)
        N = self.n_frames_total
        cat = lambda key: (np.concatenate([c[key] for c in cols])
                           if cols else np.zeros(0, np.int32))
        if S >= (1 << 16):
            raise ValueError(f"{S} streams: sid is uint16")
        self.sid = np.repeat(np.arange(S, dtype=np.uint16),
                             [c["n_frames"] for c in cols])
        self.start_bit = cat("start_bit").astype(np.int32)
        # full-width band types (type-1 streams accumulate deltas mod
        # 0x10000); the compact wire narrows to uint8 and checks
        self.bt = (np.concatenate([c["bt"] for c in cols])
                   if cols else np.zeros((0, 16), np.int32))
        mix = cat("mix")
        vol = cat("vol")
        if mix.size and (mix.max() >= (1 << 16) or vol.max() >= 256):
            raise ValueError("mix exceeds uint16 or volume shift uint8")
        self.mix_u16 = mix.astype(np.uint16)
        self.vol_u8 = vol.astype(np.uint8)
        self.hdr_tab = (np.stack([c["header"] for c in cols])
                        if S else np.zeros((0, 16), np.int32)) \
            .astype(np.uint8)
        self.fmt_tab = np.asarray([c["fmt"] for c in cols], np.uint8)
        self.sub_tab = np.asarray([c["sub"] for c in cols], np.uint8)
        self.n_steps = int(min(256, (self.dense_totals.max() + 7) & ~7)) \
            if N else 8
        return self

    def args(self):
        """The wide flat_pipeline arguments as numpy (pool as uint8): pool,
        start_bit, header, fmt, sub, bt, btp, mix, vol, stream_start,
        n_steps."""
        cols = self._cols
        sid = self.sid.astype(np.int32)
        header = (self.hdr_tab.astype(np.int32)[sid] if cols
                  else np.zeros((0, 16), np.int32))
        fmt = (self.fmt_tab.astype(np.int32)[sid] if cols
               else np.zeros(0, np.int32))
        sub = (self.sub_tab.astype(np.int32)[sid] if cols
               else np.zeros(0, np.int32))
        btp = (np.concatenate([c["btp"] for c in cols])
               if cols else np.zeros((0, 16), np.int32))
        sstart = (np.concatenate([[True], sid[1:] != sid[:-1]])
                  if sid.size else np.zeros(0, bool))
        return (self.pool_u8, self.start_bit, header, fmt, sub, self.bt, btp,
                self.mix_u16.astype(np.int32), self.vol_u8.astype(np.int32),
                sstart, self.n_steps)

    def compact_host_arrays(self):
        """Transfer-compact numpy columns for flat_pipeline_packed
        (requires pack())."""
        bt = self.bt
        if bt.size and (bt.min() < 0 or bt.max() > 255):
            raise ValueError("band types exceed uint8: use the wide args()")
        return dict(
            pool_u8=self.pool_u8,
            sid=self.sid,
            start_bit=self.start_bit,
            bt_u8=bt.astype(np.uint8),
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
