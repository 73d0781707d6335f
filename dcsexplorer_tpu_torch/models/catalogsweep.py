"""Flat catalog sweep of the 1993 family (93b / 93a Type-0, and OS93a
Type-1) in PyTorch + CUDA.

Counterpart of the 1993 half of ``dcsexplorer_tpu/models/catalogsweep.py``.
All frames of all streams of a catalog share ONE flat frame axis: the
streams' bytes concatenate into one pool (8-byte $FF separators), bit
offsets become global, and the overlap carry resets at each stream's first
frame.  The sweep runs

    host:   native prescan93 / prescan93a + native VM trace
            -> Flat93Sweep.compact_host_arrays() (the reference's compact
            wire) -> packed93_to_device (the bank columns of
            ops/decode93.py, uploaded)
    device: decode93_pcm (one voice a frame; decode, transform and overlap
            resolve in one) -> PCM

with the device part as ``Flat93Pipeline`` (an ``nn.Module`` whose buffers
are the codec tables of ``codec_tables93``).  On CUDA tensors the stage is
a hand-written kernel (``ops/kernels.py``); on CPU tensors its plain
PyTorch version runs.  ``pool_columns93`` lays out the decode columns of
both this sweep and the 1993 session bank of ``models/pipeline.py``.
``catalog_pipeline`` runs a mixed 94 + 93b + 93a-Type-1 catalog through
both pipelines and sums the families' PCM checksums.  The entry points run
on the card unless the caller names another device.  Bit-exact with the JAX
reference and the scalar decoder.
"""

import numpy as np
import torch
from torch import nn

from ..format import tables as T
from ..ops import decode93, decode93a
from ..refdec import decoder as rd
from ..utils.profiling import span
from .flatsweep import _device, to_int16, trace_standalone

_SCALE_MANT = np.asarray(T.SCALE_MANTISSA, dtype=np.int64)
# standalone playback settings of the sweep (the reference's defaults)
MIXING_LEVEL, MASTER_VOLUME = 0x64, 255


def codec_tables93():
    """The 1993 family's constant tables as int32 CPU tensors, derived from
    ``format/tables.py`` as the reference derives them (transform.py:23-27,
    480-487; decode93a.py:26-31): the transform's twiddles (cos, sin), the
    overlap window (ovl_new, and ovl_old reversed), the collection map
    br93_half (the re-plane index of each natural-order output), the OS93a
    pair table and the inputs per band."""
    br = np.asarray(T.BITREV9, np.int64)
    ifft = np.asarray(T.IFFT_COEFF, np.int64)
    ovl = np.asarray(T.OVERLAP_COEFF, np.int64)
    tabs = {"cos": ifft[128:], "sin": ifft[:128], "ovl_new": ovl,
            "ovl_old": ovl[::-1], "br93_half": br[:256] >> 1,
            "pair": decode93a.PAIR, "inputs": decode93a.INPUTS}
    return {k: torch.tensor(np.ascontiguousarray(v).astype(np.int32))
            for k, v in tabs.items()}


def _stream93_band_tables(stream):
    """Per-stream per-band decode constants from the 16 header bytes
    (prescan93's derivation of scale/n/inc/fix/stride_skip): scale u16, n,
    inc, pre-increment, fix, stride_skip -- everything about a band's
    layout that does NOT change frame to frame."""
    fmt = (stream[2] & 0x80) >> 7
    scale = np.zeros(16, np.uint16)
    n = np.zeros(16, np.uint8)
    inc = np.ones(16, np.uint8)
    pre = np.zeros(16, np.uint8)
    fix = np.zeros(16, np.int8)
    skip = np.zeros(16, np.uint8)
    for b in range(16):
        cur = stream[2 + b] & 0x7F
        if cur == 0x7F:
            break
        sf_shift = ((cur >> 2) & 0xF) - 0xF
        mant = int(_SCALE_MANT[cur & 3])
        scale[b] = (mant << sf_shift if sf_shift >= 0
                    else mant >> -sf_shift) & 0xFFFF
        stride = cur >> 6
        if fmt == 0:
            if stride == 0:
                n[b], inc[b], fix[b], skip[b] = 16, 1, 0, 16
            else:
                n[b], inc[b], fix[b], skip[b], pre[b] = 16, 2, -1, 31, 1
        else:
            if stride == 0:
                n[b] = 15 if b == 0 else 16
                inc[b], fix[b], skip[b] = 1, 0, n[b]
            else:
                n[b], inc[b], fix[b], skip[b] = 8, 2, 0, 8
    return fmt, dict(scale=scale, n=n, inc=inc, pre=pre, fix=fix, skip=skip)


BAND_FIELDS = ("scale", "n", "inc", "pre", "fix", "skip")


def band_table(tab):
    """_stream93_band_tables' dict (fields [16], or [S, 16] stacked) -> the
    int32 rows of band_tab: [.., 16, 8] of (scale, n, inc, pre, fix, skip,
    0, 0)."""
    cols = [np.asarray(tab[k]).astype(np.int32) for k in BAND_FIELDS]
    return np.stack(cols + [np.zeros_like(cols[0])] * 2, axis=-1)


def _check_range(name, a, hi):
    """Raise unless every value of ``a`` lies in [0, hi): the narrowing of
    the compact wire must never wrap."""
    if a.size and (a.min() < 0 or a.max() >= hi):
        raise ValueError(f"{name} outside [0, {hi})")


def _decompose_scale32(sc32):
    """[..,] int64 resolved 93a scale words -> u8 codes (shift<<2 | mant
    index); 0xFF marks an unused band (scale 0).  Raises unless each word
    rebuilds exactly, so the narrowing can never silently wrap."""
    sc32 = np.asarray(sc32, np.int64)
    out = np.full(sc32.shape, 0xFF, np.uint8)
    nz = sc32 > 0
    if nz.any():
        v = sc32[nz]
        shift = np.maximum(
            0, (np.floor(np.log2(v.astype(np.float64))) - 15)
            .astype(np.int64))
        base = v >> shift
        e = np.searchsorted(_SCALE_MANT, base)
        ok = (e < 4) & (_SCALE_MANT[np.minimum(e, 3)] == base) \
            & ((base << shift) == v) & (shift <= 14)
        if not ok.all():
            raise ValueError("93a scale word does not decompose")
        out[nz] = (shift << 2 | e).astype(np.uint8)
    return out


def stream_columns(idx, t1, bit_base):
    """One stream's compact per-frame columns (numpy): frame_word [F] and
    the frame-relative bit offsets bit_rel (0 where a band reads nothing),
    with the band widths and scale codes (t1: bits, code [F, 18]) or the
    packed kind and width and the chain state (kw, prv_in, prv_dl
    [F, 16]).  bit_base: the stream's bit offset in the pool, less its
    prescan's origin."""
    mod = decode93a if t1 else decode93
    fw = (mod.frame_base_bits(idx) + bit_base) >> 5
    # frame-relative bit offsets fit u16: a frame spans < 2^16 bits
    rel = idx.bit_start + bit_base - (fw[:, None] << 5)
    if t1:
        return dict(frame_word=fw, bit_rel=np.where(idx.bits > 0, rel, 0),
                    bits=idx.bits, code=_decompose_scale32(idx.scale32))
    data = (idx.kind >= decode93.K_DATA0) & (idx.kind <= decode93.K_DATA2)
    return dict(frame_word=fw, bit_rel=np.where(data, rel, 0),
                kw=(idx.kind << 5) | idx.width, prv_in=idx.prv_in,
                prv_dl=idx.prv_dl)


def rows93(c, t1):
    """Compact columns of one kind (a stream's stream_columns, or a sweep's
    wire under the same names) -> the bank's per-row columns (numpy;
    ops/decode93.py's layout, without pool_u8, sid and band_tab)."""
    n = len(c["frame_word"])
    kw = np.zeros((n, 18), np.uint8)
    rel = np.zeros((n, 18), np.int32)
    code = np.full((n, 18), 0xFF, np.uint8)
    prv = np.zeros((n, 16), np.uint32)
    if t1:
        kw[:] = c["bits"]
        rel[:] = c["bit_rel"]
        code[:] = c["code"]
    else:
        kw[:, :16] = c["kw"]
        rel[:, :16] = c["bit_rel"]
        prv[:] = (np.asarray(c["prv_in"], np.uint32)
                  | (np.asarray(c["prv_dl"], np.uint32) << 16))
    return dict(frame_word=np.asarray(c["frame_word"], np.int32),
                kind_u8=np.full(n, decode93.ROW_93A if t1 else decode93.ROW_93,
                                np.uint8),
                kw_u8=kw, bit_rel=rel, prv=prv.view(np.int32), code_u8=code)


def _check_layout(tab, idx):
    """The device recomputes each frame's output layout (out_start,
    out_inc, n_samp) from the stream's band tables ``tab``; check the
    reconstruction against the walker's index once per stream."""
    n = tab["n"].astype(np.int64)[None, :]
    kindm = idx.kind
    adv = tab["pre"].astype(np.int64)[None, :] + np.where(
        kindm == decode93.K_NONE, tab["skip"].astype(np.int64)[None, :],
        n * tab["inc"].astype(np.int64)[None, :]
        + tab["fix"].astype(np.int64)[None, :])
    start = 1 + np.cumsum(adv, axis=1) - adv \
        + tab["pre"].astype(np.int64)[None, :]
    used = kindm != decode93.K_NONE
    inc = np.broadcast_to(tab["inc"].astype(np.int64)[None, :],
                          kindm.shape)
    if not (np.array_equal(start[used], idx.out_start[used])
            and np.array_equal(np.broadcast_to(n, kindm.shape)[used],
                               idx.n_samp[used])
            and np.array_equal(inc[used], idx.out_inc[used])):
        raise ValueError("the band tables' layout differs from the "
                         "walker's")


def pool_columns93(bodies, idxs, t1s, origins):
    """The decode columns of 1993-family streams (numpy), the layout every
    1993 decode reads.  ``bodies[k]`` holds a stream from its header on (at
    least the bytes its frames read); ``idxs[k]`` is its index by the
    walker of its kind (prescan93a where ``t1s[k]``, the OS93a Type-1 wire;
    prescan93 otherwise), taken at byte ``origins[k]`` of the buffer the
    body was cut from.  The bodies enter one byte pool, each followed by 8
    $FF bytes, and 8 more close it.  Returns (pool_u8, each stream's
    stream_columns at its bit base in the pool, each stream's band tables
    checked against its index, None for a Type-1 stream)."""
    bufs, cols, tabs = [], [], []
    pos = 0
    for body, idx, t1, o in zip(bodies, idxs, t1s, origins):
        cols.append(stream_columns(idx, t1, (pos - o) * 8))
        tab = None
        if not t1:
            tab = _stream93_band_tables(body)[1]
            _check_layout(tab, idx)
        tabs.append(tab)
        body = bytes(body)
        bufs += [body, b"\xff" * 8]
        pos += len(body) + 8
    bufs.append(b"\xff" * 8)
    return np.frombuffer(b"".join(bufs), dtype=np.uint8), cols, tabs


class Flat93Sweep:
    """Host packing of a 1993-family catalog onto one flat frame axis.

    ``t1`` selects the OS93a Type-1 walker; otherwise the 93b / 93a Type-0
    walker (both subfamilies share the decompressor).  Per stream the
    native indexer records the per-band decode controls and the native VM
    traces mix and volume, at the reference's standalone settings;
    pool_columns93 lays out the decode columns."""

    def __init__(self, streams, t1, mixing_level=MIXING_LEVEL,
                 master_volume=MASTER_VOLUME):
        self.t1 = t1
        os_v = rd.OS93A if t1 else rd.OS93B
        idxs = [decode93a.prescan93a(s, 0) if t1 else decode93.prescan93(s, 0)
                for s in streams]
        S = len(streams)
        self.pool_u8, cols, tabs = pool_columns93(streams, idxs, [t1] * S,
                                                  [0] * S)
        for s, idx, c in zip(streams, idxs, cols):
            mix, vol = trace_standalone(s, idx.n_frames, os_v, mixing_level,
                                        master_volume)
            c.update(n_frames=idx.n_frames, mix=mix, vol=vol)
        self._cols = cols
        self._tabs = [t for t in tabs if t is not None]
        self.n_frames_total = int(sum(c["n_frames"] for c in cols))
        self.audio_samples = self.n_frames_total * 240

    def compact_host_arrays(self):
        """Transfer-compact numpy columns, the reference's wire: narrow
        dtypes, each range checked here so the narrowing can never
        silently wrap.  OS93a Type-1 widths may reach 9 (the codebooks'
        widest band; the reference asserts < 8)."""
        cols = self._cols
        S = len(cols)
        if S >= (1 << 16):
            raise ValueError("sid is uint16: at most 65,535 streams")
        cat = lambda key: (np.concatenate([c[key] for c in cols])
                           if cols else np.zeros(0, np.int64))
        sid = np.repeat(np.arange(S, dtype=np.uint16),
                        [c["n_frames"] for c in cols])
        fw = cat("frame_word")
        rel = cat("bit_rel")
        mix = cat("mix")
        vol = cat("vol")
        for name, a, hi in (("frame_word", fw, 1 << 31),
                            ("bit_rel", rel, 1 << 16), ("mix", mix, 1 << 16),
                            ("vol", vol, 256)):
            _check_range(name, a, hi)
        out = dict(pool_u8=self.pool_u8, sid=sid,
                   frame_word=fw.astype(np.int32),
                   bit_rel=rel.astype(np.uint16),
                   mix_u16=mix.astype(np.uint16),
                   vol_u8=vol.astype(np.uint8))
        if self.t1:
            bits = cat("bits")
            _check_range("bits", bits, decode93a.MAX_BITS + 1)
            out.update(bits_u8=bits.astype(np.uint8),
                       code_u8=cat("code").astype(np.uint8))
        else:
            kw = cat("kw")
            pin = cat("prv_in")
            pdl = cat("prv_dl")
            for name, a, hi in (("kw", kw, 256), ("prv_in", pin, 1 << 16),
                                ("prv_dl", pdl, 1 << 16)):
                _check_range(name, a, hi)
            out.update(kw_u8=kw.astype(np.uint8),
                       prv_in=pin.astype(np.uint16),
                       prv_dl=pdl.astype(np.uint16),
                       **{f"{k}_tab": np.stack([t[k] for t in self._tabs])
                          for k in BAND_FIELDS})
        return out


def columns93(arrays):
    """Flat93Sweep.compact_host_arrays() (numpy) -> Flat93Pipeline keyword
    arguments as numpy, built on the host: the bank columns of
    ops/decode93.py (row f is frame f), mix and vol as int32."""
    t1 = "bits_u8" in arrays
    sid = np.asarray(arrays["sid"], np.int32)
    c = {"frame_word": arrays["frame_word"], "bit_rel": arrays["bit_rel"]}
    if t1:
        c.update(bits=arrays["bits_u8"], code=arrays["code_u8"])
        band_tab = np.zeros((int(sid.max(initial=0)) + 1, 16, 8), np.int32)
    else:
        c.update(kw=arrays["kw_u8"], prv_in=arrays["prv_in"],
                 prv_dl=arrays["prv_dl"])
        band_tab = band_table({k: arrays[f"{k}_tab"] for k in BAND_FIELDS})
    out = rows93(c, t1)
    out.update(pool_u8=arrays["pool_u8"], sid=sid, band_tab=band_tab,
               mix=np.asarray(arrays["mix_u16"], np.int32),
               vol=np.asarray(arrays["vol_u8"], np.int32))
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def packed93_to_device(arrays, device="cuda"):
    """Flat93Sweep.compact_host_arrays() (numpy) -> Flat93Pipeline keyword
    arguments on ``device`` (the card by default): columns93's, uploaded."""
    device = _device(device)
    return {k: torch.tensor(v, device=device)
            for k, v in columns93(arrays).items()}


class Flat93Pipeline(nn.Module):
    """The device half of the 1993 flat sweep, both wires (93b / 93a
    Type-0 and OS93a Type-1); ``forward`` takes the tensors of
    packed93_to_device and returns pcm [N, 240] int32 (u16 storage).  The
    codec tables are buffers, made on ``device`` (the card unless
    given)."""

    def __init__(self, device=None):
        super().__init__()
        dev = _device("cuda" if device is None else device)
        for name, t in codec_tables93().items():
            self.register_buffer(name, t.to(dev))

    def forward(self, mix, vol, **cols):
        with span("dcs.flat93"):
            return decode93.decode93_pcm(cols, mix, vol, cols["sid"],
                                         dict(self.named_buffers()))


def run_flat93(sweep, device="cuda"):
    """Decode the packed 1993 catalog through Flat93Pipeline on ``device``
    (the card by default); returns int16 PCM [N*240]."""
    pipe = Flat93Pipeline(device)
    return to_int16(pipe(**packed93_to_device(sweep.compact_host_arrays(),
                                              device)))


def checksum(pcm):
    """sum(pcm & 0xFF) as the JAX package's ``jnp.sum(pcm & 0xFF,
    dtype=jnp.int32)`` computes it, wrapped to a signed int32: a 0-d int32
    tensor on pcm's device.  torch sums int32 in int64, so the wrap is
    explicit (66,648 frames x 240 x 255 exceed 2^31)."""
    return wrap_int32((pcm & 0xFF).sum(dtype=torch.int64))


def wrap_int32(x):
    """An int64 tensor -> int32, modulo 2^32 into [-2^31, 2^31)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def catalog_pipeline(pipe94, pipe93, args94, args93b, args93a):
    """One pass over a mixed 94 + 93b + 93a-Type-1 catalog: ``pipe94`` (a
    FlatPipeline) on the 1994+ tensors (packed_to_device's), ``pipe93`` (a
    Flat93Pipeline) on the 93b and 93a-Type-1 tensors (packed93_to_device's);
    any family may be None.  The caller builds the pipelines once (a
    ColdDevice holds both).  Returns the families' checksums summed as the
    JAX catalog_pipeline sums them, in int32 (a 0-d int32 tensor)."""
    total = torch.zeros((), dtype=torch.int64)
    runs = ((pipe94, args94), (pipe93, args93b), (pipe93, args93a))
    for pipe, args in runs:
        if args is not None:
            pcm = pipe(**args)
            total = total.to(pcm.device) + checksum(pcm)
    return wrap_int32(total)
