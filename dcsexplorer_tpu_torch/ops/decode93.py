"""1993-family frame decode: the host prescan, and the device decode of the
93 bands and of OS93a Type-1 into frame buffers.

PyTorch counterpart of ``dcsexplorer_tpu/ops/decode93.py``.  The 93 frame
format codes no sample with Huffman codes: every band's samples are
fixed-width.  Once the host prescan has recorded each band's bit offset,
width, kind, scale and the differential-chain state entering it, every
sample of every frame decodes independently.

Host half (numpy): ``Stream93Index``, ``prescan93`` (the native walker of
``native/``; it raises if it cannot run), ``prescan93_python`` (the scalar
walker, kept for the tests to hold the native one against),
``frame_base_bits`` and ``index_arrays``.  The reference's
``window_words_needed`` sizes its window rows, which have no counterpart:
the port reads bits straight from the byte pool.

Device half: ``decode93_frames_plain`` is the band decode of one voice
(fixed-width extraction, the Sigma / Sigma-Sigma chains, the subtype-1 repeat
anomaly in closed form, scale/mix accumulate, the first-sample fix-up);
``decode93a.decode93a_frames_plain`` is OS93a Type-1's.
``decode93_fb_plain`` decodes a session batch or a flat sweep from the bank
columns (below): per output frame and voice, in channel order, the 93 body
and then the 93a body, exactly as the reference's ``device_decode93`` chains
them, into frame buffers; ``decode93_pcm_plain`` follows it with
``transform.transform93_pcm_plain``'s inverse transform and overlap
resolve, and is the plain version both instances of the kernel are held
against.  ``decode93_pcm`` is the flat sweeps' stage (rows None, one voice
a frame): bank columns in and PCM out, through the columns' instance of
``csrc/decode93_pcm.cu`` for CUDA tensors, whose frame buffers never reach
device memory, and ``decode93_pcm_plain`` for CPU tensors.  The kernels
of the two halves, ``kernels.decode93_fb`` and ``kernels.transform93_pcm``,
are on no path.

The session path plays each bank row thousands of times a batch, so it
decodes once per ROM what does not depend on the mix: ``decode93_bank``
(``csrc/decode93_bank.cu``; plain ``decode93_bank_plain``) turns the bank
columns into the session bank, per row and frame-buffer word the low word
of its write (``cells93_plain``) or its Type-1 pair value
(``decode93a.inputs93a_plain``), with repeat indices and Type-1 scales
beside them (layout: ``csrc/decode93_bank.cuh``).  ``session93_pcm`` is
the sessions' stage: those words mixed in channel order
(``session93_fb_plain``), then the same transform, through the session
instance of ``csrc/decode93_pcm.cu`` for CUDA tensors.

The bank columns (``models/catalogsweep.columns93``), one row per stream
frame (row kinds: 0 silent, 1 the 93 bands, 2 OS93a Type-1):
  pool_u8 [L] uint8; frame_word [R] int32 (the frame's first 32-bit pool
  word); sid [R] int32 (the row's stream, indexing band_tab); kind_u8 [R];
  kw_u8 [R, 18] uint8 (kind << 5 | width of 93 bands 0..15, or the 93a
  band widths); bit_rel [R, 18] int32 (each data band's first bit past
  frame_word * 32, 0 elsewhere); prv [R, 16] int32 (the chain state
  entering each 93 band, prv_in | prv_dl << 16); code_u8 [R, 18] uint8
  (93a scale codes: shift << 2 | mantissa index, $FF unused); band_tab
  [S, 16, 8] int32 (each 93 stream's band layout from its 16 header bytes:
  scale, n, inc, pre, fix, skip, 0, 0).
The decode rebuilds each 93 frame's output layout from band_tab with a
16-band prefix sum, as ``flat93_pipeline_packed`` does.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..format import tables as T
from ..refdec.bitreader import BitReader, PaddedView
from ..refdec.frames import _read_huff93
from . import decode93a, kernels
from . import transform as tf
from .decode93a import pool_bits, stream_bytes
from .fixmath import M16, s16, sat16

# band kinds
K_NONE, K_DATA0, K_DATA1, K_DATA2, K_REPEAT, K_RAMP = 0, 1, 2, 3, 4, 5

# row kinds of the bank columns
ROW_SILENT, ROW_93, ROW_93A = 0, 1, 2

# frames per step of the plain decode (bounds its int64 temporaries)
_CHUNK = 1 << 15


@dataclass
class Stream93Index:
    n_frames: int
    fmt_type: int
    # per frame, per band slot (max 16 bands):
    kind: np.ndarray        # [F,16] band kind (K_*)
    width: np.ndarray       # [F,16] sample bit width (data kinds)
    n_samp: np.ndarray      # [F,16] samples/outputs in the band
    bit_start: np.ndarray   # [F,16] absolute bit offset of first sample
    out_start: np.ndarray   # [F,16] frame-buffer index of first output
    out_inc: np.ndarray     # [F,16]
    scale: np.ndarray       # [F,16] scale factor (u16)
    prv_in: np.ndarray      # [F,16] chain value entering the band
    prv_dl: np.ndarray      # [F,16] chain delta entering the band
    end_bit: np.ndarray     # [F]


def prescan93(mem, pos=0):
    """Index the 93-format stream at ``mem[pos]`` with the native walker
    (``dcs93_index``, field-identical to ``prescan93_python``).  Bytes past
    the stream read as $FF.  Raises on a stream too short for its frame
    count and on a band width over 24 bits."""
    lib = native.get_lib()
    buf = stream_bytes(mem)
    F = lib.dcs94_frame_count(buf, len(buf), pos)
    if F < 0:
        raise ValueError("stream too short")
    meta = np.zeros(1, dtype=np.int32)
    z32 = lambda: np.zeros((F, 16), dtype=np.int32)
    kind, width, n_samp = z32(), z32(), z32()
    out_start, out_inc, scale = z32(), z32(), z32()
    prv_in, prv_dl = z32(), z32()
    bit_start = np.zeros((F, 16), dtype=np.int64)
    end_bit = np.zeros(F, dtype=np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.dcs93_index(buf, len(buf), pos, p(meta), p(kind), p(width),
                         p(n_samp), p(bit_start), p(out_start), p(out_inc),
                         p(scale), p(prv_in), p(prv_dl), p(end_bit))
    if rc == -2:
        raise ValueError("93 stream: a band width over 24 bits")
    if rc != 0:
        raise RuntimeError(f"native 93 index failed: {rc}")
    to64 = lambda a: a.astype(np.int64)
    return Stream93Index(
        n_frames=F, fmt_type=int(meta[0]), kind=to64(kind),
        width=to64(width), n_samp=to64(n_samp), bit_start=bit_start,
        out_start=to64(out_start), out_inc=to64(out_inc), scale=to64(scale),
        prv_in=to64(prv_in), prv_dl=to64(prv_dl), end_bit=end_bit)


def prescan93_python(mem, pos=0):
    """The scalar Python walker: the same index as ``prescan93``.  Nothing
    in the port calls it."""
    mem = PaddedView(mem)
    n_frames = (int(mem[pos]) << 8) | int(mem[pos + 1])
    hdr_pos = pos + 2
    fmt_type = (int(mem[hdr_pos]) & 0x80) >> 7
    bit = BitReader(mem, hdr_pos + 16)

    F = n_frames
    z = lambda: np.zeros((F, 16), dtype=np.int64)
    idx = Stream93Index(n_frames=F, fmt_type=fmt_type, kind=z(), width=z(),
                        n_samp=z(), bit_start=z(), out_start=z(), out_inc=z(),
                        scale=z(), prv_in=z(), prv_dl=z(),
                        end_bit=np.zeros(F, dtype=np.int64))
    band_type_acc = [0] * 16

    for f in range(F):
        band_sub_type = 0 if fmt_type == 1 else 2
        is_first = True
        prv_in = 0
        prv_dl = 0
        reuse = False
        cur_type = 0
        out_idx = 1
        for band in range(16):
            cur_hdr = int(mem[hdr_pos + band]) & 0x7F
            if cur_hdr == 0x7F:
                break
            sf_index = cur_hdr & 3
            sf_shift = ((cur_hdr >> 2) & 0xF) - 0xF
            stride = cur_hdr >> 6
            mant = int(T.SCALE_MANTISSA[sf_index])
            scale = (mant << sf_shift if sf_shift >= 0
                     else mant >> -sf_shift) & M16

            if fmt_type == 0:
                if stride == 0:
                    n, inc, fix = 16, 1, 0
                    stride_skip = 16
                else:
                    out_idx += 1
                    n, inc, fix = 16, 2, -1
                    stride_skip = 31
            else:
                if stride == 0:
                    n = 15 if is_first else 16
                    inc, fix, stride_skip = 1, 0, n
                else:
                    n, inc, fix, stride_skip = 8, 2, 0, 8

            if reuse:
                reuse = bit.get(1) != 0
            if not reuse:
                if fmt_type == 0:
                    if bit.get(1):
                        if bit.get(1):
                            band_sub_type = (1, 2, 0)[band_sub_type]
                        else:
                            band_sub_type = (2, 0, 1)[band_sub_type]
                    cur_type = bit.get(4)
                else:
                    delta, band_sub_type = _read_huff93(bit, band_sub_type)
                    band_type_acc[band] = (band_type_acc[band] + delta) & M16
                    cur_type = band_type_acc[band]

            idx.scale[f, band] = scale
            idx.out_inc[f, band] = inc
            idx.prv_in[f, band] = prv_in
            idx.prv_dl[f, band] = prv_dl

            if cur_type == 0:
                reuse = True
                if band_sub_type == 0:
                    idx.kind[f, band] = K_NONE
                    out_idx += stride_skip
                    prv_in = 0
                    prv_dl = 0
                elif band_sub_type == 1:
                    idx.kind[f, band] = K_REPEAT
                    idx.n_samp[f, band] = n
                    idx.out_start[f, band] = out_idx
                    out_idx += n * inc + fix
                    prv_dl = 0
                else:
                    idx.kind[f, band] = K_RAMP
                    idx.n_samp[f, band] = n
                    idx.out_start[f, band] = out_idx
                    out_idx += n * inc + fix
                    prv_in = (prv_in + n * prv_dl) & M16
            else:
                width = cur_type + (1 if fmt_type == 0 else 0)
                idx.kind[f, band] = (K_DATA0, K_DATA1, K_DATA2)[band_sub_type]
                idx.width[f, band] = width
                idx.n_samp[f, band] = n
                idx.bit_start[f, band] = bit.pos * 8 - bit.nbits
                idx.out_start[f, band] = out_idx
                # read (and fold) the samples to advance + track the chain
                vals = [bit.get_signed(width) & M16 for _ in range(n)]
                if band_sub_type == 0:
                    prv_in = vals[-1]
                    prv_dl = (vals[-1] - vals[-2]) & M16
                elif band_sub_type == 1:
                    for v in vals:
                        prv_dl = v
                        prv_in = (prv_in + v) & M16
                else:
                    for v in vals:
                        prv_dl = (prv_dl + v) & M16
                        prv_in = (prv_in + prv_dl) & M16
                out_idx += n * inc + fix
            is_first = False
        idx.end_bit[f] = bit.pos * 8 - bit.nbits
    return idx


def frame_base_bits(idx):
    """Per-frame first-bit offsets (stream-relative): frame f's reads all
    lie in [frame_base[f], end_bit[f]).  Frames are contiguous in the
    bitstream, so frame_base[f] = end_bit[f-1]; frame 0's base is its
    first data-band read (or end_bit[0] if the frame carries no data)."""
    base = np.empty(idx.n_frames, dtype=np.int64)
    base[1:] = idx.end_bit[:-1]
    d0 = (idx.kind[0] >= K_DATA0) & (idx.kind[0] <= K_DATA2)
    base[0] = idx.bit_start[0][d0].min() if d0.any() else idx.end_bit[0]
    return base


def index_arrays(idx, bit_base=0):
    """Stream93Index -> dict of int32 numpy arrays (bit offsets shifted by
    bit_base): frame_word [F] and the [F, 16] per-band fields."""
    i32 = lambda a: np.asarray(a).astype(np.int32)
    return {
        "frame_word": i32((frame_base_bits(idx) + bit_base) >> 5),
        "kind": i32(idx.kind), "width": i32(idx.width),
        "n_samp": i32(idx.n_samp), "bit_start": i32(idx.bit_start + bit_base),
        "out_start": i32(idx.out_start), "out_inc": i32(idx.out_inc),
        "scale": i32(idx.scale), "prv_in": i32(idx.prv_in),
        "prv_dl": i32(idx.prv_dl),
    }


def cells93_plain(pool_u8, arrs):
    """Each (band, sample) cell of one voice of the 93 band decode, as the
    words of its write that do not depend on the mix: (target word, writes,
    lo, i), each [F, 16, 16].  The cell's write is (((old << 16) | lo') +
    P) >> 16 with P = s16(lo) * mix and lo' = (lo + i * (P & $FFFF)) & $FFFF:
    lo is the cell's value, chained by its band's kind and scaled, and i is
    0; a repeat cell's lo is its band's l0 = low16(prv_in * scale) and i its
    index (the subtype-1 repeat anomaly in closed form: the product's low
    word carries across iterations as L_i = (l0 + i * low16(s16(l0) *
    mix)) mod 2^16).  arrs as decode93_frames_plain takes them."""
    kind, width, n_samp, bit_start, out_start, out_inc, scale, prv_in, \
        prv_dl = (arrs[k].long() for k in (
            "kind", "width", "n_samp", "bit_start", "out_start", "out_inc",
            "scale", "prv_in", "prv_dl"))
    dev = kind.device
    i16 = torch.arange(16, device=dev).reshape(1, 1, 16)
    kx = kind[:, :, None]
    w = width[:, :, None]
    live = i16 < n_samp[:, :, None]
    data = live & (kx >= K_DATA0) & (kx <= K_DATA2)
    w1 = w.clamp(min=1)
    at = torch.where(data, bit_start[:, :, None] + i16 * w, 0)
    raw = torch.where(data, pool_bits(pool_u8, at, w1), 0)
    samp = (raw - ((raw >> (w1 - 1)) << w1)) & M16          # sign-extend

    # the differential chains, mod 2^16
    c1 = torch.cumsum(samp, dim=2)
    c2 = torch.cumsum(c1, dim=2)
    p_in = prv_in[:, :, None]
    p_dl = prv_dl[:, :, None]
    ramp = p_in + (i16 + 1) * p_dl
    vals = torch.where(kx == K_DATA1, (p_in + c1) & M16,
                       torch.where(kx == K_DATA2, (ramp + c2) & M16,
                                   torch.where(kx == K_RAMP, ramp & M16,
                                               samp)))
    sc = scale[:, :, None] & M16
    rep = kx == K_REPEAT
    lo = torch.where(rep, (s16(p_in) * sc) & M16, (s16(vals) * sc) & M16)
    fbi = out_start[:, :, None] + i16 * out_inc[:, :, None]
    return (fbi, live & (kx != K_NONE), lo,
            torch.where(rep, i16, 0).expand_as(lo))


def decode93_frames_plain(pool_u8, arrs, mix, fb_prev=None):
    """One voice of the 93 band decode into frame buffers [F, 512].

    pool_u8 [L] uint8; arrs: the index_arrays fields as tensors ([F, 16]
    each; bit_start absolute in the pool); mix [F]; fb_prev [F, 512] the
    frame buffers so far, or None for silence.  Returns int32 (u16
    storage): each (band, sample) cell's value, chained by its band's kind,
    scaled and mixed into its word (cells93_plain; words past 511 are
    dropped; no two cells of a frame share a word), then the saturating
    first-sample fix-up of words 0 and 1.  Placement is a scatter, not the
    reference's compare-reduce."""
    F = arrs["kind"].shape[0]
    dev = arrs["kind"].device
    fb = torch.zeros((F, 513), dtype=torch.long, device=dev)
    if fb_prev is not None:
        fb[:, :512] = fb_prev.long()
    outbuf1 = fb[:, 1].clone()

    fbi, write, lo, i = cells93_plain(pool_u8, arrs)
    write = write & (fbi >= 0) & (fbi < 512)
    old = torch.gather(fb, 1, fbi.clamp(0, 511).reshape(F, 256))
    old = s16(old.reshape(F, 16, 16))
    # the exact scale/mix accumulate (reference AddOutput)
    p = s16(lo) * (mix.long()[:, None, None] & M16)
    lo_i = (lo + i * (p & M16)) & M16
    new_val = ((((old << 16) | lo_i) + p) >> 16) & M16
    # cells that write nothing go to the spare word 512
    fb.scatter_(1, torch.where(write, fbi, 512).reshape(F, 256),
                new_val.reshape(F, 256))

    # first-sample delta fix-up (reference :2608-2611)
    delta = sat16(s16(fb[:, 1]) - s16(outbuf1))
    fb[:, 0] = sat16(s16(delta) + s16(fb[:, 0]))
    fb[:, 1] = outbuf1
    return fb[:, :512].int()


def unpack_columns93(cols):
    """The bank columns -> per-row fields in the reference's index_arrays
    layout, as int64 tensors: (arrs93 with the [R, 16] band fields,
    arrs93a with bits, bit_start, scale32 [R, 18]).  Each holds zeros on
    rows of another kind.  The 93 layout (n_samp, out_start, out_inc,
    scale) comes from band_tab: out_start is 1 + the prefix sum of each
    band's advance (pre-increment, then n * inc + fix, or the skip of a
    band without samples) plus the pre-increment; bit_start is
    frame_word * 32 + bit_rel."""
    kind_row = cols["kind_u8"].long()
    fw = cols["frame_word"].long()
    kw = cols["kw_u8"].long()
    bit_start = (fw[:, None] << 5) + cols["bit_rel"].long()
    is93 = (kind_row == ROW_93)[:, None]
    is93a = (kind_row == ROW_93A)[:, None]

    kind = torch.where(is93, kw[:, :16] >> 5, 0)
    tab = torch.where(is93[:, :, None],
                      cols["band_tab"].long()[cols["sid"].long()], 0)
    scale, n, inc, pre, fix, skip = tab.unbind(-1)[:6]
    none = kind == K_NONE
    adv = pre + torch.where(none, skip, n * inc + fix)
    out_start = 1 + torch.cumsum(adv, dim=1) - adv + pre
    data = (kind >= K_DATA0) & (kind <= K_DATA2)
    prv = cols["prv"].long()
    arrs93 = {"frame_word": torch.where(is93[:, 0], fw, 0), "kind": kind,
              "width": torch.where(is93, kw[:, :16] & 0x1F, 0),
              "n_samp": torch.where(none, 0, n),
              "bit_start": torch.where(data, bit_start[:, :16], 0),
              "out_start": torch.where(none, 0, out_start),
              "out_inc": inc, "scale": scale,
              "prv_in": torch.where(is93, prv & M16, 0),
              "prv_dl": torch.where(is93, (prv >> 16) & M16, 0)}

    bits = torch.where(is93a, kw, 0)
    code = cols["code_u8"].long()
    mant = torch.tensor(np.asarray(T.SCALE_MANTISSA), device=code.device)
    scale32 = torch.where(code == 0xFF, 0,
                          mant[code & 3] << (code >> 2).clamp(0, 14))
    arrs93a = {"frame_word": torch.where(is93a[:, 0], fw, 0), "bits": bits,
               "bit_start": torch.where(bits > 0, bit_start, 0),
               "scale32": torch.where(bits > 0, scale32, 0)}
    return arrs93, arrs93a


def decode93_fb_plain(cols, rows, mix, tabs):
    """Plain version of the decode93_fb kernel.

    cols: the bank columns (module docstring); rows [F, C] int32 bank rows
    per output frame and voice, or None for the flat sweep (row f is frame
    f, one voice); mix [F, C] (or [F] with rows None) mixing multipliers;
    tabs: ``pair`` [2048] (the OS93a pair table).  Each frame starts from
    silence and, per voice in channel order, runs the 93 body
    (decode93_frames_plain) and then the 93a body
    (decode93a.decode93a_frames_plain) of its row.  Returns frame buffers
    [F, 512] int32 (u16 storage)."""
    arrs93, arrs93a = unpack_columns93(cols)
    F = mix.shape[0]
    mix = mix.reshape(F, -1)
    dev = mix.device
    if rows is None:
        rows = torch.arange(F, device=dev).reshape(F, 1)
    out = torch.empty((F, 512), dtype=torch.int32, device=dev)
    for lo in range(0, F, _CHUNK):
        hi = min(F, lo + _CHUNK)
        fb = None
        for c in range(mix.shape[1]):
            r = rows[lo:hi, c].long()
            m = mix[lo:hi, c]
            fb = decode93_frames_plain(cols["pool_u8"],
                                       {k: v[r] for k, v in arrs93.items()},
                                       m, fb)
            fb = decode93a.decode93a_frames_plain(
                cols["pool_u8"], {k: v[r] for k, v in arrs93a.items()}, m,
                tabs["pair"], fb)
        out[lo:hi] = fb
    return out


COLUMNS = ("pool_u8", "frame_word", "sid", "kind_u8", "kw_u8", "bit_rel",
           "prv", "code_u8", "band_tab")


def decode93_pcm_plain(cols, rows, mix, vol_shift, sid, tabs, overlap0=None):
    """Plain version of the decode93_pcm kernel: decode93_fb_plain, then
    transform.transform93_pcm_plain.

    cols, rows, mix: as decode93_fb_plain; vol_shift [F] and sid [F] (each
    output frame's stream or session; the overlap carry resets where it
    changes); tabs: codec_tables93.  Returns pcm [F, 240] int32 (u16
    storage); with overlap0 [G, 16] (the carried state of each id), (pcm,
    last_ov [G, 16]) as transform93_pcm_plain returns them."""
    fb = decode93_fb_plain(cols, rows, mix, tabs)
    return tf.transform93_pcm_plain(fb, vol_shift, sid, tabs, overlap0)


def decode93_pcm(cols, mix, vol_shift, sid, tabs):
    """The flat sweep's bank columns -> PCM, each row one frame of one
    voice (decode93_pcm_plain with rows None): plain version for CPU
    tensors, the CUDA kernel's columns' instance for CUDA tensors."""
    if mix.device.type == "cpu":
        return decode93_pcm_plain(cols, None, mix, vol_shift, sid, tabs)
    return kernels.decode93_pcm(*(cols[k] for k in COLUMNS), mix, vol_shift,
                                sid, tabs)


# -- the session bank ---------------------------------------------------------

# the session bank's layout (csrc/decode93_bank.cuh): int32 words a row
# (256 halfwords, then 32 side words), and its row kinds
BANK_WORDS, BANK_SIDE = kernels.BANK93_WORDS, 128
BANK_SILENT, BANK_93, BANK_93A, BANK_93R = 0, 1, 2, 3
# lane l's 8 frame-buffer words, in the order of its side word's nibbles
LANE_WORDS = torch.tensor([[4 * l + k for k in range(4)]
                           + [128 + 4 * l + k for k in range(4)]
                           for l in range(32)])
# each frame-buffer word's Type-1 band (words 254 and 255: 18, no band)
WORD_BAND = torch.from_numpy(np.concatenate(
    [np.repeat(decode93a.IN_BAND, 2), [decode93a.N_BANDS] * 2]))


def _wrap32(x):
    """int64 words of 32 bits -> int32 (two's complement)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).int()


def decode93_bank_plain(cols, tabs):
    """Plain version of the decode93_bank kernel: the session bank of the
    bank columns, the words of each row's decode that do not depend on the
    mix (csrc/decode93_bank.cuh).  Returns {"words93": [R, 160] int32,
    "kind93": [R] uint8}.  A row's halfword t is frame-buffer word t's lo
    (cells93_plain) for a 93 row, its pair-table value for an OS93a Type-1
    row (inputs93a_plain), 0 where nothing writes it; its side word l holds
    a 93 row's repeat indices of LANE_WORDS[l], 4 bits each, or a Type-1
    row's band l's scale32 >> 16 (l < 18, bands with samples).  Kinds:
    BANK_93R for a 93 row with a repeat index above 0, else the row's."""
    arrs93, arrs93a = unpack_columns93(cols)
    kind_row = cols["kind_u8"].long()
    R = kind_row.shape[0]
    dev = kind_row.device
    lo = torch.zeros((R, 257), dtype=torch.long, device=dev)
    rep = torch.zeros((R, 257), dtype=torch.long, device=dev)
    for a in range(0, R, _CHUNK):
        b = min(R, a + _CHUNK)
        fbi, write, c_lo, c_i = cells93_plain(
            cols["pool_u8"], {k: v[a:b] for k, v in arrs93.items()})
        write = write & (fbi >= 0) & (fbi < 256)
        # cells that write nothing go to the spare word 256
        at = torch.where(write, fbi, 256).reshape(b - a, 256)
        lo[a:b].scatter_(1, at, c_lo.reshape(b - a, 256))
        rep[a:b].scatter_(1, at, c_i.reshape(b - a, 256))
        vals, live = decode93a.inputs93a_plain(
            cols["pool_u8"], {k: v[a:b] for k, v in arrs93a.items()},
            tabs["pair"])
        lo[a:b, :decode93a.TOTAL_OUT] += torch.where(live, vals & M16, 0)
    lo, rep = lo[:, :256], rep[:, :256]
    nib = (rep[:, LANE_WORDS.to(dev)] << (4 * torch.arange(8, device=dev))) \
        .sum(-1)                                            # [R, 32]
    scale = torch.zeros((R, 32), dtype=torch.long, device=dev)
    scale[:, :decode93a.N_BANDS] = arrs93a["scale32"] >> 16
    is93 = kind_row == ROW_93
    side = torch.where(is93[:, None], nib, scale)
    kind93 = torch.where(is93 & (nib != 0).any(1), BANK_93R, kind_row)
    words = torch.cat([lo[:, 0::2] | lo[:, 1::2] << 16, side], 1)
    return {"words93": _wrap32(words), "kind93": kind93.to(torch.uint8)}


def decode93_bank(cols, tabs):
    """The bank columns -> the session bank (see decode93_bank_plain):
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if cols["pool_u8"].device.type == "cpu":
        return decode93_bank_plain(cols, tabs)
    words, kind93 = kernels.decode93_bank(*(cols[k] for k in COLUMNS),
                                          tabs["pair"], tabs["inputs"])
    return {"words93": words, "kind93": kind93}


def session93_fb_plain(bank, rows, mix, fb_prev=None):
    """The session bank's rows mixed into frame buffers, as the session
    instance of the decode93_pcm kernel folds them: bank (decode93_bank's),
    rows [F, C] int32 and mix [F, C].  Each frame starts from silence (or
    from words 0..255 of fb_prev [F, 512]) and folds its voices in channel
    order: a 93 voice adds to word t the delta
    (lo' + P) >> 16 (cells93_plain's write, whose old word's bits enter
    only above the shift), then takes the first-sample fix-up of words 0
    and 1; a Type-1 voice adds (p8 >> 16) with p8 = pk * 2 * eff + $8000
    mod 2^32, eff = s16((scale * mix) >> 15) of the word's band, and clears
    bit 0 where p8's low half is 0 (the MAC's tie rule on the running
    word).  Returns [F, 512] int32 (u16 storage, words 256..511 zero:
    the transform reads words 0..255 only)."""
    words = bank["words93"].long() & 0xFFFFFFFF
    kind = bank["kind93"].long()
    R = kind.shape[0]
    dev = kind.device
    lo_all = torch.stack([words[:, :128] & M16, words[:, :128] >> 16],
                         -1).reshape(R, 256)
    side = words[:, BANK_SIDE:]
    rep_all = torch.zeros((R, 256), dtype=torch.long, device=dev)
    rep_all[:, LANE_WORDS.reshape(-1).to(dev)] = (
        (side[:, :, None] >> (4 * torch.arange(8, device=dev))) & 15
    ).reshape(R, 256)
    scale_all = torch.cat([side[:, :decode93a.N_BANDS],
                           torch.zeros((R, 1), dtype=torch.long,
                                       device=dev)], 1)
    band = WORD_BAND.to(dev)
    F, C = rows.shape
    out = torch.zeros((F, 512), dtype=torch.int32, device=dev)
    for a in range(0, F, _CHUNK):
        b = min(F, a + _CHUNK)
        fb = (torch.zeros((b - a, 256), dtype=torch.long, device=dev)
              if fb_prev is None else fb_prev[a:b, :256].long())
        for c in range(C):
            r = rows[a:b, c].long()
            m = mix[a:b, c].long()[:, None] & M16
            k = kind[r][:, None]
            lo = lo_all[r]
            p = s16(lo) * m
            d = (((lo + rep_all[r] * (p & M16)) & M16) + p) >> 16
            w93 = fb + d
            w0, w1 = fb[:, 0], fb[:, 1]
            w93[:, 0] = sat16(s16(sat16(s16(w1 + d[:, 1]) - s16(w1)))
                              + s16(w0))
            w93[:, 1] = w1
            eff = s16((scale_all[r] * m) >> 15)[:, band]
            p8 = (s16(lo) * 2 * eff + 0x8000) & 0xFFFFFFFF
            wa = fb + (p8 >> 16)
            wa = torch.where((p8 & M16) == 0, wa & ~1, wa)
            fb = torch.where((k == BANK_93) | (k == BANK_93R), w93,
                             torch.where(k == BANK_93A, wa, fb))
        out[a:b, :256] = (fb & M16).int()
    return out


def session93_pcm_plain(bank, rows, mix, vol_shift, sid, tabs,
                        overlap0=None):
    """Plain version of the decode93_pcm kernel's session instance:
    session93_fb_plain, then transform.transform93_pcm_plain (arguments
    and result as decode93_pcm_plain's).  On the bank of the same columns
    it equals decode93_pcm_plain."""
    fb = session93_fb_plain(bank, rows, mix)
    return tf.transform93_pcm_plain(fb, vol_shift, sid, tabs, overlap0)


def session93_pcm(bank, rows, mix, vol_shift, sid, tabs, overlap0=None):
    """The session bank's rows -> PCM (see session93_pcm_plain): plain
    version for CPU tensors, the CUDA kernel's session instance for CUDA
    tensors."""
    if mix.device.type == "cpu":
        return session93_pcm_plain(bank, rows, mix, vol_shift, sid, tabs,
                                   overlap0)
    return kernels.decode93_pcm_bank(bank["words93"], bank["kind93"], rows,
                                     mix, vol_shift, sid, tabs, overlap0)
