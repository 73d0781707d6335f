"""1993 frame decode (93b and OS93a Type-0) over the frame axis, plain
PyTorch, and its scalar prescan.

The benchmark's frozen copy of the port's ``ops/decode93.py`` without the
native walker and the kernel paths: ``Stream93Index`` and
``prescan93_python`` (the walk of every frame's bands: kinds, widths, bit
offsets, layout, scales and the chain values entering each band), then
``index_arrays`` and ``decode93_frames_plain``, one voice of the band
decode into 512-word frame buffers (reference: DCSDecoderNative.cpp
:2293-2615, ReadHuff93 :2618-2684).
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import tables as T
from .bitreader import BitReader, PaddedView
from .decode93a import pool_bits
from .frames import _read_huff93
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


def decode93_frames_plain(pool_u8, arrs, mix, fb_prev=None):
    """One voice of the 93 band decode into frame buffers [F, 512].

    pool_u8 [L] uint8; arrs: the index_arrays fields as tensors ([F, 16]
    each; bit_start absolute in the pool); mix [F]; fb_prev [F, 512] the
    frame buffers so far, or None for silence.  Returns int32 (u16
    storage): each (band, sample) cell's value, chained by its band's kind,
    scaled and mixed into its word (words past 511 are dropped; no two
    cells of a frame share a word), then the saturating first-sample
    fix-up of words 0 and 1.  Placement is a scatter, not the reference's
    compare-reduce."""
    kind, width, n_samp, bit_start, out_start, out_inc, scale, prv_in, \
        prv_dl = (arrs[k].long() for k in (
            "kind", "width", "n_samp", "bit_start", "out_start", "out_inc",
            "scale", "prv_in", "prv_dl"))
    F = kind.shape[0]
    dev = kind.device
    fb = torch.zeros((F, 513), dtype=torch.long, device=dev)
    if fb_prev is not None:
        fb[:, :512] = fb_prev.long()
    outbuf1 = fb[:, 1].clone()

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

    # the exact scale/mix accumulate (reference AddOutput)
    sc = scale[:, :, None] & M16
    mixv = mix.long()[:, None, None] & M16
    fbi = out_start[:, :, None] + i16 * out_inc[:, :, None]
    write = live & (kx != K_NONE) & (fbi >= 0) & (fbi < 512)
    old = torch.gather(fb, 1, fbi.clamp(0, 511).reshape(F, 256))
    old = s16(old.reshape(F, 16, 16))
    scaled = (s16(vals) * sc) & M16
    acc_new = ((((old << 16) | scaled) + s16(scaled) * mixv) >> 16) & M16

    # subtype-1 repeat anomaly, closed form: the product's low word carries
    # across iterations as L_k = (L0 + k*M) mod 2^16 with
    # L0 = low16(prv_in*scale), M = low16(s16(L0)*mix)
    l0 = (s16(p_in) * sc) & M16
    pl = s16(l0)
    l_enter = (l0 + i16 * ((pl * mixv) & M16)) & M16
    rep_new = ((((old << 16) | l_enter) + pl * mixv) >> 16) & M16

    new_val = torch.where(kx == K_REPEAT, rep_new, acc_new)
    # cells that write nothing go to the spare word 512
    fb.scatter_(1, torch.where(write, fbi, 512).reshape(F, 256),
                new_val.reshape(F, 256))

    # first-sample delta fix-up (reference :2608-2611)
    delta = sat16(s16(fb[:, 1]) - s16(outbuf1))
    fb[:, 0] = sat16(s16(delta) + s16(fb[:, 0]))
    fb[:, 1] = outbuf1
    return fb[:, :512].int()


