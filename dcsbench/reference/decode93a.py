"""OS93a Type-1 frame decode over the frame axis, plain PyTorch, and its
scalar prescan.

The benchmark's frozen copy of the port's ``ops/decode93a.py`` without the
native walker: ``prescan93a_python`` (per frame and band the bit widths,
bit offsets and 32-bit scales), ``index_arrays`` and
``decode93a_frames_plain`` (reference: DCSDecoderNative.cpp:2698-3032).
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import tables as T
from .bitreader import BitReader, PaddedView
from .fixmath import M16, s16

N_BANDS = 18
INPUTS = np.asarray(T.OS93A_INPUTS_PER_BAND, dtype=np.int64)     # [18]
OUT_BASE = np.concatenate([[0], np.cumsum(2 * INPUTS)])          # [19]
TOTAL_OUT = int(OUT_BASE[-1])                                    # 254
PAIR = np.asarray(T.OS93A_PAIR_TABLE, dtype=np.int64)            # [2048]
MAX_BITS = 9            # the widest band of the band-bits codebooks
# input j of a frame: its band and its index within the band
IN_BAND = np.repeat(np.arange(N_BANDS), INPUTS)                  # [127]
IN_IDX = np.arange(IN_BAND.size) - (OUT_BASE[IN_BAND] >> 1)


@dataclass
class Stream93aIndex:
    n_frames: int
    selector: int
    bits: np.ndarray        # [F,18] sample bit width (0 = skipped band)
    bit_start: np.ndarray   # [F,18] absolute bit offset of first sample
    scale32: np.ndarray     # [F,18] resolved 32-bit scale word
    end_bit: np.ndarray     # [F]


def prescan93a_python(mem, pos=0):
    """The scalar Python walker: the same index as ``prescan93a``.  Nothing
    in the port calls it."""
    mem = PaddedView(mem)
    n_frames = (int(mem[pos]) << 8) | int(mem[pos + 1])
    hdr = int(mem[pos + 2])
    selector = hdr & 0x60
    num_bands = hdr & 0x1F
    bit = BitReader(mem, pos + 3)

    band_books = np.asarray(T.OS93A_BAND_BITS_CODEBOOKS, dtype=np.int64)
    scale_book = np.asarray(T.OS93A_SCALE_CODEBOOK, dtype=np.int64)
    book_base = selector >> 1

    F = n_frames
    idx = Stream93aIndex(
        n_frames=F, selector=selector,
        bits=np.zeros((F, N_BANDS), dtype=np.int64),
        bit_start=np.zeros((F, N_BANDS), dtype=np.int64),
        scale32=np.zeros((F, N_BANDS), dtype=np.int64),
        end_bit=np.zeros(F, dtype=np.int64))

    for f in range(F):
        prv_scale_code = 0x1A
        for band in range(min(num_bands, N_BANDS)):
            ele = band_books[book_base + bit.peek(4)]
            band_bits = int(ele[0]) & M16
            bit.get(int(ele[1]))
            if band_bits == 0xFFFF:
                break
            if band_bits == 0:
                continue

            sc = scale_book[bit.peek(4)]
            bit.get(int(sc[1]))
            if (int(sc[0]) & M16) == 0xFFFF:
                sc = scale_book[int(sc[2]) + bit.peek(4)]
                bit.get(int(sc[1]) - 4)

            scale_code = prv_scale_code + int(sc[0]) - 1 + band_bits * 2
            if scale_code > 0x39:
                scale_code -= 0x36
            prv_scale_code = scale_code - band_bits * 2

            shift = scale_code >> 2
            exponent = scale_code & 3
            scale = 0x8000
            for _ in range(exponent):
                scale = (scale * 0x9838) >> 15
            scale = (scale << shift) & 0xFFFFFFFF

            n = int(INPUTS[band])
            idx.bits[f, band] = band_bits
            idx.scale32[f, band] = scale
            idx.bit_start[f, band] = bit.pos * 8 - bit.nbits
            for _ in range(n):
                bit.get(band_bits)
        idx.end_bit[f] = bit.pos * 8 - bit.nbits
    return idx


def frame_base_bits(idx):
    """Per-frame first-bit offsets (stream-relative); see
    decode93.frame_base_bits."""
    base = np.empty(idx.n_frames, dtype=np.int64)
    base[1:] = idx.end_bit[:-1]
    d0 = idx.bits[0] > 0
    base[0] = idx.bit_start[0][d0].min() if d0.any() else idx.end_bit[0]
    return base


def index_arrays(idx, bit_base=0):
    """Stream93aIndex -> dict of int32 numpy arrays (bit offsets shifted by
    bit_base): frame_word [F], bits, bit_start, scale32 [F, 18]."""
    i32 = lambda a: np.asarray(a).astype(np.int32)
    return {"frame_word": i32((frame_base_bits(idx) + bit_base) >> 5),
            "bits": i32(idx.bits), "bit_start": i32(idx.bit_start + bit_base),
            "scale32": i32(idx.scale32)}


def pool_bits(pool_u8, bit, w):
    """Bits [bit, bit + w) of the byte pool, most significant first, as
    int64 tensors (bit, w broadcast; 0 <= w <= 25).  Bytes past the pool
    read as $FF."""
    n = pool_u8.numel()
    b = (bit >> 3).clamp(min=0)
    word = torch.zeros_like(b)
    for k in range(4):
        i = b + k
        byte = pool_u8[i.clamp(max=n - 1)].long()
        word = (word << 8) | torch.where(i < n, byte, 0xFF)
    return ((word << (bit & 7)) & 0xFFFFFFFF) >> (32 - w)


def decode93a_frames_plain(pool_u8, arrs, mix, pair, fb_prev=None):
    """One voice of the OS93a Type-1 decode into frame buffers [F, 512].

    pool_u8 [L] uint8; arrs: the index_arrays fields as tensors (bits,
    bit_start absolute in the pool, scale32; [F, 18] each); mix [F]; pair
    [2048] the pair table; fb_prev [F, 512] the frame buffers so far, or
    None for silence.  Input j (band b, index i) reads bits[b] bits at
    bit_start[b] + i * bits[b] and folds pair[(2 << bits) + 2 * raw + k],
    k = 0, 1, into words 2j + k: round((old << 16) + (s16(pair) *
    s16(eff)) << 1) with eff = ((scale32 >> 16) * mix) >> 15 and the MAC's
    tie rule.  Words of bands without samples, and words 254..511, keep
    their value.  Returns int32 (u16 storage)."""
    bits = arrs["bits"].long()
    dev = bits.device
    F = bits.shape[0]
    band = torch.from_numpy(IN_BAND).to(dev)
    w = bits[:, band]                                       # [F, 127]
    live = w > 0
    at = arrs["bit_start"].long()[:, band] \
        + torch.from_numpy(IN_IDX).to(dev) * w
    raw = torch.where(live, pool_bits(pool_u8, torch.where(live, at, 0), w),
                      0)
    p = (2 << w) + 2 * raw
    vals = pair.long()[torch.stack([p, p + 1], dim=-1)].reshape(F, TOTAL_OUT)

    eff = (((arrs["scale32"].long() & 0xFFFFFFFF) >> 16)
           * (mix.long()[:, None] & M16)) >> 15               # [F, 18]
    eff2 = eff[:, band].repeat_interleave(2, dim=1)
    live2 = live.repeat_interleave(2, dim=1)
    fb = (torch.zeros((F, 512), dtype=torch.long, device=dev)
          if fb_prev is None else fb_prev.long().clone())
    old = fb[:, :TOTAL_OUT]
    prod = (s16(vals) * s16(eff2)) << 1
    res = (s16(old) << 16) + prod + 0x8000
    res = torch.where((prod & M16) == 0x8000, res & ~0x10000, res)
    fb[:, :TOTAL_OUT] = torch.where(live2, (res >> 16) & M16, old & M16)
    return fb.int()

