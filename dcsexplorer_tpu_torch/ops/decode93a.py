"""OS93a Type-1 (Judge Dredd) frame decode: the host prescan and the plain
device decode of one voice.

PyTorch counterpart of ``dcsexplorer_tpu/ops/decode93a.py``.  Per band the
stream carries a Huffman bit-width prefix from one of four selector-chosen
codebooks, a two-level scale codeword feeding a wrapping scale-code chain,
then fixed-width samples where EACH input yields TWO outputs through the
pair table (reference: refdec/frames.decompress_frame_93a_type1).  Every
band's output span is static (bands without samples still advance by two
outputs per input), so input j of a frame always lands at words 2j, 2j+1.

Host half (numpy): ``Stream93aIndex``, ``prescan93a`` (native; it raises if
it cannot run), ``prescan93a_python`` (the scalar walker, for the tests),
``frame_base_bits`` and ``index_arrays``.  The decode looks each input's
pair up in the full 2,048-entry table at (2 << width) + 2 * raw, as the
reference decoder does, for every width the codebooks hold (0..9); the
reference package's gather-free lookup covers widths up to 6 only.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..format import tables as T
from ..refdec.bitreader import BitReader, PaddedView
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


def stream_bytes(mem):
    """A stream's bytes (bytes, or a PaddedView's) with 8 bytes of $FF
    after them, as the native walkers read them."""
    return bytes(mem.mem if isinstance(mem, PaddedView) else mem) \
        + b"\xff" * 8


def prescan93a(mem, pos=0):
    """Index the OS93a Type-1 stream at ``mem[pos]`` with the native walker
    (``dcs93a_index``, field-identical to ``prescan93a_python``).  Bytes
    past the stream read as $FF.  Raises on a stream too short for its
    frame count."""
    lib = native.get_lib()
    buf = stream_bytes(mem)
    F = lib.dcs94_frame_count(buf, len(buf), pos)
    if F < 0:
        raise ValueError("stream too short")
    meta = np.zeros(1, dtype=np.int32)
    bits = np.zeros((F, N_BANDS), dtype=np.int32)
    scale32 = np.zeros((F, N_BANDS), dtype=np.int32)
    bit_start = np.zeros((F, N_BANDS), dtype=np.int64)
    end_bit = np.zeros(F, dtype=np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.dcs93a_index(buf, len(buf), pos, p(meta), p(bits), p(bit_start),
                          p(scale32), p(end_bit))
    if rc != 0:
        raise RuntimeError(f"native 93a index failed: {rc}")
    return Stream93aIndex(
        n_frames=F, selector=int(meta[0]), bits=bits.astype(np.int64),
        bit_start=bit_start,
        scale32=scale32.astype(np.int64) & 0xFFFFFFFF, end_bit=end_bit)


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


def inputs93a_plain(pool_u8, arrs, pair):
    """Each input's pair-table values of one voice of the OS93a Type-1
    decode, which do not depend on the mix: (vals [F, 254] (words 2j and
    2j + 1 of input j: pair[(2 << bits) + 2 * raw + k], k = 0, 1), live
    [F, 254] (the word's band has samples)).  arrs as
    decode93a_frames_plain takes them."""
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
    return vals, live.repeat_interleave(2, dim=1)


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
    F = arrs["bits"].shape[0]
    dev = arrs["bits"].device
    vals, live2 = inputs93a_plain(pool_u8, arrs, pair)
    eff = (((arrs["scale32"].long() & 0xFFFFFFFF) >> 16)
           * (mix.long()[:, None] & M16)) >> 15               # [F, 18]
    eff2 = eff[:, torch.from_numpy(IN_BAND).to(dev)].repeat_interleave(
        2, dim=1)
    fb = (torch.zeros((F, 512), dtype=torch.long, device=dev)
          if fb_prev is None else fb_prev.long().clone())
    old = fb[:, :TOTAL_OUT]
    prod = (s16(vals) * s16(eff2)) << 1
    res = (s16(old) << 16) + prod + 0x8000
    res = torch.where((prod & M16) == 0x8000, res & ~0x10000, res)
    fb[:, :TOTAL_OUT] = torch.where(live2, (res >> 16) & M16, old & M16)
    return fb.int()
