"""1993-format stream encoder (OS93a Type 0, OS93b Type 0 and Type 1).

Counterpart of the reference's CompressFrame93b (reference:
DCSEncoder.cpp:2053-2476) driven by this framework's 93 decode grammar
(refdec/frames.py:185-306):

 - per band: three candidate codings — direct samples (subtype 0), deltas
   from the previous input (subtype 1), deltas of deltas (subtype 2, Type 0
   streams only) — with the narrowest acceptable bit width winning;
 - band types are explicit 4-bit codes (Type 0, width = code + 1) or
   frame-to-frame Huffman deltas (Type 1, width = code) where the choice of
   "keep" vs "invert" codeword doubles as the subtype toggle;
 - a band type of 0 enables the 1-bit repeat coding for runs of empty bands;
 - the prv-input/prv-delta state carries ACROSS bands in their unscaled
   integer domain, exactly as the decoder tracks it.

OS93a Type 1 (the Judge Dredd pair-table format) has no encoder, matching
the reference, which also declines to encode it (DCSEncoder.cpp:811-819).

Slots 0/1 of the frame buffer are never transmitted (see
analysis.LIVE_SLOTS93): they feed the decoder's nonlinear element-0
magnitude fixup, and leaving them at zero keeps the analysis linear.

The port's copy of ``dcsexplorer_tpu/encoder/encoder93.py``: the header
and scale decisions here, the quantization, width search and emission in
the native ``encode93_stream`` (native/src/encoder93.cpp), which raises on
failure.  The 1993 family has no device path, in the JAX package either.
"""

import numpy as np

from ..format import tables as T
from .core94 import _BAND_SHARE, _SCALE_MANT
from .encoder import CompressionParams

RATE = 31250
FRAME = 240

SAMPLES93_T0 = [16] * 16
SAMPLES93_T1 = [15] + [16] * 15


def _scale_factor(code):
    """The decoder's scale-factor rule without core94's clamp to 1: the
    header-code search below steps past the codes whose factor is 0."""
    return int(_SCALE_MANT[code & 3]) >> (15 - ((code >> 2) & 0xF))


def _huff93_codes():
    """Invert the 93 band-type tree: (delta, invert_subtype) → (code, nbits).

    Leaf values < 0x1E carry deltas −15..+14 with the subtype kept;
    values ≥ 0x1E carry deltas −16..+15 with the subtype inverted
    (refdec/frames.py:165-182)."""
    tree = np.asarray(T.HUFFTREE93)
    codes = {}

    def walk(idx, bits, nb):
        ele = int(tree[idx])
        if ele & 0x8000:
            v = ele & 0x3F
            key = (v - 0x0F, False) if v < 0x1E else (v - 0x2E, True)
            if key not in codes:
                codes[key] = (bits, nb)
            return
        walk(ele & 0xFF, bits << 1, nb + 1)
        walk((ele >> 8) & 0x7F, (bits << 1) | 1, nb + 1)

    e0 = int(tree[0])
    walk(e0 & 0xFF, 0, 1)
    walk((e0 >> 8) & 0x7F, 1, 1)
    return codes


_HUFF93 = _huff93_codes()


def _huff93_arrays():
    """Flatten the (delta, invert) → (code, nbits) map into the native
    body encoder's table layout: idx = invert*32 + delta + 16."""
    cw = np.full(64, 0, dtype=np.int32)
    nb = np.full(64, -1, dtype=np.int32)
    for (delta, invert), (code, nbits) in _HUFF93.items():
        idx = (32 if invert else 0) + delta + 16
        cw[idx] = code
        nb[idx] = nbits
    return cw, nb


_HUFF93_CW, _HUFF93_NB = _huff93_arrays()


def encode_stream93(coefs, fmt_type, params: CompressionParams,
                    os93a=False):
    """Encode [F, 254] coefficients (fb slots 2..255) into a 93 stream.

    fmt_type 0 → explicit band types (all OS93 software); fmt_type 1 →
    Huffman-delta band types (OS93b / STTNG only).
    """
    if os93a and fmt_type == 1:
        raise ValueError(
            "No encoder is available for OS93a Type 1 streams (the reference "
            "encoder declines them as well)")
    F = coefs.shape[0]
    counts = SAMPLES93_T0 if fmt_type == 0 else SAMPLES93_T1

    # transmit-position layout: position 0 ↔ fb slot 1 (zeroed), positions
    # k ↔ slot k+1; slot 256 (type 0 only) is dead and zeroed
    tx = np.zeros((F, 256), dtype=np.float64)
    tx[:, 1:255] = coefs

    band_start = np.concatenate([[0], np.cumsum(counts)])[:16]

    # --- band cutoff by RMS share (same policy as the 94 encoder)
    rms = np.zeros(16)
    for b in range(16):
        s, n = band_start[b], counts[b]
        rms[b] = np.sqrt(np.mean(tx[:, s:s + n] ** 2))
    total = rms.sum()
    bands_keep = 16
    if total > 0:
        cum = np.cumsum(rms) / total
        over = np.nonzero(cum >= params.power_band_cutoff)[0]
        if over.size:
            bands_keep = int(over[0])
    bands_keep = max(1, min(16, bands_keep))

    # --- header scale codes from the bit-rate allocation
    bits_per_frame = params.target_bit_rate / (RATE / FRAME)
    share_norm = sum(_BAND_SHARE[b] * counts[b] for b in range(bands_keep))
    hdr_scale = [0] * 16
    for b in range(bands_keep):
        bits_b = int(_BAND_SHARE[b] / share_norm * bits_per_frame)
        s, n = band_start[b], counts[b]
        full = float(np.abs(tx[:, s:s + n]).max()) if F else 0.0
        target = int(np.ceil(full / (1 << bits_b))) if full > 0 else 1
        code = 0
        for j in range(64):
            if _scale_factor(j) < target:
                code = j
            else:
                break
        hdr_scale[b] = code

    header = bytearray(16)
    for b in range(16):
        header[b] = hdr_scale[b] if b < bands_keep else 0xFF
    if fmt_type != 0:
        header[0] |= 0x80

    max_err = params.maximum_quantization_error * 32768.0

    from .. import native
    bstart16 = np.zeros(16, dtype=np.int32)
    bstart16[:len(band_start)] = band_start
    counts16 = np.asarray(counts, dtype=np.int32)
    scales16 = np.asarray(
        [float(max(_scale_factor(c), 1)) for c in hdr_scale], np.float64)
    body = native.encode93_stream(tx, fmt_type, bands_keep, counts16,
                                  bstart16, scales16, max_err,
                                  _HUFF93_CW, _HUFF93_NB)
    out = bytearray()
    out += F.to_bytes(2, "big")
    out += header
    out += body
    return bytes(out)
