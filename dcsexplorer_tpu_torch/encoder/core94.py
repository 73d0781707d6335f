"""Integer-canonical setup and host core of the 1994+ stream encoder.

A copy of what the device encoder needs from the JAX package's
``encoder/core94.py``: the codec constants and the code tables inverted from
the decode tables, the canonical quantizer ``rdiv``, the per-stream setup
(band cutoff, header scale codes, thresholds, per-format LUTs) and the
native single-stream search ``encode_stream94``, the port's independent
host reference.  The decisions (decision tables, wrap refinement, band-type
scan, exact sizes) run on the device (``device94.py``), with plain PyTorch
versions beside the kernels.

Every encoding decision is defined over integer quantities derived from
integer-rounded analysis coefficients, so the device and the host emit
byte-identical streams.  (Reference anchor for the decision semantics:
DCSEncoder.cpp:743-956 band cutoff / bit allocation, :1502-1621
FindBestBandEncoding, :784-853 format search.)
"""

from dataclasses import dataclass, field

import numpy as np

from ..format import tables as T

FRAME = 240
RATE = 31250

BAND_SIZES = np.asarray(T.BAND_OUTPUT_COUNT)              # [16], sums to 255
BAND_START = np.concatenate([[0], np.cumsum(BAND_SIZES)])[:16]
NBANDS = 16
NPAD = 32                                                  # padded band width

_SCALE_MANT = np.asarray(T.SCALE_MANTISSA)
_BAND_SHARE = np.asarray([16, 14, 12, 10, 9, 8, 6, 5, 4, 4, 3, 3, 3, 3, 2, 2])

# stream-format candidates in reference search order (DCSEncoder.cpp:784-853)
FORMATS = ((0, 0), (0, 3), (1, 0), (1, 3))


def _scale_factor(code):
    """Decoder scale-factor rule incl. 6-bit wrap semantics
    (DCSDecoderNative.cpp:1978-1979)."""
    return max(int(_SCALE_MANT[code & 3]) >> (15 - ((code >> 2) & 0xF)), 1)


_SCALE64 = np.asarray([_scale_factor(j) for j in range(64)])
# _scale_factor over any int code (vectorized; wraps at 64 like the decoder)
_SCALEANY = _SCALE64

_XLATS = [np.asarray(T.XLAT02), np.asarray(T.XLAT35), np.asarray(T.XLAT6F)]


def _xlat_for(band):
    return _XLATS[0 if band < 3 else 1 if band < 6 else 2]


def rdiv(a, s):
    """Round-half-away-from-zero integer division (the canonical
    quantizer): q = floor((2|a| + s) / 2s), signed.

    |a| ≤ 2^20 and s < 2^16, so every intermediate integer is < 2^24 and
    exactly representable in float32; the f32 division's floor is off by
    at most 1 and r = x − q·y is computed exactly (the true product is an
    integer < 2^24), so one fixup round makes q the exact floor.  It
    equals the integer form floor((2|a| + s) / 2s) that the device
    encoder's plain versions and kernels evaluate (device94.rdiv_int)."""
    a = np.asarray(a)
    x = 2.0 * np.abs(a, dtype=np.float32) + np.asarray(s, np.float32)
    y = np.float32(2.0) * np.asarray(s, dtype=np.float32)
    q = np.floor(x / y)
    r = x - q * y
    q += (r >= y).astype(np.float32) - (r < 0).astype(np.float32)
    return np.where(a < 0, -q, q).astype(np.int32)


# ----------------------------------------------------------------------
# codeword LUTs inverted from the decode tables (shared with device94)

def _invert_codebooks():
    lut_code = np.zeros((7, 64), dtype=np.int32)
    lut_bits = np.zeros((7, 64), dtype=np.int32)
    tz_code = np.zeros(7, dtype=np.int32)
    tz_bits = np.zeros(7, dtype=np.int32)
    for k in range(1, 7):
        flat = np.asarray(T.CODEBOOKS[k])
        maxw = int(T.MAX_BIT_WIDTH[k])
        seen = set()
        for i, e in enumerate(flat):
            e = int(e)
            ln, val = e >> 8, e & 0xFF
            if val & 0x80:
                if tz_bits[k] == 0:
                    tz_code[k], tz_bits[k] = i >> (maxw - ln), ln
            elif (val & 0x7F) not in seen:
                seen.add(val & 0x7F)
                lut_code[k, val & 0x7F] = i >> (maxw - ln)
                lut_bits[k, val & 0x7F] = ln
    return lut_code, lut_bits, tz_code, tz_bits


CB_CODE, CB_BITS, TZ_CODE, TZ_BITS = _invert_codebooks()


def _bits_steps():
    """Codeword lengths as step functions of the stored value.

    For codebook k the length array over the valid values [0, 2^k) is
    piecewise constant with ~a dozen plateaus (short codes cluster around
    the reference value), so bits(v) = b0 + Σ_j d_j·[v ≥ t_j] — a dozen
    compares instead of a 64-way table lookup.  The plain version of the
    size pass (device94.select94_plain) counts codeword lengths this way;
    its kernel looks them up in CB_BITS, so the two forms check each
    other."""
    steps = []
    for k in range(7):
        if k == 0:
            steps.append((0, [], []))
            continue
        arr = CB_BITS[k, :1 << k]
        b0 = int(arr[0])
        ts, ds = [], []
        for v in range(1, 1 << k):
            if arr[v] != arr[v - 1]:
                ts.append(v)
                ds.append(int(arr[v]) - int(arr[v - 1]))
        steps.append((b0, ts, ds))
    jmax = max(len(t) for (_, t, _) in steps)
    b0s = np.asarray([s[0] for s in steps], dtype=np.int32)
    t_tab = np.full((7, jmax), 64, dtype=np.int32)     # 64 = never reached
    d_tab = np.zeros((7, jmax), dtype=np.int32)
    for k, (_, ts, ds) in enumerate(steps):
        t_tab[k, :len(ts)] = ts
        d_tab[k, :len(ds)] = ds
    return b0s, t_tab, d_tab


BITS_B0, BITS_T, BITS_D = _bits_steps()


def _invert_delta_tree():
    tree = np.asarray(T.HUFFTREE94)
    codes = {}

    def walk(node, bits, nbits):
        for b in (0, 1):
            nxt = node + (int(tree[node]) if b else 1)
            v = int(tree[nxt])
            nb = (bits << 1) | b
            if v & 0x8000:
                codes[(v & 0xFF) - 0x2E] = (nb, nbits + 1)
            else:
                walk(nxt, nb, nbits + 1)

    walk(0, 0, 0)
    lo = min(codes)
    val = np.zeros(max(codes) - lo + 1, np.int32)
    bts = np.zeros_like(val)
    for d, (c, nb) in codes.items():
        val[d - lo] = c
        bts[d - lo] = nb
    return lo, val, bts


DELTA_LO, DELTA_VAL, DELTA_BITS = _invert_delta_tree()

# max preadjustment column count across formats (PREADJ3 has 5 distinct)
PMAX = max(len(set(np.asarray(T.PREADJ0).tolist())),
           len(set(np.asarray(T.PREADJ3).tolist())))


# ----------------------------------------------------------------------
# per-stream setup (host, deterministic): band stats → cutoff, header
# scale codes, thresholds, per-format LUTs

@dataclass
class FormatSetup:
    fmt_type: int
    sub_type: int
    hdr_scale: np.ndarray        # [16] int
    header: bytes                # 16-byte stream header
    n_p: int                     # live preadjustment columns (1 or len(P))
    pidx_of_prev: np.ndarray     # [16] int — preadj column for prev code
    w_lut: np.ndarray            # [16, 16, PMAX] width per (band, code, p)
    sf_lut: np.ndarray           # [16, 16, PMAX] scale factor (≥1)
    amax_lut: np.ndarray = None  # [16, 16, PMAX] largest coef that fits
    amin_lut: np.ndarray = None  # [16, 16, PMAX] smallest coef that fits


@dataclass
class StreamSetup:
    n_frames: int
    bands_keep: int
    thr: np.ndarray              # [16] int32 — per-band error sum threshold
    sil_max: int                 # band is silent iff (max-min) <= sil_max
    formats: list = field(default_factory=list)   # [FormatSetup]


def _int_lt_threshold(x):
    """Largest integer d with d < x (for canonical integer comparison
    against a float threshold)."""
    f = int(np.floor(x))
    return f - 1 if f == x else f


def setup94(ci, params, wanted=None):
    """Compute the per-stream setup from canonical coefficients.

    ci: [F, 255] int32.  wanted: iterable of (type, subtype) candidates to
    build (default: all four, filtered by params).  All math here is
    integer or host-float64 scalar — identical for the numpy and device
    paths (both call this on the host).
    """
    F = ci.shape[0]
    ci64 = ci.astype(np.int64)

    # band cutoff by cumulative size-normalized RMS share
    # (reference: DCSEncoder.cpp:743-771)
    energy = np.zeros(16, dtype=np.int64)
    maxabs = np.zeros(16, dtype=np.int64)
    for b in range(16):
        s, n = BAND_START[b], BAND_SIZES[b]
        seg = ci64[:, s:s + n]
        energy[b] = np.sum(seg * seg)
        maxabs[b] = np.abs(seg).max() if F else 0
    rms = np.sqrt(energy / (max(F, 1) * BAND_SIZES))
    total = rms.sum()
    bands_keep = 16
    if total > 0:
        cum = np.cumsum(rms) / total
        over = np.nonzero(cum >= params.power_band_cutoff)[0]
        if over.size:
            bands_keep = int(over[0])
    bands_keep = max(1, min(16, bands_keep))

    # thresholds
    err_ps = (params.maximum_quantization_error * 32768.0) ** 2
    thr = np.minimum(np.floor(err_ps * BAND_SIZES), 2 ** 30).astype(np.int32)
    sil_max = _int_lt_threshold(params.minimum_dynamic_range * 2 * 32768.0)

    st = StreamSetup(n_frames=F, bands_keep=bands_keep, thr=thr,
                     sil_max=sil_max)

    # per-band bit budget → header scale codes (DCSEncoder.cpp:876-956)
    bits_per_frame = params.target_bit_rate / (RATE / FRAME)
    share_norm = int(np.sum(_BAND_SHARE[:bands_keep]
                            * BAND_SIZES[:bands_keep]))
    base_code = np.zeros(16, dtype=np.int64)
    for b in range(bands_keep):
        bits_b = int(_BAND_SHARE[b] / share_norm * bits_per_frame)
        full = int(maxabs[b])
        target = -(-full // (1 << bits_b)) if full > 0 else 1
        # the reference walks codes in ascending order and stops at the
        # first factor >= target, keeping the last smaller one; factors
        # are non-decreasing, so that is searchsorted minus one
        cnt = int(np.searchsorted(_SCALE64, target, side="left"))
        base_code[b] = max(0, cnt - 1)

    if wanted is None:
        wanted = [f for f in FORMATS
                  if (params.stream_format_type < 0
                      or params.stream_format_type == f[0])
                  and (params.stream_format_subtype < 0
                       or params.stream_format_subtype == f[1])]
        if not wanted:
            raise ValueError(
                "No available stream format types match the requested "
                "encoding parameters")

    for (t, sub) in wanted:
        st.formats.append(_format_setup(t, sub, base_code, bands_keep))
    return st


def _format_setup(t, sub, base_code, bands_keep):
    preadj_map = np.asarray(T.PREADJ0 if sub == 0 else T.PREADJ3)
    if t == 1:
        pvals = sorted(set(int(x) for x in preadj_map))
        pidx_of_prev = np.asarray([pvals.index(int(preadj_map[c]))
                                   for c in range(16)], dtype=np.int64)
        n_p = len(pvals)
    else:
        pvals = [0]
        pidx_of_prev = np.zeros(16, dtype=np.int64)
        n_p = 1

    hdr_scale = np.zeros(16, dtype=np.int64)
    for b in range(bands_keep):
        code = int(base_code[b])
        if t == 1:
            adjust = (0x0D if b < 3 else 0x17) + (1 if sub == 0 else 3)
            code = max(0, code - adjust)
        hdr_scale[b] = code

    header = bytearray(16)
    for b in range(16):
        header[b] = int(hdr_scale[b]) if b < bands_keep else 0xFF
    if t != 0:
        header[0] |= 0x80
    header[1] |= (sub & 0x02) << 6
    header[2] |= (sub & 0x01) << 7

    # (band, code, p) → width / scale factor, fully vectorized
    kept = np.arange(16) < bands_keep                        # [16] bands
    codes = np.arange(16)                                    # [16] codes
    pcols = np.asarray([pvals[min(pi, n_p - 1)] for pi in range(PMAX)])
    p_eff = np.zeros((16, PMAX), dtype=np.int64)             # [band, pi]
    if t == 1:
        p_eff[:3] = pcols[None, :]
    if t == 0:
        w = np.broadcast_to(codes[None, :, None], (16, 16, PMAX))
        sc = np.broadcast_to(hdr_scale[:, None, None], (16, 16, PMAX))
    else:
        xl = np.stack([_xlat_for(b) for b in range(16)])     # [16, 16, 2]
        w = np.broadcast_to(xl[:, :, 0][:, :, None], (16, 16, PMAX))
        sc = (hdr_scale[:, None, None] + xl[:, :, 1][:, :, None]
              + p_eff[:, None, :])
    live = kept[:, None, None] & (codes[None, :, None] >= 1)
    w_lut = np.where(live, w, 0).astype(np.int32)
    sf_lut = np.where(live, _SCALEANY[sc & 63], 1).astype(np.int32)

    # coefficient-domain fit window per (band, code, p): the width w can
    # represent quantized values in [-2^(w-1), 2^(w-1)-1], and
    # rdiv(a, sf) <= L  ⟺  a <= (sf·(2L+1) − 1) // 2, so the per-frame
    # fit test reduces to comparing the band min/max against these limits
    half = np.int64(1) << np.maximum(w_lut.astype(np.int64) - 1, 0)
    sf64 = sf_lut.astype(np.int64)
    amax_lut = ((sf64 * (2 * (half - 1) + 1) - 1) // 2).astype(np.int32)
    amin_lut = (-((sf64 * (2 * half + 1) - 1) // 2)).astype(np.int32)
    return FormatSetup(fmt_type=t, sub_type=sub, hdr_scale=hdr_scale,
                       header=bytes(header), n_p=n_p,
                       pidx_of_prev=pidx_of_prev, w_lut=w_lut, sf_lut=sf_lut,
                       amax_lut=amax_lut, amin_lut=amin_lut)


# ----------------------------------------------------------------------
# flat [255]-position helpers: band id, position-within-band, and whether
# the next position is still in the same band (zero runs never cross bands)
BAND_OF = np.repeat(np.arange(16), BAND_SIZES)
POS_IN_BAND = np.concatenate([np.arange(n) for n in BAND_SIZES])
NOT_BAND_LAST = np.concatenate(
    [(np.arange(n) != n - 1) for n in BAND_SIZES])


# wrap-tolerant refinement candidate range: only low codes can ever absorb
# a two's-complement wrap within the error budget (a wrapped sample's
# error is at least (2^w·sf − sf/2)², which exceeds any realistic budget
# once the represented range is wide)
WRAP_CMAX = 6
D_CLAMP = 5793          # per-sample |diff| clamp: 5793² < 2³¹/32


def skip_dup_format(formats):
    """Under the wildcard search, (0,3) is body-identical to (0,0) — for
    type 0 the subtype bits only flip header flags and the pre-adjustment
    tables they select never apply — so when both are candidates the
    search outcome is decided by (0,0) and (0,3) need not be built.  The
    device encoder applies the same rule (byte-identical winners)."""
    pairs = [(f.fmt_type, f.sub_type) for f in formats]
    if (0, 0) in pairs and (0, 3) in pairs:
        return [f for f in formats if (f.fmt_type, f.sub_type) != (0, 3)]
    return list(formats)


def encode_stream94(ci, params):
    """Full single-stream encode from canonical coefficients through the
    native search (native/src/encoder94.cpp): every format candidate,
    keeping the smallest.  Returns the stream bytes; raises if the native
    search fails."""
    from .. import native
    st = setup94(ci, params)
    formats = skip_dup_format(st.formats)
    k, body = native.encode94_search(ci, formats, st.bands_keep, st.thr,
                                     st.sil_max)
    return st.n_frames.to_bytes(2, "big") + formats[k].header + body
