// A copy of dcsexplorer_tpu/native/src/encoder93.cpp, kept in the port so
// that it builds and loads without the JAX package.  1993-format stream body
// encoder: the C++ form of the frame loop of encoder/encoder93.py
// (encode_stream93).  Counterpart of the reference's CompressFrame93b
// (reference: DCSEncoder.cpp:2053-2476): the header/scale decisions are made
// in Python, and dcs93_encode_stream quantizes, searches each band's
// subtype-0 width and replays the sequential per-frame emission — candidate
// coding in the decoder's unscaled integer domain, band-type bookkeeping
// (explicit 4-bit codes for Type 0, frame-to-frame Huffman deltas for Type
// 1), the 1-bit empty-band repeat coding, and the prv-input/prv-delta chain
// that carries across bands exactly as the decoder tracks it.
//
// Byte-identical to the JAX package's encoder by construction
// (tests/test_torch_compiler.py compares the streams).
//
// Build: native/__init__.py (g++ -O3 -ffp-contract=off, plain C interface,
// ctypes).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct BitW {
    uint8_t *out;
    int64_t cap, n;
    // 64-bit accumulator: the Type-1 band-code Huffman tree has codewords up
    // to 30 bits, and up to 7 residual bits can be pending, so a 32-bit
    // accumulator overflows on `acc << bw` (37 bits needed).
    uint64_t acc;
    int nbits;
    bool ok;

    BitW(uint8_t *o, int64_t c)
        : out(o), cap(c), n(0), acc(0), nbits(0), ok(true) {}

    inline void write(uint32_t val, int bw) {
        const uint32_t m = (bw >= 32) ? 0xFFFFFFFFu : ((1u << bw) - 1u);
        acc = (acc << bw) | (uint64_t)(val & m);
        nbits += bw;
        while (nbits >= 8) {
            nbits -= 8;
            if (n >= cap) { ok = false; return; }
            out[n++] = (uint8_t)((acc >> nbits) & 0xFF);
        }
        acc &= ((uint64_t)1 << nbits) - 1;
    }

    inline int64_t finish() {
        if (!ok) return -1;
        if (nbits) {
            if (n >= cap) return -1;
            out[n++] = (uint8_t)((acc << (8 - nbits)) & 0xFF);
        }
        return n;
    }
};

static inline int64_t w16s(int64_t x) {
    return ((x + 0x8000) & 0xFFFF) - 0x8000;
}

// Explicit round-half-to-even, matching numpy's np.round/np.rint semantics
// unconditionally — std::nearbyint follows the ambient FP rounding mode, so a
// library calling fesetround() would silently break the byte-identity
// contract with the JAX package's numpy encoder.  Exact for |x| < 2^52 (always true here:
// coefficients are 16-bit-scale, scales >= 1).
static inline int64_t round_half_even_i64(double x) {
    const double fl = std::floor(x);
    const double diff = x - fl;
    if (diff > 0.5) return (int64_t)fl + 1;
    if (diff < 0.5) return (int64_t)fl;
    const int64_t i = (int64_t)fl;
    return (i & 1) ? i + 1 : i;
}

// narrowest band code whose 2's-complement width fits all values
// (encoder93._delta_band_code)
static inline int delta_band_code(const int64_t *vals, int n, int fmt_type) {
    int64_t hi = 0;
    for (int i = 0; i < n; i++) {
        int64_t v = vals[i];
        if (v > hi) hi = v;
        if (-v > hi) hi = -v;
    }
    if (hi == 0) return 0;
    int nbits = 1;
    while (hi != 0) { hi >>= 1; nbits++; }
    return nbits - (fmt_type == 0 ? 1 : 0);
}

}  // namespace

extern "C" int64_t dcs93_encode_body(
    const int64_t *q0,        // [F * 256] quantized samples, transmit layout
    int F, int fmt_type, int bands_keep,
    const int32_t *counts,    // [16] samples per band
    const int32_t *bstart,    // [16] transmit-position band starts
    const int32_t *best_full, // [16 * F] subtype-0 code, full 1..15 range
    const int32_t *best_no15, // [16 * F] subtype-0 code, range 1..14
    const uint8_t *allzero,   // [16 * F] subtype-0 band is entirely zero
    const int32_t *huff_cw,   // [64] Type-1 codeword: idx = invert*32+delta+16
    const int32_t *huff_nb,   // [64] Type-1 codeword bit count (-1 = absent)
    uint8_t *out, int64_t cap) {
    BitW w(out, cap);
    int frame_codes[16] = {0};
    int64_t buf1[16], buf2[16];

    for (int f = 0; f < F; f++) {
        int last_code = -1;
        int last_sub = (fmt_type == 1) ? 0 : 2;
        int64_t prv_sample = 0, prv_delta = 0;
        const int64_t *qf = q0 + (int64_t)f * 256;

        for (int b = 0; b < bands_keep; b++) {
            const int n = counts[b];
            const int64_t *buf0 = qf + bstart[b];

            // candidate codings in the decoder's unscaled integer domain
            {
                int64_t ps = prv_sample, pd = prv_delta;
                for (int i = 0; i < n; i++) {
                    int64_t cur = buf0[i];
                    buf1[i] = cur - ps;
                    buf2[i] = cur - ps - pd;
                    pd = buf1[i];
                    ps = cur;
                }
            }
            const int64_t prv_frame_sample = prv_sample;
            const int64_t prv_frame_delta = prv_delta;

            // code_range(0): Type 1 limits subtype-0 codes reachable from
            // the previous frame's code under the chosen codeword family
            int code0;
            int hi0 = 15;
            if (fmt_type != 0)
                hi0 = frame_codes[b] + (last_sub == 0 ? 14 : 15);
            if (hi0 <= 14)
                code0 = best_no15[(int64_t)b * F + f];
            else
                code0 = best_full[(int64_t)b * F + f];
            int code1 = delta_band_code(buf1, n, fmt_type);
            int code2 = delta_band_code(buf2, n, fmt_type);
            if (allzero[(int64_t)b * F + f]) code0 = 0;

            int new_code = code0, new_sub = 0;
            if (code1 < new_code || (code1 == new_code && last_sub == 1)) {
                new_code = code1;
                new_sub = 1;
            }
            if (fmt_type == 0 && code2 < new_code) {
                new_code = code2;
                new_sub = 2;
            }
            if (fmt_type != 0) {
                // respect the delta range the chosen codeword family spans
                int lo, hi;
                if (new_sub == last_sub) {
                    lo = frame_codes[b] - 15;
                    hi = frame_codes[b] + 14;
                } else {
                    lo = frame_codes[b] - 16;
                    hi = frame_codes[b] + 15;
                }
                if (new_code < 0) new_code = 0;
                if (new_code > hi) new_code = hi;
                if (new_code < lo) new_code = lo;
            }
            if (new_code < 0) new_code = 0;
            if (new_code > 15) new_code = 15;

            if (last_code == 0 && new_code == 0 && new_sub == last_sub) {
                w.write(1, 1);  // repeat the empty band
            } else {
                if (last_code == 0) w.write(0, 1);  // not repeating
                if (fmt_type == 0) {
                    if (new_sub == last_sub) {
                        w.write(0, 1);
                    } else {
                        w.write(1, 1);
                        int inc = (((new_sub - last_sub) % 3 + 3) % 3) == 1;
                        w.write(inc ? 1 : 0, 1);
                    }
                    w.write((uint32_t)new_code, 4);
                } else {
                    int invert = (new_sub != last_sub) ? 1 : 0;
                    int delta = new_code - frame_codes[b];
                    int idx = invert * 32 + delta + 16;
                    if (idx < 0 || idx >= 64 || huff_nb[idx] < 0) return -2;
                    w.write((uint32_t)huff_cw[idx], huff_nb[idx]);
                    frame_codes[b] = new_code;
                }

                if (new_code == 0) {
                    // empty band: update prv state per subtype semantics
                    if (new_sub == 0) {
                        prv_sample = 0;
                        prv_delta = 0;
                    } else if (new_sub == 1) {
                        prv_sample = prv_frame_sample;
                        prv_delta = 0;
                    } else {
                        prv_sample = prv_frame_sample;
                        prv_delta = prv_frame_delta;
                    }
                } else {
                    const int width = new_code + (fmt_type == 0 ? 1 : 0);
                    const uint32_t mask = (1u << width) - 1;
                    const int64_t *buf =
                        (new_sub == 0) ? buf0 : (new_sub == 1) ? buf1 : buf2;
                    const int64_t lim = (int64_t)1 << (width - 1);
                    // track what the decoder reconstructs (s16 wrap domain)
                    int64_t ps = prv_frame_sample, pd = prv_frame_delta;
                    for (int i = 0; i < n; i++) {
                        int64_t v = buf[i];
                        if (v < -lim) v = -lim;
                        if (v > lim - 1) v = lim - 1;
                        w.write((uint32_t)(v & mask), width);
                        if (new_sub == 0) {
                            pd = w16s(v - ps);
                            ps = v;
                        } else if (new_sub == 1) {
                            pd = v;
                            ps = w16s(ps + v);
                        } else {
                            pd = w16s(pd + v);
                            ps = w16s(ps + pd);
                        }
                    }
                    prv_sample = ps;
                    prv_delta = pd;
                }
            }
            if (!w.ok) return -1;

            last_code = new_code;
            last_sub = new_sub;
        }
    }
    return w.finish();
}

// Full-stream entry: quantization + the subtype-0 width search + the
// emission loop in one call.  Replicates the JAX package's numpy precompute
// (its encoder/encoder93.py) bit for bit: q0 = round-half-even(seg/scale)
// (explicit, independent of the FP environment — see round_half_even_i64),
// and the per-width error sum accumulates doubles
// sequentially in sample order — the same order numpy's add.reduce uses
// over the middle axis of the [F, n, widths] error tensor.  Decision
// identity (first passing width, else first arg-min) is fuzz-checked
// against that numpy precompute in tests/test_format93.py.
extern "C" int64_t dcs93_encode_stream(
    const double *tx,         // [F * 256] transmit-position coefficients
    int F, int fmt_type, int bands_keep,
    const int32_t *counts,    // [16]
    const int32_t *bstart,    // [16]
    const double *scales,     // [16] max(scale_factor(hdr_scale[b]), 1)
    double max_err,
    const int32_t *huff_cw, const int32_t *huff_nb,
    uint8_t *out, int64_t cap) {
    std::vector<int64_t> q0all((size_t)F * 256, 0);
    std::vector<int32_t> best_full((size_t)16 * F, 0);
    std::vector<int32_t> best_no15((size_t)16 * F, 0);
    std::vector<uint8_t> allzero((size_t)16 * F, 0);

    for (int b = 0; b < bands_keep; b++) {
        const int s = bstart[b], n = counts[b];
        const double scale = scales[b];
        const double thr = max_err * max_err * (double)n;
        for (int f = 0; f < F; f++) {
            const double *seg = tx + (int64_t)f * 256 + s;
            int64_t *q0 = q0all.data() + (int64_t)f * 256 + s;
            bool az = true;
            for (int i = 0; i < n; i++) {
                q0[i] = round_half_even_i64(seg[i] / scale);
                if (q0[i] != 0) az = false;
            }
            allzero[(size_t)b * F + f] = az ? 1 : 0;

            double err[15];
            for (int w = 0; w < 15; w++) {
                const int width = (w + 1) + (fmt_type == 0 ? 1 : 0);
                const int64_t ref = (int64_t)1 << (width - 1);
                const int64_t mask = ((int64_t)1 << width) - 1;
                double e = 0.0;
                for (int i = 0; i < n; i++) {
                    const int64_t stored = (q0[i] + ref) & mask;
                    const double recon = (double)(stored - ref) * scale;
                    const double d = recon - seg[i];
                    e += d * d;
                }
                err[w] = e;
            }
            // first passing width, else the first arg-min (numpy argmax
            // over ok / argmin over err semantics)
            auto pick = [&](int m) {
                int first_ok = -1, amin = 0;
                for (int w = 0; w < m; w++) {
                    if (first_ok < 0 && err[w] <= thr) first_ok = w;
                    if (err[w] < err[amin]) amin = w;
                }
                return (first_ok >= 0 ? first_ok : amin) + 1;
            };
            best_full[(size_t)b * F + f] = pick(15);
            best_no15[(size_t)b * F + f] = pick(14);
        }
    }
    return dcs93_encode_body(q0all.data(), F, fmt_type, bands_keep, counts,
                             bstart, best_full.data(), best_no15.data(),
                             allzero.data(), huff_cw, huff_nb, out, cap);
}
