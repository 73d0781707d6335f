// Native host runtime of the port: stream indexing for the 1994+ DCS
// stream family (dcs94_frame_count, dcs94_decode_dense) and the 1993
// family (dcs93_index, dcs93a_index).
//
// A copy of the indexers of dcsexplorer_tpu/native/src/dcs_native.cpp,
// kept in the port so that it builds and loads without the JAX package.
// The walk over the variable-length bitstream is the one serial part of
// the codec; it runs here on the host and yields the per-frame index the
// device decode consumes (ops/prescan.py; format anchors: reference
// DCSDecoderNative.cpp:1679-2261).
//
// Build: native/__init__.py (g++ -O3, plain C interface, ctypes).

#include <stdint.h>
#include <string.h>

#include "dcs_tables.h"

namespace {

struct BitReader {
    // 64-bit left-justified lookahead, refilled 7 bytes at a time (one
    // unaligned big-endian load) — the indexer's whole job is this walk,
    // so the refill path is the hot path.  Invariant: the top `nbits`
    // bits of `buf` are valid, everything below is zero.
    const uint8_t* mem;
    int len;
    int pos;        // next byte to pull
    uint64_t buf;
    int nbits;

    void init(const uint8_t* m, int l, int p) {
        mem = m; len = l; pos = p; buf = 0; nbits = 0;
    }
    inline uint8_t byteAt(int i) const { return i < len ? mem[i] : 0xFF; }
    inline void refill() {
        if (nbits > 56) return;
        if (pos + 8 <= len) {
            uint64_t w;
            memcpy(&w, mem + pos, 8);
            w = __builtin_bswap64(w);
            int nn = nbits | 56;                 // 56..63 valid afterwards
            buf |= w >> nbits;
            buf &= ~0ull << (64 - nn);           // drop the partial 8th byte
            pos += (nn - nbits) >> 3;
            nbits = nn;
        } else {
            while (nbits <= 56) {
                buf |= static_cast<uint64_t>(byteAt(pos)) << (56 - nbits);
                ++pos;
                nbits += 8;
            }
        }
    }
    inline uint32_t peek(int n) {
        if (nbits < n) refill();
        return static_cast<uint32_t>(buf >> 1 >> (63 - n));
    }
    inline uint32_t get(int n) {
        uint32_t v = peek(n);
        nbits -= n;
        buf <<= n;
        return v;
    }
    // advance the cursor without decoding (fixed-width runs)
    inline void skip(int64_t n) {
        if (n <= nbits) {
            nbits -= static_cast<int>(n);
            buf <<= n;
            return;
        }
        n -= nbits;
        pos += static_cast<int>(n >> 3);
        buf = 0;
        nbits = 0;
        int rem = static_cast<int>(n & 7);
        if (rem) get(rem);
    }
    inline int64_t cursor() const {
        return static_cast<int64_t>(pos) * 8 - nbits;
    }
};

// Flat lookup for the 94 band-type delta tree: peek(DEPTH) resolves codes
// of <= DEPTH bits to packed (codeword length << 8) | delta byte; longer
// codes (the rare large deltas — the tree is 23 deep but everything past
// 12 bits is tail) store the interior node to resume the bit-serial walk
// from, flagged by a zero length byte.  Built once from kHuffTree94.
struct DeltaTab94 {
    static const int DEPTH = 12;
    uint16_t tab[1 << DEPTH];

    DeltaTab94() { emit(0, 0, 0); }
    void emit(int node, int bits, int nb) {
        for (int b = 0; b < 2; ++b) {
            int nxt = node + (b ? kHuffTree94[node] : 1);
            int nb2 = nb + 1;
            int bits2 = (bits << 1) | b;
            bool leaf = (kHuffTree94[nxt] & 0x8000) != 0;
            if (leaf || nb2 == DEPTH) {
                uint16_t e = leaf
                    ? static_cast<uint16_t>(0x8000 | (nb2 << 8)
                                            | (kHuffTree94[nxt] & 0xFF))
                    : static_cast<uint16_t>(nxt);   // resume node (bit15=0)
                int lo = bits2 << (DEPTH - nb2);
                int hi = (bits2 + 1) << (DEPTH - nb2);
                for (int i = lo; i < hi; ++i) tab[i] = e;
            } else {
                emit(nxt, bits2, nb2);
            }
        }
    }
};

const DeltaTab94& deltaTab94() {
    static DeltaTab94 t;
    return t;
}

// one band-type delta: table fast path + serial tail for >DEPTH-bit codes
inline int readDelta94(BitReader& bit, const DeltaTab94& dtab) {
    uint16_t e = dtab.tab[bit.peek(DeltaTab94::DEPTH)];
    if (e & 0x8000) {
        bit.get((e >> 8) & 0x7F);
        return (e & 0xFF) - 0x2E;
    }
    bit.get(DeltaTab94::DEPTH);
    int node = e;
    for (;;) {
        uint32_t b = bit.get(1);
        node += b ? kHuffTree94[node] : 1;
        if (kHuffTree94[node] & 0x8000) break;
    }
    return (kHuffTree94[node] & 0xFF) - 0x2E;
}

}  // namespace

extern "C" {

// Read the frame count of a stream (first U16).
int dcs94_frame_count(const uint8_t* mem, int len, int pos) {
    if (pos + 2 > len) return -1;
    return (mem[pos] << 8) | mem[pos + 1];
}

// Index a 1994+ stream and emit dense values + slot controls.
//
// Outputs (caller-allocated, F = frame count):
//   header16      [16]      stream header copy
//   meta          [4]       {fmt_type, sub_type, error_frame, max_symbols}
//   start_bit     [F]       absolute first-sample bit offset (int64)
//   end_bit       [F]       one past the frame's last bit (int64)
//   band_type     [F*16]    absolute band types (post-delta)
//   band_type_prev[F*16]    band types before this frame's deltas
//   dense         [F*256]   sample values (u16 storage, int32)
//   scale         [F*256]   per-slot scale factor
//   fb_idx        [F*256]   frame-buffer target index (int16)
//   valid         [F*256]   1 if the slot holds a decoded sample
//
// Any output pointer may be null to skip it.  Returns 0 on success.
int dcs94_decode_dense(const uint8_t* mem, int len, int pos,
                       uint8_t* header16, int32_t* meta,
                       int64_t* start_bit, int64_t* end_bit,
                       int32_t* band_type, int32_t* band_type_prev,
                       int32_t* dense, int32_t* scale,
                       int16_t* fb_idx, uint8_t* valid) {
    int n_frames = dcs94_frame_count(mem, len, pos);
    if (n_frames < 0) return -1;
    int hdr_pos = pos + 2;

    uint8_t header[16];
    for (int i = 0; i < 16; ++i)
        header[i] = hdr_pos + i < len ? mem[hdr_pos + i] : 0xFF;
    if (header16) memcpy(header16, header, 16);

    int fmt_type = (header[0] & 0x80) >> 7;
    int sub_type = ((header[1] & 0x80) >> 6) | ((header[2] & 0x80) >> 7);
    const int32_t* preadj_map = (sub_type == 0) ? kPreAdj0 : kPreAdj3;

    int n_hdr = 16;
    for (int i = 0; i < 16; ++i) {
        if ((header[i] & 0x7F) == 0x7F) { n_hdr = i; break; }
    }

    BitReader bit;
    bit.init(mem, len, hdr_pos + 16);
    const DeltaTab94& dtab = deltaTab94();
    int bt[16];
    memset(bt, 0, sizeof(bt));
    int error_frame = -1;
    int max_symbols = 0;

    for (int f = 0; f < n_frames; ++f) {
        if (band_type_prev) {
            for (int i = 0; i < 16; ++i) band_type_prev[f * 16 + i] = bt[i];
        }
        int preadj[3] = {0, 0, 0};
        for (int i = 0; i < 3; ++i)
            preadj[i] = preadj_map[bt[i] & 0xF];

        // differential band-type header (flat prefix table, one peek per
        // delta instead of a bit-serial tree walk)
        for (int i = 0; i < n_hdr; ++i)
            bt[i] = (bt[i] + readDelta94(bit, dtab)) & 0xFFFF;
        if (band_type) {
            for (int i = 0; i < 16; ++i) band_type[f * 16 + i] = bt[i];
        }
        if (start_bit) start_bit[f] = bit.cursor();

        int32_t* dv = dense ? dense + f * 256 : nullptr;
        int32_t* sv = scale ? scale + f * 256 : nullptr;
        int16_t* fv = fb_idx ? fb_idx + f * 256 : nullptr;
        uint8_t* vv = valid ? valid + f * 256 : nullptr;
        if (dv) memset(dv, 0, 256 * sizeof(int32_t));
        if (sv) memset(sv, 0, 256 * sizeof(int32_t));
        if (fv) memset(fv, 0, 256 * sizeof(int16_t));
        if (vv) memset(vv, 0, 256);

        int d = 0;        // dense slot index
        int out_idx = 1;  // frame-buffer index
        int n_sym = 0;
        bool ok = true;

        for (int band = 0; band < n_hdr; ++band) {
            int cur_hdr = header[band] & 0x7F;
            int out_count = kBandOutputCount[band];
            int out_inc = 1;
            if (cur_hdr & 0x40) { out_inc = 2; out_count /= 2; }

            int code = bt[band];
            if (code == 0) { out_idx += out_count; continue; }

            int scale_code = cur_hdr;
            if (fmt_type != 0) {
                const int32_t* xlat = band < 3 ? kXlat02
                                     : band < 6 ? kXlat35 : kXlat6F;
                int c15 = code & 0xF;
                if (code > 15 && error_frame < 0) error_frame = f;
                int adj_hdr = cur_hdr + (band < 3 ? preadj[band] : 0);
                scale_code = adj_hdr + xlat[c15 * 2 + 1];
                code = xlat[c15 * 2];
            }
            if (code == 0) {
                if (error_frame < 0) error_frame = f;
                ok = false;
                break;
            }
            int sf = (kScaleMantissa[scale_code & 3]
                      >> (15 - ((scale_code >> 2) & 0xF))) & 0xFFFF;

            if (code <= 6) {
                int ref = 1 << (code - 1);
                int maxw = kMaxBitWidth[code];
                const int32_t* book = kCodebookFlat + kCodebookBase[code];
                for (int i = out_count; i != 0; --i) {
                    int entry = book[bit.peek(maxw)];
                    bit.get(entry >> 8);
                    ++n_sym;
                    if (entry & 0x80) {
                        if (i >= 2) { d += 2; out_idx += 2 * out_inc; --i; }
                        else {
                            if (error_frame < 0) error_frame = f;
                            ok = false;
                            i = 1;
                        }
                    } else {
                        int val = ((entry & 0x7F) - ref) & 0xFFFF;
                        if (dv && d < 256) {
                            dv[d] = val;
                            sv[d] = sf;
                            fv[d] = static_cast<int16_t>(out_idx);
                            vv[d] = 1;
                        }
                        ++d;
                        out_idx += out_inc;
                    }
                }
            } else {
                int w = code <= 17 ? code : 17;
                if (!dv) {
                    // index-only walk: a raw band is a fixed-width run —
                    // advance the cursor in one step
                    bit.skip(static_cast<int64_t>(w) * out_count);
                    d += out_count;
                    out_idx += out_count * out_inc;
                } else {
                    for (int i = 0; i < out_count; ++i) {
                        uint32_t raw = bit.get(w);
                        int val = static_cast<int>(raw);
                        if (val & (1 << (w - 1))) val -= 1 << w;
                        if (d < 256) {
                            dv[d] = val & 0xFFFF;
                            sv[d] = sf;
                            fv[d] = static_cast<int16_t>(out_idx);
                            vv[d] = 1;
                        }
                        ++d;
                        out_idx += out_inc;
                    }
                }
                n_sym += out_count;
            }
            if (!ok) break;
        }

        // Note: "emit two zeros" pairs advance d without setting valid —
        // accumulating a zero sample is an exact no-op, so skipping the
        // store is exact.  Frames flagged in error_frame are rejected by the
        // host loader (they stop the channel in the reference), so their
        // partial contents are never played.

        max_symbols = n_sym > max_symbols ? n_sym : max_symbols;
        if (end_bit) end_bit[f] = bit.cursor();
        (void)ok;
    }

    if (meta) {
        meta[0] = fmt_type;
        meta[1] = sub_type;
        meta[2] = error_frame;
        meta[3] = max_symbols;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// 1993-family stream indexing (OS93a format 0, OS93b formats 0/1, and the
// OS93a Type-1 pair-table format).  Counterparts of ops/decode93.prescan93
// and ops/decode93a.prescan93a; validated field-identically against them.

namespace {

inline int32_t getSigned(BitReader& bit, int n) {
    uint32_t v = bit.get(n);
    return (static_cast<int32_t>(v << (32 - n))) >> (32 - n);
}

// read a 93 band-type Huffman delta; 'invert' codewords flip the subtype
inline int readHuff93(BitReader& bit, int* sub) {
    int32_t ele = kHuffTree93[0];
    for (;;) {
        int b = static_cast<int>(bit.get(1));
        int idx = b ? (ele >> 8) & 0x7F : ele & 0xFF;
        ele = kHuffTree93[idx];
        if (ele & 0x8000) break;
    }
    int val = ele & 0x3F;
    if (val < 0x1E) return val - 0x0F;
    *sub = (*sub != 0) ? 0 : 1;
    return val - 0x2E;
}

enum { K_NONE = 0, K_DATA0 = 1, K_DATA1 = 2, K_DATA2 = 3,
       K_REPEAT = 4, K_RAMP = 5 };

}  // namespace

extern "C" {

// Index a 93-format stream.  Per (frame, band slot 0..15) outputs:
//   kind/width/n_samp/out_start/out_inc/scale/prv_in/prv_dl  [F*16] int32
//   bit_start [F*16] int64;  end_bit [F] int64;  meta[1] = {fmt_type}
int dcs93_index(const uint8_t* mem, int len, int pos, int32_t* meta,
                int32_t* kind, int32_t* width, int32_t* n_samp,
                int64_t* bit_start, int32_t* out_start, int32_t* out_inc,
                int32_t* scale_out, int32_t* prv_in_out, int32_t* prv_dl_out,
                int64_t* end_bit) {
    int F = dcs94_frame_count(mem, len, pos);
    if (F < 0) return -1;
    int hdr_pos = pos + 2;
    auto hdrByte = [&](int i) -> int {
        return hdr_pos + i < len ? mem[hdr_pos + i] : 0xFF;
    };
    int fmt_type = (hdrByte(0) & 0x80) >> 7;
    if (meta) meta[0] = fmt_type;

    BitReader bit;
    bit.init(mem, len, hdr_pos + 16);
    int32_t band_type_acc[16] = {0};

    for (int f = 0; f < F; ++f) {
        int band_sub_type = (fmt_type == 1) ? 0 : 2;
        bool is_first = true;
        int32_t prv_in = 0, prv_dl = 0;
        bool reuse = false;
        int32_t cur_type = 0;
        int out_idx = 1;
        for (int band = 0; band < 16; ++band) {
            int cell = f * 16 + band;
            int cur_hdr = hdrByte(band) & 0x7F;
            if (cur_hdr == 0x7F) break;
            int sf_index = cur_hdr & 3;
            int sf_shift = ((cur_hdr >> 2) & 0xF) - 0xF;
            int stride = cur_hdr >> 6;
            uint32_t mant = static_cast<uint32_t>(kScaleMantissa[sf_index]);
            int32_t scale = static_cast<int32_t>(
                (sf_shift >= 0 ? mant << sf_shift : mant >> -sf_shift)
                & 0xFFFF);

            int n, inc, fix, stride_skip;
            if (fmt_type == 0) {
                if (stride == 0) { n = 16; inc = 1; fix = 0; stride_skip = 16; }
                else { ++out_idx; n = 16; inc = 2; fix = -1; stride_skip = 31; }
            } else {
                if (stride == 0) {
                    n = is_first ? 15 : 16;
                    inc = 1; fix = 0; stride_skip = n;
                } else { n = 8; inc = 2; fix = 0; stride_skip = 8; }
            }

            if (reuse) reuse = bit.get(1) != 0;
            if (!reuse) {
                if (fmt_type == 0) {
                    if (bit.get(1)) {
                        static const int incTab[3] = {1, 2, 0};
                        static const int decTab[3] = {2, 0, 1};
                        band_sub_type = bit.get(1)
                            ? incTab[band_sub_type] : decTab[band_sub_type];
                    }
                    cur_type = static_cast<int32_t>(bit.get(4));
                } else {
                    int delta = readHuff93(bit, &band_sub_type);
                    band_type_acc[band] =
                        (band_type_acc[band] + delta) & 0xFFFF;
                    cur_type = band_type_acc[band];
                }
            }

            if (scale_out) scale_out[cell] = scale;
            if (out_inc) out_inc[cell] = inc;
            if (prv_in_out) prv_in_out[cell] = prv_in;
            if (prv_dl_out) prv_dl_out[cell] = prv_dl;

            if (cur_type == 0) {
                reuse = true;
                if (band_sub_type == 0) {
                    if (kind) kind[cell] = K_NONE;
                    out_idx += stride_skip;
                    prv_in = 0;
                    prv_dl = 0;
                } else if (band_sub_type == 1) {
                    if (kind) kind[cell] = K_REPEAT;
                    if (n_samp) n_samp[cell] = n;
                    if (out_start) out_start[cell] = out_idx;
                    out_idx += n * inc + fix;
                    prv_dl = 0;
                } else {
                    if (kind) kind[cell] = K_RAMP;
                    if (n_samp) n_samp[cell] = n;
                    if (out_start) out_start[cell] = out_idx;
                    out_idx += n * inc + fix;
                    prv_in = (prv_in + n * prv_dl) & 0xFFFF;
                }
            } else {
                int w = cur_type + (fmt_type == 0 ? 1 : 0);
                if (w > 24) return -2;   // garbage width: caller falls back
                if (kind)
                    kind[cell] = (band_sub_type == 0) ? K_DATA0
                        : (band_sub_type == 1) ? K_DATA1 : K_DATA2;
                if (width) width[cell] = w;
                if (n_samp) n_samp[cell] = n;
                if (bit_start) bit_start[cell] = bit.cursor();
                if (out_start) out_start[cell] = out_idx;
                int32_t last = 0, second = 0;
                for (int i = 0; i < n; ++i) {
                    int32_t v = getSigned(bit, w) & 0xFFFF;
                    if (band_sub_type == 0) {
                        second = last;
                        last = v;
                    } else if (band_sub_type == 1) {
                        prv_dl = v;
                        prv_in = (prv_in + v) & 0xFFFF;
                    } else {
                        prv_dl = (prv_dl + v) & 0xFFFF;
                        prv_in = (prv_in + prv_dl) & 0xFFFF;
                    }
                }
                if (band_sub_type == 0) {
                    prv_in = last;
                    prv_dl = (last - second) & 0xFFFF;
                }
                out_idx += n * inc + fix;
            }
            is_first = false;
        }
        if (end_bit) end_bit[f] = bit.cursor();
    }
    return 0;
}

// Index an OS93a Type-1 stream.  Outputs per (frame, band 0..17):
//   bits/scale32 [F*18] int32; bit_start [F*18] int64;
//   end_bit [F] int64; meta[1] = {selector}
int dcs93a_index(const uint8_t* mem, int len, int pos, int32_t* meta,
                 int32_t* bits_out, int64_t* bit_start,
                 int32_t* scale32_out, int64_t* end_bit) {
    int F = dcs94_frame_count(mem, len, pos);
    if (F < 0) return -1;
    int hdr = pos + 2 < len ? mem[pos + 2] : 0xFF;
    int selector = hdr & 0x60;
    int num_bands = hdr & 0x1F;
    if (num_bands > 18) num_bands = 18;
    if (meta) meta[0] = selector;
    int book_base = selector >> 1;

    BitReader bit;
    bit.init(mem, len, pos + 3);

    for (int f = 0; f < F; ++f) {
        int prv_scale_code = 0x1A;
        for (int band = 0; band < num_bands; ++band) {
            int cell = f * 18 + band;
            int look = static_cast<int>(bit.peek(4));
            int band_bits = kOs93aBandBitsBooks[(book_base + look) * 2]
                & 0xFFFF;
            bit.get(static_cast<int>(
                kOs93aBandBitsBooks[(book_base + look) * 2 + 1]));
            if (band_bits == 0xFFFF) break;
            if (band_bits == 0) continue;

            int si = static_cast<int>(bit.peek(4));
            const int32_t* sc = &kOs93aScaleBook[si * 3];
            bit.get(static_cast<int>(sc[1]));
            if ((sc[0] & 0xFFFF) == 0xFFFF) {
                int s2 = static_cast<int>(sc[2]) + static_cast<int>(bit.peek(4));
                sc = &kOs93aScaleBook[s2 * 3];
                bit.get(static_cast<int>(sc[1]) - 4);
            }

            int scale_code = prv_scale_code + static_cast<int>(sc[0]) - 1
                + band_bits * 2;
            if (scale_code > 0x39) scale_code -= 0x36;
            prv_scale_code = scale_code - band_bits * 2;

            int shift = scale_code >> 2;
            int exponent = scale_code & 3;
            uint32_t scale = 0x8000;
            for (int e = 0; e < exponent; ++e)
                scale = (scale * 0x9838u) >> 15;
            scale = static_cast<uint32_t>(
                (static_cast<uint64_t>(scale) << shift) & 0xFFFFFFFFu);

            int n = static_cast<int>(kOs93aInputsPerBand[band]);
            if (bits_out) bits_out[cell] = band_bits;
            if (scale32_out) scale32_out[cell] = static_cast<int32_t>(scale);
            if (bit_start) bit_start[cell] = bit.cursor();
            bit.skip(static_cast<int64_t>(band_bits) * n);
        }
        if (end_bit) end_bit[f] = bit.cursor();
    }
    return 0;
}

}  // extern "C"
