// Native host runtime of the port: stream indexing for the 1994+ DCS
// stream family (dcs94_frame_count, dcs94_decode_dense).
//
// A copy of the 1994+ part of dcsexplorer_tpu/native/src/dcs_native.cpp,
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
