// MPEG-1 Audio Layer III decoder — from-scratch implementation of the
// ISO/IEC 11172-3 decoding model, written for the encoder's audio-input
// path (counterpart of the reference's libnyquist MP3 support,
// reference: DCSEncoder/DCSEncodeFile.cpp:55-59).
//
// Format constants (Huffman codebooks in canonical form, scalefactor band
// widths, and the composite synthesis-filterbank response) come from
// mp3_tables.h, extracted by native/gen_mp3_tables.py; see that script
// for provenance.  Everything else — bitstream walk, side info, bit
// reservoir, scalefactors, requantization, stereo modes, antialiasing,
// IMDCT (direct O(n²) with analytic windows), and the FIR-form synthesis
// filterbank — is implemented here from the standard's decoding model.
//
// Scope: MPEG-1 Layer III (32/44.1/48 kHz, mono/stereo, all block types,
// MS and intensity stereo, bit reservoir).  MPEG-2/2.5 LSF extensions are
// rejected with a clear error.
//
// Output convention matches the extracted synthesis response: float PCM
// in [-1, 1], converted to int16 at the API boundary.

#include <cmath>
#include <cstdint>
#include <cstring>

#include "mp3_tables.h"

namespace {

// ----------------------------------------------------------------------
// bit reader (MSB first)

struct Bits {
    const uint8_t* p = nullptr;
    int64_t len = 0;          // bytes
    int64_t pos = 0;          // bits

    void init(const uint8_t* data, int64_t bytes, int64_t bitpos = 0) {
        p = data;
        len = bytes;
        pos = bitpos;
    }
    uint32_t peek(int n) const {        // n <= 24
        int64_t byte = pos >> 3;
        uint32_t v = 0;
        for (int k = 0; k < 4; k++) {
            v = (v << 8) | (byte + k < len ? p[byte + k] : 0);
        }
        return (v << (pos & 7)) >> (32 - n);
    }
    uint32_t get(int n) {
        uint32_t v = peek(n);
        pos += n;
        return v;
    }
};

// ----------------------------------------------------------------------
// frame header

struct Header {
    int sample_rate, bitrate, channels, mode, mode_ext, padding, crc;
    int frame_bytes;
};

const int kBitrates[15] = {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160,
                           192, 224, 256, 320};
const int kRates[3] = {44100, 48000, 32000};

// Parse an MPEG-1 Layer III header at p (needs 4 bytes).  Returns false
// if not a valid/supported frame.
bool parse_header(const uint8_t* p, Header* h) {
    if (p[0] != 0xFF || (p[1] & 0xE0) != 0xE0) return false;
    int version = (p[1] >> 3) & 3;      // 3 = MPEG-1
    int layer = (p[1] >> 1) & 3;        // 1 = Layer III
    if (version != 3 || layer != 1) return false;
    int br = (p[2] >> 4) & 15;
    int sr = (p[2] >> 2) & 3;
    if (br == 0 || br == 15 || sr == 3) return false;   // free format: no
    h->crc = !(p[1] & 1);
    h->bitrate = kBitrates[br] * 1000;
    h->sample_rate = kRates[sr];
    h->padding = (p[2] >> 1) & 1;
    h->mode = (p[3] >> 6) & 3;          // 0 stereo 1 joint 2 dual 3 mono
    h->mode_ext = (p[3] >> 4) & 3;
    h->channels = (h->mode == 3) ? 1 : 2;
    h->frame_bytes = 144 * h->bitrate / h->sample_rate + h->padding;
    return h->frame_bytes >= 24;
}

inline bool is_ms(const Header& h) { return h.mode == 1 && (h.mode_ext & 2); }
inline bool is_intensity(const Header& h) {
    return h.mode == 1 && (h.mode_ext & 1);
}
inline int sr_index(const Header& h) {
    // row into the scalefactor band tables (MPEG-1 rows are 5/6/7)
    return h.sample_rate == 44100 ? 5 : h.sample_rate == 48000 ? 6 : 7;
}

// ----------------------------------------------------------------------
// side info

struct Granule {
    int part_23_length, big_values, global_gain, scalefac_compress;
    int window_switching, block_type, mixed_block_flag;
    int table_select[3], subblock_gain[3];
    int region_count[3];                // sfb counts per region
    int preflag, scalefac_scale, count1_table;
    int scfsi;
    const uint8_t* sfbtab;              // band widths (0-terminated)
    int n_long_sfb, n_short_sfb;
};

bool read_side_info(Bits* bs, Granule gr[4], const Header& h,
                    int* main_data_begin) {
    int nch = h.channels;
    *main_data_begin = bs->get(9);
    bs->get(nch == 1 ? 5 : 3);          // private bits
    int scfsi[2] = {0, 0};
    for (int ch = 0; ch < nch; ch++) scfsi[ch] = bs->get(4);

    for (int grx = 0; grx < 2; grx++) {
        for (int ch = 0; ch < nch; ch++) {
            Granule* g = &gr[grx * nch + ch];
            g->part_23_length = bs->get(12);
            g->big_values = bs->get(9);
            if (g->big_values > 288) return false;
            g->global_gain = bs->get(8);
            g->scalefac_compress = bs->get(4);
            g->sfbtab = mp3tab::kScfLong + sr_index(h) * 23;
            g->n_long_sfb = 22;
            g->n_short_sfb = 0;
            g->window_switching = bs->get(1);
            if (g->window_switching) {
                g->block_type = bs->get(2);
                if (g->block_type == 0) return false;
                g->mixed_block_flag = bs->get(1);
                g->region_count[0] = 7;
                g->region_count[1] = 255;
                g->region_count[2] = 255;
                if (g->block_type == 2) {
                    if (!g->mixed_block_flag) {
                        g->region_count[0] = 8;
                        g->sfbtab = mp3tab::kScfShort + sr_index(h) * 40;
                        g->n_long_sfb = 0;
                        g->n_short_sfb = 39;
                    } else {
                        g->sfbtab = mp3tab::kScfMixed + sr_index(h) * 40;
                        g->n_long_sfb = 8;
                        g->n_short_sfb = 30;
                    }
                }
                g->table_select[0] = bs->get(5);
                g->table_select[1] = bs->get(5);
                g->table_select[2] = 0;
                for (int w = 0; w < 3; w++) g->subblock_gain[w] = bs->get(3);
            } else {
                g->block_type = 0;
                g->mixed_block_flag = 0;
                for (int r = 0; r < 3; r++) g->table_select[r] = bs->get(5);
                g->region_count[0] = bs->get(4);
                g->region_count[1] = bs->get(3);
                g->region_count[2] = 255;
                for (int w = 0; w < 3; w++) g->subblock_gain[w] = 0;
            }
            g->preflag = bs->get(1);
            g->scalefac_scale = bs->get(1);
            g->count1_table = bs->get(1);
            // scfsi applies to granule 1, long blocks only
            g->scfsi = (grx == 1 && g->block_type != 2) ? scfsi[ch] : 0;
        }
    }
    return true;
}

// ----------------------------------------------------------------------
// scalefactors

const uint8_t kSlen1[16] = {0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4};
const uint8_t kSlen2[16] = {0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3};

// quarter-power scale: 2^(-q/4)
inline double qpow(int q) { return std::pow(2.0, -0.25 * (double)q); }

// Read/derive the per-band scale values for one granule+channel.
// iscf_out additionally receives the raw integer scalefactors (intensity
// positions for the right channel).  prev_iscf carries granule 0's
// scalefactors for scfsi sharing.
void decode_scalefactors(const Header& h, const Granule& g, Bits* bs,
                         int iscf[40], int prev_iscf[40], float scf[40],
                         bool ms_active) {
    int slen1 = kSlen1[g.scalefac_compress];
    int slen2 = kSlen2[g.scalefac_compress];
    int n = 0;
    for (int i = 0; i < 40; i++) iscf[i] = 0;

    if (g.n_short_sfb == 0) {
        // long blocks: scfsi groups {0-5, 6-10, 11-15, 16-20}
        static const int kGroup[4][2] = {{0, 6}, {6, 11}, {11, 16}, {16, 21}};
        for (int grp = 0; grp < 4; grp++) {
            int bits = grp < 2 ? slen1 : slen2;
            bool share = (g.scfsi >> (3 - grp)) & 1;
            for (int i = kGroup[grp][0]; i < kGroup[grp][1]; i++) {
                iscf[i] = share ? prev_iscf[i] : (bits ? (int)bs->get(bits) : 0);
            }
        }
        iscf[21] = 0;
        n = 21;
    } else if (g.n_long_sfb == 0) {
        // short: sfb 0-5 slen1 (18 values), 6-11 slen2 (18 values)
        for (int i = 0; i < 18; i++) iscf[i] = slen1 ? (int)bs->get(slen1) : 0;
        for (int i = 18; i < 36; i++) iscf[i] = slen2 ? (int)bs->get(slen2) : 0;
        iscf[36] = iscf[37] = iscf[38] = 0;
        n = 36;
    } else {
        // mixed: 8 long + 9 short with slen1, 18 short with slen2
        for (int i = 0; i < 17; i++) iscf[i] = slen1 ? (int)bs->get(slen1) : 0;
        for (int i = 17; i < 35; i++) iscf[i] = slen2 ? (int)bs->get(slen2) : 0;
        iscf[35] = iscf[36] = iscf[37] = 0;
        n = 35;
    }
    for (int i = 0; i < 40; i++) prev_iscf[i] = iscf[i];

    int shift = g.scalefac_scale + 1;
    int adj[40];
    for (int i = 0; i < 40; i++) adj[i] = iscf[i];
    if (g.n_short_sfb) {
        // fold subblock gain: quarter-steps of 8·subblock_gain
        int sh = 3 - shift;
        for (int i = 0; i < g.n_short_sfb; i += 3) {
            adj[g.n_long_sfb + i + 0] += g.subblock_gain[0] << sh;
            adj[g.n_long_sfb + i + 1] += g.subblock_gain[1] << sh;
            adj[g.n_long_sfb + i + 2] += g.subblock_gain[2] << sh;
        }
    } else if (g.preflag) {
        static const uint8_t kPre[10] = {1, 1, 1, 1, 2, 2, 3, 3, 3, 2};
        for (int i = 0; i < 10; i++) adj[11 + i] += kPre[i];
    }

    // gain in quarter-powers of two; the -4 matches the extracted
    // synthesis response's scale, the -2 is the M/S 1/sqrt(2)
    int gain_q = -(g.global_gain - 210 - 4 - (ms_active ? 2 : 0));
    int nb = g.n_long_sfb + g.n_short_sfb;
    for (int i = 0; i < nb + 3 && i < 40; i++) {
        scf[i] = (float)qpow(gain_q + (adj[i] << shift));
    }
    (void)n;
}

// ----------------------------------------------------------------------
// Huffman decode + requantization

struct HuffLut {
    // first level: 10-bit direct lookup → (len<<8 | x<<4 | y); 0 = long code
    uint16_t lut[1024];
    const mp3tab::HuffEntry* longs;     // codes with len > 10
    int n_longs;
};

HuffLut g_lut[32];
bool g_lut_ready = false;

void build_luts() {
    static mp3tab::HuffEntry longbuf[
        sizeof(mp3tab::kBigValue) / sizeof(mp3tab::kBigValue[0])];
    int nlong = 0;
    for (int t = 0; t < 32; t++) {
        HuffLut* L = &g_lut[t];
        std::memset(L->lut, 0, sizeof L->lut);
        L->longs = longbuf + nlong;
        L->n_longs = 0;
        for (int e = mp3tab::kBigValueOffset[t];
             e < mp3tab::kBigValueOffset[t + 1]; e++) {
            const mp3tab::HuffEntry& he = mp3tab::kBigValue[e];
            if (he.len <= 10) {
                uint32_t base = he.code << (10 - he.len);
                for (uint32_t k = 0; k < (1u << (10 - he.len)); k++) {
                    L->lut[base + k] =
                        (uint16_t)((he.len << 8) | (he.x << 4) | he.y);
                }
            } else {
                longbuf[nlong + L->n_longs++] = he;
            }
        }
        nlong += L->n_longs;
    }
    g_lut_ready = true;
}

inline double pow43(int x) { return std::pow((double)x, 4.0 / 3.0); }

// Decode one granule+channel's spectrum into xr[576].
// Returns false on a malformed stream.
bool huffman_decode(float xr[576], Bits* bs, const Granule& g,
                    const float scf[40], int64_t limit_bits) {
    int pos = 0;
    const uint8_t* sfb = g.sfbtab;
    int sfb_idx = 0;                    // next band to enter
    int big = g.big_values;             // signed pair budget (can overshoot)
    float one = 0.0f;
    std::memset(xr, 0, 576 * sizeof(float));

    for (int region = 0; region < 3 && big > 0; region++) {
        int tab = g.table_select[region];
        int count = g.region_count[region];
        const HuffLut& L = g_lut[tab];
        int linbits = mp3tab::kLinbits[tab];
        bool has_codes = mp3tab::kBigValueOffset[tab + 1] >
                         mp3tab::kBigValueOffset[tab];
        do {
            int np = sfb[sfb_idx] / 2;
            one = scf[sfb_idx];
            sfb_idx++;
            int pairs = np < big ? np : big;
            while (pairs-- > 0) {
                int x = 0, y = 0;
                if (has_codes) {
                    uint32_t look = bs->peek(10);
                    uint16_t hit = L.lut[look];
                    if (hit) {
                        bs->pos += hit >> 8;
                        x = (hit >> 4) & 15;
                        y = hit & 15;
                    } else {
                        uint32_t look19 = bs->peek(19);
                        int li;
                        for (li = 0; li < L.n_longs; li++) {
                            const mp3tab::HuffEntry& he = L.longs[li];
                            if ((look19 >> (19 - he.len)) == he.code) {
                                bs->pos += he.len;
                                x = he.x;
                                y = he.y;
                                break;
                            }
                        }
                        if (li == L.n_longs) return false;
                    }
                }
                int vals[2] = {x, y};
                for (int j = 0; j < 2; j++, pos++) {
                    int v = vals[j];
                    if (v == 15 && linbits) v += bs->get(linbits);
                    if (v) {
                        float mag = (float)(pow43(v) * one);
                        xr[pos] = bs->get(1) ? -mag : mag;
                    }
                }
            }
            big -= np;                  // full band, even if partly decoded
        } while (big > 0 && --count >= 0 && sfb[sfb_idx] && pos < 576);
    }

    // count1 region: quads of ±1, continuing inside the current band
    // (big ≤ 0 here; -big = pairs left in the band the big values ended in)
    int np_left = 1 - big;
    while (pos <= 572) {
        int quad;
        if (g.count1_table) {
            quad = 15 - (int)bs->get(4);    // table B: value = ~code
        } else {
            uint32_t look = bs->peek(6);
            int li;
            quad = -1;
            for (li = 0; li < 16; li++) {
                const mp3tab::HuffEntry& he = mp3tab::kCount1A[li];
                if ((look >> (6 - he.len)) == he.code) {
                    bs->pos += he.len;
                    quad = he.x;
                    break;
                }
            }
            if (quad < 0) return false;
        }
        if (bs->pos > limit_bits) break;
        // quad bits are [v w x y] from MSB; band scale advances per pair
        bool ended = false;
        for (int half = 0; half < 2 && !ended; half++) {
            if (!--np_left) {
                np_left = sfb[sfb_idx] / 2;
                if (!np_left) {
                    ended = true;
                    break;
                }
                one = scf[sfb_idx];
                sfb_idx++;
            }
            for (int s = 2 * half; s < 2 * half + 2; s++, pos++) {
                if (quad & (8 >> s)) {
                    xr[pos] = bs->get(1) ? -one : one;
                }
            }
        }
        if (ended) break;
    }
    bs->pos = limit_bits;
    return true;
}

// ----------------------------------------------------------------------
// stereo

void midside(float* left, float* right, int n) {
    for (int i = 0; i < n; i++) {
        float a = left[i], b = right[i];
        left[i] = a + b;
        right[i] = a - b;
    }
}

void intensity_process(float* left, float* right, const int ist_pos[40],
                       const Granule gr1[2], const Header& h) {
    const Granule& g = gr1[1];          // right channel granule
    int n_sfb = g.n_long_sfb + g.n_short_sfb;
    // find the highest band with right-channel energy, per window
    int max_band[3] = {-1, -1, -1};
    {
        const float* r = right;
        for (int i = 0; i < n_sfb; i++) {
            int wdt = g.sfbtab[i];
            for (int k = 0; k < wdt; k += 2) {
                if (r[k] != 0 || (k + 1 < wdt && r[k + 1] != 0)) {
                    max_band[i % 3] = i;
                    break;
                }
            }
            r += wdt;
        }
    }
    int max_blocks = g.n_short_sfb ? 3 : 1;
    if (g.n_long_sfb) {
        int m = max_band[0];
        if (max_band[1] > m) m = max_band[1];
        if (max_band[2] > m) m = max_band[2];
        max_band[0] = max_band[1] = max_band[2] = m;
    }
    // positions for the top bands default to 3 (45°) unless the previous
    // band in the same window carries one
    int ipos[40];
    for (int i = 0; i < 40; i++) ipos[i] = ist_pos[i];
    for (int i = 0; i < max_blocks; i++) {
        int itop = n_sfb - max_blocks + i;
        int prev = itop - max_blocks;
        ipos[itop] = max_band[i] >= prev ? 3 : ipos[prev];
    }

    float s = is_ms(h) ? 1.41421356f : 1.0f;
    float* l = left;
    float* r = right;
    for (int i = 0; g.sfbtab[i]; i++) {
        int wdt = g.sfbtab[i];
        if (i > max_band[i % 3] && ipos[i] < 7) {
            float kl, kr;
            if (ipos[i] == 6) {
                kl = 1.0f;
                kr = 0.0f;
            } else {
                float ratio = std::tan(ipos[i] * (float)M_PI / 12.0f);
                kl = ratio / (1.0f + ratio);
                kr = 1.0f / (1.0f + ratio);
            }
            for (int k = 0; k < wdt; k++) {
                r[k] = l[k] * kr * s;
                l[k] = l[k] * kl * s;
            }
        } else if (is_ms(h)) {
            midside(l, r, wdt);
        }
        l += wdt;
        r += wdt;
    }
}

// ----------------------------------------------------------------------
// reorder / antialias / IMDCT

void reorder_short(float* grbuf, const uint8_t* short_sfb) {
    float scratch[576];
    const float* src = grbuf;
    float* dst = scratch;
    int len;
    for (; (len = *short_sfb) != 0; short_sfb += 3, src += 2 * len) {
        for (int i = 0; i < len; i++, src++) {
            *dst++ = src[0 * len];
            *dst++ = src[1 * len];
            *dst++ = src[2 * len];
        }
    }
    std::memcpy(grbuf, scratch, (dst - scratch) * sizeof(float));
}

void antialias(float* grbuf, int nbands) {
    // butterfly coefficients from the ISO ci list
    static const double ci[8] = {-0.6, -0.535, -0.33, -0.185,
                                 -0.095, -0.041, -0.0142, -0.0037};
    static float cs[8], ca[8];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 8; i++) {
            double d = std::sqrt(1.0 + ci[i] * ci[i]);
            cs[i] = (float)(1.0 / d);
            ca[i] = (float)(ci[i] / d);
        }
        init = true;
    }
    for (; nbands > 0; nbands--, grbuf += 18) {
        for (int i = 0; i < 8; i++) {
            float u = grbuf[18 + i];
            float d = grbuf[17 - i];
            grbuf[18 + i] = u * cs[i] + d * ca[i];
            grbuf[17 - i] = d * cs[i] - u * ca[i];
        }
    }
}

// The cross-granule overlap state is 9 floats per band, holding the
// RAW IMDCT tail (symmetric, so 9 values cover 18 samples) for long-type
// granules, or the combined last-sub-block output + running tail for
// short granules; the window for the overlap region is applied at
// CONSUMPTION time by the next granule, exactly the contract of the
// conformant reference filterbank (verified by impulse probing).
struct ImdctTables {
    float cos36[36][18];    // long IMDCT kernel
    float cos12[12][6];     // short IMDCT kernel
    float w0[18];           // consumption window, normal/start granules
    float w1[18];           // consumption window, stop granules
    float w12[12];          // short sub-block window
    ImdctTables() {
        for (int i = 0; i < 36; i++)
            for (int k = 0; k < 18; k++)
                cos36[i][k] = (float)std::cos(
                    M_PI / 72.0 * (2 * i + 1 + 18) * (2 * k + 1));
        for (int i = 0; i < 12; i++)
            for (int k = 0; k < 6; k++)
                cos12[i][k] = (float)std::cos(
                    M_PI / 24.0 * (2 * i + 1 + 6) * (2 * k + 1));
        for (int i = 0; i < 9; i++) {
            w0[i] = (float)std::cos(M_PI / 36.0 * (i + 0.5));
            w0[9 + i] = (float)std::sin(M_PI / 36.0 * (i + 0.5));
            w1[i] = i < 6 ? 1.0f
                          : (float)std::cos(M_PI / 12.0 * (i - 6 + 0.5));
            w1[9 + i] = i < 6 ? 0.0f
                        : (float)std::sin(M_PI / 12.0 * (i - 6 + 0.5));
        }
        for (int i = 0; i < 12; i++)
            w12[i] = (float)std::sin(M_PI / 12.0 * (i + 0.5));
    }
};
const ImdctTables& imt() {
    static ImdctTables t;
    return t;
}

// one subband's long IMDCT: W is the packed consumption window
// (W[0..8] tail half, W[9..17] current low half)
void imdct_long(const float X[18], float out[18], float ov[9],
                const float* W) {
    const ImdctTables& T = imt();
    float z[36];
    for (int i = 0; i < 36; i++) {
        float acc = 0;
        for (int k = 0; k < 18; k++) acc += X[k] * T.cos36[i][k];
        z[i] = acc;
    }
    for (int j = 0; j < 18; j++) {
        float v1 = j < 9 ? W[9 + j] : W[17 - j];
        float v2 = j < 9 ? W[j] : W[26 - j];
        out[j] = z[j] * v1 + ov[j < 9 ? j : 17 - j] * v2;
    }
    for (int i = 0; i < 9; i++) ov[i] = z[18 + i];
}

void imdct_short(const float X[18], float out[18], float ov[9]) {
    const ImdctTables& T = imt();
    for (int j = 0; j < 6; j++) out[j] = ov[j];
    float t[3] = {ov[6], ov[7], ov[8]};
    for (int b = 0; b < 3; b++) {
        float z[12];
        for (int i = 0; i < 12; i++) {
            float acc = 0;
            for (int k = 0; k < 6; k++) acc += X[3 * k + b] * T.cos12[i][k];
            z[i] = acc;
        }
        float* dst = b < 2 ? out + 6 + 6 * b : ov;
        for (int j = 0; j < 6; j++) {
            dst[j] = t[j < 3 ? j : 5 - j] * T.w12[6 + j] + z[j] * T.w12[j];
        }
        for (int i = 0; i < 3; i++) t[i] = z[6 + i];
    }
    ov[6] = t[0];
    ov[7] = t[1];
    ov[8] = t[2];
}

// ----------------------------------------------------------------------
// decoder state

struct Mp3Dec {
    Header hdr;
    uint8_t reservoir[2048];
    int reserv = 0;
    float mdct_overlap[2][32][9];
    float synth_x[2][16][32];           // subband-sample history ring
    int synth_pos = 0;
    int prev_iscf[2][40];

    Mp3Dec() {
        std::memset(mdct_overlap, 0, sizeof mdct_overlap);
        std::memset(synth_x, 0, sizeof synth_x);
        std::memset(prev_iscf, 0, sizeof prev_iscf);
    }

    // synthesis: push one time-step's 32 subband samples, emit 32 PCM
    void synth_step(int ch, int tpos, const float x[32], float pcm[32]) {
        std::memcpy(synth_x[ch][tpos & 15], x, 32 * sizeof(float));
        for (int i = 0; i < 32; i++) pcm[i] = 0;
        for (int j = 0; j < 16; j++) {
            const float* xs = synth_x[ch][(tpos - j) & 15];
            for (int sb = 0; sb < 32; sb++) {
                float v = xs[sb];
                if (v == 0) continue;
                const float* H = mp3tab::kSynthH + (sb * 16 + j) * 32;
                for (int i = 0; i < 32; i++) pcm[i] += v * H[i];
            }
        }
    }

    // Decode one frame's audio given frame bytes.  out: interleaved float,
    // 1152*channels.  Returns samples per channel, or <0 on error.
    int decode_frame(const uint8_t* frame, int nbytes, float* out);
};

int Mp3Dec::decode_frame(const uint8_t* frame, int nbytes, float* out) {
    if (!g_lut_ready) build_luts();
    const Header& h = hdr;
    int nch = h.channels;
    int side_bytes = nch == 1 ? 17 : 32;
    int data_ofs = 4 + (h.crc ? 2 : 0);
    if (data_ofs + side_bytes > nbytes) return -2;

    Bits side;
    side.init(frame + data_ofs, side_bytes);
    Granule gr[4];
    int main_data_begin;
    if (!read_side_info(&side, gr, h, &main_data_begin)) return -3;

    // bit reservoir: main data = [tail of previous frames][this frame]
    int main_ofs = data_ofs + side_bytes;
    int main_bytes = nbytes - main_ofs;
    if (main_data_begin > reserv) {
        // not enough history (stream start/seek): skip this frame's audio
        // but keep its main data for the next frames
        if (reserv + main_bytes > (int)sizeof(reservoir))
            reserv = 0;
        std::memcpy(reservoir + reserv, frame + main_ofs, main_bytes);
        reserv += main_bytes;
        if (reserv > 1024) {
            std::memmove(reservoir, reservoir + reserv - 1024, 1024);
            reserv = 1024;
        }
        return 0;
    }
    uint8_t maindata[4096];
    int have = main_data_begin;
    std::memcpy(maindata, reservoir + reserv - have, have);
    if (have + main_bytes > (int)sizeof(maindata)) return -4;
    std::memcpy(maindata + have, frame + main_ofs, main_bytes);
    Bits bs;
    bs.init(maindata, have + main_bytes);

    float grbuf[2][576];
    float scf[40];
    int iscf[2][40];

    for (int grx = 0; grx < 2; grx++) {
        for (int ch = 0; ch < nch; ch++) {
            const Granule& g = gr[grx * nch + ch];
            int64_t limit = bs.pos + g.part_23_length;
            decode_scalefactors(h, g, &bs, iscf[ch], prev_iscf[ch], scf,
                                is_ms(h));
            if (!huffman_decode(grbuf[ch], &bs, g, scf, limit)) return -5;
        }
        if (is_intensity(h)) {
            intensity_process(grbuf[0], grbuf[1], iscf[1],
                              &gr[grx * nch], h);
        } else if (is_ms(h)) {
            midside(grbuf[0], grbuf[1], 576);
        }
        for (int ch = 0; ch < nch; ch++) {
            const Granule& g = gr[grx * nch + ch];
            int n_long_bands = g.mixed_block_flag ? 2 : 0;
            if (g.n_short_sfb) {
                reorder_short(grbuf[ch] + n_long_bands * 18,
                              g.sfbtab + g.n_long_sfb);
            }
            int aa_bands = g.n_short_sfb ? n_long_bands - 1 : 31;
            if (aa_bands > 0) antialias(grbuf[ch], aa_bands);
            // IMDCT per subband
            float time[32][18];
            const float* W = g.block_type == 3 ? imt().w1 : imt().w0;
            for (int sb = 0; sb < 32; sb++) {
                const float* X = grbuf[ch] + sb * 18;
                if (g.block_type == 2 && sb >= n_long_bands) {
                    imdct_short(X, time[sb], mdct_overlap[ch][sb]);
                } else {
                    imdct_long(X, time[sb], mdct_overlap[ch][sb], W);
                }
            }
            // frequency inversion: odd subbands, odd time samples
            for (int sb = 1; sb < 32; sb += 2)
                for (int t = 1; t < 18; t += 2) time[sb][t] = -time[sb][t];
            // synthesis: 18 time steps of 32 subband samples
            for (int t = 0; t < 18; t++) {
                float col[32], pcm[32];
                for (int sb = 0; sb < 32; sb++) col[sb] = time[sb][t];
                synth_step(ch, synth_pos + t, col, pcm);
                float* dst = out + ((grx * 18 + t) * 32) * nch + ch;
                for (int i = 0; i < 32; i++) dst[i * nch] = pcm[i];
            }
        }
        synth_pos += 18;
    }

    // feed the reservoir for the next frame
    if (reserv + main_bytes > (int)sizeof(reservoir)) {
        int keep = reserv > 1024 ? 1024 : reserv;
        std::memmove(reservoir, reservoir + reserv - keep, keep);
        reserv = keep;
    }
    std::memcpy(reservoir + reserv, frame + main_ofs, main_bytes);
    reserv += main_bytes;
    if (reserv > 1024) {
        std::memmove(reservoir, reservoir + reserv - 1024, 1024);
        reserv = 1024;
    }
    return 1152;
}

int64_t skip_id3(const uint8_t* p, int64_t len) {
    if (len >= 10 && p[0] == 'I' && p[1] == 'D' && p[2] == '3') {
        int64_t sz = ((int64_t)(p[6] & 0x7F) << 21) | ((p[7] & 0x7F) << 14)
                     | ((p[8] & 0x7F) << 7) | (p[9] & 0x7F);
        return 10 + sz + ((p[5] & 0x10) ? 10 : 0);
    }
    return 0;
}

}  // namespace

// ----------------------------------------------------------------------

extern "C" {

// Probe an MP3 buffer: meta = [sample_rate, channels, approx_frames, 0].
// Returns 0 ok, -1 no frame found, -2 unsupported (not MPEG-1 Layer III).
int mp3_info(const uint8_t* data, int64_t len, int32_t* meta) {
    int64_t pos = skip_id3(data, len);
    int frames = 0;
    Header h{};
    bool found = false;
    while (pos + 4 <= len) {
        Header cand;
        if (parse_header(data + pos, &cand)) {
            if (!found) {
                h = cand;
                found = true;
            }
            frames++;
            pos += cand.frame_bytes;
        } else if (!found && data[pos] == 0xFF && (data[pos + 1] & 0xF0) == 0xF0) {
            return -2;   // sync found but unsupported flavor
        } else {
            pos++;
        }
    }
    if (!found) return -1;
    meta[0] = h.sample_rate;
    meta[1] = h.channels;
    meta[2] = frames;
    meta[3] = 0;
    return 0;
}

// Decode to interleaved int16.  Returns total samples written (frames ×
// 1152 × channels), or <0 on error (-3 = out buffer too small).
int64_t mp3_decode(const uint8_t* data, int64_t len, int16_t* out,
                   int64_t cap) {
    Mp3Dec* dec = new Mp3Dec();
    int64_t pos = skip_id3(data, len);
    int64_t written = 0;
    float fbuf[1152 * 2];
    int rate = 0, nch = 0;
    while (pos + 4 <= len) {
        Header h;
        if (!parse_header(data + pos, &h)) {
            pos++;
            continue;
        }
        if (pos + h.frame_bytes > len) break;
        if (!rate) {
            rate = h.sample_rate;
            nch = h.channels;
        }
        if (h.sample_rate == rate && h.channels == nch) {
            dec->hdr = h;
            int n = dec->decode_frame(data + pos, h.frame_bytes, fbuf);
            if (n > 0) {
                int64_t count = (int64_t)n * nch;
                if (written + count > cap) {
                    delete dec;
                    return -3;
                }
                for (int64_t i = 0; i < count; i++) {
                    float v = fbuf[i] * 32768.0f;
                    int s = (int)std::lrintf(v);
                    if (s > 32767) s = 32767;
                    if (s < -32768) s = -32768;
                    out[written + i] = (int16_t)s;
                }
                written += count;
            }
        }
        pos += h.frame_bytes;
    }
    delete dec;
    return written;
}

}  // extern "C"
