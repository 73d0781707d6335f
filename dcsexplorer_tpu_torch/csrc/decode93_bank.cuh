// What the 1993 family's two kernels share (decode93_pcm.cu and
// decode93_bank.cu): the bank columns (ops/decode93.py), their row and band
// kinds, the bitstream fields they read, and the layout of the session bank.
//
// The session bank holds, for each bank row, the words of its decode that do
// not depend on the mix, in the frame buffer's word order (words 256 and
// above are dropped: the transform never reads them).  A row is kBankWords
// int32 words:
// - words 0..127: 256 halfwords, frame-buffer word t in halfword t, so that
//   the session kernel's lane l reads its words 4l..4l+3 and
//   128+4l..128+4l+3 as two 8-byte words (l and 32 + l).  A 93 row holds
//   each target's low word lo (for a repeat cell: the band's l0), 0 where no
//   target lies; an OS93a Type-1 row holds each word's pair-table value pk,
//   0 where its band is silent.
// - words 128..159, side word l: a 93 row's repeat indices, 4 bits for each
//   of lane l's 8 words in that order (0 but in repeat cells, which the row's
//   kind BANK_93R marks); a Type-1 row's band l's scale, (scale32 >> 16) for
//   l < 18 and a band with samples, else 0.
// Mixing a row with m then gives each word's delta:
// - 93: P = sx16(lo) * m, lo' = (lo + i * (P & $FFFF)) & $FFFF (i the repeat
//   index), delta (lo' + P) >> 16; the first-sample fix-up on words 0 and 1.
// - Type-1: eff = sx16((scale * m) >> 15) of the word's band, p8 = pk * 2 *
//   eff + $8000 mod 2^32, delta p8 >> 16, and bit 0 of the word cleared
//   where p8's low half is 0 (the MAC's tie rule).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"
#include "decode94_walk.cuh"      // dcs94::pool_word

namespace dcs93 {

constexpr int kFbWords = 256;           // the words the transform reads
constexpr int kCols = 18;               // row width of kw_u8, bit_rel, code_u8
constexpr int kBands93a = 18;
constexpr int kInputs93a = 127;
constexpr int kMaxWidth93 = 24, kMaxWidth93a = 9;
enum { K_NONE = 0, K_DATA0 = 1, K_DATA1 = 2, K_DATA2 = 3, K_REPEAT = 4,
       K_RAMP = 5 };
enum { ROW_SILENT = 0, ROW_93 = 1, ROW_93A = 2 };

// the session bank: int32 words a row, and its row kinds
constexpr int kBankWords = 160;
constexpr int kBankSide = 128;          // the first side word
enum { BANK_SILENT = 0, BANK_93 = 1, BANK_93A = 2, BANK_93R = 3 };

struct Cols {
    const uint8_t *pool;
    long long pool_len;
    const uint32_t *pool32;             // the pool's whole 32-bit words
    int n_words;
    const int *frame_word, *sid;
    const uint8_t *kind, *kw;
    const int *bit_rel, *prv;
    const uint8_t *code;
    const int *band_tab;     // [n_streams, 16, 8]
    int n_streams;
};

// the columns over a pool that is 4-byte aligned; frame words index 32-bit
// words, so its whole words number below 2^31
__host__ inline Cols make_cols(const uint8_t *pool, long long pool_len,
                               const int *frame_word, const int *sid,
                               const uint8_t *kind, const uint8_t *kw,
                               const int *bit_rel, const int *prv,
                               const uint8_t *code, const int *band_tab,
                               int n_streams) {
    const long long words = pool_len / 4;
    return Cols{pool, pool_len, reinterpret_cast<const uint32_t *>(pool),
                (int)(words < 0x7FFFFFFFLL ? words : 0x7FFFFFFFLL),
                frame_word, sid, kind, kw, bit_rel, prv, code, band_tab,
                n_streams};
}

// low 16 bits, sign-extended
__device__ __forceinline__ int sx16(int x) { return (int)(short)x; }

// big-endian pool word idx (bytes 4 idx .. 4 idx + 3); $FF past the end
__device__ __forceinline__ uint32_t word_be(const Cols &c, int idx) {
    if ((unsigned)idx < (unsigned)c.n_words)
        return __byte_perm(__ldg(c.pool32 + idx), 0, 0x0123);
    return dcs94::pool_word(c.pool, c.pool_len, 4LL * idx);
}

// bits [32 fw + rel, 32 fw + rel + w) of the pool, most significant first
// (rel >= 0, 1 <= w <= 24); kFast: the caller has checked that the two
// words lie in the pool
template <bool kFast = false>
__device__ __forceinline__ uint32_t field(const Cols &c, int fw, int rel,
                                          int w) {
    const int idx = fw + (rel >> 5);
    const uint32_t hi = kFast ? __byte_perm(__ldg(c.pool32 + idx), 0, 0x0123)
                              : word_be(c, idx);
    const uint32_t lo = kFast
                            ? __byte_perm(__ldg(c.pool32 + idx + 1), 0, 0x0123)
                            : word_be(c, idx + 1);
    return __funnelshift_l(lo, hi, rel & 31) >> (32 - w);
}

}  // namespace dcs93
