// The 1993 family's session bank (decode93_bank.cuh's layout): for every
// bank row, the words of its decode that do not depend on the mix, built
// once per ROM.  It computes exactly ops/decode93.decode93_bank_plain.
//
// Replaces, in the JAX package: no kernel.  The JAX package's 1993 session
// path (device_decode93, dcsexplorer_tpu/models/pipeline.py:244-272)
// decodes every row's bitstream each time a session plays it, because the
// mix enters the 93 body's write before its shift and the Type-1 body's
// rounding; this kernel moves the part of that decode that does not depend
// on the mix (the fields, the chains, the scale and the pair look-ups) to
// set-up, and decode93_pcm.cu's session instance mixes its words.
//
// What bounds it on the H100: nothing that matters; it runs once per ROM,
// one launch of a few thousand rows (a warp a row, its bands' samples in
// order), next to seconds of set-up.
//
// Design: one warp a row, 8 warps a block.  The row's 256 halfwords and
// repeat indices gather in shared memory, zero but where the row writes;
// then lane l writes its two 8-byte words and side word l.
// - 93 row: lane b < 16 takes band b.  Its first target comes from the
//   band table by a 16-lane prefix sum of the bands' advances (as the
//   session kernel's columns instance computes it); its samples are walked
//   in order with the Sigma and Sigma-Sigma sums, scaled, and written as
//   the low word lo of each target (a repeat cell: the band's l0 and its
//   index i).  A 93 row whose repeat indices are all 0 is BANK_93, else
//   BANK_93R.
// - Type-1 row: lane l takes inputs l, 32 + l, 64 + l and 96 + l (input j
//   writes words 2j and 2j + 1 the pair-table values of its field); lane
//   b < 18 writes band b's scale (scale32 >> 16) to its side word.
//
// Semantics kept exactly (and tested against the plain version): sign
// extension (raw - ((raw >> (w-1)) << w)); the chains mod 2^16; bytes past
// the pool read as $FF; bands without data read no bit; a band's samples
// past 16 are not decoded; targets outside 0..255 are dropped; a row kind,
// band kind, width or stream id out of range traps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"
#include "decode93_bank.cuh"

namespace {

using namespace dcs93;

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct RowBuf {
    unsigned short lo[kFbWords];
    unsigned char rep[kFbWords];
};

__global__ void __launch_bounds__(32 * kWarps)
decode93_bank_kernel(Cols c, const int *__restrict__ pair,
                     const int *__restrict__ inputs, int *__restrict__ words,
                     uint8_t *__restrict__ kind93, int n_rows) {
    __shared__ unsigned short in_map[kInputs93a];  // input j: band | index << 8
    __shared__ __align__(16) RowBuf buf[kWarps];
    if (threadIdx.x == 0) {
        int j = 0;
        for (int b = 0; b < kBands93a; ++b)
            for (int i = 0; i < __ldg(inputs + b); ++i, ++j) {
                if (j >= kInputs93a) __trap();
                in_map[j] = (unsigned short)(b | i << 8);
            }
        if (j != kInputs93a) __trap();
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (r >= n_rows) return;
    RowBuf &rb = buf[threadIdx.x >> 5];
    for (int t = lane; t < kFbWords; t += 32) {
        rb.lo[t] = 0;
        rb.rep[t] = 0;
    }
    __syncwarp();
    const int kind = c.kind[r];
    if (kind > ROW_93A) __trap();
    const int fw = c.frame_word[r];
    uint32_t side = 0;
    if (kind == ROW_93) {
        const int rs = c.sid[r];
        if ((unsigned)rs >= (unsigned)c.n_streams) __trap();
        const int b = lane & 15;
        const int kw = c.kw[(size_t)r * kCols + b];
        const int bk = kw >> 5, w = kw & 31;
        if (bk > K_RAMP || w > kMaxWidth93) __trap();
        const int *tab = c.band_tab + 8 * (rs * 16 + b);
        const int sc = tab[0] & dcs::kM16, n = tab[1], inc = tab[2];
        const int pre = tab[3];
        const int adv = pre + (bk == K_NONE ? tab[5] : n * inc + tab[4]);
        // out_start = 1 + (the advances of the bands before) + pre
        int incl = adv;
#pragma unroll
        for (int d = 1; d < 16; d <<= 1) {
            const int o = __shfl_up_sync(kFull, incl, d, 16);
            if (b >= d) incl += o;
        }
        const int ostart = 1 + incl - adv + pre;
        if (lane < 16 && bk != K_NONE) {
            const int prv = c.prv[(size_t)r * 16 + b];
            const uint32_t p_in = (uint32_t)prv & 0xFFFFu;
            const uint32_t p_dl = (uint32_t)prv >> 16;
            const int rel = c.bit_rel[(size_t)r * kCols + b];
            const bool data = bk >= K_DATA0 && bk <= K_DATA2;
            const int w1 = max(w, 1);
            const int l0 = (dcs::s16((int)p_in) * sc) & dcs::kM16;
            uint32_t c1 = 0, c2 = 0;            // the Sigma sums
            for (int i = 0; i < min(n, 16); ++i) {
                const uint32_t raw = data ? field(c, fw, rel + i * w, w1) : 0u;
                const uint32_t samp = raw - ((raw >> (w1 - 1)) << w1);
                c1 += samp;
                c2 += c1;
                const uint32_t ramp = p_in + (uint32_t)(i + 1) * p_dl;
                const uint32_t val = bk == K_DATA0   ? samp
                                     : bk == K_DATA1 ? p_in + c1
                                     : bk == K_DATA2 ? ramp + c2
                                                     : ramp;
                const int tgt = ostart + i * inc;
                if ((unsigned)tgt >= (unsigned)kFbWords) continue;
                if (bk == K_REPEAT) {
                    rb.lo[tgt] = (unsigned short)l0;
                    rb.rep[tgt] = (unsigned char)i;
                } else {
                    rb.lo[tgt] =
                        (unsigned short)((sx16((int)val) * sc) & dcs::kM16);
                }
            }
        }
        __syncwarp();
        // lane l's repeat indices: words 4l..4l+3, 128+4l..128+4l+3
#pragma unroll
        for (int k = 0; k < 8; ++k)
            side |= (uint32_t)rb.rep[(k < 4 ? 0 : 124) + 4 * lane + k]
                    << 4 * k;
    } else if (kind == ROW_93A) {
        if (lane < kBands93a) {
            const int wb = c.kw[(size_t)r * kCols + lane];
            if (wb > kMaxWidth93a) __trap();
            const int code = c.code[(size_t)r * kCols + lane];
            const uint32_t mant[4] = {0x8000, 0x9838, 0xB505, 0xD745};
            if (wb != 0 && code != 0xFF)
                side = (mant[code & 3] << min(code >> 2, 14)) >> 16;
        }
        for (int j = lane; j < kInputs93a; j += 32) {
            const int jm = in_map[j];
            const int b = jm & 0xFF;
            const int wb = c.kw[(size_t)r * kCols + b];
            if (wb == 0) continue;
            const uint32_t raw =
                field(c, fw, c.bit_rel[(size_t)r * kCols + b] + (jm >> 8) * wb,
                      wb);
            const int p = (2 << wb) + 2 * (int)raw;
            rb.lo[2 * j] = (unsigned short)__ldg(pair + p);
            rb.lo[2 * j + 1] = (unsigned short)__ldg(pair + p + 1);
        }
        __syncwarp();
    }
    int *out = words + (size_t)r * kBankWords;
    const uint2 *lo4 = reinterpret_cast<const uint2 *>(rb.lo);
    reinterpret_cast<uint2 *>(out)[lane] = lo4[lane];
    reinterpret_cast<uint2 *>(out)[32 + lane] = lo4[32 + lane];
    out[kBankSide + lane] = (int)side;
    const bool rep = __any_sync(kFull, side != 0u);
    if (lane == 0)
        kind93[r] = (uint8_t)(kind == ROW_93 ? (rep ? BANK_93R : BANK_93)
                                             : kind);
}

}  // namespace

// rows 0 .. n_rows - 1 of the session bank from the bank columns (their
// pool 4-byte aligned; pair [2048] and inputs [18] the OS93a tables) into
// words [n_rows, 160] (8-byte aligned) and kind93 [n_rows]
extern "C" int dcs_decode93_bank(
    const uint8_t *pool, long long pool_len, const int *frame_word,
    const int *sid, const uint8_t *kind, const uint8_t *kw,
    const int *bit_rel, const int *prv, const uint8_t *code,
    const int *band_tab, int n_streams, const int *pair, const int *inputs,
    int *words, uint8_t *kind93, int n_rows, cudaStream_t stream) {
    const Cols c = make_cols(pool, pool_len, frame_word, sid, kind, kw,
                             bit_rel, prv, code, band_tab, n_streams);
    const int blocks = (n_rows + kWarps - 1) / kWarps;
    decode93_bank_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
        c, pair, inputs, words, kind93, n_rows);
    return (int)cudaGetLastError();
}
