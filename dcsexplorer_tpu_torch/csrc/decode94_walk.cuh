// The 1994+ frame walk shared by decode94_fb.cu and decode94_bank.cu: band
// controls built in registers as the walk reaches each band, and the
// Huffman / raw symbol decode with a per-thread bit window.  One thread
// walks one frame; the kernels differ only in what they do with each
// position's value (their epilogues).
//
// Replaces, in the JAX package: band_controls_dyn
// (dcsexplorer_tpu/models/flatsweep.py:42), _expand / slot_controls
// (dcsexplorer_tpu/ops/band_decode.py:240,259) and the decode_flat scan
// (dcsexplorer_tpu/models/flatsweep.py:87-145).
//
// Design:
// - Each band's packed control word (the layout of slot_controls: code |
//   maxw<<5 | cb_base<<10 | 1<<20 | scale_code<<21 | (out_inc-1)<<27 |
//   start_parity<<28) is built when the walk reaches the band, from
//   hdr_tab[sid], fmt/sub_tab[sid], the frame's band types and the previous
//   frame's (read from global memory, since that frame may sit in another
//   block).  No per-position tensor exists.
// - A 64-bit bit window per thread, refilled with one aligned 4-byte word
//   when fewer than 25 bits remain (a step needs at most 23).  That word is
//   loaded one refill ahead, so its latency hides behind the symbols in
//   between.  Bytes past the pool read as $FF; a load goes byte by byte only
//   at the pool's end, so nothing is read past it.
// - The codec tables (6 KB, read with divergent indices) sit in shared
//   memory, copied once a block.
//
// Semantics kept exactly (and tested against the plain versions):
// - the $7F terminator ends the band list; type-1 band types translate
//   through xt/xa with codes clamped to 0..15, preadj only on bands < 3;
//   skipped bands (type 0) advance by the halved count; maxw/cb_base come
//   from the codebook tables only for codes 1..6, raw widths cap at 17;
//   code bits past bit 4 fall into the maxw field, as the packed word does;
// - a decimated ($40) band emits on every other position, starting at the
//   band start's parity; bands that share a start resolve to the last;
// - the lookup reads the 32-bit big-endian word at the cursor's byte, so
//   bits past 32 - (cursor & 7) read as 0;
// - a codebook lane's index clamps to the last entry; a filler position
//   clears the two-zero skip carry;
// - scale = mant[sc & 3] >> (15 - ((sc >> 2) & 15)).
#pragma once

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"

namespace dcs94 {

constexpr int kCbLen = 940;            // flattened codebooks 1..6

// shared-memory copy of the codec tables (int32 each)
struct Tables {
    int cb[kCbLen];
    int out_count[16];
    int xt[16 * 16];
    int xa[16 * 16];
    int preadj[2 * 16];
    int maxw[7];
    int cb_base[7];
    int mant[4];
};

// the codec tables in global memory, in the order of the C arguments
struct TablePtrs {
    const int *out_count, *xt, *xa, *preadj, *maxw, *cb_base, *mant, *cb;
};

__device__ __forceinline__ void copy_tab(int *dst, const int *__restrict__ src,
                                         int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// the block copies the tables; the caller synchronises
__device__ __forceinline__ void load_tables(Tables &tb, const TablePtrs &g) {
    copy_tab(tb.cb, g.cb, kCbLen);
    copy_tab(tb.out_count, g.out_count, 16);
    copy_tab(tb.xt, g.xt, 256);
    copy_tab(tb.xa, g.xa, 256);
    copy_tab(tb.preadj, g.preadj, 32);
    copy_tab(tb.maxw, g.maxw, 7);
    copy_tab(tb.cb_base, g.cb_base, 7);
    copy_tab(tb.mant, g.mant, 4);
}

// big-endian 32-bit pool word at byte i (a multiple of 4); $FF past the end
__device__ __forceinline__ uint32_t pool_word(const uint8_t *__restrict__ pool,
                                              long long len, long long i) {
    if (i >= 0 && i + 4 <= len) {
        uint32_t w = __ldg(reinterpret_cast<const unsigned int *>(pool + i));
        return __byte_perm(w, 0, 0x0123);
    }
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
        long long b = i + j;
        w = (w << 8) | (b >= 0 && b < len ? (uint32_t)__ldg(pool + b) : 0xFFu);
    }
    return w;
}

__device__ __forceinline__ int byte_of(uint4 v, int b) {
    uint32_t w = b < 8 ? (b < 4 ? v.x : v.y) : (b < 12 ? v.z : v.w);
    return (int)((w >> (8 * (b & 3))) & 0xFFu);
}

// One frame's walk.  step(tb, t) returns the sample value (u16 storage) of
// frame-buffer position t + 1 and the scale of its band; it is called for
// t = 0, 1, 2, ... in order, with the block's shared tables.
struct Walk {
    const uint8_t *__restrict__ pool;
    long long pool_len;
    uint4 hdr, bt, btp;
    bool type1;
    const int *preadj;
    // bit window: the top nb bits of win are the pool at the cursor, the
    // bits below them are 0; `ahead` is the next 4-byte word, loaded one
    // refill early so that its latency hides behind the steps before it
    long long cursor, nxt;
    uint64_t win;
    int nb;
    uint32_t ahead;
    // the band under the walk
    int b = 0, band_start = 0, band_end = 0;
    int packed = 0, scale = 1;
    bool inc2 = false, done = false, skip = false;

    __device__ __forceinline__ Walk(const Tables &tables,
                                    const uint8_t *__restrict__ pool_,
                                    long long pool_len_,
                                    const int *__restrict__ sid,
                                    const int *__restrict__ start_bit,
                                    const uint8_t *__restrict__ bt_u8,
                                    const uint8_t *__restrict__ hdr_tab,
                                    const uint8_t *__restrict__ fmt_tab,
                                    const uint8_t *__restrict__ sub_tab,
                                    int n_streams, int f)
        : pool(pool_), pool_len(pool_len_) {
        const int s = sid[f];
        if ((unsigned)s >= (unsigned)n_streams) __trap();
        hdr = __ldg(reinterpret_cast<const uint4 *>(hdr_tab) + s);
        type1 = fmt_tab[s] != 0;
        preadj = tables.preadj + (sub_tab[s] != 0 ? 16 : 0);
        bt = __ldg(reinterpret_cast<const uint4 *>(bt_u8) + f);
        btp = (f > 0 && sid[f - 1] == s)
                  ? __ldg(reinterpret_cast<const uint4 *>(bt_u8) + f - 1)
                  : make_uint4(0, 0, 0, 0);
        cursor = start_bit[f];
        nxt = (cursor >> 3) & ~3LL;
        const int sh = (int)(cursor - nxt * 8);
        win = (((uint64_t)pool_word(pool, pool_len, nxt) << 32) |
               pool_word(pool, pool_len, nxt + 4)) << sh;
        nb = 64 - sh;
        ahead = pool_word(pool, pool_len, nxt + 8);
        nxt += 12;
    }

    __device__ __forceinline__ int step(const Tables &tb, int t,
                                        int &scale_out) {
        while (t == band_end && !done) {
            // next band's controls (band_controls_dyn + slot_controls)
            const int hb = b < 16 ? byte_of(hdr, b) : 0x7F;
            if ((hb & 0x7F) == 0x7F) {
                done = true;
                packed = 0;
                break;
            }
            const int cur = hb & 0x7F;
            inc2 = (cur & 0x40) != 0;
            int oc = tb.out_count[b];
            if (inc2) oc >>= 1;
            const int btv = byte_of(bt, b);
            int code = btv, sc = cur;
            if (type1) {
                const int c15 = min(btv, 15);
                code = tb.xt[b * 16 + c15];
                sc = cur + tb.xa[b * 16 + c15] +
                     (b < 3 ? preadj[min(byte_of(btp, b), 15)] : 0);
            }
            if (btv == 0) code = 0;
            band_start = band_end;
            band_end = band_start + (btv != 0 && inc2 ? 2 * oc : oc);
            packed = 0;
            if (code != 0) {
                const bool is_cb = code >= 1 && code <= 6;
                const int book = min(code, 6);
                const int maxw = is_cb ? tb.maxw[book] : min(code, 17);
                packed = code | (maxw << 5) | (tb.cb_base[book] << 10) |
                         (1 << 20) | ((sc & 0x3F) << 21) | ((int)inc2 << 27) |
                         ((band_start & 1) << 28);
            }
            const int sc6 = (packed >> 21) & 0x3F;
            scale = tb.mant[sc6 & 3] >> (15 - ((sc6 >> 2) & 0xF));
            ++b;
        }
        scale_out = scale;
        // a decimated band's off-parity positions are fillers (bitwise, not
        // short-circuit: a select, not a branch)
        const bool filler = done | (inc2 & (((t ^ band_start) & 1) != 0));
        const int p = filler ? 0 : packed;
        int v = 0;
        if (p == 0 || skip) {
            skip = false;      // a filler or the second of two zeros
        } else {
            if (nb < 25) {
                win |= (uint64_t)ahead << (32 - nb);
                nb += 32;
                ahead = pool_word(pool, pool_len, nxt);
                nxt += 4;
            }
            const int c = p & 0x1F;
            const int mw = (p >> 5) & 0x1F;
            const int cb = (p >> 10) & 0x3FF;
            const uint32_t top = (uint32_t)(win >> 32) &
                                 (0xFFFFFFFFu << (int)(cursor & 7));
            const int look = mw ? (int)(top >> (32 - mw)) : 0;
            int sample, nbits;
            bool two_zero = false;
            if (c <= 6) {
                const int entry = tb.cb[min(cb + look, kCbLen - 1)];
                two_zero = (entry & 0x80) != 0;
                sample = (entry & 0x7F) - (1 << min(max(c - 1, 0), 14));
                nbits = entry >> 8;
            } else {
                const int mw1 = max(mw, 1);
                sample = look - ((look >> (mw1 - 1)) << mw1);
                nbits = mw;
            }
            win <<= nbits;
            nb -= nbits;
            cursor += nbits;
            skip = two_zero;
            v = two_zero ? 0 : (sample & dcs::kM16);
        }
        return v;
    }
};

}  // namespace dcs94
