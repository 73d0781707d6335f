// The 1994+ frame walk shared by decode94_fb.cu and decode94_bank.cu: a
// frame's band list built before the walk, and the Huffman / raw symbol
// decode with a per-thread bit window.  One thread walks one frame; the
// kernels differ only in what they do with each position's value (their
// epilogues).  pool_word also serves the 1993 kernels.
//
// Replaces, in the JAX package: band_controls_dyn
// (dcsexplorer_tpu/models/flatsweep.py:42), _expand / slot_controls
// (dcsexplorer_tpu/ops/band_decode.py:240,259) and the decode_flat scan
// (dcsexplorer_tpu/models/flatsweep.py:87-145).
//
// What bounds it on the H100: issue slots.  Each position step waits on
// the bit cursor of the step before, so the walk is a serial chain a
// frame; with enough frames in flight the SMs' instruction issue sets the
// pace, so the design counts instructions a step.  (A bank of a few
// thousand frames, a warp to a scheduler, waits on each step's chain
// instead.)
//
// Design:
// - Before the walk, the thread builds its frame's band list in shared
//   memory: every band that takes positions (a band of zero positions is
//   dropped, so bands that share a start resolve to the last), then an end
//   marker.  An entry holds what a step reads, pre-shifted (Band below),
//   and where the band ends with its scale.  The step only compares t with
//   the current band's end and, there, takes the next entry, prefetched at
//   the transition before; no table look-up, no header byte and no loop
//   runs at a band transition.  The list also gives the position after the
//   last band that decodes: the kernels run a warp's loop to the largest
//   of its lanes' (one warp reduction, before the loop), not to n_steps.
// - The block's stretch of the pool, from its first frame's start to the
//   furthest its frames can read, is copied once into shared memory as
//   big-endian words (coalesced loads, stage_pool), so no global load sits
//   on the walk's path.  The refills of a warp's lanes fall on different
//   steps, and a warp waits on a register for every lane's load into it:
//   refilled from global memory, a step waited on the loads other lanes
//   had issued the step before.  A block whose stretch does not fit
//   (frames far apart in the pool) reads global memory instead.
// - A two-word window w0:w1 of big-endian pool words and a 32-bit cursor
//   (its bit in w0, and the next word's index; the pool is under 2^28
//   bytes).  The 32 bits at the cursor are one __funnelshift_l; a step
//   reads at most 23 bits and consumes at most 32, so the window moves by
//   at most one word a step, taking a word loaded one refill ahead.
// - One bounds check a frame: the furthest a frame can read is 32 bits a
//   position up to the end of its last decoding band.  The stretch is
//   bounded by it, and on the global path a frame inside the pool loads
//   whole words unchecked; only the words at the pool's end take
//   pool_word.
// - One decode path: the codebook look-up and the raw field are both
//   computed, and selects pick the sample and the bits consumed.
// - The codec tables (6 KB, read with divergent indices) sit in shared
//   memory, copied once a block.
//
// Semantics kept exactly (and tested against the plain versions):
// - the $7F terminator ends the band list; type-1 band types translate
//   through xt/xa with codes clamped to 0..15, preadj only on bands < 3;
//   skipped bands (type 0) advance by the halved count; maxw/cb_base come
//   from the codebook tables only for codes 1..6, raw widths cap at 17;
//   code bits past bit 4 fall into the maxw field, as the packed word of
//   slot_controls does;
// - a decimated ($40) band emits on every other position, starting at the
//   band start's parity; bands that share a start resolve to the last;
// - the lookup reads the 32-bit big-endian word at the cursor's byte, so
//   bits past 32 - (cursor & 7) read as 0: they are never read, since a
//   look-up takes at most 23 bits (maxw <= 17, or'ed with code bits 5..7);
// - bytes past the pool read as $FF;
// - a codebook lane's index clamps to the last entry; a filler position
//   clears the two-zero skip carry;
// - scale = mant[sc & 3] >> (15 - ((sc >> 2) & 15)).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"

namespace dcs94 {

constexpr int kCbLen = 940;            // flattened codebooks 1..6
// entries of a frame's band list: up to 16 bands, the end marker, and one
// slot that the prefetch past the marker reads and never uses
constexpr int kBandSlots = 18;

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

// the block copies the tables, every load in flight before the first
// store; the caller synchronises
template <int kThreads>
__device__ __forceinline__ void load_tables(Tables &tb, const TablePtrs &g) {
    // the fields' first words in Tables, in order
    constexpr int o1 = kCbLen, o2 = o1 + 16, o3 = o2 + 256, o4 = o3 + 256,
                  o5 = o4 + 32, o6 = o5 + 7, o7 = o6 + 7, kN = o7 + 4;
    static_assert(sizeof(Tables) == kN * sizeof(int), "Tables layout");
    constexpr int kPer = (kN + kThreads - 1) / kThreads;
    int v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int *src = i < o1   ? g.cb + i
                         : i < o2 ? g.out_count + (i - o1)
                         : i < o3 ? g.xt + (i - o2)
                         : i < o4 ? g.xa + (i - o3)
                         : i < o5 ? g.preadj + (i - o4)
                         : i < o6 ? g.maxw + (i - o5)
                         : i < o7 ? g.cb_base + (i - o6)
                                  : g.mant + (i - o7);
        v[j] = i < kN ? __ldg(src) : 0;
    }
    int *dst = reinterpret_cast<int *>(&tb);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < kN) dst[i] = v[j];
    }
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

// A band-list entry: x holds the fields a step reads, y = end | scale << 16
// (end: the position after the band; scale: its dequantization factor).
namespace Band {
constexpr int kBias = 5;               // bits 0-4: maxw field (bits to look
                                       // up; a raw field's width)
constexpr uint32_t kIsCb = 1u << 11;   // bits 5-10: 1 << max(c - 1, 0), the
                                       // codebook sample's bias
constexpr uint32_t kEven = 1u << 12;   // the band emits at even positions
constexpr uint32_t kOdd = 1u << 13;    // and at odd ones (a decimated band
                                       // at one parity; a silent at none)
constexpr int kCb = 22;                // bits 22-31: the codebook's base
}  // namespace Band

// Copy pool words [lo, hi) of every thread's frame, the union over the
// block rounded out to 16-byte words, into stg (kCap words) as big-endian
// words, every load in flight before the first store; every thread of the
// block calls it.  Returns whether the stretch fit, and its first word's
// index in base.  red: 2 * kThreads / 32 ints of scratch.
template <int kThreads, int kCap>
__device__ __forceinline__ bool stage_pool(uint32_t *stg, int lo, int hi,
                                           const uint8_t *__restrict__ pool,
                                           int pool_len, int *red,
                                           int &base) {
    constexpr int kWarps = kThreads / 32, kPer = kCap / 4 / kThreads;
    static_assert(kCap % (4 * kThreads) == 0, "whole uint4 per thread");
    const int warp = threadIdx.x >> 5;
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    if ((threadIdx.x & 31) == 0) {
        red[warp] = lo;
        red[kWarps + warp] = hi;
    }
    __syncthreads();
    lo = red[0];
    hi = red[kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
        lo = min(lo, red[w]);
        hi = max(hi, red[kWarps + w]);
    }
    lo &= ~3;
    hi = (hi + 3) & ~3;
    base = lo;
    const int n4 = (hi - lo) >> 2;
    if (n4 > kCap / 4) return false;
    if (lo >= 0 && 4LL * hi <= (long long)pool_len &&
        (reinterpret_cast<uintptr_t>(pool) & 15) == 0) {
        const uint4 *p = reinterpret_cast<const uint4 *>(pool) + (lo >> 2);
        uint4 v[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int q = threadIdx.x + j * kThreads;
            if (q < n4) v[j] = __ldg(p + q);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int q = threadIdx.x + j * kThreads;
            if (q < n4)
                reinterpret_cast<uint4 *>(stg)[q] = make_uint4(
                    __byte_perm(v[j].x, 0, 0x0123),
                    __byte_perm(v[j].y, 0, 0x0123),
                    __byte_perm(v[j].z, 0, 0x0123),
                    __byte_perm(v[j].w, 0, 0x0123));
        }
    } else {
        for (int i = threadIdx.x; i < 4 * n4; i += kThreads)
            stg[i] = pool_word(pool, pool_len, 4LL * (lo + i));
    }
    __syncthreads();
    return true;
}

// The warp zeroes 16-byte units [q0, kUnits) of its rows 0 .. n_rows - 1
// (kUnits units a row from `out`): consecutive lanes on consecutive units
// of a row, as many rows at a time as the units left in a row allow.
template <int kUnits>
__device__ __forceinline__ void zero_rows(uint4 *__restrict__ out, int n_rows,
                                          int q0) {
    const int u = kUnits - q0;
    if (u <= 0) return;
    // lanes a row: the power of 2 at or above u, at most 32
    const int lpr = u >= 32 ? 32 : 1 << (32 - __clz(u - 1));
    const int lane = threadIdx.x & 31;
    const int lq = lane & (lpr - 1);
    for (int r = lane / lpr; r < n_rows; r += 32 / lpr)
        for (int q = q0 + lq; q < kUnits; q += lpr)
            out[(size_t)r * kUnits + q] = make_uint4(0, 0, 0, 0);
}

// One frame's walk.  The constructor builds the band list in column `list`
// of a [kBandSlots][kCols] uint2 array in shared memory; begin() loads the
// window, from the staged stretch of the pool (stage_pool, with
// first_word() and end_word()) or, given none, from global memory.
// step(tb, t, scale) returns the sample value (u16 storage) of
// frame-buffer position t + 1 and the scale of its band; it is called for
// t = 0, 1, 2, ... in order, with the block's shared tables.  `last` is
// the position after the frame's last band that decodes: every step from
// there on returns 0 and reads nothing.
template <int kCols>
struct Walk {
    const uint8_t *__restrict__ pool;
    int pool_len;
    const uint32_t *stg = nullptr;     // the staged words, word i at
    int base = 0;                      // stg[i - base]; or null
    bool fast = false;                 // global: every read inside the pool
    // the window: w0:w1 are pool words [wi, wi + 2) big-endian, the cursor
    // is bit `pos` of w0; `ahead` is word wi + 2, loaded one refill early,
    // and `nxt` the index of the word after it
    uint32_t w0 = 0, w1 = 0, ahead = 0;
    int cursor, pos = 0, nxt = 0;
    // the band under the walk and the next entry of the list
    const uint2 *band;
    uint2 next;
    uint32_t ctl = 0;
    int end = 0, scale = 1;
    bool skip = false;
    uint32_t parity = Band::kEven;     // the emit bit of this step's parity
    int last = 0;

    __device__ __forceinline__ Walk(const Tables &tb, uint2 *list,
                                    const uint8_t *__restrict__ pool_,
                                    int pool_len_,
                                    const int *__restrict__ sid,
                                    const int *__restrict__ start_bit,
                                    const uint8_t *__restrict__ bt_u8,
                                    const uint8_t *__restrict__ hdr_tab,
                                    const uint8_t *__restrict__ fmt_tab,
                                    const uint8_t *__restrict__ sub_tab,
                                    int n_streams, int f, int n_steps)
        : pool(pool_), pool_len(pool_len_), band(list) {
        const int s = sid[f];
        if ((unsigned)s >= (unsigned)n_streams) __trap();
        const uint4 hdr = __ldg(reinterpret_cast<const uint4 *>(hdr_tab) + s);
        const bool type1 = fmt_tab[s] != 0;
        const int *preadj = tb.preadj + (sub_tab[s] != 0 ? 16 : 0);
        const uint4 bt = __ldg(reinterpret_cast<const uint4 *>(bt_u8) + f);
        const uint4 btp =
            (f > 0 && sid[f - 1] == s)
                ? __ldg(reinterpret_cast<const uint4 *>(bt_u8) + f - 1)
                : make_uint4(0, 0, 0, 0);

        // the band list (band_controls_dyn + slot_controls)
        int start = 0, n = 0;
        bool done = false;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
            const int hb = byte_of(hdr, b);
            done |= (hb & 0x7F) == 0x7F;
            if (done) continue;
            const int cur = hb & 0x7F;
            const bool inc2 = (cur & 0x40) != 0;
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
            const int stop = start + (btv != 0 && inc2 ? 2 * oc : oc);
            uint32_t x = 0;
            int sc6 = 0;
            if (code != 0) {
                const bool is_book = code >= 1 && code <= 6;
                const int book = min(code, 6);
                const int maxw = is_book ? tb.maxw[book] : min(code, 17);
                const int c = code & 0x1F;
                const uint32_t emit =
                    !inc2 ? Band::kEven | Band::kOdd
                          : (start & 1 ? Band::kOdd : Band::kEven);
                x = (uint32_t)(((code >> 5) | maxw) & 0x1F) |
                    (c <= 6 ? ((1u << max(c - 1, 0)) << Band::kBias) |
                                  Band::kIsCb
                            : 0u) |
                    emit |
                    ((uint32_t)(tb.cb_base[book] & 0x3FF) << Band::kCb);
                sc6 = sc & 0x3F;
                if (stop > start) last = stop;
            }
            if (stop > start) {
                const int scl = tb.mant[sc6 & 3] >> (15 - ((sc6 >> 2) & 0xF));
                list[n * kCols] =
                    make_uint2(x, (uint32_t)stop | ((uint32_t)scl << 16));
                ++n;
            }
            start = stop;
        }
        // the end marker: decodes nothing, never ends
        list[n * kCols] = make_uint2(0u, 0xFFFFu);
        next = list[0];

        cursor = start_bit[f];
    }

    // the pool words this frame can read: [first_word(), end_word(n_steps))
    // (32 bits a position up to the end of its last decoding band)
    __device__ __forceinline__ int first_word() const { return cursor >> 5; }
    __device__ __forceinline__ int end_word(int n_steps) const {
        return (cursor >> 5) + 4 + min(n_steps, last);
    }

    __device__ __forceinline__ void begin(const uint32_t *stg_, int base_,
                                          int n_steps) {
        stg = stg_;
        base = base_;
        fast = cursor >= 0 && 4LL * end_word(n_steps) <= (long long)pool_len;
        const int wi = cursor >> 5;
        pos = cursor & 31;
        w0 = word(wi);
        w1 = word(wi + 1);
        ahead = word(wi + 2);
        nxt = wi + 3;
    }

    __device__ __forceinline__ uint32_t word(int i) const {
        if (stg) return stg[i - base];
        return fast ? __byte_perm(
                          __ldg(reinterpret_cast<const uint32_t *>(pool) + i),
                          0, 0x0123)
                    : pool_word(pool, pool_len, 4LL * i);
    }

    __device__ __forceinline__ int step(const Tables &tb, int t,
                                        int &scale_out) {
        if (t == end) {
            // the next band; the entry after it loads under this one
            ctl = next.x;
            end = (int)(next.y & 0xFFFFu);
            scale = (int)(next.y >> 16);
            band += kCols;
            next = *band;
        }
        scale_out = scale;
        // a decimated band's off-parity positions are fillers; a filler, a
        // silent band or the second of two zeros reads nothing and emits 0
        const bool act = (ctl & parity) != 0 && !skip;
        parity ^= Band::kEven | Band::kOdd;
        // the 32 bits at the cursor, and the look-up's top maxw of them
        // (the funnel shifts take ctl & 31, the maxw field)
        const uint32_t top = __funnelshift_l(w1, w0, pos);
        const uint32_t look = __funnelshift_l(top, 0u, ctl);
        const int entry = tb.cb[min((ctl >> Band::kCb) + look,
                                    (uint32_t)(kCbLen - 1))];
        const bool is_cb = (ctl & Band::kIsCb) != 0;
        const bool two_zero = is_cb && (entry & 0x80) != 0;
        // a raw field: the same bits, sign-extended
        const int raw =
            (int)__funnelshift_l(top, (uint32_t)((int)top >> 31), ctl);
        const int sample =
            is_cb ? (entry & 0x7F) - (int)((ctl >> Band::kBias) & 0x3F) : raw;
        const int nbits = is_cb ? entry >> 8 : (int)(ctl & 0x1F);
        skip = act && two_zero;
        pos += act ? nbits : 0;
        if (pos >= 32) {
            pos -= 32;
            w0 = w1;
            w1 = ahead;
            ahead = word(nxt++);
        }
        return act && !two_zero ? sample & dcs::kM16 : 0;
    }
};

}  // namespace dcs94
