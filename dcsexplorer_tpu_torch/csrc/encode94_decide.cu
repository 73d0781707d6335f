// encode94_decide: the 1994+ encoder's decision tables on the card.
//
// Replaces the decision half of the JAX package's device encoder:
// dcsexplorer_tpu/encoder/device94.py:_encode_all's band min/max and
// silence (:313-321), _derive_luts (:268-296), and _encode_format's first
// fitting code and wrap refinement (:114-153, with _refine_ok :70-93 and
// the exact-floor _rdiv :55-67).  Plain version: device94.decide94_plain.
//
// Work.  A (frame, slot, band, pre-adjustment column) whose adjustment
// equals the previous column's (every column of a type-0 slot, and of
// bands past 2 in the shipped slots) has the same tables and repeats its
// result, so the distinct (slot, band, column) passes are the unit: 63 a
// frame for the default slots (0,0), (1,0), (1,3).  Per (pass, frame) pair
// the decision is the first code 1..15 whose fit window holds the band's
// min and max (o15), then the least key w*16 + c over o15 and the live
// candidates c < o15 (kept, w >= 1, range floor under dlim) whose capped
// error sum over the band stays within thr.  Nearly all the operations
// are those error sums (12.2 M position-candidates at enc94_dev's first
// chunk against 0.27 M pairs), and how many candidates a pair has is data
// dependent (0..6).
//
// Design: every live candidate of the tile is one thread's serial sum
// over its band's 7..32 positions, and all of them run at once.  Giving a
// warp to a band or to a pair instead, with the sums as warp or segmented
// shuffle reductions, spends most of the time in those reductions and in
// per-pair overhead (timed in PERF.md section 6).  Here a pair's fit test
// and its final minimum are one thread's short loops, and the candidates
// are compacted into a list (a block-wide prefix sum of the pairs' live
// counts) so that every lane of a warp sums a live candidate; consecutive
// entries share a pass, so the lanes of a warp mostly share the band
// width.  Every live candidate is evaluated, as the plain version does,
// so the minimum needs no ordering of the keys (no early exit).
//
// Geometry: blocks of 8 warps (256 threads), a block kTile = 8 frames of
// one stream: (ceil(Fmax/8), B) blocks, 544 at enc94_dev's chunk (Fmax 272,
// B 16).  Static shared memory ~40 KB a block (the tile's coefficients
// 8.2 KB, the code tables and pair states of at most 240 passes 15.4 KB,
// the candidate list 4 KB, the staged slot tables 5 KB, the outputs 4 KB):
// 5 blocks an SM, 660 a wave on 132 SMs, so the chunk's 544 blocks are
// resident at once (dcs_encode94_decide_geometry reports these on the
// card).  Phases, a __syncthreads between each:
//   0. the tile's ci rows, coalesced 16-byte loads, and the slots' tables
//      and the stream's header codes, into shared memory; the 65-entry
//      scale table: sf = max(1, mant[i & 3] >> (15 - (i >> 2 & 15))) for
//      i = sc & 63 (58 distinct values, all < 2^16), and entry 64 = 1 (a
//      dead band or code 0), each with its reciprocal (m, s);
//   1. the pass list (one warp: a ballot over (k, band, p) entries laid
//      out 8 columns a (k, band)) and each pass's column count; each
//      (frame, band)'s min, max and silent flag (a thread each);
//   2. per (pass, code) the table index sc & 63 and the width (two bytes)
//      and each pass's 6-bit candidate filter (a ballot);
//   3. per pair (a thread each, pass-major): o15 and the live mask; the
//      block's exclusive prefix sum of the live counts;
//   4. the live candidates as a list (in windows of kListCap entries), a
//      thread each: the capped error sum, and a shared-memory atomicOr of
//      its pass bit into the pair's state;
//   5. per pair: the least passing key, o15's and code 14's keys, the two
//      codes into the tile's outputs; then the tile's decisions out with
//      16-byte stores.
// There is no / or % in the index arithmetic.
//
// Division by multiplication: rdiv(a, sf) as __umulhi(2|a| + sf, m) >> s
// from the 65-entry scale table (encode94_scale.cuh, with its proof).
//
// Every value stays in int32 without wrap: |ci| <= 2^20, scale factors
// < 2^16, widths <= 15, so (2^w)*sf < 2^31, and the error terms are capped
// (cape <= 2^25, a sum of 32 under 2^31).  Codes out of this kernel are
// 0..15, and out14 <= 14: the select kernel's delta index relies on it (a
// code 15 never follows a 0).
//
// Bound: integer operations (the candidates' error sums, data dependent)
// or the bytes of the coefficients, whichever is larger; the outputs are
// two bytes a (slot, frame, band, column).
//
// Build: ops/kernels.py (nvcc -gencode arch=compute_90a,code=sm_90a, plain
// C interface, ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode94_scale.cuh"

namespace {

constexpr int kTileShift = 3;
constexpr int kTile = 1 << kTileShift;   // frames per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBands = 16;
constexpr int kCols = 255;
constexpr int kMaxSlots = 3;
constexpr int kP = 5;                    // pre-adjustment columns (PMAX)
constexpr int kMaxPass = kMaxSlots * kBands * kP;
constexpr int kMaxPairs = kMaxPass * kTile;
constexpr int kListCap = 2048;           // candidates a window
constexpr int kDClamp = 5793;
constexpr int kBig = 1 << 30;
constexpr int kCandBig = 1 << 14;

__device__ __forceinline__ int band_start(int b) {
    return b == 0 ? 0 : (b == 1 ? 7 : 15 + 16 * (b - 2));
}
__device__ __forceinline__ int band_size(int b) {
    return b == 0 ? 7 : (b == 1 ? 8 : (b == 15 ? 32 : 16));
}

// pass descriptor bits: band 0-3, slot 4-5, column 6-8, columns it covers
// 9-11
__device__ __forceinline__ int pass_band(int d) { return d & 15; }
__device__ __forceinline__ int pass_slot(int d) { return (d >> 4) & 3; }
__device__ __forceinline__ int pass_col(int d) { return (d >> 6) & 7; }
__device__ __forceinline__ int pass_ncols(int d) { return (d >> 9) & 7; }

// pair state bits: live candidates 0-5 (bit c-1), o15 8-11, passing
// candidates 16-21

__global__ void __launch_bounds__(kThreads)
encode94_decide_kernel(const int32_t* __restrict__ ci,
                       const uint8_t* __restrict__ hdr_scale,
                       const uint8_t* __restrict__ keep,
                       const int32_t* __restrict__ w_tab,
                       const int32_t* __restrict__ xa_tab,
                       const int32_t* __restrict__ peff_tab,
                       const uint8_t* __restrict__ is1,
                       const int32_t* __restrict__ mant,
                       const int32_t* __restrict__ thr,
                       const int32_t* __restrict__ dlim,
                       const int32_t* __restrict__ cape, int sil_max,
                       uint8_t* __restrict__ out15,
                       uint8_t* __restrict__ out14,
                       uint8_t* __restrict__ silent, int K, int fmax) {
    __shared__ int s_ci[kTile * kCols + 4];
    __shared__ int8_t s_w[kMaxSlots * 256];        // w_tab
    __shared__ int s_xa[kMaxSlots * 256];          // xa_tab
    __shared__ int s_peff[kMaxSlots * kBands * kP];
    __shared__ int s_hdr[kMaxSlots * kBands];      // this stream's codes
    __shared__ uint8_t s_is1[kMaxSlots], s_keep[kBands];
    __shared__ int s_thr[kBands], s_dlim[kBands], s_cape[kBands];
    __shared__ int4 s_scale[kDead + 1];
    __shared__ int s_desc[kMaxPass];
    __shared__ uint8_t s_valid[kMaxPass];          // candidates, bit c-1
    __shared__ uint16_t s_code[kMaxPass * 16];     // index | w << 8
    __shared__ int2 s_mnmx[kTile * kBands];
    __shared__ unsigned s_st[kMaxPairs];           // pair states
    __shared__ uint16_t s_list[kListCap];          // pair << 3 | c - 1
    __shared__ int s_scan[kWarps];
    __shared__ int s_np;
    __shared__ __align__(16) uint8_t s_o15[kMaxSlots * kTile * kBands * kP];
    __shared__ __align__(16) uint8_t s_o14[kMaxSlots * kTile * kBands * kP];
    __shared__ __align__(16) uint8_t s_sil[kTile * kBands];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kTile;
    const int nf = fmax - f0 < kTile ? fmax - f0 : kTile;

    // 0. the tile's coefficient rows (s_ci[off + j] is element g0 + j),
    // the tables, the scale table
    const size_t g0 = (static_cast<size_t>(b) * fmax + f0) * kCols;
    const size_t total = static_cast<size_t>(gridDim.y) * fmax * kCols;
    const int cnt = nf * kCols;
    int off = 0;
    if ((reinterpret_cast<uintptr_t>(ci) & 15) == 0) {
        off = static_cast<int>(g0 & 3);
        const size_t a0 = g0 - off;
        const int4* src = reinterpret_cast<const int4*>(ci + a0);
        for (int i = tid; 4 * i < off + cnt; i += kThreads) {
            if (a0 + 4 * i + 4 <= total) {
                const int4 v = src[i];
                s_ci[4 * i] = v.x;
                s_ci[4 * i + 1] = v.y;
                s_ci[4 * i + 2] = v.z;
                s_ci[4 * i + 3] = v.w;
            } else {
                for (int j = 0; j < 4; ++j)
                    if (a0 + 4 * i + j < total)
                        s_ci[4 * i + j] = ci[a0 + 4 * i + j];
            }
        }
    } else {
        for (int i = tid; i < cnt; i += kThreads) s_ci[i] = ci[g0 + i];
    }
    for (int i = tid; i < K * 256; i += kThreads) {
        s_w[i] = static_cast<int8_t>(w_tab[i]);
        s_xa[i] = xa_tab[i];
    }
    for (int i = tid; i < K * kBands * kP; i += kThreads)
        s_peff[i] = peff_tab[i];
    if (tid < K * kBands) s_hdr[tid] = hdr_scale[b * K * kBands + tid];
    if (tid < K) s_is1[tid] = is1[tid];
    if (tid < kBands) {
        s_keep[tid] = keep[b * kBands + tid];
        s_thr[tid] = thr[tid];
        s_dlim[tid] = dlim[tid];
        s_cape[tid] = cape[tid];
    }
    if (tid >= kThreads - kDead - 1)
        s_scale[tid - (kThreads - kDead - 1)] =
            scale_entry(mant, tid - (kThreads - kDead - 1));
    __syncthreads();

    // 1. the pass list: entry e = k << 7 | band << 3 | p (p < 5 live);
    // each (frame, band)'s min, max and silent flag
    if (warp == 0) {
        int np = 0;
        for (int e0 = 0; e0 < K << 7; e0 += 32) {
            const int e = e0 + lane;
            const int k = e >> 7, band = (e >> 3) & 15, p = e & 7;
            const int kbp = (k * kBands + band) * kP + p;
            const bool distinct = p < kP
                && (p == 0 || (s_is1[k] && s_peff[kbp] != s_peff[kbp - 1]));
            const unsigned m = __ballot_sync(0xffffffffu, distinct);
            if (distinct) {
                const int grp = lane & ~7;
                const unsigned above = m & ~((2u << lane) - 1u)
                                       & (0xffu << grp);
                const int next = above ? __ffs(above) - 1 - grp : kP;
                s_desc[np + __popc(m & ((1u << lane) - 1u))] =
                    band | k << 4 | p << 6 | (next - p) << 9;
            }
            np += __popc(m);
        }
        if (lane == 0) s_np = np;
    } else if (tid >= kThreads - kTile * kBands) {
        const int item = tid - (kThreads - kTile * kBands);
        const int fi = item >> 4, band = item & 15;
        if (fi < nf) {
            const int* row = s_ci + off + fi * kCols + band_start(band);
            int mn = kBig, mx = -kBig;
            for (int j = 0; j < band_size(band); ++j) {
                mn = min(mn, row[j]);
                mx = max(mx, row[j]);
            }
            s_mnmx[item] = make_int2(mn, mx);
            s_sil[item] = static_cast<int>(static_cast<unsigned>(mx)
                                           - static_cast<unsigned>(mn))
                          <= sil_max;
        }
    }
    __syncthreads();
    const int np = s_np;

    // 2. per (pass, code): the scale table index and the width; per pass
    // the candidates' filter.  Sixteen threads a pass (a half warp).
    for (int item = tid; item < ((np * 16 + 31) & ~31); item += kThreads) {
        const bool in = item < np * 16;
        const int pi = item >> 4, c = item & 15;
        bool ok = false;
        if (in) {
            const int d = s_desc[pi];
            const int band = pass_band(d), k = pass_slot(d);
            const int kb = k * kBands + band;
            const bool live = s_keep[band] != 0 && c >= 1;
            int idx = kDead, w = 0;
            if (live) {
                int sc = s_hdr[kb];
                if (s_is1[k])
                    sc += s_xa[kb * 16 + c] + s_peff[kb * kP + pass_col(d)];
                idx = sc & 63;
                w = s_w[kb * 16 + c];
            }
            s_code[item] = static_cast<uint16_t>(idx | w << 8);
            const int sf = s_scale[idx].x;
            ok = live && c <= 6 && w >= 1
                 && (sf << w) - sf / 2 <= s_dlim[band] - 1;
        }
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        if (in && c == 0)
            s_valid[pi] = static_cast<uint8_t>((m >> ((lane & 16) + 1)) & 63);
    }
    __syncthreads();

    // 3. per pair (pass pi, frame fi; pair = pi << 3 | fi), q a thread:
    // the first fitting code and the live candidates below it
    const int npairs = np << kTileShift;
    static_assert(kThreads == 256, "q below divides by 2^8");
    const int q = (npairs + kThreads - 1) >> 8;
    const int p0 = tid * q;
    const int p1 = p0 + q < npairs ? p0 + q : npairs;
    int count = 0;
    for (int pair = p0; pair < p1; ++pair) {
        const int pi = pair >> kTileShift, fi = pair & (kTile - 1);
        unsigned st = 0;
        if (fi < nf) {
            const int band = pass_band(s_desc[pi]);
            const int2 r = s_mnmx[fi * kBands + band];
            const uint16_t* code = s_code + pi * 16;
            int o15 = 15;
            for (int c = 14; c >= 1; --c) {
                const int ce = code[c];
                const int w = ce >> 8;
                const int sf = s_scale[ce & 0xFF].x;
                const int hprod = sf << (w > 1 ? w - 1 : 0);
                if (r.x >= -(hprod + ((sf - 1) >> 1))
                    && r.y <= hprod - ((sf + 2) >> 1))
                    o15 = c;
            }
            const unsigned live = s_valid[pi] & ((1u << (o15 - 1)) - 1u);
            st = live | static_cast<unsigned>(o15) << 8;
            count += __popc(live);
        }
        s_st[pair] = st;
    }
    // the block's exclusive prefix sum of the counts
    int incl = count;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int x = lane < kWarps ? s_scan[lane] : 0;
        for (int o = 1; o < kWarps; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += t;
        }
        if (lane < kWarps) s_scan[lane] = x;
    }
    __syncthreads();
    const int start = (warp ? s_scan[warp - 1] : 0) + incl - count;
    const int n_cand = s_scan[kWarps - 1];

    // 4. the live candidates, a thread each, in windows of kListCap
    for (int base = 0; base < n_cand; base += kListCap) {
        int pos = start;
        for (int pair = p0; pair < p1 && pos < base + kListCap; ++pair) {
            unsigned live = s_st[pair] & 63u;
            while (live) {
                const int c = __ffs(live);
                live &= live - 1u;
                if (pos >= base && pos < base + kListCap)
                    s_list[pos - base] =
                        static_cast<uint16_t>(pair << 3 | (c - 1));
                ++pos;
            }
        }
        __syncthreads();
        const int n_here = n_cand - base < kListCap ? n_cand - base
                                                     : kListCap;
        for (int e = tid; e < n_here; e += kThreads) {
            const int entry = s_list[e];
            const int pair = entry >> 3, c = (entry & 7) + 1;
            const int pi = pair >> kTileShift, fi = pair & (kTile - 1);
            const int band = pass_band(s_desc[pi]);
            const int ce = s_code[pi * 16 + c];
            const int w = ce >> 8;
            const int4 t = s_scale[ce & 0xFF];
            const int ref = 1 << (w - 1);
            const int mask = (1 << w) - 1;
            const int cape_b = s_cape[band];
            const int* row = s_ci + off + fi * kCols + band_start(band);
            const int n = band_size(band);
            // the sum as int32 (at most 32 * 2^25 for thr >= 0)
            unsigned es = 0;
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                const int a = row[j];
                const int stored = (rdiv(a, t) + ref) & mask;
                int diff = (stored - ref) * t.x - a;
                diff = diff < 0 ? -diff : diff;
                diff = diff > kDClamp ? kDClamp : diff;
                es += static_cast<unsigned>(diff * diff < cape_b
                                            ? diff * diff : cape_b);
            }
            if (static_cast<int>(es) <= s_thr[band])
                atomicOr(&s_st[pair], 1u << (15 + c));
        }
        __syncthreads();
    }

    // 5. per pair: the least passing key against o15's and code 14's
    for (int pair = p0; pair < p1; ++pair) {
        const int pi = pair >> kTileShift, fi = pair & (kTile - 1);
        if (fi >= nf) continue;
        const unsigned st = s_st[pair];
        const int d = s_desc[pi];
        const uint16_t* code = s_code + pi * 16;
        const int o15 = (st >> 8) & 15;
        int candmin = kCandBig;
        for (unsigned ok = (st >> 16) & 63u; ok; ok &= ok - 1u) {
            const int c = __ffs(ok);
            const int key = (code[c] >> 8) * 16 + c;
            candmin = key < candmin ? key : candmin;
        }
        const int key15 = (code[o15] >> 8) * 16 + o15;
        const int new15 = (candmin < key15 ? candmin : key15) & 15;
        const int key14 = (code[14] >> 8) * 16 + 14;
        const int new14 = o15 == 15 ? (candmin < key14 ? candmin : key14) & 15
                                    : new15;
        const int o = (pass_slot(d) * kTile + fi) * (kBands * kP)
                      + pass_band(d) * kP + pass_col(d);
        for (int j = 0; j < pass_ncols(d); ++j) {
            s_o15[o + j] = static_cast<uint8_t>(new15);
            s_o14[o + j] = static_cast<uint8_t>(new14);
        }
    }
    __syncthreads();

    // the tile's decisions: K runs of nf * 80 bytes, and nf * 16 flags
    const int n16 = nf * (kBands * kP / 16);
    for (int k = 0; k < K; ++k) {
        const size_t o = ((static_cast<size_t>(b) * K + k) * fmax + f0)
                         * (kBands * kP);
        const int4* s15 = reinterpret_cast<const int4*>(
            s_o15 + k * kTile * kBands * kP);
        const int4* s14 = reinterpret_cast<const int4*>(
            s_o14 + k * kTile * kBands * kP);
        if (tid < n16)
            reinterpret_cast<int4*>(out15 + o)[tid] = s15[tid];
        else if (tid >= 128 && tid - 128 < n16)
            reinterpret_cast<int4*>(out14 + o)[tid - 128] = s14[tid - 128];
    }
    if (tid >= 64 && tid < 64 + nf)
        reinterpret_cast<int4*>(silent + (static_cast<size_t>(b) * fmax
                                          + f0) * kBands)[tid - 64]
            = reinterpret_cast<const int4*>(s_sil)[tid - 64];
}

// mismatches of the reciprocal rdiv against the integer division over
// every |a| <= 2^20 (x) and every scale table entry (y)
__global__ void encode94_rdiv_check_kernel(const int32_t* __restrict__ mant,
                                           unsigned long long* bad) {
    const int a = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x)
                  - (1 << 20);
    if (a > (1 << 20)) return;
    const int4 t = scale_entry(mant, blockIdx.y);
    const unsigned ua = static_cast<unsigned>(a < 0 ? -a : a);
    const unsigned us = static_cast<unsigned>(t.x);
    const int q = static_cast<int>((2u * ua + us) / (2u * us));
    if (rdiv(a, t) != (a < 0 ? -q : q)) atomicAdd(bad, 1ull);
}

}  // namespace

extern "C" int dcs_encode94_decide(
        const int32_t* ci, const uint8_t* hdr_scale, const uint8_t* keep,
        const int32_t* w_tab, const int32_t* xa_tab, const int32_t* peff_tab,
        const uint8_t* is1, const int32_t* mant, const int32_t* thr,
        const int32_t* dlim, const int32_t* cape, int sil_max,
        uint8_t* out15, uint8_t* out14, uint8_t* silent, int n_streams,
        int K, int fmax, cudaStream_t stream) {
    if (K < 1 || K > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((fmax + kTile - 1) / kTile, n_streams);
    encode94_decide_kernel<<<grid, kThreads, 0, stream>>>(
        ci, hdr_scale, keep, w_tab, xa_tab, peff_tab, is1, mant, thr, dlim,
        cape, sil_max, out15, out14, silent, K, fmax);
    return static_cast<int>(cudaGetLastError());
}

// the decide kernel's geometry on this card: frames a block, then
// kernel_geometry's four (encode94_scale.cuh), then the SMs
extern "C" int dcs_encode94_decide_geometry(int* out) {
    out[0] = kTile;
    int err = kernel_geometry(
        reinterpret_cast<const void*>(encode94_decide_kernel), kThreads,
        out + 1);
    if (err == 0) err = sm_count(out + 5);
    return err;
}

extern "C" int dcs_encode94_rdiv_check(const int32_t* mant,
                                       unsigned long long* bad,
                                       cudaStream_t stream) {
    const dim3 grid(((2 << 20) + 1 + 255) / 256, kDead + 1);
    encode94_rdiv_check_kernel<<<grid, 256, 0, stream>>>(mant, bad);
    return static_cast<int>(cudaGetLastError());
}
