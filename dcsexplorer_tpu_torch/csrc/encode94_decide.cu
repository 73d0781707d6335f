// encode94_decide: the 1994+ encoder's decision tables on the card.
//
// Replaces the decision half of the JAX package's device encoder:
// dcsexplorer_tpu/encoder/device94.py:_encode_all's band min/max and
// silence (:313-321), _derive_luts (:268-296), and _encode_format's first
// fitting code and wrap refinement (:114-153, with _refine_ok :70-93 and
// the exact-floor _rdiv :55-67).  Plain version: device94.decide94_plain.
//
// One warp a band (lanes over its 7 to 32 positions), 16 warps a block, a
// block a tile of kTile frames of one stream.  Each warp first derives its
// band's tables for every slot, code and pre-adjustment column from the
// stream's header scale codes (width, scale factor, fit window) into its
// own stretch of shared memory.  Then per frame: min/max by warp
// reductions, and per slot and column the first fitting code by one ballot
// (lane c tests code c), then the candidates 1..6 below it whose range
// floor is within the budget, each an exact capped error sum over the lanes
// (integer rdiv; every term is capped at cape <= 2^25).  A column whose
// scale pre-adjustment equals the previous column's (every column of a
// type-0 slot, and of bands past 2) has the same tables and repeats its
// result: 8 of the 15 (slot, column) passes of bands 0-2 remain under the
// default slots (0,0), (1,0), (1,3).
//
// Every value stays in int32 without wrap: |ci| <= 2^20, scale factors
// < 2^16, widths <= 15, so (2^w)*sf < 2^31, and the error terms are capped.
// Codes out of this kernel are 0..15, and out14 <= 14: the select kernel's
// delta index relies on it (a code 15 never follows a 0).
//
// Bound: integer operations (the candidates' error sums, data dependent)
// or the bytes of the coefficients, whichever is larger; the outputs are
// two bytes a (slot, frame, band, column).
//
// Build: ops/kernels.py (nvcc -gencode arch=compute_90a,code=sm_90a, plain
// C interface, ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // frames per block
constexpr int kBands = 16;
constexpr int kThreads = 32 * kBands;
constexpr int kCols = 255;
constexpr int kMaxSlots = 3;
constexpr int kP = 5;              // pre-adjustment columns (PMAX)
constexpr int kCand = 6;           // wrap-refinement candidates 1..6
constexpr int kDClamp = 5793;
constexpr int kBig = 1 << 30;
constexpr int kCandBig = 1 << 14;

__device__ __forceinline__ int band_start(int b) {
    return b == 0 ? 0 : (b == 1 ? 7 : 15 + 16 * (b - 2));
}
__device__ __forceinline__ int band_size(int b) {
    return b == 0 ? 7 : (b == 1 ? 8 : (b == 15 ? 32 : 16));
}

// sign(a) * floor((2|a| + s) / 2s), s >= 1, |a| <= 2^20
__device__ __forceinline__ int rdiv(int a, int s) {
    const unsigned ua = a < 0 ? 0u - static_cast<unsigned>(a)
                              : static_cast<unsigned>(a);
    const unsigned us = static_cast<unsigned>(s);
    const int q = static_cast<int>((2u * ua + us) / (2u * us));
    return a < 0 ? -q : q;
}

struct BandTables {
    int amin[kMaxSlots][15][kP];   // codes 1..15
    int amax[kMaxSlots][15][kP];
    int sf[kMaxSlots][kCand][kP];  // codes 1..6
    int8_t w[kMaxSlots][16][kP];   // codes 0..15
    bool same[kMaxSlots][kP];      // column p's tables equal column p-1's
};

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
    __shared__ BandTables tabs[kBands];
    const int band = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kTile;
    BandTables& t = tabs[band];
    const bool kept = keep[b * kBands + band] != 0;

    // this band's tables for every slot, code and column
    for (int e = lane; e < K * 16 * kP; e += 32) {
        const int k = e / (16 * kP);
        const int c = e / kP % 16;
        const int p = e % kP;
        const int kb = k * kBands + band;
        const bool live = kept && c >= 1;
        int sc = hdr_scale[b * K * kBands + kb];
        if (is1[k]) sc += xa_tab[kb * 16 + c] + peff_tab[kb * kP + p];
        const int w = live ? w_tab[kb * 16 + c] : 0;
        int sf = live ? mant[sc & 3] >> (15 - ((sc >> 2) & 0xF)) : 1;
        sf = sf < 1 ? 1 : sf;
        const int hprod = sf << (w > 1 ? w - 1 : 0);
        t.w[k][c][p] = static_cast<int8_t>(w);
        if (c >= 1) {
            t.amax[k][c - 1][p] = hprod - ((sf + 2) >> 1);
            t.amin[k][c - 1][p] = -(hprod + ((sf - 1) >> 1));
        }
        if (c >= 1 && c <= kCand) t.sf[k][c - 1][p] = sf;
    }
    if (lane < K * kP) {
        const int k = lane / kP, p = lane % kP;
        const int kb = k * kBands + band;
        t.same[k][p] = p > 0 && (!is1[k] || peff_tab[kb * kP + p]
                                            == peff_tab[kb * kP + p - 1]);
    }
    __syncwarp();

    const int n = band_size(band);
    const bool in_band = lane < n;
    const int thr_b = thr[band];
    const int dlim_b = dlim[band];
    const int cape_b = cape[band];

    for (int f = f0; f < f0 + kTile && f < fmax; ++f) {
        const size_t row = static_cast<size_t>(b) * fmax + f;
        const int a = in_band ? ci[row * kCols + band_start(band) + lane] : 0;
        const int mn = __reduce_min_sync(0xffffffffu, in_band ? a : kBig);
        const int mx = __reduce_max_sync(0xffffffffu, in_band ? a : -kBig);
        if (lane == 0)
            silent[row * kBands + band] =
                static_cast<int>(static_cast<unsigned>(mx)
                                 - static_cast<unsigned>(mn)) <= sil_max;
        for (int k = 0; k < K; ++k) {
            int r15[kP], r14[kP];
#pragma unroll
            for (int p = 0; p < kP; ++p) {
                if (p > 0 && t.same[k][p]) {   // equal tables, equal result
                    r15[p] = r15[p - 1];
                    r14[p] = r14[p - 1];
                    continue;
                }
                // the first code 1..15 whose window holds [mn, mx]
                const bool fit = lane >= 1 && lane <= 15
                    && mn >= t.amin[k][lane - 1][p]
                    && mx <= t.amax[k][lane - 1][p];
                const unsigned m = __ballot_sync(0xffffffffu, fit);
                const int o15 = m ? __ffs(m) - 1 : 15;
                // wrap refinement: candidates below it within the budget
                int candmin = kCandBig;
                const int cmax = kept ? (o15 - 1 < kCand ? o15 - 1 : kCand)
                                      : 0;
                for (int c = 1; c <= cmax; ++c) {
                    const int w = t.w[k][c][p];
                    const int sf = t.sf[k][c - 1][p];
                    if (w < 1 || (sf << w) - sf / 2 > dlim_b - 1) continue;
                    int e = 0;
                    if (in_band) {
                        const int ref = 1 << (w - 1);
                        const int stored = (rdiv(a, sf) + ref)
                                           & ((1 << w) - 1);
                        int diff = (stored - ref) * sf - a;
                        diff = diff < 0 ? -diff : diff;
                        diff = diff > kDClamp ? kDClamp : diff;
                        e = diff * diff < cape_b ? diff * diff : cape_b;
                    }
                    // the sum as int32 (at most 32 * 2^25 for thr >= 0)
                    const int es = static_cast<int>(__reduce_add_sync(
                        0xffffffffu, static_cast<unsigned>(e)));
                    const int key = w * 16 + c;
                    if (es <= thr_b && key < candmin)
                        candmin = key;
                }
                const int key15 = t.w[k][o15][p] * 16 + o15;
                const int new15 = (candmin < key15 ? candmin : key15) & 15;
                const int key14 = t.w[k][14][p] * 16 + 14;
                r15[p] = new15;
                r14[p] = o15 == 15 ? (candmin < key14 ? candmin : key14) & 15
                                   : new15;
            }
            if (lane < kP) {
                const size_t o = ((static_cast<size_t>(b) * K + k) * fmax + f)
                                 * (kBands * kP) + band * kP + lane;
                int v15 = r15[0], v14 = r14[0];
#pragma unroll
                for (int j = 1; j < kP; ++j)
                    if (lane == j) { v15 = r15[j]; v14 = r14[j]; }
                out15[o] = static_cast<uint8_t>(v15);
                out14[o] = static_cast<uint8_t>(v14);
            }
        }
    }
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
