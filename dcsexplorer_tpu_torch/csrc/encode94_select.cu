// encode94_select: the 1994+ encoder's band-type scan, exact stream sizes,
// winner and packed result rows, on the card.
//
// Replaces the rest of the JAX package's device encoder:
// dcsexplorer_tpu/encoder/device94.py:_encode_format's scan and sizes
// (:155-232: lax.scan over frames, deltas, codeword lengths, zero-run
// pairing by a cummax) and _encode_all's winner and packing (:331-346).
// Plain version: device94.select94_plain.
//
// Bound: the bytes of the coefficients read once per slot, or the integer
// operations of the sizes (about 22 a sample and slot), whichever is
// larger.  Neither sets the pace: a walk over the frames in order is a
// chain of Fmax dependent steps a band, and a size pass that looks its
// tables up in global memory a chain of dependent loads a frame.  The
// design below takes both off the chain.
//
// Two launches from one C entry, the second a programmatic dependent of
// the first (and the first of the launch before it), so that each one's
// launch and staging overlap the end of the one before:
// 1. encode94_scan, a warp a (stream, slot, band), a block 4 bands of one
//    (stream, slot): 4 x K x B blocks of 128 threads (192 at enc94_dev's
//    chunk).  The scan's carry is the previous code c, and the next step
//    depends on it only through its class: 0 for c = 0 (the code comes
//    from out14), else 1 + the column pi(c) = pip[min(c, 15)] on a band
//    with dep, 1 on one without (the code comes from out15 at that
//    column); a silent or dropped band gives 0.  So a frame is a map of
//    the (at most 6) classes, a nibble each in one word, and the scan is
//    a prefix of compositions:
//      - the block stages its bands' decisions (20 bytes of each 80-byte
//        row of out15 and out14, and a word of silent flags) for a round
//        of up to 32 x kMaxSeg frames in shared memory, every load of a
//        thread issued before its first store;
//      - each lane builds the maps of its segment of L = ceil(Fmax/32)
//        frames (at most kMaxSeg; longer inputs take several rounds, the
//        class carried from one to the next) in registers and composes
//        them as a tree;
//      - an inclusive warp scan of the segments' maps by __shfl_up_sync
//        (5 rounds) gives each lane its entry class;
//      - each lane replays its segment from there, the classes by its
//        frames' maps and, off that chain, the codes (the full decision
//        byte), the columns, and the delta codes' bits of the live frames
//        of a kept band (the code before the segment from the lane before,
//        by a shuffle);
//      - the codes and columns go out as words (a frame's 4 bands), and
//        the block's delta bits to its own entry of the stream's sums.
//    Its first block of a (stream, slot) clears the size pass's entry of
//    the sums, and of a stream the block counter.
// 2. encode94_size, a block a (32-frame tile, slot, stream): 9 x K x B
//    blocks of 256 threads (432 at the chunk).  Before it waits on the
//    scan, the block stages the tile's coefficient rows (16-byte loads),
//    its slot's width and adjustment tables, the stream's header codes,
//    the codeword lengths and the 65-entry scale table with its
//    reciprocals (encode94_scale.cuh) in shared memory; then the tile's
//    codes and columns, and for each (frame, band) its scale entry, width
//    and zero-pair length.  A frame's 255 positions lie on its 8 warps at
//    lane v = position + 1, which puts every band inside one warp (band 0
//    at lanes 1-7 of warp 0, band 1 at 8-15, then 16 lanes a band, band 15
//    on warp 7).  Each warp takes the frames where one of its bands is
//    live, four at a time, without a branch: per position the division by
//    __umulhi, the codeword length, and the zero pairs within the band
//    from two ballots (a run pairs from its start: the start is the
//    highest run start at or below the lane, a band's first lane always
//    one).  Frames past nf count nothing.  The block sum is added
//    atomically to its (stream, slot) entry.  The last block of a stream
//    (a counter after a fence) adds the delta bits, picks the winner, the
//    least nbytes*K + k among the wanted slots with nbytes = 18 +
//    ceil(bits/8), and writes the packed row through shared memory with
//    16-byte loads and stores:
//      [ nbytes[K] as 4 LE bytes each | winner | codes[F,16] | pidx[F,16] ]
//
// Sums: nbits is [B, K, kSums]: entries 0-3 the delta bits of the four
// scan blocks (each written by its block), entry 4 the size pass's
// (cleared by the scan launch, added to by the size blocks).  Nothing
// assumes fresh memory; the last block resets the counter.
//
// Invariants kept rather than clamped: decide's codes are 0..15 and out14
// <= 14, so a delta is -15..14 and inside the delta table (-16..14).  A
// decision byte above 15 is carried as class of 15 and written as it is,
// as the plain version does.  Indexes are clamped all the same, as a JAX
// gather clamps, so that no input reads out of bounds.  Every sum is an
// integer: the result does not depend on the order of the atomics.
// Preconditions: |ci| <= 2^20 and scale factors under 2^16 (the
// reciprocal division's range; the wrappers refuse other coefficients).
//
// Build: ops/kernels.py (nvcc -gencode arch=compute_90a,code=sm_90a, plain
// C interface, ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode94_scale.cuh"

namespace {

constexpr int kBands = 16;
constexpr int kP = 5;                  // pre-adjustment columns (PMAX)
constexpr int kMaxSlots = 3;
constexpr int kCols = 255;
constexpr int kGroup = 4;              // bands a scan block
constexpr int kGroups = kBands / kGroup;
constexpr int kGroupWords = kGroup * kP / 4;         // 5 words of a row
constexpr int kScanThreads = 32 * kGroup;
constexpr int kMaxSeg = 9;             // frames a lane in a round
constexpr int kMaxRound = 32 * kMaxSeg;
constexpr int kStageWords =            // decision words a thread a round
    (kMaxRound * kGroupWords + kScanThreads - 1) / kScanThreads;
constexpr int kStageSil = (kMaxRound + kScanThreads - 1) / kScanThreads;
constexpr int kSums = kGroups + 1;     // nbits entries a (stream, slot)
constexpr int kMaxDelta = 64;          // delta table entries at most
constexpr int kTile = 32;              // frames a size block
constexpr int kSizeWarps = 8;          // a frame's 256 lanes
constexpr int kSizeThreads = 32 * kSizeWarps;
static_assert(kSizeThreads == kBands * 16, "a slot's width table a thread");
static_assert(kTile <= 32, "a tile's frames on a warp's lanes");
constexpr int kPackChunk = 16384;      // bytes of the packed row a pass
static_assert(kPackChunk % 16 == 0 && kPackChunk + 16 <= kTile * kCols * 4,
              "a chunk of the packed row fits in the coefficients' buffer");
constexpr int kBig = 1 << 30;
constexpr int kDeltaLo = -16;          // first delta of the delta table

// a map of the scan's classes (at most 6), a nibble each: the image of
// class x is nibble x
constexpr uint32_t kIdentity = 0x543210u;
constexpr int kClasses = kP + 1;

__device__ __forceinline__ uint32_t image(uint32_t m, uint32_t x) {
    return (m >> (4u * x)) & 15u;
}

// b after a
__device__ __forceinline__ uint32_t then(uint32_t a, uint32_t b) {
    uint32_t c = 0u;
#pragma unroll
    for (int x = 0; x < kClasses; ++x)
        c |= image(b, image(a, x)) << (4 * x);
    return c;
}

__device__ __forceinline__ uint32_t min15(uint32_t c) {
    return c < 15u ? c : 15u;
}

__global__ void __launch_bounds__(kScanThreads)
encode94_scan_kernel(const uint8_t* __restrict__ out15,
                     const uint8_t* __restrict__ out14,
                     const uint8_t* __restrict__ silent,
                     const int32_t* __restrict__ nf,
                     const uint8_t* __restrict__ keep,
                     const int32_t* __restrict__ pip,
                     const uint8_t* __restrict__ dep,
                     const int32_t* __restrict__ delta_bits, int delta_len,
                     uint8_t* __restrict__ codes, uint8_t* __restrict__ pidx,
                     int32_t* __restrict__ nbits, int32_t* __restrict__ done,
                     int K, int fmax) {
    __shared__ uint32_t s15[kMaxRound * kGroupWords];
    __shared__ uint32_t s14[kMaxRound * kGroupWords];
    __shared__ uint32_t s_sil[kMaxRound];
    __shared__ uint32_t s_code[kMaxRound];
    __shared__ uint32_t s_pidx[kMaxRound];
    __shared__ int s_delta[kMaxDelta];
    __shared__ int s_warp[kGroup];
    const int g = blockIdx.x;
    const int k = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int w = tid >> 5;
    const int band = g * kGroup + w;
    const int kb = k * kBands + band;
    const size_t bk = static_cast<size_t>(b) * K + k;
    // the launch before this one complete (this one's own launch overlapped
    // its end); the size launch may start (its staging overlaps this one)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;");

    // the class of each code 0..15 (two words of 8 nibbles): 0 for 0, else
    // 1 + its column pi(c) = pip[c] (clamped) on a band with dep, else 1
    const bool kept = keep[b * kBands + band] != 0;
    const bool has_dep = dep[kb] != 0;
    uint32_t cls_lo = 0u, cls_hi = 0u;
#pragma unroll
    for (int c = 1; c < 16; ++c) {
        int pi = has_dep ? pip[k * 16 + c] : 0;
        pi = pi < 0 ? 0 : (pi >= kP ? kP - 1 : pi);
        if (c < 8) cls_lo |= static_cast<uint32_t>(1 + pi) << (4 * c);
        else cls_hi |= static_cast<uint32_t>(1 + pi) << (4 * (c - 8));
    }
    int pi0 = has_dep ? pip[k * 16] : 0;        // the column after a 0
    pi0 = pi0 < 0 ? 0 : (pi0 >= kP ? kP - 1 : pi0);
    const int n_cols = has_dep ? kP : 1;
    // the class of a decision byte (a byte past 15 reads as 15)
    auto cls = [&](uint32_t c) {
        c = min15(c);
        return ((c & 8u ? cls_hi : cls_lo) >> (4u * (c & 7u))) & 15u;
    };

    if (g == 0 && tid == 0) {
        nbits[bk * kSums + kGroups] = 0;
        if (k == 0) done[b] = 0;
    }
    const int nf_b = nf[b];
    const int seg = min((fmax + 31) / 32, kMaxSeg);
    const int round = 32 * seg;
    const uint32_t* o15 = reinterpret_cast<const uint32_t*>(out15);
    const uint32_t* o14 = reinterpret_cast<const uint32_t*>(out14);
    const uint32_t* sil = reinterpret_cast<const uint32_t*>(silent);
    const uint8_t* b15 = reinterpret_cast<const uint8_t*>(s15) + kP * w;
    const uint8_t* b14 = reinterpret_cast<const uint8_t*>(s14) + kP * w;
    const uint8_t* bsil = reinterpret_cast<const uint8_t*>(s_sil) + w;
    uint8_t* bcode = reinterpret_cast<uint8_t*>(s_code) + w;
    uint8_t* bpidx = reinterpret_cast<uint8_t*>(s_pidx) + w;
    uint32_t state = 0;                  // the class before the round
    uint32_t code_in = 0;                // the code before the round
    int acc = 0;
    for (int r0 = 0; r0 < fmax; r0 += round) {
        const int n = min(round, fmax - r0);
        // each thread's words of the round, all loads before any store
        uint32_t v15[kStageWords], v14[kStageWords], vs[kStageSil];
#pragma unroll
        for (int u = 0; u < kStageWords; ++u) {
            const int i = tid + u * kScanThreads;
            const int f = i / kGroupWords;
            const size_t at = (bk * fmax + r0 + f) * (kBands * kP / 4)
                              + g * kGroupWords + (i - f * kGroupWords);
            v15[u] = i < n * kGroupWords ? o15[at] : 0u;
            v14[u] = i < n * kGroupWords ? o14[at] : 0u;
        }
#pragma unroll
        for (int u = 0; u < kStageSil; ++u) {
            const int i = tid + u * kScanThreads;
            vs[u] = i < n ? sil[(static_cast<size_t>(b) * fmax + r0 + i)
                                * (kBands / 4) + g] : 0u;
        }
        if (r0 == 0 && tid < delta_len) s_delta[tid] = delta_bits[tid];
#pragma unroll
        for (int u = 0; u < kStageWords; ++u) {
            const int i = tid + u * kScanThreads;
            if (i < n * kGroupWords) {
                s15[i] = v15[u];
                s14[i] = v14[u];
            }
        }
#pragma unroll
        for (int u = 0; u < kStageSil; ++u) {
            const int i = tid + u * kScanThreads;
            if (i < n) s_sil[i] = vs[u];
        }
        __syncthreads();

        // this lane's segment [lo, hi) of the round: each frame's map (a
        // dead frame, silent or not kept, sends every class to 0), then
        // their composition as a tree
        const int lo = min(lane * seg, n);
        const int hi = min(lo + seg, n);
        uint32_t mf[kMaxSeg], t[kMaxSeg];
#pragma unroll
        for (int j = 0; j < kMaxSeg; ++j) {
            const int i = lo + j;
            mf[j] = kIdentity;
            if (i < hi) {
                mf[j] = 0u;
                if (kept && bsil[4 * i] == 0) {
                    const uint8_t* r15 = b15 + i * (kGroup * kP);
                    mf[j] = cls(b14[i * (kGroup * kP) + pi0]);
#pragma unroll
                    for (int c = 0; c < kP; ++c)
                        if (c < n_cols) mf[j] |= cls(r15[c]) << (4 * (c + 1));
                }
            }
            t[j] = mf[j];
        }
#pragma unroll
        for (int d = 1; d < kMaxSeg; d <<= 1) {
#pragma unroll
            for (int j = 0; j + d < kMaxSeg; j += 2 * d)
                t[j] = then(t[j], t[j + d]);
        }
        // inclusive prefix over the lanes: the maps of all frames so far
        uint32_t m = t[0];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t before = __shfl_up_sync(0xffffffffu, m, d);
            if (lane >= d) m = then(before, m);
        }
        const uint32_t ex = __shfl_up_sync(0xffffffffu, m, 1);
        uint32_t x = lane == 0 ? state : image(ex, state);

        // replay the segment from its entry class: the classes by the
        // frames' maps, the codes and columns from the decisions
        uint32_t first = 0, pc = 0;
#pragma unroll
        for (int j = 0; j < kMaxSeg; ++j) {
            const int i = lo + j;
            if (i < hi) {
                const uint32_t pi = x == 0 ? pi0 : x - 1;
                uint32_t c = 0;
                if (kept && bsil[4 * i] == 0)
                    c = (x == 0 ? b14 : b15)[i * (kGroup * kP) + pi];
                bcode[4 * i] = static_cast<uint8_t>(c);
                bpidx[4 * i] = static_cast<uint8_t>(pi);
                if (j == 0) {
                    first = c;
                } else if (kept && r0 + i < nf_b) {
                    int di = static_cast<int>(c) - static_cast<int>(pc)
                             - kDeltaLo;
                    di = di < 0 ? 0 : (di >= delta_len ? delta_len - 1 : di);
                    acc += s_delta[di];
                }
                pc = c;
                x = image(mf[j], x);
            }
        }
        // the first frame's delta, from the code before it
        const uint32_t before = __shfl_up_sync(0xffffffffu, pc, 1);
        if (lo < hi && kept && r0 + lo < nf_b) {
            const uint32_t p = lane == 0 ? code_in : before;
            int di = static_cast<int>(first) - static_cast<int>(p) - kDeltaLo;
            di = di < 0 ? 0 : (di >= delta_len ? delta_len - 1 : di);
            acc += s_delta[di];
        }
        code_in = __shfl_sync(0xffffffffu, pc, (n - 1) / seg);
        state = cls(code_in);
        __syncthreads();

        // the round's codes and columns out, a word a frame
        for (int i = tid; i < n; i += kScanThreads) {
            const size_t at = (bk * fmax + r0 + i) * (kBands / 4) + g;
            reinterpret_cast<uint32_t*>(codes)[at] = s_code[i];
            reinterpret_cast<uint32_t*>(pidx)[at] = s_pidx[i];
        }
        __syncthreads();
    }

    const int wsum = static_cast<int>(
        __reduce_add_sync(0xffffffffu, static_cast<unsigned>(acc)));
    if (lane == 0) s_warp[w] = wsum;
    __syncthreads();
    if (tid == 0) {
        int total = 0;
        for (int i = 0; i < kGroup; ++i) total += s_warp[i];
        nbits[bk * kSums + g] = total;
    }
}

__global__ void __launch_bounds__(kSizeThreads)
encode94_size_kernel(const int32_t* __restrict__ ci,
                     const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ pidx,
                     const int32_t* __restrict__ nf,
                     const uint8_t* __restrict__ keep,
                     const uint8_t* __restrict__ hdr_scale,
                     const uint8_t* __restrict__ wanted,
                     const int32_t* __restrict__ w_tab,
                     const int32_t* __restrict__ xa_tab,
                     const int32_t* __restrict__ peff_tab,
                     const uint8_t* __restrict__ is1,
                     const int32_t* __restrict__ mant,
                     const int32_t* __restrict__ cb_bits,
                     const int32_t* __restrict__ tz_bits,
                     int32_t* __restrict__ nbits,
                     int32_t* __restrict__ done, uint8_t* __restrict__ packed,
                     int K, int fmax) {
    __shared__ __align__(16) int s_ci[kTile * kCols + 4];
    // each (frame, band) of the tile: sf | s << 24, m (its scale table
    // entry), the zero-pair length of its width, its width
    __shared__ int4 s_fe[kTile * kBands];
    __shared__ int4 s_scale[kDead + 1];
    __shared__ int s_w[kBands * 16], s_xa[kBands * 16], s_peff[kBands * kP];
    __shared__ int s_hdr[kBands];
    __shared__ uint8_t s_keep[kBands];
    __shared__ uint8_t s_cb[7 * 64];
    __shared__ int s_tz[7];
    __shared__ uint32_t s_code[kTile * kBands / 4];
    __shared__ uint32_t s_pidx[kTile * kBands / 4];
    __shared__ int s_warp[kSizeWarps];
    __shared__ int s_sums[kMaxSlots * kSums];
    __shared__ uint8_t s_wanted[kMaxSlots];
    __shared__ int s_nbytes[kMaxSlots];
    __shared__ int s_winner;
    __shared__ bool s_last;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wp = tid >> 5;
    const int f0 = blockIdx.x * kTile;
    const int k = blockIdx.y;
    const int b = blockIdx.z;
    const size_t bk = static_cast<size_t>(b) * K + k;
    int nf_b = nf[b];
    nf_b = nf_b < fmax ? nf_b : fmax;
    const int n_live = nf_b - f0 < kTile ? nf_b - f0 : kTile;

    int acc = 0;
    if (n_live > 0) {
        // the tile's coefficient rows (s_ci[off + j] is element g0 + j),
        // 16-byte loads where ci is aligned; the slot's tables, the
        // stream's codes and columns of the tile, the codeword lengths and
        // the scale table, each thread's loads issued together
        const size_t g0 = (static_cast<size_t>(b) * fmax + f0) * kCols;
        const size_t total = static_cast<size_t>(gridDim.z) * fmax * kCols;
        const int cnt = n_live * kCols;
        int off = 0;
        if ((reinterpret_cast<uintptr_t>(ci) & 15) == 0) {
            off = static_cast<int>(g0 & 3);
            const size_t a0 = g0 - off;
            const int n4 = (off + cnt + 3) / 4;
            const int n_full = static_cast<int>(
                min(static_cast<size_t>(n4), (total - a0) / 4));
            const int4* src = reinterpret_cast<const int4*>(ci + a0);
#pragma unroll 4
            for (int i = tid; i < n_full; i += kSizeThreads)
                reinterpret_cast<int4*>(s_ci)[i] = src[i];
            for (int i = 4 * n_full + tid; i < off + cnt; i += kSizeThreads)
                s_ci[i] = ci[a0 + i];
        } else {
            for (int i = tid; i < cnt; i += kSizeThreads) s_ci[i] = ci[g0 + i];
        }
        s_w[tid] = w_tab[k * kBands * 16 + tid];
        s_xa[tid] = xa_tab[k * kBands * 16 + tid];
        if (tid < kBands * kP) s_peff[tid] = peff_tab[k * kBands * kP + tid];
        if (tid < kBands) {
            s_hdr[tid] = hdr_scale[bk * kBands + tid];
            s_keep[tid] = keep[b * kBands + tid];
        }
        for (int i = tid; i < 7 * 64; i += kSizeThreads)
            s_cb[i] = static_cast<uint8_t>(cb_bits[i]);
        if (tid < 7) s_tz[tid] = tz_bits[tid];
        if (tid < kDead + 1) s_scale[tid] = scale_entry(mant, tid);
        const bool type1 = is1[k] != 0;
        // what follows reads the scan launch's codes (its grid complete)
        asm volatile("griddepcontrol.wait;" ::: "memory");
        const uint32_t* cw = reinterpret_cast<const uint32_t*>(codes)
                             + (bk * fmax + f0) * (kBands / 4);
        const uint32_t* pw = reinterpret_cast<const uint32_t*>(pidx)
                             + (bk * fmax + f0) * (kBands / 4);
        if (tid < n_live * (kBands / 4)) {
            s_code[tid] = cw[tid];
            s_pidx[tid] = pw[tid];
        }
        __syncthreads();
        // each (frame, band): its code's width and scale table entry (sc &
        // 63 of a live code, else the sf = 1 entry)
        for (int e = tid; e < n_live * kBands; e += kSizeThreads) {
            const int band = e & (kBands - 1);
            const uint32_t code = reinterpret_cast<const uint8_t*>(s_code)[e];
            uint32_t pi = reinterpret_cast<const uint8_t*>(s_pidx)[e];
            pi = pi < kP ? pi : kP - 1;
            const int c = static_cast<int>(min15(code));
            int w = 0, idx = kDead;
            if (s_keep[band] != 0 && c >= 1) {
                w = s_w[band * 16 + c];
                unsigned sc = static_cast<unsigned>(s_hdr[band]);
                if (type1)
                    sc += static_cast<unsigned>(s_xa[band * 16 + c])
                          + static_cast<unsigned>(s_peff[band * kP + pi]);
                idx = static_cast<int>(sc & 63u);
            }
            const int4 t = s_scale[idx];
            s_fe[e] = make_int4(t.x | (t.z << 24), t.y,
                                s_tz[w < 0 ? 0 : (w > 6 ? 6 : w)], w);
        }
        __syncthreads();

        // lane v = position + 1 of the frame: band 0 at v 1-7, band 1 at
        // 8-15, band j >= 2 at 16 (j - 1) .. +15 (band 15: 224-255)
        const int v = wp * 32 + lane;
        const bool valid = v >= 1;
        const int band = v < 8 ? 0 : (v < 16 ? 1 : min((v >> 4) + 1, 15));
        const unsigned first_lanes = wp == 0 ? 0x00010102u
                                   : (wp == kSizeWarps - 1 ? 1u : 0x00010001u);
        const bool seg_last = lane == 31 || ((first_lanes >> (lane + 1)) & 1u);
        const unsigned low = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
        const int* a_row = s_ci + off + (valid ? v - 1 : 0);
        const int4* fe_row = s_fe + band;
        // a frame's bits on this lane, without a branch: the codeword, the
        // pair symbol at a pair's head, nothing in its shadow
        auto frame_bits = [&](int i, bool on) {
            const int a = a_row[i * kCols];
            const int4 fe = fe_row[i * kBands];
            const int w = fe.w;
            const int q = rdiv(a, make_int4(fe.x & 0xFFFFFF, fe.y,
                                            fe.x >> 24, 0));
            const bool live = on && valid && w != 0;   // a code 0: width 0
            const bool is_cb = static_cast<unsigned>(w - 1) < 6u;
            const bool zero = live && is_cb && q == 0 && fe.z > 0;
            const unsigned z = __ballot_sync(0xffffffffu, zero);
            const unsigned starts = z & (~(z << 1) | first_lanes);
            const int run_start = 31 - __clz(starts & low);
            const bool head = zero && !seg_last && ((z >> lane) & 2u)
                              && ((lane - run_start) & 1) == 0;
            const unsigned heads = __ballot_sync(0xffffffffu, head);
            const bool shadow = ((heads << 1) >> lane) & 1u;
            const int wc = w < 1 ? 1 : (w > 6 ? 6 : w);
            const int cb = s_cb[wc * 64 + ((q + (1 << (wc - 1)))
                                           & ((1 << wc) - 1))];
            const int bits = head ? fe.z : (is_cb ? cb : w);
            return live && !shadow ? bits : 0;
        };
        // the frames where a band of this warp is live (lane i: frame i),
        // four at a time (a slot past the last one counts nothing)
        const int band_lo = wp == 0 ? 0 : 2 * wp + 1;
        const int band_hi = wp == 0 ? 2 : min(2 * wp + 2, kBands - 1);
        bool frame_live = false;
        if (lane < n_live)
            for (int bb = band_lo; bb <= band_hi; ++bb)
                frame_live |= s_fe[lane * kBands + bb].w != 0;
        unsigned todo = __ballot_sync(0xffffffffu, frame_live);
        while (todo) {
            int ii[4];
            bool on[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                on[u] = todo != 0;
                ii[u] = on[u] ? __ffs(todo) - 1 : 0;
                todo &= todo - 1;
            }
            acc += frame_bits(ii[0], on[0]) + frame_bits(ii[1], on[1])
                   + frame_bits(ii[2], on[2]) + frame_bits(ii[3], on[3]);
        }
    }

    // the sums and the counter: cleared by the scan launch
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int wsum = static_cast<int>(
        __reduce_add_sync(0xffffffffu, static_cast<unsigned>(acc)));
    if (lane == 0) s_warp[wp] = wsum;
    __syncthreads();
    if (tid == 0) {
        int total = 0;
        for (int i = 0; i < kSizeWarps; ++i) total += s_warp[i];
        atomicAdd(&nbits[bk * kSums + kGroups], total);
        __threadfence();
        const int n_blocks = gridDim.x * gridDim.y;
        s_last = atomicAdd(&done[b], 1) == n_blocks - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the stream's last block: sizes, winner, packed row (its counter back
    // to 0 for the next launch)
    if (tid < K * kSums)
        s_sums[tid] = __ldcg(&nbits[static_cast<size_t>(b) * K * kSums + tid]);
    if (tid >= 32 && tid < 32 + K)
        s_wanted[tid - 32] = wanted[b * K + tid - 32];
    __syncthreads();
    if (tid == 0) {
        done[b] = 0;
        int best = kBig, winner = 0;
        for (int j = 0; j < K; ++j) {
            int bits = 0;
            for (int i = 0; i < kSums; ++i) bits += s_sums[j * kSums + i];
            const int nbytes = 18 + (bits + 7) / 8;
            s_nbytes[j] = nbytes;
            const int key = s_wanted[j] ? nbytes * K + j : kBig;
            if (key < best) { best = key; winner = j; }
        }
        s_winner = winner;
    }
    __syncthreads();
    // the row through shared memory (s_ci, free now) in chunks: the
    // winner's codes and columns in with 16-byte loads, the row out with
    // 16-byte stores where its address is aligned, bytes at its two ends
    // (their words hold the rows beside it)
    const int winner = s_winner;
    const int head = 4 * K + 1;
    const int plane = fmax * kBands;            // a multiple of 256 bytes
    const int len = head + 2 * plane;
    uint8_t* row = packed + static_cast<size_t>(b) * len;
    const size_t wrow = (static_cast<size_t>(b) * K + winner) * plane;
    const int4* wc4 = reinterpret_cast<const int4*>(codes + wrow);
    const int4* wp4 = reinterpret_cast<const int4*>(pidx + wrow);
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15u);
    uint8_t* buf = reinterpret_cast<uint8_t*>(s_ci);
    for (int c0 = 0; c0 < len; c0 += kPackChunk) {
        const int n = min(kPackChunk, len - c0);
        // buf[mis + i] is row byte c0 + i
        if (c0 == 0 && tid < head)
            buf[mis + tid] = tid < 4 * K
                ? static_cast<uint8_t>(s_nbytes[tid >> 2] >> (8 * (tid & 3)))
                : static_cast<uint8_t>(winner);
        const int o_lo = max(c0 - head, 0);     // body bytes of the chunk
        const int o_hi = min(c0 + n - head, 2 * plane);
        for (int x = (o_lo >> 4) + tid; 16 * x < o_hi; x += kSizeThreads) {
            const int4 v = 16 * x < plane ? __ldg(wc4 + x)
                                          : __ldg(wp4 + x - plane / 16);
            const uint32_t word[4] = {static_cast<uint32_t>(v.x),
                                      static_cast<uint32_t>(v.y),
                                      static_cast<uint32_t>(v.z),
                                      static_cast<uint32_t>(v.w)};
#pragma unroll
            for (int q = 0; q < 16; ++q) {
                const int o = 16 * x + q;
                if (o >= o_lo && o < o_hi)
                    buf[mis + head + o - c0] =
                        static_cast<uint8_t>(word[q >> 2] >> (8 * (q & 3)));
            }
        }
        __syncthreads();
        uint8_t* dst = row + c0 - mis;          // 16-byte aligned
        const int first = (mis + 15) >> 4;      // whole 16-byte blocks
        const int last = (mis + n) >> 4;
        for (int j = first + tid; j < last; j += kSizeThreads)
            reinterpret_cast<int4*>(dst)[j] =
                reinterpret_cast<const int4*>(buf)[j];
        const int tail = max(16 * last, 16 * first);
        if (tid < 16 * first - mis && mis + tid < mis + n)
            dst[mis + tid] = buf[mis + tid];
        for (int i = tail + tid; i < mis + n; i += kSizeThreads)
            if (i >= 16 * first) dst[i] = buf[i];
        __syncthreads();
    }
}

int launch(const int32_t* ci, const uint8_t* out15, const uint8_t* out14,
           const uint8_t* silent, const int32_t* nf, const uint8_t* keep,
           const uint8_t* hdr_scale, const uint8_t* wanted,
           const int32_t* w_tab, const int32_t* xa_tab,
           const int32_t* peff_tab, const uint8_t* is1, const int32_t* mant,
           const int32_t* pip, const uint8_t* dep, const int32_t* cb_bits,
           const int32_t* tz_bits, const int32_t* delta_bits, int delta_len,
           uint8_t* codes, uint8_t* pidx, int32_t* nbits, int32_t* done,
           uint8_t* packed, int n_streams, int K, int fmax, int parts,
           cudaStream_t stream) {
    if (K < 1 || K > kMaxSlots || fmax < 16 || fmax % 16 || delta_len < 1
            || delta_len > kMaxDelta)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    if (parts & 1) {
        // a programmatic dependent launch too: its set-up overlaps the end
        // of the launch before it, whose results it reads after a wait
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(kGroups, K, n_streams);
        cfg.blockDim = dim3(kScanThreads);
        cfg.stream = stream;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        const cudaError_t err = cudaLaunchKernelEx(
            &cfg, encode94_scan_kernel, out15, out14, silent, nf, keep, pip,
            dep, delta_bits, delta_len, codes, pidx, nbits, done, K, fmax);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (parts & 2) {
        // after the scan launch, a programmatic dependent launch: the size
        // blocks stage what the scan does not write before they wait on it
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((fmax + kTile - 1) / kTile, K, n_streams);
        cfg.blockDim = dim3(kSizeThreads);
        cfg.stream = stream;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        const cudaError_t err = cudaLaunchKernelEx(
            &cfg, encode94_size_kernel, ci, codes, pidx, nf, keep, hdr_scale,
            wanted, w_tab, xa_tab, peff_tab, is1, mant, cb_bits, tz_bits,
            nbits, done, packed, K, fmax);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dcs_encode94_select(
        const int32_t* ci, const uint8_t* out15, const uint8_t* out14,
        const uint8_t* silent, const int32_t* nf, const uint8_t* keep,
        const uint8_t* hdr_scale, const uint8_t* wanted, const int32_t* w_tab,
        const int32_t* xa_tab, const int32_t* peff_tab, const uint8_t* is1,
        const int32_t* mant, const int32_t* pip, const uint8_t* dep,
        const int32_t* cb_bits, const int32_t* tz_bits,
        const int32_t* delta_bits, int delta_len,
        uint8_t* codes, uint8_t* pidx, int32_t* nbits, int32_t* done,
        uint8_t* packed, int n_streams, int K, int fmax,
        cudaStream_t stream) {
    return launch(ci, out15, out14, silent, nf, keep, hdr_scale, wanted,
                  w_tab, xa_tab, peff_tab, is1, mant, pip, dep, cb_bits,
                  tz_bits, delta_bits, delta_len, codes, pidx, nbits, done,
                  packed, n_streams, K, fmax, 3, stream);
}

// one of the two launches alone (parts 1: the scan, 2: the sizes), each as
// the path launches it, for timing them apart; the size launch reads what a
// scan launch left
extern "C" int dcs_encode94_select_parts(
        const int32_t* ci, const uint8_t* out15, const uint8_t* out14,
        const uint8_t* silent, const int32_t* nf, const uint8_t* keep,
        const uint8_t* hdr_scale, const uint8_t* wanted, const int32_t* w_tab,
        const int32_t* xa_tab, const int32_t* peff_tab, const uint8_t* is1,
        const int32_t* mant, const int32_t* pip, const uint8_t* dep,
        const int32_t* cb_bits, const int32_t* tz_bits,
        const int32_t* delta_bits, int delta_len,
        uint8_t* codes, uint8_t* pidx, int32_t* nbits, int32_t* done,
        uint8_t* packed, int n_streams, int K, int fmax, int parts,
        cudaStream_t stream) {
    return launch(ci, out15, out14, silent, nf, keep, hdr_scale, wanted,
                  w_tab, xa_tab, peff_tab, is1, mant, pip, dep, cb_bits,
                  tz_bits, delta_bits, delta_len, codes, pidx, nbits, done,
                  packed, n_streams, K, fmax, parts & 3, stream);
}

// the scratch's layout, for the wrapper's buffers: nbits entries a
// (stream, slot), and the most delta codes the scan stages
extern "C" int dcs_encode94_select_layout(int* out) {
    out[0] = kSums;
    out[1] = kMaxDelta;
    return 0;
}

// the two kernels' geometry on this card: for the scan, then the sizes,
// blocks a (stream, slot) or frames a block, then kernel_geometry's four
// (encode94_scale.cuh); then the SMs
extern "C" int dcs_encode94_select_geometry(int* out) {
    out[0] = kGroups;
    int err = kernel_geometry(
        reinterpret_cast<const void*>(encode94_scan_kernel), kScanThreads,
        out + 1);
    out[5] = kTile;
    if (err == 0)
        err = kernel_geometry(
            reinterpret_cast<const void*>(encode94_size_kernel), kSizeThreads,
            out + 6);
    if (err == 0) err = sm_count(out + 10);
    return err;
}
