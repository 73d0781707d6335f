// encode94_select: the 1994+ encoder's band-type scan, exact stream sizes,
// winner and packed result rows, on the card.
//
// Replaces the rest of the JAX package's device encoder:
// dcsexplorer_tpu/encoder/device94.py:_encode_format's scan and sizes
// (:155-232: lax.scan over frames, deltas, codeword lengths, zero-run
// pairing by a cummax) and _encode_all's winner and packing (:331-346).
// Plain version: device94.select94_plain.
//
// Two launches from one C entry:
// 1. encode94_scan, a block a stream: per (slot, band) one thread walks the
//    frames in order (the carry is the previous code: after a 0 the code
//    comes from out14, else from out15, at the pre-adjustment column
//    pip[prev] on type-1 bands 0-2).  The decisions of the next 16 frames
//    are loaded into registers while the scan runs over the current 16 in
//    shared memory.  Codes and columns go to a scratch [B, K, Fmax, 16];
//    the block also clears its stream's size sums and block counter.
// 2. encode94_size, a block a (16-frame tile, slot, stream), a warp a band
//    (lanes over its positions): each sample's codeword length (the full
//    CB_BITS table in shared memory), zero pairs within the band from two
//    ballots (a run pairs from its start: the start is the highest run
//    start at or below the lane), and the band's delta code; a block sum
//    added atomically to its (stream, slot) total.  The last block of a
//    stream (a counter after a fence) picks the winner, the least
//    nbytes*K + k among the wanted slots with nbytes = 18 + ceil(bits/8),
//    and writes the packed row:
//      [ nbytes[K] as 4 LE bytes each | winner | codes[F,16] | pidx[F,16] ]
//
// Invariants kept rather than clamped: decide's codes are 0..15 and out14
// <= 14, so a delta is -15..14 and always inside the delta table (-16..14);
// indexes are clamped all the same, as a JAX gather clamps, so that no
// input reads out of bounds.  Every sum is an integer: the result does not
// depend on the order of the atomics.
//
// Bound: the bytes of the coefficients read once per slot, or the integer
// operations of the sizes (about 40 a sample and slot), whichever is
// larger; the scan is a chain of Fmax dependent steps a band.
//
// Build: ops/kernels.py (nvcc -gencode arch=compute_90a,code=sm_90a, plain
// C interface, ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;              // frames per tile
constexpr int kBands = 16;
constexpr int kP = 5;                  // pre-adjustment columns (PMAX)
constexpr int kMaxSlots = 3;
constexpr int kCols = 255;
constexpr int kRowBytes = kTile * kBands * kP;        // 1280 a slot
constexpr int kRowWords = kRowBytes / 4;
constexpr int kSilWords = kTile * kBands / 4;         // 64
constexpr int kScanThreads = 256;
constexpr int kMaxWords = 2 * kMaxSlots * kRowWords + kSilWords;
constexpr int kWordsPerThread = (kMaxWords + kScanThreads - 1) / kScanThreads;
constexpr int kSizeThreads = 32 * kBands;
constexpr int kBig = 1 << 30;
constexpr int kDeltaLo = -16;          // first delta of the delta table

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

// word i of a tile's decisions: out15 of each slot, out14 of each slot,
// then the silent flags
__device__ __forceinline__ uint32_t tile_word(
        const uint32_t* o15, const uint32_t* o14, const uint32_t* sil,
        int b, int K, int fmax, int f0, int i) {
    const int rows = K * kRowWords;
    if (i < 2 * rows) {
        const uint32_t* src = i < rows ? o15 : o14;
        const int j = i < rows ? i : i - rows;
        const int k = j / kRowWords;
        return src[((static_cast<size_t>(b) * K + k) * fmax + f0) * (kBands * kP)
                   / 4 + j % kRowWords];
    }
    return sil[(static_cast<size_t>(b) * fmax + f0) * kBands / 4 + i - 2 * rows];
}

__global__ void __launch_bounds__(kScanThreads)
encode94_scan_kernel(const uint8_t* __restrict__ out15,
                     const uint8_t* __restrict__ out14,
                     const uint8_t* __restrict__ silent,
                     const uint8_t* __restrict__ keep,
                     const int32_t* __restrict__ pip,
                     const uint8_t* __restrict__ dep,
                     uint8_t* __restrict__ codes, uint8_t* __restrict__ pidx,
                     int32_t* __restrict__ nbits, int32_t* __restrict__ done,
                     int K, int fmax) {
    __shared__ uint32_t buf[2][kMaxWords];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int n_words = 2 * K * kRowWords + kSilWords;
    const int n_tiles = fmax / kTile;
    const uint32_t* o15 = reinterpret_cast<const uint32_t*>(out15);
    const uint32_t* o14 = reinterpret_cast<const uint32_t*>(out14);
    const uint32_t* sil = reinterpret_cast<const uint32_t*>(silent);
    if (tid < K) nbits[b * K + tid] = 0;
    if (tid == 0) done[b] = 0;

    for (int j = 0; j < kWordsPerThread; ++j) {
        const int i = tid + j * kScanThreads;
        if (i < n_words)
            buf[0][i] = tile_word(o15, o14, sil, b, K, fmax, 0, i);
    }
    __syncthreads();

    const bool scans = tid < K * kBands;
    const int k = tid / kBands;
    const int band = tid % kBands;
    const bool live = scans && keep[b * kBands + band] != 0;
    const bool has_dep = scans && dep[k * kBands + band] != 0;
    int prev = 0;
    for (int t = 0; t < n_tiles; ++t) {
        uint32_t next[kWordsPerThread];
        if (t + 1 < n_tiles) {
#pragma unroll
            for (int j = 0; j < kWordsPerThread; ++j) {
                const int i = tid + j * kScanThreads;
                if (i < n_words)
                    next[j] = tile_word(o15, o14, sil, b, K, fmax,
                                        (t + 1) * kTile, i);
            }
        }
        if (scans) {
            const uint8_t* c15 = reinterpret_cast<const uint8_t*>(buf[t & 1])
                                 + k * kRowBytes;
            const uint8_t* c14 = c15 + K * kRowBytes;
            const uint8_t* s = reinterpret_cast<const uint8_t*>(buf[t & 1])
                               + 2 * K * kRowBytes;
            for (int f = 0; f < kTile; ++f) {
                const int pi = has_dep ? pip[k * kBands + (prev < 15 ? prev : 15)]
                                       : 0;
                const int o = f * (kBands * kP) + band * kP + pi;
                int c = prev == 0 ? c14[o] : c15[o];
                if (!live || s[f * kBands + band]) c = 0;
                const size_t at = ((static_cast<size_t>(b) * K + k) * fmax
                                   + t * kTile + f) * kBands + band;
                codes[at] = static_cast<uint8_t>(c);
                pidx[at] = static_cast<uint8_t>(pi);
                prev = c;
            }
        }
        if (t + 1 < n_tiles) {
#pragma unroll
            for (int j = 0; j < kWordsPerThread; ++j) {
                const int i = tid + j * kScanThreads;
                if (i < n_words) buf[(t + 1) & 1][i] = next[j];
            }
        }
        __syncthreads();
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
                     const int32_t* __restrict__ delta_bits, int delta_len,
                     int32_t* __restrict__ nbits,
                     int32_t* __restrict__ done, uint8_t* __restrict__ packed,
                     int K, int fmax) {
    __shared__ int s_cb[7 * 64];
    __shared__ int s_tz[7];
    __shared__ int s_warp[kBands];
    __shared__ int s_nbytes[kMaxSlots];
    __shared__ int s_winner;
    __shared__ bool s_last;
    const int tid = threadIdx.x;
    const int band = tid >> 5;
    const int lane = tid & 31;
    const int f0 = blockIdx.x * kTile;
    const int k = blockIdx.y;
    const int b = blockIdx.z;
    for (int i = tid; i < 7 * 64; i += kSizeThreads) s_cb[i] = cb_bits[i];
    if (tid < 7) s_tz[tid] = tz_bits[tid];
    __syncthreads();

    const int kb = k * kBands + band;
    const bool kept = keep[b * kBands + band] != 0;
    const int hs = hdr_scale[b * K * kBands + kb];
    const int nf_b = nf[b];
    const int n = band_size(band);
    const bool in_band = lane < n;
    const size_t crow = (static_cast<size_t>(b) * K + k) * fmax;
    int acc = 0;
    for (int f = f0; f < f0 + kTile; ++f) {
        const int code = codes[(crow + f) * kBands + band];
        const int pi = pidx[(crow + f) * kBands + band];
        const int cc = code < 15 ? code : 15;
        const bool live_code = kept && cc >= 1;
        const int w = live_code ? w_tab[kb * 16 + cc] : 0;
        int sc = hs;
        if (is1[k]) sc += xa_tab[kb * 16 + cc] + peff_tab[kb * kP + pi];
        int sf = live_code ? mant[sc & 3] >> (15 - ((sc >> 2) & 0xF)) : 1;
        sf = sf < 1 ? 1 : sf;
        const bool live = code != 0 && w != 0;
        const bool is_cb = w >= 1 && w <= 6;
        const int bwc = w < 0 ? 0 : (w > 6 ? 6 : w);
        const bool frame_live = f < nf_b;

        int q = 0, stored = 0;
        if (in_band) {
            const int a = ci[(static_cast<size_t>(b) * fmax + f) * kCols
                             + band_start(band) + lane];
            q = rdiv(a, sf);
            const int ref = is_cb ? 1 << (w - 1) : 0;
            stored = (q + ref) & ((1 << (w > 1 ? w : 1)) - 1);
        }
        const bool zero = in_band && q == 0 && is_cb && live
                          && s_tz[bwc] > 0;
        const unsigned z = __ballot_sync(0xffffffffu, zero);
        const unsigned starts = z & ~(z << 1);
        bool head = false;
        if (zero && lane + 1 < n && ((z >> (lane + 1)) & 1u)) {
            const unsigned low = lane == 31 ? 0xffffffffu
                                            : (2u << lane) - 1u;
            const int run_start = 31 - __clz(starts & low);
            head = ((lane - run_start) & 1) == 0;
        }
        const unsigned heads = __ballot_sync(0xffffffffu, head);
        const bool shadow = lane > 0 && ((heads >> (lane - 1)) & 1u);
        if (in_band && live && !shadow && frame_live)
            acc += head ? s_tz[bwc]
                        : (is_cb ? s_cb[bwc * 64 + (stored & 63)] : w);
        if (lane == 0 && kept && frame_live) {
            const int pc = f > 0 ? codes[(crow + f - 1) * kBands + band] : 0;
            int di = code - pc - kDeltaLo;
            di = di < 0 ? 0 : (di >= delta_len ? delta_len - 1 : di);
            acc += delta_bits[di];
        }
    }

    const int wsum = static_cast<int>(
        __reduce_add_sync(0xffffffffu, static_cast<unsigned>(acc)));
    if (lane == 0) s_warp[band] = wsum;
    __syncthreads();
    if (tid == 0) {
        int total = 0;
        for (int i = 0; i < kBands; ++i) total += s_warp[i];
        atomicAdd(&nbits[b * K + k], total);
        __threadfence();
        const int n_blocks = gridDim.x * gridDim.y;
        s_last = atomicAdd(&done[b], 1) == n_blocks - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the stream's last block: sizes, winner, packed row
    if (tid == 0) {
        __threadfence();
        int best = kBig, winner = 0;
        for (int j = 0; j < K; ++j) {
            const int bits = atomicAdd(&nbits[b * K + j], 0);
            const int nbytes = 18 + (bits + 7) / 8;
            s_nbytes[j] = nbytes;
            const int key = wanted[b * K + j] ? nbytes * K + j : kBig;
            if (key < best) { best = key; winner = j; }
        }
        s_winner = winner;
    }
    __syncthreads();
    const int head_len = 4 * K + 1;
    const int plane = fmax * kBands;
    const size_t wrow = (static_cast<size_t>(b) * K + s_winner) * plane;
    uint8_t* out = packed + static_cast<size_t>(b) * (head_len + 2 * plane);
    for (int i = tid; i < head_len + 2 * plane; i += kSizeThreads) {
        uint8_t v;
        if (i < 4 * K) v = static_cast<uint8_t>(s_nbytes[i / 4] >> (8 * (i % 4)));
        else if (i == 4 * K) v = static_cast<uint8_t>(s_winner);
        else if (i < head_len + plane) v = codes[wrow + i - head_len];
        else v = pidx[wrow + i - head_len - plane];
        out[i] = v;
    }
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
    if (K < 1 || K > kMaxSlots || fmax < kTile || fmax % kTile)
        return static_cast<int>(cudaErrorInvalidValue);
    encode94_scan_kernel<<<n_streams, kScanThreads, 0, stream>>>(
        out15, out14, silent, keep, pip, dep, codes, pidx, nbits, done, K,
        fmax);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(fmax / kTile, K, n_streams);
    encode94_size_kernel<<<grid, kSizeThreads, 0, stream>>>(
        ci, codes, pidx, nf, keep, hdr_scale, wanted, w_tab, xa_tab,
        peff_tab, is1, mant, cb_bits, tz_bits, delta_bits, delta_len,
        nbits, done, packed, K, fmax);
    return static_cast<int>(cudaGetLastError());
}
