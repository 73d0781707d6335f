// Flat 1994+ decode from the compact catalog columns straight to frame
// buffers: band controls, the Huffman / raw symbol walk and the
// dequant/mix epilogue in one kernel.
//
// Replaces, in the JAX package: band_controls_dyn
// (dcsexplorer_tpu/models/flatsweep.py:42), _expand / slot_controls
// (dcsexplorer_tpu/ops/band_decode.py:240,259), the decode_flat scan
// (dcsexplorer_tpu/models/flatsweep.py:87-145) and dequant_mix, whose
// Pallas kernel is dequant_mix_pallas (dcsexplorer_tpu/ops/pallas_kernels.py
// :65-103, single-voice form).  Its plain version is
// ops/band_decode.decode94_fb_plain, and it is bit-identical to it.
//
// What bounds it on the H100: bytes.  Per frame it reads sid, start_bit and
// mix (4 B each), 16 band-type bytes and its stretch of the byte pool, and
// writes one 2 KB frame buffer.  At the flat94_music catalog (300,096
// frames, 24.4 MB pool) that is ~33 MB in and 614.6 MB out: 0.193 ms at
// 3.35 TB/s.  The integer work is a serial chain per frame (every step
// waits on the bit cursor of the step before), a few tens of instructions
// a position; with enough frames in flight it is issue-bound, not
// latency-bound.
//
// Design:
// - One thread per frame walks it (decode94_walk.cuh: the band list built
//   before the walk, the block's stretch of the pool in shared memory, a
//   two-word window refilled one word ahead).  A warp walks to the end of
//   the last band that decodes in any of its 32 frames (at most n_steps).
// - The dequant/mix epilogue runs per position as it is decoded (single
//   voice: the prior frame buffer is silence), and the word goes to shared
//   memory as u16.
// - Every 16 positions the warp flushes the staged words of its 32 frames
//   with 16-byte stores, the lanes on neighbouring addresses (4 lanes per
//   64-byte stretch of a row); the words past the warp's walk are stored
//   as zeros directly.
// - Block split: 128 threads = 128 frames per block, staging 16 words a
//   frame (row of 20 u16, 5 KB), the band lists (18 KB), the block's
//   stretch of the pool (14 KB) and the codec tables (6 KB, read with
//   divergent indices, so in shared memory): 43 KB a block, 5 blocks (20
//   warps) an SM, 64 registers a thread (held there by __launch_bounds__).
//   Staging whole rows (260 u16, 71 KB a block) fitted only 3 blocks, 12
//   warps, on an SM; they walked in lockstep and then stored in a burst,
//   and took 0.66 ms on an H100 (700 W).  With chunks the walks of some
//   warps overlap other warps' stores.  A row of 20 u16 (10 words) puts
//   the 32 lanes of a warp on 16 banks when each stores its position: a
//   2-way conflict.

// Semantics kept exactly (and tested against the plain version): those of
// decode94_walk.cuh; positions at and past n_steps are 0; the accumulate
// is uint32 (dcs_fixmath.cuh:accum_word); word 0 gets the saturating delta
// fix-up last and word 1 keeps the prior buffer's 0.

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"
#include "decode94_walk.cuh"

namespace {

constexpr int kThreads = 128;          // = frames per block
constexpr int kChunk = 16;             // frame-buffer words staged per flush
constexpr int kStride = 20;            // staged u16 words per frame
constexpr int kWords = 512;
constexpr int kPoolWords = 3584;       // the block's stretch of the pool

__global__ void __launch_bounds__(kThreads, 8)
decode94_fb_kernel(const uint8_t *__restrict__ pool, int pool_len,
                   const int *__restrict__ sid,
                   const int *__restrict__ start_bit,
                   const uint8_t *__restrict__ bt_u8,
                   const int *__restrict__ mix,
                   const uint8_t *__restrict__ hdr_tab,
                   const uint8_t *__restrict__ fmt_tab,
                   const uint8_t *__restrict__ sub_tab, int n_streams,
                   dcs94::TablePtrs g_tabs, int *__restrict__ out,
                   int n_frames, int n_steps) {
    __shared__ __align__(16) uint16_t stage[kThreads * kStride];
    __shared__ uint2 bands[dcs94::kBandSlots * kThreads];
    __shared__ uint32_t stg[kPoolWords];
    __shared__ int red[2 * kThreads / 32];
    __shared__ dcs94::Tables tb;
    dcs94::load_tables<kThreads>(tb, g_tabs);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp0 = threadIdx.x & ~31;
    const int f_warp = blockIdx.x * kThreads + warp0;
    // frames of this warp to write out; a lane past the last frame walks
    // the last frame again, in step with the warp, and writes nothing
    const int n_rows = min(32, n_frames - f_warp);
    const int f = min(f_warp + lane, n_frames - 1);
    uint16_t *row = stage + threadIdx.x * kStride;
    const uint16_t *wstage = stage + warp0 * kStride;

    // the warp writes words [kChunk k, kChunk (k + 1)) of its frame buffers
    // from the staging, with the words past last_w (and word 1) as 0:
    // 16-byte stores, kLanes lanes per stretch of a row, 32 / kLanes rows
    // at a time
    constexpr int kLanes = kChunk / 4;
    const int c4 = 4 * (lane % kLanes);
    auto flush = [&](int k, int last_w) {
        __syncwarp();
        const int w = k * kChunk + c4;
        for (int r = lane / kLanes; r < n_rows; r += 32 / kLanes) {
            const uint2 h =
                *reinterpret_cast<const uint2 *>(wstage + r * kStride + c4);
            int4 o;
            o.x = w <= last_w ? (int)(h.x & 0xFFFFu) : 0;
            o.y = w + 1 > 1 && w + 1 <= last_w ? (int)(h.x >> 16) : 0;
            o.z = w + 2 <= last_w ? (int)(h.y & 0xFFFFu) : 0;
            o.w = w + 3 <= last_w ? (int)(h.y >> 16) : 0;
            *reinterpret_cast<int4 *>(out + (size_t)(f_warp + r) * kWords +
                                      w) = o;
        }
        __syncwarp();
    };

    const int mx = mix[f];
    dcs94::Walk<kThreads> walk(tb, bands + threadIdx.x, pool, pool_len, sid,
                               start_bit, bt_u8, hdr_tab, fmt_tab, sub_tab,
                               n_streams, f, n_steps);
    int base;
    const bool staged = dcs94::stage_pool<kThreads, kPoolWords>(
        stg, walk.first_word(), walk.end_word(n_steps), pool, pool_len, red,
        base);
    walk.begin(staged ? stg : nullptr, base, n_steps);
    // every word past the warp's last decoding band is 0
    const int steps = min(n_steps, __reduce_max_sync(0xFFFFFFFFu, walk.last));
    for (int k = 0; k * kChunk <= steps; ++k) {
        const int w_end = min(steps, (k + 1) * kChunk - 1);
        for (int w = max(k * kChunk, 1); w <= w_end; ++w) {
            int scale;
            // position w - 1 -> word w
            const int v = walk.step(tb, w - 1, scale);
            // dequant/mix epilogue (single voice: the prior buffer is
            // silence)
            const int scaled = (dcs::s16(v) * (scale & dcs::kM16)) & dcs::kM16;
            const int word = dcs::accum_word(0, scaled, mx);
            if (w == 1) {
                // word 0: the saturating first-sample delta against the
                // prior buffer's word 1 (0), added to its word 0 (0); word 1
                // stays 0
                row[0] = (uint16_t)dcs::sat16(
                    dcs::s16(dcs::sat16(dcs::s16(word))));
            } else {
                row[w & (kChunk - 1)] = (uint16_t)word;
            }
        }
        if (steps) flush(k, steps);
    }
    // the words from the last flushed chunk on are 0: whole rows' tails
    dcs94::zero_rows<kWords / 4>(
        reinterpret_cast<uint4 *>(out + (size_t)f_warp * kWords), n_rows,
        (steps ? steps / kChunk + 1 : 0) * (kChunk / 4));
}

}  // namespace

extern "C" int dcs_decode94_fb(const uint8_t *pool, long long pool_len,
                               const int *sid, const int *start_bit,
                               const uint8_t *bt_u8, const int *mix,
                               const uint8_t *hdr_tab, const uint8_t *fmt_tab,
                               const uint8_t *sub_tab, int n_streams,
                               const int *out_count, const int *xt,
                               const int *xa, const int *preadj,
                               const int *maxw, const int *cb_base,
                               const int *mant, const int *cb_flat, int *out,
                               int n_frames, int n_steps,
                               cudaStream_t stream) {
    // five blocks an SM need the largest shared-memory carveout
    cudaError_t err = cudaFuncSetAttribute(
        decode94_fb_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    // pool_len < 2^28 (the wrapper checks)
    int blocks = (n_frames + kThreads - 1) / kThreads;
    decode94_fb_kernel<<<blocks, kThreads, 0, stream>>>(
        pool, (int)pool_len, sid, start_bit, bt_u8, mix, hdr_tab, fmt_tab,
        sub_tab, n_streams,
        dcs94::TablePtrs{out_count, xt, xa, preadj, maxw, cb_base, mant,
                         cb_flat},
        out, n_frames, n_steps);
    return (int)cudaGetLastError();
}
