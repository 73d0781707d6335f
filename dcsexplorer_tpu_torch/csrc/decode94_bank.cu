// A session bank's decode: every frame of every stream a ROM's tracks play,
// walked once and kept mix-independent, one 256-position row per frame.
//
// Replaces, in the JAX package: StreamBank.decode_all
// (dcsexplorer_tpu/models/pipeline.py:76-138), which runs the decode_flat
// scan (dcsexplorer_tpu/models/flatsweep.py:87-145) over the bank's streams
// and keeps dense values, scales and position counts.  Here a row holds
// what dequant_mix reads of them (band_decode.py:392-442): the dequantized
// sample (s16(value) * u16(scale)) & $FFFF per position, zero at and past
// the frame's position count.  A zero word passes the accumulator through
// exactly and an all-zero row leaves the first-sample fix-up's words as
// they were, so neither the count nor an active mask need travel.  Row 0 is
// the silent dummy, all zero.  Its plain version is
// ops/band_decode.decode94_bank_plain, and it is bit-identical to it.
//
// What bounds it on the H100: bytes in principle.  Per frame it reads sid
// and start_bit (4 B each), 16 band-type bytes and its stretch of the byte
// pool, and writes one 512 B row: at the flat94_music catalog (300,096
// frames, 24.4 MB pool) ~33 MB in and 154 MB out, 0.056 ms at 3.35 TB/s.
// The walk is a serial chain per frame, so in practice issue slots bound
// it, as they do decode94_fb.  A session bank is far smaller (2,778 rows
// for session6's six streams, 22 blocks): there one frame's walk sets the
// time, and it runs once per ROM.
//
// Design: decode94_fb's, with another epilogue.  One thread walks one frame
// (decode94_walk.cuh: the band list built before the walk, the block's
// stretch of the pool in shared memory, a two-word window), 128 frames a
// block.  A warp walks to the end of the last band that decodes in any of
// its 32 frames (at most n_steps).  Each position's scaled word goes to
// shared memory as u16; every 16 positions the warp flushes the staged
// words of its 32 frames with 16-byte stores, 2 lanes per 32-byte stretch
// of a row, neighbouring lanes on neighbouring addresses.  The positions
// past the warp's walk are stored as zeros directly.  Block 0 also writes
// row 0.  Shared memory: 5 KB of staging, 18 KB of band lists, 14 KB for
// the pool and 6 KB of tables (43 KB), 5 blocks an SM; 64 registers.

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"
#include "decode94_walk.cuh"

namespace {

constexpr int kThreads = 128;          // = frames per block
constexpr int kChunk = 16;             // positions staged per flush
constexpr int kStride = 20;            // staged u16 words per frame
constexpr int kPos = 256;              // positions (u16 words) per row
constexpr int kPoolWords = 3584;       // the block's stretch of the pool

__global__ void __launch_bounds__(kThreads, 8)
decode94_bank_kernel(const uint8_t *__restrict__ pool, int pool_len,
                     const int *__restrict__ sid,
                     const int *__restrict__ start_bit,
                     const uint8_t *__restrict__ bt_u8,
                     const uint8_t *__restrict__ hdr_tab,
                     const uint8_t *__restrict__ fmt_tab,
                     const uint8_t *__restrict__ sub_tab, int n_streams,
                     dcs94::TablePtrs g_tabs, uint16_t *__restrict__ out,
                     int n_frames, int n_steps) {
    __shared__ __align__(16) uint16_t stage[kThreads * kStride];
    __shared__ uint2 bands[dcs94::kBandSlots * kThreads];
    __shared__ uint32_t stg[kPoolWords];
    __shared__ int red[2 * kThreads / 32];
    __shared__ dcs94::Tables tb;
    dcs94::load_tables<kThreads>(tb, g_tabs);
    if (blockIdx.x == 0 && threadIdx.x < kPos / 8)
        reinterpret_cast<uint4 *>(out)[threadIdx.x] = make_uint4(0, 0, 0, 0);
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
    // frame f's row is out row f + 1
    uint16_t *out_warp = out + (size_t)(f_warp + 1) * kPos;

    // the warp writes positions [kChunk k, kChunk (k + 1)) of its rows from
    // the staging, with the positions past last_t as 0: 16-byte stores,
    // kLanes lanes per stretch of a row, 32 / kLanes rows at a time
    constexpr int kLanes = kChunk / 8;
    const int c8 = 8 * (lane % kLanes);
    auto flush = [&](int k, int last_t) {
        __syncwarp();
        const int t = k * kChunk + c8;
        for (int r = lane / kLanes; r < n_rows; r += 32 / kLanes) {
            const uint16_t *src = wstage + r * kStride + c8;
            const uint2 lo = *reinterpret_cast<const uint2 *>(src);
            const uint2 hi = *reinterpret_cast<const uint2 *>(src + 4);
            const uint32_t w[4] = {lo.x, lo.y, hi.x, hi.y};
            uint32_t o[4];
            for (int i = 0; i < 4; ++i) {
                const uint32_t a = t + 2 * i <= last_t ? w[i] & 0xFFFFu : 0u;
                const uint32_t b = t + 2 * i + 1 <= last_t ? w[i] >> 16 : 0u;
                o[i] = a | (b << 16);
            }
            *reinterpret_cast<uint4 *>(out_warp + (size_t)r * kPos + t) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
        __syncwarp();
    };

    dcs94::Walk<kThreads> walk(tb, bands + threadIdx.x, pool, pool_len, sid,
                               start_bit, bt_u8, hdr_tab, fmt_tab, sub_tab,
                               n_streams, f, n_steps);
    int base;
    const bool staged = dcs94::stage_pool<kThreads, kPoolWords>(
        stg, walk.first_word(), walk.end_word(n_steps), pool, pool_len, red,
        base);
    walk.begin(staged ? stg : nullptr, base, n_steps);
    // every position from the warp's last decoding band on is 0
    const int steps = min(n_steps, __reduce_max_sync(0xFFFFFFFFu, walk.last));
    for (int k = 0; k * kChunk < steps; ++k) {
        const int n = min(kChunk, steps - k * kChunk);
        for (int i = 0; i < n; ++i) {
            int scale;
            const int v = walk.step(tb, k * kChunk + i, scale);
            row[i] =
                (uint16_t)((dcs::s16(v) * (scale & dcs::kM16)) & dcs::kM16);
        }
        flush(k, steps - 1);
    }
    // the positions from the last flushed chunk on are 0: whole rows' tails
    dcs94::zero_rows<kPos / 8>(reinterpret_cast<uint4 *>(out_warp), n_rows,
                               (steps + kChunk - 1) / kChunk * (kChunk / 8));
}

}  // namespace

extern "C" int dcs_decode94_bank(const uint8_t *pool, long long pool_len,
                                 const int *sid, const int *start_bit,
                                 const uint8_t *bt_u8, const uint8_t *hdr_tab,
                                 const uint8_t *fmt_tab,
                                 const uint8_t *sub_tab, int n_streams,
                                 const int *out_count, const int *xt,
                                 const int *xa, const int *preadj,
                                 const int *maxw, const int *cb_base,
                                 const int *mant, const int *cb_flat,
                                 uint16_t *out, int n_frames, int n_steps,
                                 cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        decode94_bank_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    // n_frames >= 1 (the wrapper makes a bank with no frames itself) and
    // pool_len < 2^28 (the wrapper checks)
    const int blocks = (n_frames + kThreads - 1) / kThreads;
    decode94_bank_kernel<<<blocks, kThreads, 0, stream>>>(
        pool, (int)pool_len, sid, start_bit, bt_u8, hdr_tab, fmt_tab, sub_tab,
        n_streams,
        dcs94::TablePtrs{out_count, xt, xa, preadj, maxw, cb_base, mant,
                         cb_flat},
        out, n_frames, n_steps);
    return (int)cudaGetLastError();
}
