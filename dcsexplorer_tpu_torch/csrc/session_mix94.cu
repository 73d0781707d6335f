// The session path's multi-voice dequant/mix: for each output frame, start
// from silence and fold channels 0..C-1 in order, each the bank row the
// frame plays on that channel at the channel's mixing multiplier, with the
// Pallas kernel's exact arithmetic.
//
// Replaces, in the JAX package: device_decode's channel loop
// (dcsexplorer_tpu/models/pipeline.py:305-313), whose every step is
// dequant_mix with the active mask (dcsexplorer_tpu/ops/band_decode.py
// :392-442), the semantics of the Pallas kernel dequant_mix_pallas
// (dcsexplorer_tpu/ops/pallas_kernels.py:31-62, :83).  On the session path
// this kernel does the Pallas kernel's job; dequant_mix.cu stays its
// single-voice counterpart.  Its plain version is
// ops/band_decode.session_mix94_plain, and it is bit-identical to it.
//
// Input: the bank (decode94_bank.cu) holds each stream frame's dequantized
// samples, u16 [R, 256], row 0 silent; rows [F, C] and mix [F, C] int32.
// A zero sample passes the accumulator through exactly and a silent row
// leaves words 0 and 1 as they were, so the active mask (rows > 0) needs no
// test.  Starting from silence, word 1 ends every channel as the prior
// buffer's word 1, i.e. 0: position 0 of each channel only feeds word 0's
// saturating fix-up.  Output: frame buffers [F, 512] int32 (u16 storage),
// words past 256 zero, as the JAX contract has them.
//
// What bounds it on the H100: bytes.  Per frame it reads C row ids and
// mixes (8 B each) and writes one 2 KB frame buffer; the bank rows it
// gathers (512 B each) come from L2, where a session bank (~2,800 rows,
// 1.4 MB) stays.  At session6's batch (320,000 frames, C = 6) that is
// 15 MB in and 655 MB out: 0.20 ms at 3.35 TB/s, with ~1 GB of L2 reads
// beside it.
//
// Design: one warp per frame, 8 a block.  Lane c < C reads channel c's row
// and mix; a shuffle hands them to the warp.  Each lane holds positions
// 4l..4l+3 and 128+4l..128+4l+3 of the accumulator in registers: every
// channel's row arrives as two 8-byte loads a lane, each a contiguous 256 B
// across the warp, all C rows' loads issued before the first accumulate.
// The fold runs in registers in uint32 (dcs_fixmath.cuh:accum_word).
// Word w of the output is position w - 1, so each 16-byte store takes one
// word from the lane below (one shuffle); a warp writes its frame's 2 KB as
// four 512 B stores.

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 8;
constexpr int kPos = 256;
constexpr int kWords = 512;

__device__ __forceinline__ void fold(int (&acc)[4], uint2 v, int m) {
    acc[0] = dcs::accum_word(acc[0], (int)(v.x & 0xFFFFu), m);
    acc[1] = dcs::accum_word(acc[1], (int)(v.x >> 16), m);
    acc[2] = dcs::accum_word(acc[2], (int)(v.y & 0xFFFFu), m);
    acc[3] = dcs::accum_word(acc[3], (int)(v.y >> 16), m);
}

__global__ void __launch_bounds__(kThreads)
session_mix94_kernel(const uint16_t *__restrict__ bank, int n_rows,
                     const int *__restrict__ rows, const int *__restrict__ mix,
                     int *__restrict__ out, int n_frames, int n_ch) {
    const int lane = threadIdx.x & 31;
    const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (f >= n_frames) return;                      // uniform per warp

    int r = 0, m = 0;
    if (lane < n_ch) {
        r = rows[(size_t)f * n_ch + lane];
        m = mix[(size_t)f * n_ch + lane];
        if ((unsigned)r >= (unsigned)n_rows) __trap();
    }
    const uint2 *b8 = reinterpret_cast<const uint2 *>(bank);
    uint2 lo[kMaxC], hi[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
        const int rc = __shfl_sync(0xFFFFFFFFu, r, c);
        if (c < n_ch) {
            lo[c] = __ldg(b8 + (size_t)rc * (kPos / 4) + lane);
            hi[c] = __ldg(b8 + (size_t)rc * (kPos / 4) + 32 + lane);
        }
    }
    int a[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0};
    int fb0 = 0;                                    // word 0 (lane 0)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
        const int mc = __shfl_sync(0xFFFFFFFFu, m, c);
        if (c < n_ch) {
            fold(a, lo[c], mc);
            fold(b, hi[c], mc);
            if (lane == 0) {
                // position 0 lands in word 1, whose prior value (0) it
                // keeps: the new value's saturating delta goes to word 0
                const int delta = dcs::sat16(dcs::s16(a[0]));
                fb0 = dcs::sat16(dcs::s16(delta) + dcs::s16(fb0));
                a[0] = 0;
            }
        }
    }

    // word 4j is position 4j - 1, the last of the lane below
    int a_up = __shfl_up_sync(0xFFFFFFFFu, a[3], 1);
    int b_up = __shfl_up_sync(0xFFFFFFFFu, b[3], 1);
    const int a31 = __shfl_sync(0xFFFFFFFFu, a[3], 31);   // position 127
    const int b31 = __shfl_sync(0xFFFFFFFFu, b[3], 31);   // position 255
    if (lane == 0) {
        a_up = fb0;
        b_up = a31;
    }
    int4 *o = reinterpret_cast<int4 *>(out + (size_t)f * kWords);
    o[lane] = make_int4(a_up, a[0], a[1], a[2]);
    o[32 + lane] = make_int4(b_up, b[0], b[1], b[2]);
    o[64 + lane] = make_int4(lane == 0 ? b31 : 0, 0, 0, 0);
    o[96 + lane] = make_int4(0, 0, 0, 0);
}

}  // namespace

extern "C" int dcs_session_mix94(const uint16_t *bank, int n_rows,
                                 const int *rows, const int *mix, int *out,
                                 int n_frames, int n_ch,
                                 cudaStream_t stream) {
    const int blocks = (n_frames + kWarps - 1) / kWarps;
    session_mix94_kernel<<<blocks, kThreads, 0, stream>>>(
        bank, n_rows, rows, mix, out, n_frames, n_ch);
    return (int)cudaGetLastError();
}
