// The serving wire's control plane, unpacked and expanded on the card:
// each (session, channel) lane's linear segments become dense per-frame
// bank rows and mixing multipliers, and the volume column widens.
//
// Replaces, in the JAX package: unpack_controls_wire and
// reconstruct_from_segments (dcsexplorer_tpu/models/romplay.py:115-152),
// two XLA stages of SessionServer's program.  Its plain version is
// models/romplay.segments94_plain, and it is bit-identical to it.
//
// The wire is one uint8 buffer as pack_controls_wire lays it out: slope
// [S, C, E] u8, vol [S, T] u8, then f0, base and mixv [S, C, E] as
// little-endian u16.  f0 ascends within a lane with unused entries at
// $FFFF, so the segment at frame t is count(f0 <= t) - 1 (segment 0 starts
// at frame 0; a count of 0 takes segment 0).  Out, all int32:
// rows [S*T, C] = base + slope * (t - f0), mix [S*T, C] = mixv, vol [S*T].
// E is a runtime argument: a wider segment table needs no rebuild.
//
// What bounds it on the H100: launch overhead at session6's size.  It
// reads 0.75 MB of wire and writes 16.6 MB (0.005 ms at 3.35 TB/s), with a
// binary search of at most 8 steps per output in shared memory.
//
// Design: one block per session.  The block widens its C * E segment
// entries into shared memory once, then its threads take the session's
// (frame, channel) outputs in order, so neighbouring threads write
// neighbouring words; the volume bytes widen in the same pass.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int u16_le(const uint8_t *__restrict__ p) {
    return (int)p[0] | ((int)p[1] << 8);
}

__global__ void __launch_bounds__(kThreads)
segments94_kernel(const uint8_t *__restrict__ wire, int n_sessions,
                  int n_frames, int n_ch, int n_seg, int *__restrict__ rows,
                  int *__restrict__ mix, int *__restrict__ vol) {
    extern __shared__ int seg[];      // f0, base, slope, mixv: [C * E] each
    const int s = blockIdx.x;
    const int ce = n_ch * n_seg;
    const size_t n_par = (size_t)n_sessions * ce;
    const size_t n_vol = (size_t)n_sessions * n_frames;
    const uint8_t *slope_w = wire;
    const uint8_t *vol_w = wire + n_par;
    const uint8_t *f0_w = vol_w + n_vol;
    const uint8_t *base_w = f0_w + 2 * n_par;
    const uint8_t *mixv_w = base_w + 2 * n_par;
    int *f0 = seg, *base = seg + ce, *slope = seg + 2 * ce,
        *mixv = seg + 3 * ce;
    for (int i = threadIdx.x; i < ce; i += kThreads) {
        const size_t k = (size_t)s * ce + i;
        f0[i] = u16_le(f0_w + 2 * k);
        base[i] = u16_le(base_w + 2 * k);
        slope[i] = slope_w[k];
        mixv[i] = u16_le(mixv_w + 2 * k);
    }
    __syncthreads();

    const size_t o = (size_t)s * n_frames;
    for (int t = threadIdx.x; t < n_frames; t += kThreads)
        vol[o + t] = vol_w[o + t];
    for (int j = threadIdx.x; j < n_frames * n_ch; j += kThreads) {
        const int t = j / n_ch, c = j - t * n_ch;
        const int *lf0 = f0 + c * n_seg;
        // count(f0 <= t): the first entry past t, by binary search
        int lo = 0, hi = n_seg;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (lf0[mid] <= t)
                lo = mid + 1;
            else
                hi = mid;
        }
        const int e = c * n_seg + max(lo - 1, 0);
        rows[o * n_ch + j] = base[e] + slope[e] * (t - f0[e]);
        mix[o * n_ch + j] = mixv[e];
    }
}

}  // namespace

extern "C" int dcs_segments94(const uint8_t *wire, int n_sessions,
                              int n_frames, int n_ch, int n_seg, int *rows,
                              int *mix, int *vol, cudaStream_t stream) {
    const int smem = 4 * n_ch * n_seg * (int)sizeof(int);
    segments94_kernel<<<n_sessions, kThreads, smem, stream>>>(
        wire, n_sessions, n_frames, n_ch, n_seg, rows, mix, vol);
    return (int)cudaGetLastError();
}
