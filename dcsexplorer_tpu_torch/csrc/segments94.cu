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
// little-endian u16; on the wide wire (a bank of 64Ki rows or more, under
// 2^24) base is a little-endian u32.  f0 does not descend within a lane
// and unused entries hold $FFFF (T < $FFFF, so they never count), so the
// segment at frame t is count(f0 <= t) - 1: the last entry at or before t
// (equal entries resolve to the last one), or segment 0 where none is.
// Out, all int32:
// rows [S*T, C] = base + slope * (t - f0), mix [S*T, C] = mixv, vol [S*T].
// E is a runtime argument (1..255): a wider segment table needs no rebuild.
//
// What bounds it on the H100: bytes, and at session6's size (S 320, T
// 1,000, C 6, E 32) launch latency.  It reads 0.75 MB of wire and writes
// 16.6 MB (0.005 ms at 3.35 TB/s).
//
// Design:
// - Block (s, k) takes frames [512 k, 512 k + 512) of session s, 4
//   consecutive frames a thread; a session6 batch is 640 blocks.
// - The block widens its session's C * E segment entries into shared
//   memory once (f0 | base << 16 and mixv | slope << 16, 8 bytes each; on
//   the wide wire f0 | mixv << 16 and base | slope << 24).
// - C is a template argument (1..8, dispatched on the host): a thread's
//   4 * C words sit in registers at indices the compiler knows.  So is the
//   wire (kWide): the u16 instance is the code of the 16-bit wire alone.
// - A thread finds its first frame's segment in each channel by a
//   branchless binary search of fixed depth (log2 E), the C channels'
//   probes interleaved, and advances it over its next frames: the
//   segment index only grows with t.  No integer division.
// - The block's rows, then its mixes, go through shared memory so that the
//   stores to device memory are coalesced: each warp store is 128
//   consecutive bytes.  (16-byte stores straight from the registers, a
//   lane's 4 * C words at a stride of 16 * C bytes, wrote 16.6 MB in
//   0.0189 ms on an H100.)

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 4;                // frames a thread
constexpr int kFrames = kThreads * kRun;  // frames a block

__device__ __forceinline__ int u16_le(const uint8_t *__restrict__ p) {
    return (int)__ldg(p) | ((int)__ldg(p + 1) << 8);
}

__device__ __forceinline__ uint32_t u32_le(const uint8_t *__restrict__ p) {
    return (uint32_t)u16_le(p) | ((uint32_t)u16_le(p + 2) << 16);
}

template <int C, bool kWide>
__global__ void __launch_bounds__(kThreads)
segments94_kernel(const uint8_t *__restrict__ wire, int n_sessions,
                  int n_frames, int n_seg, int *__restrict__ rows,
                  int *__restrict__ mix, int *__restrict__ vol) {
    // the block's words [kFrames * C], then the session's segment entries
    // [C * E]: entry e of channel c, i = c E + e, holds f0 | base << 16 and
    // mixv | slope << 16 (wide: f0 | mixv << 16 and base | slope << 24)
    extern __shared__ uint4 smem[];
    int *words = reinterpret_cast<int *>(smem);
    uint2 *seg = reinterpret_cast<uint2 *>(smem + kFrames * C / 4);
    const int s = blockIdx.x;
    const int ce = C * n_seg;
    const int n_par = n_sessions * ce;
    const uint8_t *vol_w = wire + n_par;
    const uint8_t *f0_w = vol_w + n_sessions * n_frames;
    const uint8_t *base_w = f0_w + 2 * n_par;
    const uint8_t *mixv_w = base_w + (kWide ? 4 : 2) * n_par;
    for (int i = threadIdx.x; i < ce; i += kThreads) {
        const int k = s * ce + i;
        if constexpr (kWide)
            seg[i] = make_uint2(
                (uint32_t)u16_le(f0_w + 2 * k) |
                    ((uint32_t)u16_le(mixv_w + 2 * k) << 16),
                u32_le(base_w + 4 * k) | ((uint32_t)__ldg(wire + k) << 24));
        else
            seg[i] = make_uint2(
                (uint32_t)u16_le(f0_w + 2 * k) |
                    ((uint32_t)u16_le(base_w + 2 * k) << 16),
                (uint32_t)u16_le(mixv_w + 2 * k) |
                    ((uint32_t)__ldg(wire + k) << 16));
    }
    __syncthreads();

    // the block's frames of the session, and this thread's first
    const int b0 = blockIdx.y * kFrames;
    const int nb = min(kFrames, n_frames - b0);
    const int t0 = b0 + kRun * threadIdx.x;
    auto f0_of = [&](int c, int e) {
        return (int)(seg[c * n_seg + e].x & 0xFFFFu);
    };

    // count(f0 <= t0) in each channel: a branchless search of fixed
    // depth, the channels' probes interleaved
    int at[C];
#pragma unroll
    for (int c = 0; c < C; ++c) at[c] = 0;
    for (int n = n_seg; n > 1; n -= n >> 1) {
        const int half = n >> 1;
#pragma unroll
        for (int c = 0; c < C; ++c)
            at[c] = f0_of(c, at[c] + half) <= t0 ? at[c] + half : at[c];
    }
    int r[kRun * C], m[kRun * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        // the segment: count - 1, or 0 where no entry is at or before t0
        int e = max(at[c] + (f0_of(c, at[c]) <= t0 ? 1 : 0) - 1, 0);
        uint2 ent = seg[c * n_seg + e];
        int nxt = e + 1 < n_seg ? f0_of(c, e + 1) : 0xFFFF;
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
            const int t = t0 + k;
            if (k > 0) {
                // the entries that start at or before t (ties: the last)
                while (nxt <= t) {
                    ent = seg[c * n_seg + ++e];
                    nxt = e + 1 < n_seg ? f0_of(c, e + 1) : 0xFFFF;
                }
            }
            if constexpr (kWide) {
                r[k * C + c] = (int)(ent.y & 0xFFFFFFu) +
                               (int)(ent.y >> 24) *
                                   (t - (int)(ent.x & 0xFFFFu));
                m[k * C + c] = (int)(ent.x >> 16);
            } else {
                r[k * C + c] = (int)(ent.x >> 16) +
                               (int)(ent.y >> 16) *
                                   (t - (int)(ent.x & 0xFFFFu));
                m[k * C + c] = (int)(ent.y & 0xFFFFu);
            }
        }
    }

    // rows, then mix: the thread's 4 * C words into shared memory, then the
    // block's nb * C words out with consecutive threads on consecutive
    // words (frames past the session's end are never copied out)
    const size_t out0 = ((size_t)s * n_frames + b0) * C;
    auto out = [&](const int(&x)[kRun * C], int *dst) {
#pragma unroll
        for (int j = 0; j < C; ++j)
            smem[threadIdx.x * C + j] = make_uint4(x[4 * j], x[4 * j + 1],
                                                   x[4 * j + 2], x[4 * j + 3]);
        __syncthreads();
        for (int i = threadIdx.x; i < nb * C; i += kThreads)
            dst[out0 + i] = words[i];
    };
    out(r, rows);
    __syncthreads();
    out(m, mix);
    const size_t v0 = (size_t)s * n_frames + b0;
    for (int i = threadIdx.x; i < nb; i += kThreads)
        vol[v0 + i] = __ldg(vol_w + v0 + i);
}

template <int C, bool kWide>
int launch(const uint8_t *wire, int n_sessions, int n_frames, int n_seg,
           int *rows, int *mix, int *vol, cudaStream_t stream) {
    const dim3 grid(n_sessions, (n_frames + kFrames - 1) / kFrames);
    const int smem = kFrames * C * (int)sizeof(int) +
                     C * n_seg * (int)sizeof(uint2);
    segments94_kernel<C, kWide><<<grid, kThreads, smem, stream>>>(
        wire, n_sessions, n_frames, n_seg, rows, mix, vol);
    return (int)cudaGetLastError();
}

using Launch = int (*)(const uint8_t *, int, int, int, int *, int *, int *,
                       cudaStream_t);

template <bool kWide>
int dispatch(const uint8_t *wire, int n_sessions, int n_frames, int n_ch,
             int n_seg, int *rows, int *mix, int *vol, cudaStream_t stream) {
    static const Launch kLaunch[8] = {
        launch<1, kWide>, launch<2, kWide>, launch<3, kWide>,
        launch<4, kWide>, launch<5, kWide>, launch<6, kWide>,
        launch<7, kWide>, launch<8, kWide>};
    if (n_ch < 1 || n_ch > 8) return (int)cudaErrorInvalidValue;
    return kLaunch[n_ch - 1](wire, n_sessions, n_frames, n_seg, rows, mix,
                             vol, stream);
}

}  // namespace

// 1 <= n_sessions, 1 <= n_frames < $FFFF, the wire and outputs under 2^31
// elements (the wrapper checks)
extern "C" int dcs_segments94(const uint8_t *wire, int n_sessions,
                              int n_frames, int n_ch, int n_seg, int *rows,
                              int *mix, int *vol, cudaStream_t stream) {
    return dispatch<false>(wire, n_sessions, n_frames, n_ch, n_seg, rows, mix,
                           vol, stream);
}

// the wide wire: base a u32 under 2^24 (the caller's bank has fewer rows)
extern "C" int dcs_segments94_rows32(const uint8_t *wire, int n_sessions,
                                     int n_frames, int n_ch, int n_seg,
                                     int *rows, int *mix, int *vol,
                                     cudaStream_t stream) {
    return dispatch<true>(wire, n_sessions, n_frames, n_ch, n_seg, rows, mix,
                          vol, stream);
}
