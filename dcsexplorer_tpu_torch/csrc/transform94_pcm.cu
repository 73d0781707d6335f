// 1994+ inverse transform, overlap resolve and bit-reversed extraction in
// one kernel: frame buffers in, PCM out.  It computes exactly
// overlap_resolve_planar(*transform94_planar(fb, vol), stream_starts(sid))
// (ops/transform.transform94_pcm_plain), and the re/im planes between the
// two never reach device memory.
//
// Replaces, in the JAX package: transform94_planar
// (dcsexplorer_tpu/ops/transform.py:255) and overlap_resolve_planar
// (:324), two XLA stages on the TPU.  On the flat sweep it also replaces
// this package's transform94.cu launch (kept for the sessions slice, which
// needs the planes) and the plain-torch overlap resolve after it.
//
// What bounds it on the H100: bytes.  Per frame it reads words 0..$103 of
// the frame buffer (1,040 B, of which the transform needs 0..$101), the
// volume shift and the stream id, and writes 240 PCM words (960 B): ~2 KB
// a frame, 600 MB at the flat94_music catalog, 0.18 ms at 3.35 TB/s.  The
// integer work (~6,000 operations a frame: three pre-passes, six radix-2
// stages over 64 complex pairs, the volume shift and 16 blends) is ~3x
// below that in principle, but each operation of the 1.15 fixed-point
// numerics costs several instructions (sign extension, saturation, the
// MAC's rounding quirk), so issue slots are the second limit.
//
// Design (transform94.cu, one 64-thread block per frame with a block
// barrier after every stage and scalar loads and stores, took 0.48 ms on
// an H100, 38% of its bound, and left a 3.2 ms plain overlap pass behind):
// - One warp per frame, 8 warps a block, a block per tile of kTile = 64
//   consecutive frames; the warps take the tile's frames in turn.
// - Loads: each lane loads three 16-byte words straight into registers:
//   frame-buffer words 4l..4l+3 (the x pairs 2l, 2l+1), $100-4l..$103-4l
//   (the descending y words of pair 2l, and of pair 2l-1 for lane l-1,
//   handed down by one shuffle) and $80..$83 (the centre words, the same
//   address for every lane).  Each instruction covers 512 contiguous bytes;
//   no staging in shared memory is needed because every word lands in the
//   lane that uses it.
// - Tables: the pre-pass and twiddle coefficients, the blend coefficients
//   and the extraction maps are copied into shared memory once a block;
//   the stages read no table from global memory.
// - Stages: every lane holds 4 complex values in registers and runs two
//   radix-2 stages on them locally (a radix-4 step), three times: on plane
//   index bits 5,4, then 3,2, then 1,0.  Between the steps the warp
//   exchanges the values through a 128-word re and im buffer in shared
//   memory under __syncwarp().  An XOR swizzle of index bits 2..4 by bits
//   5 and 6 (pos() below) makes every exchange free of bank conflicts and
//   keeps groups of 4 words contiguous, so the last step reads and writes
//   16 bytes a lane.  Two buffers alternate, so a frame costs 4
//   __syncwarp() and no block barrier.
// - Overlap: frame f's 16 head words blend with frame f-1's 16 unblended,
//   volume-shifted tail words, zero where sid[f] != sid[f-1] and at f = 0.
//   The warps write each frame's tail and head words to shared memory and
//   its other 224 words straight out; after one __syncthreads() a tile the
//   block blends the heads with the tails and writes them.  The tail of
//   the frame before the tile comes from a halo frame that the block
//   transforms again when that frame lies in the same stream: at most
//   1/64 extra work.
// - Stores: the 240 words of a frame are staged nowhere; each lane gathers
//   4 output words (re and im of two extraction indices) from the final
//   buffer and writes them as one 16-byte store, so a warp writes a frame's
//   896 body bytes contiguously and 4 threads its 64 head bytes.
//
// - Carried state (the session path; overlap_resolve_planar_state,
//   dcsexplorer_tpu/ops/transform.py:352-376): with overlap0 [G, 16], a
//   run's first frame blends with overlap0[sid] instead of zeros, and the
//   last frame of each run writes its tail, 4 int4s from the tails buffer,
//   to last_ov[sid].  Both are in the interleaved 16-slot order (re, im of
//   each saved pair), which is the order the tails buffer already holds.
//   The carry is a template argument: with overlap0 null (the flat sweep)
//   the launch runs an instance compiled without the carry's code.
//
// Semantics kept exactly (and tested against the plain version): the MAC
// rounding quirk keys on the second product; volume shifts clamp to 31;
// the blend runs in uint32 and keeps bits 16..31 (each doubled product can
// reach 2^32); the carried words are the previous frame's plain tail, not
// its blended output; re takes the even blend coefficients, im the odd.

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // frames per block: kernels.py's
                                      // TRANSFORM94_PCM_TILE
constexpr int kFbWords = 512;
constexpr int kPcmWords = 240;
constexpr int kPcm4 = kPcmWords / 4;  // 16-byte words of one PCM row
static_assert(kThreads == 4 * kTile, "the blend takes 4 threads a frame");

// plane index e (0..127) -> its word in a 128-word exchange buffer: bits
// 2..4 XORed with (b6, b6, b5) so that each exchange hits 32 banks
__device__ __forceinline__ int pos(int e) {
    const int b6 = (e >> 6) & 1, b5 = (e >> 5) & 1;
    return e ^ (b6 << 4) ^ (b6 << 3) ^ (b5 << 2);
}

struct Tables {
    int4 p2[32];      // {c0[2l], c1[2l], c0[2l+1], c1[2l+1]}
    int2 cs[64];      // {cos[g], sin[g]}
    int4 cn[4];       // ovl_new, interleaved re/im like the output
    int4 co[4];       // ovl_old
    int ext[120];     // pos(ext_half[j])
    int save[8];      // pos(save_half[j])
};

// two stages on the 4 values whose plane indices differ only in the two
// stage bits, k = 2 * (higher bit) + (lower bit); g is value 0's group in
// the first stage, so the second stage's groups are 2g and 2g + 1
__device__ __forceinline__ void radix4(int (&r)[4], int (&i)[4], int g,
                                       const int2 *cs) {
    const int2 w = cs[g], w0 = cs[2 * g], w1 = cs[2 * g + 1];
    dcs::butterfly(r[0], i[0], r[2], i[2], w.x, w.y);
    dcs::butterfly(r[1], i[1], r[3], i[3], w.x, w.y);
    dcs::butterfly(r[0], i[0], r[1], i[1], w0.x, w0.y);
    dcs::butterfly(r[2], i[2], r[3], i[3], w1.x, w1.y);
}

template <bool kCarry>
__global__ void __launch_bounds__(kThreads, 4)
transform94_pcm_kernel(const int *__restrict__ fb, const int *__restrict__ vol,
                       const int *__restrict__ sid,
                       const int *__restrict__ p2_c0,
                       const int *__restrict__ p2_c1,
                       const int *__restrict__ cos_tab,
                       const int *__restrict__ sin_tab,
                       const int *__restrict__ ovl_new,
                       const int *__restrict__ ovl_old,
                       const int *__restrict__ ext_half,
                       const int *__restrict__ save_half,
                       const int *__restrict__ overlap0,
                       int *__restrict__ last_ov, int n_groups,
                       int *__restrict__ pcm, int n_frames) {
    // per warp: two exchange buffers of re[128] | im[128]; buffer 1 also
    // holds the pre-pass results fx[64], fy[64] (int2 each)
    __shared__ __align__(16) int wbuf[kWarps][2][256];
    __shared__ int4 heads[kTile][4];          // unblended head words
    __shared__ int4 tails[kTile + 1][4];      // [0]: the halo frame's
    __shared__ Tables tb;

    for (int i = threadIdx.x; i < 120; i += kThreads) {
        if (i < 64) {
            reinterpret_cast<int *>(tb.p2)[2 * i] = p2_c0[i];
            reinterpret_cast<int *>(tb.p2)[2 * i + 1] = p2_c1[i];
            tb.cs[i] = make_int2(cos_tab[i], sin_tab[i]);
        }
        if (i < 16) {
            reinterpret_cast<int *>(tb.cn)[i] = ovl_new[i];
            reinterpret_cast<int *>(tb.co)[i] = ovl_old[i];
        }
        if (i < 8) tb.save[i] = pos(save_half[i]);
        tb.ext[i] = pos(ext_half[i]);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int f0 = blockIdx.x * kTile;
    const bool halo = f0 > 0 && sid[f0 - 1] == sid[f0];
    int *re0 = wbuf[warp][0], *im0 = re0 + 128;
    int *re1 = wbuf[warp][1], *im1 = re1 + 128;
    int2 *fx = reinterpret_cast<int2 *>(re1);
    int2 *fy = reinterpret_cast<int2 *>(im1);

    // slot s holds frame f0 + s - 1; slot 0 is the halo
    for (int s = warp; s <= kTile; s += kWarps) {
        const int f = f0 + s - 1;
        if (s == 0 ? !halo : f >= n_frames) continue;
        const int *row = fb + (size_t)f * kFbWords;
        const int vs = vol[f];

        // pre-passes 1 and 2 on pairs 2l and 2l + 1
        const int4 xv = __ldg(reinterpret_cast<const int4 *>(row) + lane);
        const int4 yv =
            __ldg(reinterpret_cast<const int4 *>(row + 0x100) - lane);
        const int4 cv = __ldg(reinterpret_cast<const int4 *>(row + 0x80));
        int yz = __shfl_down_sync(0xFFFFFFFFu, yv.z, 1);
        int yw = __shfl_down_sync(0xFFFFFFFFu, yv.w, 1);
        if (lane == 31) {
            yz = cv.z;
            yw = cv.w;
        }
        const int4 c = tb.p2[lane];
        int4 x4, y4;
        dcs::fold_pair(xv.x, xv.y, yv.x, yv.y, c.x, c.y, x4.x, x4.y, y4.x,
                       y4.y);
        dcs::fold_pair(xv.z, xv.w, yz, yw, c.z, c.w, x4.z, x4.w, y4.z, y4.w);
        reinterpret_cast<int4 *>(fx)[lane] = x4;
        reinterpret_cast<int4 *>(fy)[lane] = y4;
        __syncwarp();

        // pre-pass 3 (x[q] +/- y[128+q]) into plane indices
        // b6*64 + 16k + c, then stages 1-2 (index bits 5, 4)
        int r[4], m[4];
        {
            const int b6 = lane >> 4, cq = lane & 15;
            for (int k = 0; k < 4; ++k) {
                const int q = 16 * k + cq;
                const int2 x = fx[q];
                int ya, yb;
                if (q == 0) {
                    ya = dcs::s16(dcs::mulss(cv.x, 0x8000));
                    yb = dcs::s16(dcs::mulss((-dcs::s16(cv.y)) & dcs::kM16,
                                             0x8000));
                } else {
                    const int2 y = fy[64 - q];
                    ya = dcs::s16(y.x);
                    yb = dcs::s16(y.y);
                }
                r[k] = dcs::sat16(b6 ? x.x - ya : x.x + ya);
                m[k] = dcs::sat16(b6 ? x.y - yb : x.y + yb);
            }
            radix4(r, m, b6, tb.cs);
            for (int k = 0; k < 4; ++k) {
                const int p = pos(64 * b6 + 16 * k + cq);
                re0[p] = r[k];
                im0[p] = m[k];
            }
        }
        __syncwarp();

        // stages 3-4 (index bits 3, 2): indices 16*hi + 4k + lo
        {
            const int hi = lane >> 2, lo = lane & 3;
            for (int k = 0; k < 4; ++k) {
                const int p = pos(16 * hi + 4 * k + lo);
                r[k] = re0[p];
                m[k] = im0[p];
            }
            radix4(r, m, hi, tb.cs);
            for (int k = 0; k < 4; ++k) {
                const int p = pos(16 * hi + 4 * k + lo);
                re1[p] = r[k];
                im1[p] = m[k];
            }
        }
        __syncwarp();

        // stages 5-6 (index bits 1, 0): indices 4l..4l+3, then the volume
        // shift, back into buffer 0 in the same 16-byte groups
        {
            const int p = pos(4 * lane);
            const int4 rv = *reinterpret_cast<const int4 *>(re1 + p);
            const int4 mv = *reinterpret_cast<const int4 *>(im1 + p);
            r[0] = rv.x, r[1] = rv.y, r[2] = rv.z, r[3] = rv.w;
            m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
            radix4(r, m, lane, tb.cs);
            for (int k = 0; k < 4; ++k) {
                r[k] = dcs::volume_shift(r[k], vs);
                m[k] = dcs::volume_shift(m[k], vs);
            }
            *reinterpret_cast<int4 *>(re0 + p) = make_int4(r[0], r[1], r[2],
                                                           r[3]);
            *reinterpret_cast<int4 *>(im0 + p) = make_int4(m[0], m[1], m[2],
                                                           m[3]);
        }
        __syncwarp();

        // extraction: PCM words 4j..4j+3 are re, im of ext[2j], ext[2j+1];
        // words 0..15 (the heads) wait for the blend
        if (s > 0) {
            int4 *out = reinterpret_cast<int4 *>(pcm + (size_t)f * kPcmWords);
            for (int j = lane; j < kPcm4; j += 32) {
                const int a = tb.ext[2 * j], b = tb.ext[2 * j + 1];
                const int4 o = make_int4(re0[a], im0[a], re0[b], im0[b]);
                if (j < 4)
                    heads[s - 1][j] = o;
                else
                    out[j] = o;
            }
        }
        if (lane < 4) {
            const int a = tb.save[2 * lane], b = tb.save[2 * lane + 1];
            const int4 tail = make_int4(re0[a], im0[a], re0[b], im0[b]);
            tails[s][lane] = tail;
            // the carried state out: the tail of each run's last frame
            if (kCarry && s > 0 &&
                (f + 1 == n_frames || sid[f + 1] != sid[f])) {
                const int g = sid[f];
                if ((unsigned)g >= (unsigned)n_groups) __trap();
                reinterpret_cast<int4 *>(last_ov)[4 * g + lane] = tail;
            }
        }
    }
    __syncthreads();

    // overlap blend: 4 threads a frame, 4 words each
    const int t = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int f = f0 + t;
    if (f < n_frames) {
        const int g = sid[f];
        const bool carry = f > 0 && g == sid[f - 1];
        const int4 h = heads[t][j];
        int4 p = make_int4(0, 0, 0, 0);
        if (carry) {
            p = tails[t][j];
        } else if (kCarry) {
            if ((unsigned)g >= (unsigned)n_groups) __trap();
            p = reinterpret_cast<const int4 *>(overlap0)[4 * g + j];
        }
        const int4 cn = tb.cn[j], co = tb.co[j];
        reinterpret_cast<int4 *>(pcm + (size_t)f * kPcmWords)[j] =
            make_int4(dcs::overlap_mix(h.x, p.x, cn.x, co.x),
                      dcs::overlap_mix(h.y, p.y, cn.y, co.y),
                      dcs::overlap_mix(h.z, p.z, cn.z, co.z),
                      dcs::overlap_mix(h.w, p.w, cn.w, co.w));
    }
}

}  // namespace

extern "C" int dcs_transform94_pcm(const int *fb, const int *vol_shift,
                                   const int *sid, const int *p2_c0,
                                   const int *p2_c1, const int *cos_tab,
                                   const int *sin_tab, const int *ovl_new,
                                   const int *ovl_old, const int *ext_half,
                                   const int *save_half,
                                   const int *overlap0, int *last_ov,
                                   int n_groups, int *pcm, int n_frames,
                                   cudaStream_t stream) {
    // overlap0 and last_ov are both given (the session path) or both null
    const int blocks = (n_frames + kTile - 1) / kTile;
    if (overlap0 != nullptr)
        transform94_pcm_kernel<true><<<blocks, kThreads, 0, stream>>>(
            fb, vol_shift, sid, p2_c0, p2_c1, cos_tab, sin_tab, ovl_new,
            ovl_old, ext_half, save_half, overlap0, last_ov, n_groups, pcm,
            n_frames);
    else
        transform94_pcm_kernel<false><<<blocks, kThreads, 0, stream>>>(
            fb, vol_shift, sid, p2_c0, p2_c1, cos_tab, sin_tab, ovl_new,
            ovl_old, ext_half, save_half, nullptr, nullptr, 0, pcm, n_frames);
    return (int)cudaGetLastError();
}
