// 1993 inverse transform and overlap resolve in one kernel: frame buffers
// in, PCM out.  It computes exactly ops/transform.transform93_pcm_plain:
// transform93_raw (the slot-0 magnitude fix-up, the 256 -> 512 expansion,
// seven radix-2 stages with wrapping arithmetic, the volume shift and the
// bit-reversed collection), then the overlap blend of each frame's 16 head
// words with the previous frame's 16 tail words, reset where the stream id
// changes; the planes never reach device memory.
//
// Replaces, in the JAX package: _taylor_sqrt93 and transform93_raw
// (dcsexplorer_tpu/ops/transform.py:400-562) and overlap_resolve93_flat /
// overlap_resolve93 (:565-598), XLA stages on the TPU.
//
// What bounds it on the H100: bytes, in principle.  Per frame it reads
// words 0..255 of the frame buffer (1 KB), the volume shift and the stream
// id, and writes 240 PCM words (960 B): ~2 KB a frame, 0.09 ms for the
// 150,048-frame dec93b sweep at 3.35 TB/s.  The integer work (seven stages
// of 128 butterflies, each a rounded complex rotate and four wrapping adds:
// ~15,000 operations a frame, 0.07 ms at 33.5 TOP/s) is close behind, and
// each operation costs several instructions (sign extension, the MAC's
// rounding quirk), so issue slots hold the kernel well above the bound.
//
// Design (a first, simple kernel, shaped like transform94_pcm.cu):
// - One warp per frame, 8 warps a block, a block per tile of kTile = 64
//   consecutive frames; the warps take the tile's frames in turn.
// - Each lane loads two 16-byte words of the frame buffer into a staging
//   buffer in shared memory; the lanes then write the expanded re and im
//   planes (256 words each) beside it.  Every lane computes the slot-0
//   fix-up itself (a scalar, uniform across the warp).
// - Stages: each lane takes 4 of a stage's 128 butterflies, in place in
//   the planes, with __syncwarp() between stages.  (Two-way bank conflicts
//   in the stages whose half-width is below 32.)
// - Collection: output j = volume_shift(re[br93_half[j]]); words 16..239
//   go straight out (coalesced), the 16 head and 16 tail words to shared
//   memory.
// - Overlap: after one __syncthreads() a tile, 4 threads a frame blend the
//   heads with the previous frame's tails (zero at a stream start) and write
//   them as 16-byte words.  The tail of the frame before the tile comes
//   from a halo frame that the block transforms again when that frame lies
//   in the same stream: at most 1/64 extra work.
// - Carried state (the session path; overlap_resolve93): with overlap0
//   [G, 16], a run's first frame blends with overlap0[sid] instead of
//   zeros, and the last frame of each run writes its tail to last_ov[sid].
//   The carry is a template argument: with overlap0 null (the flat sweep,
//   a served batch) the launch runs an instance compiled without it.
//
// Semantics kept exactly (and tested against the plain version): the
// normalize loop's 31 steps with the exp > -31 stop (no clz shortcut),
// floor halving of the even exponent, clamped shifts, the AR == 0 bypass;
// the collisions re[192] = yr - xr and im[64] = yi - xi; the MAC rounding
// quirk keys on the second product; volume shifts clamp to 31; the blend
// runs in uint32 and keeps bits 16..31; the carried words are the previous
// frame's plain tail, not its blended output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // frames per block: kernels.py's
                                      // TRANSFORM93_PCM_TILE
constexpr int kFbWords = 512;
constexpr int kPcmWords = 240;
static_assert(kThreads == 4 * kTile, "the blend takes 4 threads a frame");

struct Tables {
    int2 cs[128];        // {cos[g], sin[g]}
    int4 cn[4], co[4];   // ovl_new, ovl_old
    int br[256];         // br93_half
};

// MR1 of round((s16(a) * s16(b)) << 1) with the MAC's tie rule; the whole
// rounded accumulator in *res
__device__ __forceinline__ int mul_round93(int a, int b, uint32_t *res) {
    const uint32_t prod = (uint32_t)(dcs::s16(a) * dcs::s16(b)) << 1;
    uint32_t r = prod + 0x8000u;
    if ((prod & 0xFFFFu) == 0x8000u) r &= ~0x10000u;
    *res = r;
    return (int)(r >> 16);
}

// the slot-0 magnitude fix-up (reference :633-704), u16 storage
__device__ int taylor_sqrt93(int fb0, int fb1) {
    int ar = dcs::s16(fb0);
    const bool neg = ar < 0;
    ar = (neg ? -ar : ar) & dcs::kM16;
    const uint32_t v = ((uint32_t)(dcs::s16(fb1) * dcs::s16(fb1)) +
                        (uint32_t)(dcs::s16(ar) * dcs::s16(ar))) << 1;
    // normalize32: 31 steps, as the reference walks them
    int ex = 0;
    uint32_t xx = v;
    for (int k = 0; k < 31; ++k) {
        const bool more = (int)xx < 0 ? (xx & 0x40000000u) != 0
                                      : ex > -31 && (xx & 0x40000000u) == 0;
        if (more) {
            --ex;
            xx <<= 1;
        }
    }
    const uint32_t mant = v << (-ex);       // 0 <= -ex <= 31
    const int ar2 = (int)(mant >> 16);
    if (ar2 == 0) return 0;                 // AR == 0 skips the series

    // 5-term Taylor series in the accumulator
    uint32_t mr = 0x0D490000u + ((uint32_t)(0x5D1D * dcs::s16(ar2)) << 1);
    uint32_t unused;
    int mf = ar2;
    const int coef[4] = {-22035, 0x46D6, -8790, 0x072D};
    for (int k = 0; k < 4; ++k) {
        mf = mul_round93(ar2, mf, &unused);
        mr += (uint32_t)(coef[k] * dcs::s16(mf)) << 1;
    }
    if (ex & 1) {            // MultiplyAndRound(MR1(mr), $5A82)
        mul_round93((int)(mr >> 16), 0x5A82, &mr);
        ++ex;
    }
    ex = (ex >> 1) + 1;      // even: the floor
    // BitShiftSigned32 of the low 32 bits of mr
    const int shifted = ex >= 0 ? (int)(mr << min(ex, 31))
                                : (int)mr >> min(-ex, 31);
    const int arf = (shifted >> 16) & dcs::kM16;
    return neg ? (-dcs::s16(arf)) & dcs::kM16 : arf;
}

template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
transform93_pcm_kernel(const int *__restrict__ fb, const int *__restrict__ vol,
                       const int *__restrict__ sid,
                       const int *__restrict__ cos_tab,
                       const int *__restrict__ sin_tab,
                       const int *__restrict__ ovl_new,
                       const int *__restrict__ ovl_old,
                       const int *__restrict__ br_half,
                       const int *__restrict__ overlap0,
                       int *__restrict__ last_ov, int n_groups,
                       int *__restrict__ pcm, int n_frames) {
    // per warp: the frame's words 0..255, then the re and im planes
    __shared__ __align__(16) int wbuf[kWarps][3][256];
    __shared__ __align__(16) int heads[kTile][16];
    __shared__ __align__(16) int tails[kTile + 1][16];   // [0]: the halo's
    __shared__ __align__(16) Tables tb;

    for (int i = threadIdx.x; i < 256; i += kThreads) {
        if (i < 128) tb.cs[i] = make_int2(cos_tab[i], sin_tab[i]);
        if (i < 16) {
            reinterpret_cast<int *>(tb.cn)[i] = ovl_new[i];
            reinterpret_cast<int *>(tb.co)[i] = ovl_old[i];
        }
        tb.br[i] = br_half[i];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int f0 = blockIdx.x * kTile;
    const bool halo = f0 > 0 && sid[f0 - 1] == sid[f0];
    int *w = wbuf[warp][0], *re = wbuf[warp][1], *im = wbuf[warp][2];

    // slot s holds frame f0 + s - 1; slot 0 is the halo
    for (int s = warp; s <= kTile; s += kWarps) {
        const int f = f0 + s - 1;
        if (s == 0 ? !halo : f >= n_frames) continue;
        const int4 *row = reinterpret_cast<const int4 *>(fb + (size_t)f *
                                                        kFbWords);
        reinterpret_cast<int4 *>(w)[lane] = __ldg(row + lane);
        reinterpret_cast<int4 *>(w)[lane + 32] = __ldg(row + lane + 32);
        __syncwarp();

        // expansion 256 -> 512: pair i of x = (w[2+2i], w[3+2i]) and of
        // y = (w[254-2i], w[255-2i])
        for (int i = lane; i < 64; i += 32) {
            const int xr = dcs::s16(w[2 + 2 * i]), xi = dcs::s16(w[3 + 2 * i]);
            const int yr = dcs::s16(w[254 - 2 * i]);
            const int yi = dcs::s16(w[255 - 2 * i]);
            const int add_r = (xr + yr) & dcs::kM16;
            const int add_i = (xi + yi) & dcs::kM16;
            re[1 + i] = add_r;                          // re[1..64]
            re[255 - i] = (yr - xr) & dcs::kM16;        // re[192..255]
            im[127 - i] = (yi - xi) & dcs::kM16;        // im[64..127]
            im[129 + i] = add_i;                        // im[129..192]
            if (i < 63) {
                re[127 - i] = add_r;                    // re[65..127]
                re[129 + i] = (xr - yr) & dcs::kM16;    // re[129..191]
                im[1 + i] = (xi - yi) & dcs::kM16;      // im[1..63]
                im[255 - i] = add_i;                    // im[193..255]
            }
        }
        if (lane == 0) {
            const int ar = taylor_sqrt93(w[0], w[1]);
            re[0] = re[128] = ar;
            im[0] = im[128] = 0;
        }
        __syncwarp();

        // seven radix-2 stages; stage st pairs a and a + h, h = 64 >> st,
        // twiddle of group a / 2h
        for (int st = 0; st < 7; ++st) {
            const int lg = 6 - st;
            for (int t = lane; t < 128; t += 32) {
                const int a = ((t >> lg) << (lg + 1)) | (t & ((1 << lg) - 1));
                const int b = a + (1 << lg);
                const int2 c = tb.cs[a >> (lg + 1)];
                int tr, ti;
                dcs::rotate_round(re[b], im[b], c.x, c.y, tr, ti);
                const int ur = dcs::s16(re[a]), ui = dcs::s16(im[a]);
                re[a] = (ur - tr) & dcs::kM16;
                re[b] = (ur + tr) & dcs::kM16;
                im[a] = (ui - ti) & dcs::kM16;
                im[b] = (ui + ti) & dcs::kM16;
            }
            __syncwarp();
        }

        // volume shift + collection in natural time order
        const int vs = vol[f];
        int *out = pcm + (size_t)f * kPcmWords;
        for (int j = lane; j < 256; j += 32) {
            const int v = dcs::volume_shift(re[tb.br[j]], vs);
            if (j >= kPcmWords) {
                tails[s][j - kPcmWords] = v;
                // the carried state out: the tail of each run's last frame
                if (kCarry && s > 0 &&
                    (f + 1 == n_frames || sid[f + 1] != sid[f])) {
                    const int g = sid[f];
                    if ((unsigned)g >= (unsigned)n_groups) __trap();
                    last_ov[16 * g + j - kPcmWords] = v;
                }
            } else if (s > 0) {
                if (j < 16)
                    heads[s - 1][j] = v;
                else
                    out[j] = v;
            }
        }
        __syncwarp();
    }
    __syncthreads();

    // overlap blend: 4 threads a frame, 4 words each
    const int t = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int f = f0 + t;
    if (f < n_frames) {
        const int g = sid[f];
        const bool carry = f > 0 && g == sid[f - 1];
        const int4 h = reinterpret_cast<const int4 *>(heads[t])[j];
        int4 p = make_int4(0, 0, 0, 0);
        if (carry) {
            p = reinterpret_cast<const int4 *>(tails[t])[j];
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

extern "C" int dcs_transform93_pcm(const int *fb, const int *vol_shift,
                                   const int *sid, const int *cos_tab,
                                   const int *sin_tab, const int *ovl_new,
                                   const int *ovl_old, const int *br_half,
                                   const int *overlap0, int *last_ov,
                                   int n_groups, int *pcm, int n_frames,
                                   cudaStream_t stream) {
    // overlap0 and last_ov are both given (the carried state) or both null
    const int blocks = (n_frames + kTile - 1) / kTile;
    if (overlap0 != nullptr)
        transform93_pcm_kernel<true><<<blocks, kThreads, 0, stream>>>(
            fb, vol_shift, sid, cos_tab, sin_tab, ovl_new, ovl_old, br_half,
            overlap0, last_ov, n_groups, pcm, n_frames);
    else
        transform93_pcm_kernel<false><<<blocks, kThreads, 0, stream>>>(
            fb, vol_shift, sid, cos_tab, sin_tab, ovl_new, ovl_old, br_half,
            nullptr, nullptr, 0, pcm, n_frames);
    return (int)cudaGetLastError();
}
