// 1994+ inverse transform in planar layout: center fix-ups, three
// fold/twiddle pre-passes, a six-stage radix-2 integer IFFT in 1.15 fixed
// point (saturating, with the MAC's convergent-rounding quirk) and the
// volume shift.  Output: re[k] = word 2k, im[k] = word 2k+1 of the
// time-domain frame, in bit-reversed storage order.
//
// Replaces: dcsexplorer_tpu/ops/transform.py:transform94_planar, an XLA
// stage on the TPU.
//
// What bounds it on the H100: per frame it reads 258 words (1 KB) and
// writes 256 (1 KB) around ~6 x 64 butterflies of integer multiplies, so
// it is memory-bound in principle; the six dependent stages add a barrier
// each, which a small block pays in latency.
//
// Design: one block of 64 threads per frame, one butterfly per thread per
// stage, the re/im planes (128 words each) in shared memory with a
// __syncthreads() between stages.  The twiddle and pre-pass tables come in
// as device tensors (the module's buffers) through the read-only cache.
// The flat sweep runs transform94_pcm.cu instead (a warp per frame, stages
// in registers, the overlap resolve fused); this kernel serves callers that
// need the planes.

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
transform94_kernel(const int *__restrict__ fb, const int *__restrict__ vol,
                   const int *__restrict__ p2_c0, const int *__restrict__ p2_c1,
                   const int *__restrict__ cos_tab,
                   const int *__restrict__ sin_tab, int *__restrict__ out_re,
                   int *__restrict__ out_im) {
    using dcs::mulss;
    using dcs::s16;
    using dcs::sat16;
    __shared__ int re[128], im[128], fy0[64], fy1[64];
    const int i = threadIdx.x;
    const int *row = fb + (size_t)blockIdx.x * 512;

    // pre-passes 1 and 2 on pair i
    int fx0, fx1;
    dcs::fold_pair(row[2 * i], row[2 * i + 1], row[0x100 - 2 * i],
                   row[0x101 - 2 * i], p2_c0[i], p2_c1[i], fx0, fx1, fy0[i],
                   fy1[i]);
    __syncthreads();

    // pre-pass 3: x[q] +/- y[128+q]; y[128], y[129] are the center
    // fix-ups, y[130..255] the folded y words read back ascending
    int yA = s16(i == 0 ? mulss(row[0x80], 0x8000) : fy0[64 - i]);
    int yB = s16(i == 0 ? mulss((-s16(row[0x81])) & dcs::kM16, 0x8000)
                        : fy1[64 - i]);
    re[i] = sat16(fx0 + yA);
    re[64 + i] = sat16(fx0 - yA);
    im[i] = sat16(fx1 + yB);
    im[64 + i] = sat16(fx1 - yB);
    __syncthreads();

    // six radix-2 stages: group g of n_part, butterfly j of h = part / 2
    for (int n_part = 2, part = 64; n_part <= 64; n_part *= 2, part /= 2) {
        int h = part / 2;
        int g = i / h;
        int u = g * part + i % h;
        int a = u + h;
        int ur = re[u], ui = im[u], ar = re[a], ai = im[a];
        dcs::butterfly(ur, ui, ar, ai, cos_tab[g], sin_tab[g]);
        re[u] = ur;
        re[a] = ar;
        im[u] = ui;
        im[a] = ai;
        __syncthreads();
    }

    int vs = vol[blockIdx.x];
    size_t o = (size_t)blockIdx.x * 128;
    out_re[o + i] = dcs::volume_shift(re[i], vs);
    out_re[o + 64 + i] = dcs::volume_shift(re[64 + i], vs);
    out_im[o + i] = dcs::volume_shift(im[i], vs);
    out_im[o + 64 + i] = dcs::volume_shift(im[64 + i], vs);
}

}  // namespace

extern "C" int dcs_transform94_planar(const int *fb, const int *vol_shift,
                                      const int *p2_c0, const int *p2_c1,
                                      const int *cos_tab, const int *sin_tab,
                                      int *out_re, int *out_im, int n_frames,
                                      cudaStream_t stream) {
    transform94_kernel<<<n_frames, kThreads, 0, stream>>>(
        fb, vol_shift, p2_c0, p2_c1, cos_tab, sin_tab, out_re, out_im);
    return (int)cudaGetLastError();
}
