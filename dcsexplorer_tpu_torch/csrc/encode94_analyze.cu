// encode94_analyze: raw int16 PCM -> the canonical analysis coefficients of
// the 1994+ encoder, on the card.
//
// Replaces the XLA analysis of the JAX package's device encoder,
// dcsexplorer_tpu/encoder/device94.py:_analyze_device (:354-390), which ran
// four int8-plane matrix products with int32 sums and a nested-shift
// rounding.  Here each (frame, column) dot of 256 int16 x int16 terms is
// summed exactly in int64 for every int16 PCM and matrix: the terms are
// multiplied and added in pairs in 32-bit unsigned arithmetic.  A term is
// at most 2^30 in magnitude, so a pair's sum lies in (-2^31, 2^31]; less
// one, it lies in [-2^31, 2^31) and its value modulo 2^32, read as an int,
// is exact.  The ones taken off (one a pair) start the int64 sum.  Then
// ci = clip((sum + 2^20) >> 21, +-2^20), the arithmetic shift being the
// floor: equal to the host's float64 evaluation
// (encoder.analyze_frames_canonical) for every input.
//
// Frames come straight from the PCM: frame f of stream b is samples
// f*240 .. f*240+255 of its row (the last 16 are the next frame's head),
// so no frames tensor exists.  A block stages kTile frames in shared memory
// as int32 and computes all 255 columns of them, one column a thread; each
// thread keeps kTile int64 sums and reads its matrix column once (a 16-byte
// broadcast load of four samples serves four products of each frame).
//
// Bound: the bytes (PCM, the 130 KB matrix, the coefficients).  The
// product is exact on int8 tensor cores as four int8-plane products, whose
// operations take about half the bytes' time; this kernel runs on the
// CUDA cores, and the int64 sums cost about five instructions per four
// products more than int32 would.  Tensor cores (wgmma s8) are later work.
//
// Build: ops/kernels.py (nvcc -gencode arch=compute_90a,code=sm_90a, plain
// C interface, ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;        // frames per block
constexpr int kThreads = 256;    // one column a thread (255 used)
constexpr int kWin = 256;        // samples per frame
constexpr int kHop = 240;        // frame stride
constexpr int kCols = 255;       // coefficients per frame
constexpr int kShift = 21;       // the matrix's scale, 2^21
constexpr int kClip = 1 << 20;

__global__ void __launch_bounds__(kThreads)
encode94_analyze_kernel(const int16_t* __restrict__ pcm,
                        const int16_t* __restrict__ fq,
                        int32_t* __restrict__ ci, int fmax) {
    __shared__ int4 xs[kTile][kWin / 4];
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kTile;
    const int16_t* src = pcm + static_cast<size_t>(b) * (fmax * kHop + kHop);
    int* xsi = reinterpret_cast<int*>(xs);
    for (int i = threadIdx.x; i < kTile * kWin; i += kThreads) {
        const int f = i / kWin;
        xsi[i] = f0 + f < fmax ? src[(f0 + f) * kHop + i % kWin] : 0;
    }
    __syncthreads();
    const int c = threadIdx.x;
    if (c >= kCols) return;

    long long acc[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) acc[f] = kWin / 2;  // one a pair
#pragma unroll 2
    for (int k4 = 0; k4 < kWin / 4; ++k4) {
        const int16_t* w = fq + 4 * k4 * kCols + c;
        const unsigned w0 = w[0], w1 = w[kCols], w2 = w[2 * kCols],
                       w3 = w[3 * kCols];
#pragma unroll
        for (int f = 0; f < kTile; ++f) {
            const int4 x = xs[f][k4];
            const unsigned s01 = static_cast<unsigned>(x.x) * w0
                                 + static_cast<unsigned>(x.y) * w1 - 1u;
            const unsigned s23 = static_cast<unsigned>(x.z) * w2
                                 + static_cast<unsigned>(x.w) * w3 - 1u;
            acc[f] += static_cast<long long>(static_cast<int>(s01))
                      + static_cast<int>(s23);
        }
    }
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
        if (f0 + f >= fmax) break;
        long long v = (acc[f] + (1LL << (kShift - 1))) >> kShift;
        v = v < -kClip ? -kClip : (v > kClip ? kClip : v);
        ci[(static_cast<size_t>(b) * fmax + f0 + f) * kCols + c] =
            static_cast<int32_t>(v);
    }
}

}  // namespace

extern "C" int dcs_encode94_analyze(const int16_t* pcm, const int16_t* fq,
                                    int32_t* ci, int n_streams, int fmax,
                                    cudaStream_t stream) {
    const dim3 grid((fmax + kTile - 1) / kTile, n_streams);
    encode94_analyze_kernel<<<grid, kThreads, 0, stream>>>(pcm, fq, ci,
                                                           fmax);
    return static_cast<int>(cudaGetLastError());
}
