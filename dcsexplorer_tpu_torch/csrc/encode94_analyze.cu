// encode94_analyze: raw int16 PCM -> the canonical analysis coefficients of
// the 1994+ encoder, on the card's int8 tensor cores (wgmma).
//
// Replaces the XLA analysis of the JAX package's device encoder,
// dcsexplorer_tpu/encoder/device94.py:_analyze_device (:354-390), and keeps
// its form: four int8-plane matrix products with int32 sums.  Contract
// (encoder.device94.analyze94_plain): frame f of stream b is samples
// f*240 .. f*240+255 of its row, ci = clip(floor((frame . fq + 2^20) /
// 2^21), +-2^20) for every int16 PCM and every int16 matrix fq [256, 255].
//
// Planes.  Any int16 v = 256*v1 + v0 with v0 = v & 255 (u8) and v1 = v >> 8
// (arithmetic: s8), -32768 included.  With x = 256*x1 + x0 (a frame) and
// a = 256*a1 + a0 (a matrix column), x.a = p00 + 256*(p01 + p10) +
// 65536*p11 where pij = sum_k xi*aj over the 256 taps; Hopper's integer
// wgmma takes u8 and s8 in any mix, so each pij is one product with no
// offset correction.  Two int32 accumulator sets:
//   acc1 = p00, |p00| <= 256*255*255 < 2^24;
//   acc2 = 256*p11 + p01 + p10: p11's K loop runs first, is scaled by 256
//   in registers (|256*p11| <= 256*256*128*128 = 2^30), then p01 and p10
//   join it (|p01 + p10| <= 2*256*255*128 < 2^24).  Every partial sum of
//   any order is bounded by the sum of the terms' magnitudes, < 2^31.
// Epilogue, the JAX package's nested shift, exact in int32: (x.a + 2^20)
// >> 21 = (acc2 + ((acc1 + 2^20) >> 8)) >> 13, since floor((256*q + u) /
// 2^21) = floor((q + floor(u / 256)) / 2^13); the sum stays < 2^31.
// (tests/test_torch_analyze94.py models this arithmetic on the CPU.)
//
// Tiles.  A block takes 64 frames of one stream (kTileF, wgmma's M) by a
// slab of 96 columns (kSlab; past column 254 zero): ceil(Fmax/64) x 3 x B
// blocks of two warpgroups, each the 64 frames by 48 columns.  At the
// encoder's chunk (16 streams, Fmax 272) that is 240 blocks, two an SM
// (79,904 B of shared memory each), one wave of 264 slots on 132 SMs:
// 108 SMs hold two blocks and set the pace.  Slabs of 128 columns (160
// blocks, 28 SMs with two) measured 12% slower: each of those SMs does a
// third more; slabs of 64 (3 blocks an SM) spilled and were slower still.
//
// A operand (PCM).  A tile's frames are one contiguous span of 64*240 + 16
// samples whose start (f0*480 bytes into a row of (Fmax+1)*480 bytes) is a
// multiple of 16 bytes: it arrives by 16-byte cp.async (the wrapper
// requires a 16-byte-aligned pcm), overlapped with the matrix's transpose
// below, and is split in place into a u8 and an s8 plane of the span.
// Frame f's row of either plane starts f*240 bytes in: a multiple of 16,
// as ldmatrix needs, and 60 words apart, so the 8 rows of an 8x8 load
// fall in 8 distinct bank quads (-4r mod 32): no padding, no swizzle, no
// copy of the 16 shared samples.  wgmma's shared-memory operands need 8
// rows of 16 contiguous bytes, which overlapping frames are not, so A goes
// to wgmma in registers, by ldmatrix (a warp's 16 frames by 32 taps).
// Only the samples of frames < Fmax are read (through (Fmax-1)*240 + 255,
// inside the row); the rest of the span is zero and its frames are never
// stored.
//
// B operand (matrix).  wgmma's int8 B is K-major, and fq is [K, N] with N
// contiguous: each block builds its slab's u8 and s8 planes in shared
// memory as wgmma's core matrices (8 columns x 16 taps, 128 contiguous
// bytes; the next 16 taps 128 bytes on, the next 8 columns 2,048), read
// through descriptors with no swizzle.  A thread loads 16 taps of one
// column (a warp's loads are 32 consecutive columns, 64 bytes), packs them
// with byte permutes and stores one 16-byte row into each plane (8
// consecutive columns: 128 contiguous bytes, no bank conflict).  Two
// blocks of a cluster each building half and storing it into both (DSMEM)
// measured slower than each block building all of it.
//
// Products.  wgmma m64n48k32 (N = kSlab/2) with A from registers: the first
// pass loads the warp's 8 s8 A fragments and issues 8 products into acc2;
// the second, in two halves of 4 taps-steps, loads u8 and s8 fragments
// and issues 3 products a step.  One commit and wait a batch; the
// registers of an in-flight wgmma are pinned by empty asm statements after
// the wait.  mma.sync.m16n8k32 from the same planes (warps of 32 x 32)
// measured 15% slower over the whole kernel: it issues at about half the
// int8 rate.
//
// Epilogue.  The coefficients go through shared memory (over the B
// planes, rows of kSlab + 8 words: conflict-free 8-byte fragment stores),
// then out with consecutive threads on consecutive words of a frame's
// run: row starts are 1,020*(b*Fmax + f) bytes, not 16-byte aligned for
// every Fmax, so the stores are words.  Column 255 and frames >= Fmax are
// never stored.
//
// Bound: the bytes (PCM, the matrix, the coefficients), of which the
// coefficients' stores are two thirds; the four plane products need about
// half the bytes' time at the int8 tensor cores' rate.
//
// Build: ops/kernels.py (nvcc -gencode arch=compute_90a,code=sm_90a, plain
// C interface, ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 256;        // samples a frame (the taps)
constexpr int kHop = 240;        // frame stride
constexpr int kCols = 255;       // coefficients a frame
constexpr int kClip = 1 << 20;
constexpr int kTileF = 64;       // frames a block: wgmma's M
constexpr int kSlab = 96;        // columns a block
constexpr int kPerSM = 2;        // blocks an SM (shared memory allows)
constexpr int kN = kSlab / 2;    // columns a warpgroup: wgmma's N
constexpr int kAcc = kN / 2;     // accumulators a thread, each set
constexpr int kThreads = 256;    // two warpgroups
constexpr int kSpan = kTileF * kHop + (kWin - kHop);  // samples a tile
constexpr int kChunks = kSpan / 8;                    // its 16-byte chunks
constexpr int kCore = 8 * kWin;  // bytes of 8 columns' planes (all taps)
constexpr int kBPlane = kSlab * kWin;
constexpr int kORow = kSlab + 8;                      // words a staged row
// shared memory: the span (int16, then its two byte planes), the matrix
// slab's two planes (later the staged coefficients)
constexpr int kSmem = 2 * kSpan + 2 * kBPlane;
static_assert(kSpan % 8 == 0 && (2 * kSpan) % 16 == 0, "chunked span");
static_assert(kSlab % 16 == 0 && kSlab * 16 % kThreads == 0, "slab");
static_assert(kTileF * kORow * 4 <= 2 * kBPlane, "staging fits");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void ldsm4(unsigned addr, unsigned (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// wgmma's shared-memory matrix descriptor of the core matrices at addr:
// K-major, no swizzle; the next core matrix along K (LBO) 128 bytes on,
// the next 8 columns (SBO) kCore bytes on
__device__ __forceinline__ unsigned long long desc(unsigned addr) {
    return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4)
           | (static_cast<unsigned long long>(128 >> 4) << 16)
           | (static_cast<unsigned long long>(kCore >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// after a wait: the accumulators are read, and the A fragments held, no
// earlier than here
__device__ __forceinline__ void keep(int (&d)[kAcc]) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) asm volatile("" : "+r"(d[e]) :: "memory");
}
__device__ __forceinline__ void keep4(const unsigned (&a)[4]) {
    asm volatile("" :: "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])
                 : "memory");
}

// d += a . b: a warpgroup's 64 x 32 A in registers (this warp's 16 rows,
// as ldmatrix gives them) and the 32 x N B at descriptor b, as AT and BT
// (u8 or s8), int32 sums
#define DCS_ACC_LIST "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14," \
    "%15,%16,%17,%18,%19,%20,%21,%22,%23}"
#define DCS_ACC_OPS(d) "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),     \
    "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),             \
    "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),        \
    "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),       \
    "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
#define DCS_A_OPS "%24,%25,%26,%27"
#define DCS_B_OP "%28"
#define DCS_SCALE_OP "%29"
static_assert(kAcc == 24, "the operand lists above are of 24 accumulators");
#define DCS_WGMMA(NAME, AT, BT)                                              \
    __device__ __forceinline__ void NAME(int (&d)[kAcc],                    \
                                         const unsigned (&a)[4],            \
                                         unsigned long long b) {            \
        asm volatile(                                                       \
            "{\n.reg .pred p;\nsetp.ne.b32 p, " DCS_SCALE_OP ", 0;\n"       \
            "wgmma.mma_async.sync.aligned.m64n48k32.s32." AT "." BT " "     \
            DCS_ACC_LIST ", {" DCS_A_OPS "}, " DCS_B_OP ", p;\n}\n"          \
            : DCS_ACC_OPS(d)                                                \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));  \
    }
DCS_WGMMA(wg_uu, "u8", "u8")
DCS_WGMMA(wg_us, "u8", "s8")
DCS_WGMMA(wg_su, "s8", "u8")
DCS_WGMMA(wg_ss, "s8", "s8")
#undef DCS_WGMMA

// the low bytes (u8 plane) and the high bytes (s8 plane) of four int16
// packed two a word: x = v0 | v1 << 16, y = v2 | v3 << 16
__device__ __forceinline__ unsigned lo_bytes(unsigned x, unsigned y) {
    return __byte_perm(x, y, 0x6420);
}
__device__ __forceinline__ unsigned hi_bytes(unsigned x, unsigned y) {
    return __byte_perm(x, y, 0x7531);
}

__global__ void __launch_bounds__(kThreads, kPerSM)
encode94_analyze_kernel(const int16_t* __restrict__ pcm,
                        const int16_t* __restrict__ fq,
                        int32_t* __restrict__ ci, int fmax) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* span = smem;                      // kSpan int16, then
    unsigned char* b_lo = smem + 2 * kSpan;          // the planes at 0 and
    unsigned char* b_hi = b_lo + kBPlane;            // kSpan
    const int tid = threadIdx.x;
    const int f0 = blockIdx.x * kTileF;
    const int n0 = blockIdx.y * kSlab;
    const int b = blockIdx.z;
    const int nvalid = min(kTileF, fmax - f0);

    // 1. the tile's span: frames < Fmax by cp.async, the rest zero
    const int16_t* src = pcm + static_cast<size_t>(b) * (fmax * kHop + kHop)
                         + static_cast<size_t>(f0) * kHop;
    const int live = (nvalid * kHop + (kWin - kHop)) / 8;
    for (int i = tid; i < kChunks; i += kThreads) {
        if (i < live)
            cp_async16(span + 16 * i, src + 8 * i);
        else
            *reinterpret_cast<uint4*>(span + 16 * i) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // 2. the slab's planes as core matrices: thread (column n, 16-tap
    // chunk c), consecutive threads on consecutive columns
#pragma unroll 2
    for (int it = 0; it < kSlab * 16 / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int n = i % kSlab, c = i / kSlab;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (n0 + n < kCols) {
            const int16_t* w = fq + 16 * c * kCols + n0 + n;
            unsigned v[16];
#pragma unroll
            for (int k = 0; k < 16; ++k)
                v[k] = static_cast<uint16_t>(__ldg(w + k * kCols));
            unsigned p[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) p[k] = v[2 * k] | (v[2 * k + 1] << 16);
            lo = make_uint4(lo_bytes(p[0], p[1]), lo_bytes(p[2], p[3]),
                            lo_bytes(p[4], p[5]), lo_bytes(p[6], p[7]));
            hi = make_uint4(hi_bytes(p[0], p[1]), hi_bytes(p[2], p[3]),
                            hi_bytes(p[4], p[5]), hi_bytes(p[6], p[7]));
        }
        const int at = (n >> 3) * kCore + 128 * c + 16 * (n & 7);
        *reinterpret_cast<uint4*>(b_lo + at) = lo;
        *reinterpret_cast<uint4*>(b_hi + at) = hi;
    }
    // the planes are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    // 3. the span split in place into its u8 plane (bytes 0 .. kSpan) and
    // its s8 plane (kSpan .. 2 kSpan)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
    uint4 x[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < kChunks) x[j] = *reinterpret_cast<const uint4*>(span + 16 * i);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < kChunks) {
            *reinterpret_cast<uint2*>(span + 8 * i) =
                make_uint2(lo_bytes(x[j].x, x[j].y), lo_bytes(x[j].z, x[j].w));
            *reinterpret_cast<uint2*>(span + kSpan + 8 * i) =
                make_uint2(hi_bytes(x[j].x, x[j].y), hi_bytes(x[j].z, x[j].w));
        }
    }
    __syncthreads();

    // 4. the products: warpgroup wg takes columns kN wg .. of the slab, its
    // warp w frames 16 w .. of the tile (A rows lane & 15, taps + 16 for
    // lanes 16 .. 31)
    const int warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, w = warp & 3;
    int acc1[kAcc], acc2[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc1[e] = acc2[e] = 0;
    const unsigned a_lo = smem_addr(span) + (16 * w + (lane & 15)) * kHop
                          + 16 * (lane >> 4);
    const unsigned a_hi = a_lo + kSpan;
    // a 32-tap step is 256 bytes of the planes: 16 in the descriptor
    const unsigned long long d_lo = desc(smem_addr(b_lo) + wg * kN * kWin);
    const unsigned long long d_hi = desc(smem_addr(b_hi) + wg * kN * kWin);
    {   // first pass: p11 into acc2
        unsigned a[8][4];
#pragma unroll
        for (int s = 0; s < 8; ++s) ldsm4(a_hi + 32 * s, a[s]);
        wg_fence();
#pragma unroll
        for (int s = 0; s < 8; ++s) wg_ss(acc2, a[s], d_hi + 16 * s);
        wg_commit_wait();
        keep(acc2);
#pragma unroll
        for (int s = 0; s < 8; ++s) keep4(a[s]);
    }
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc2[e] *= 256;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // second pass: p00, p01 and p10
        unsigned al[4][4], ah[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            ldsm4(a_lo + 32 * (4 * h + s), al[s]);
            ldsm4(a_hi + 32 * (4 * h + s), ah[s]);
        }
        wg_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const unsigned long long o = 16 * (4 * h + s);
            wg_uu(acc1, al[s], d_lo + o);
            wg_us(acc2, al[s], d_hi + o);
            wg_su(acc2, ah[s], d_lo + o);
        }
        wg_commit_wait();
        keep(acc1);
        keep(acc2);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            keep4(al[s]);
            keep4(ah[s]);
        }
    }
    __syncthreads();

    // 5. round, clip and stage over the B planes: accumulator 4i + 2h + e
    // is row g + 8h of the warp's 16, column 8i + 2t + e of the
    // warpgroup's, g = lane / 4, t = lane % 4
    int* stage = reinterpret_cast<int*>(b_lo);
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int k1 = acc2[4 * i + 2 * h + e]
                               + ((acc1[4 * i + 2 * h + e] + kClip) >> 8);
                const int q = k1 >> 13;
                v[e] = q < -kClip ? -kClip : (q > kClip ? kClip : q);
            }
            const int row = 16 * w + 8 * h + (lane >> 2);
            const int col = kN * wg + 8 * i + 2 * (lane & 3);
            *reinterpret_cast<int2*>(stage + row * kORow + col) =
                make_int2(v[0], v[1]);
        }
    __syncthreads();

    // 6. out: a frame's run of columns, consecutive threads on consecutive
    // words
    constexpr int kRows = kThreads / kSlab;          // rows a pass
    int32_t* dst = ci + (static_cast<size_t>(b) * fmax + f0) * kCols + n0;
    const int ncols = min(kSlab, kCols - n0);
    const int col = tid % kSlab;
    if (tid < kRows * kSlab && col < ncols) {
        for (int r = tid / kSlab; r < nvalid; r += kRows)
            dst[r * kCols + col] = stage[r * kORow + col];
    }
}

cudaError_t set_shared() {
    cudaError_t err = cudaFuncSetAttribute(
        encode94_analyze_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    // kPerSM blocks an SM need the largest shared-memory carveout
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            encode94_analyze_kernel,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            static_cast<int>(cudaSharedmemCarveoutMaxShared));
    return err;
}

}  // namespace

// pcm 16-byte aligned (the wrapper checks), 1 <= n_streams < 65536
extern "C" int dcs_encode94_analyze(const int16_t* pcm, const int16_t* fq,
                                    int32_t* ci, int n_streams, int fmax,
                                    cudaStream_t stream) {
    const cudaError_t err = set_shared();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((fmax + kTileF - 1) / kTileF, (kCols + kSlab - 1) / kSlab,
                    n_streams);
    encode94_analyze_kernel<<<grid, kThreads, kSmem, stream>>>(pcm, fq, ci,
                                                               fmax);
    return static_cast<int>(cudaGetLastError());
}

// the kernel's geometry on this card, eight ints: frames and columns a
// block, threads a block, dynamic shared bytes, registers a thread, local
// (spilled) bytes a thread, resident blocks an SM, SMs
extern "C" int dcs_encode94_analyze_geometry(int* out) {
    cudaError_t err = set_shared();
    cudaFuncAttributes attr = {};
    int per_sm = 0, dev = 0, sms = 0;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&attr, encode94_analyze_kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, encode94_analyze_kernel, kThreads, kSmem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    const int vals[8] = {kTileF, kSlab, kThreads, kSmem, attr.numRegs,
                         static_cast<int>(attr.localSizeBytes), per_sm, sms};
    for (int i = 0; i < 8; ++i) out[i] = vals[i];
    return static_cast<int>(err);
}
