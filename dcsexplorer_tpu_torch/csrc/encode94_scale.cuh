// encode94_scale.cuh: the 1994+ encoder's 65-entry scale table and its
// division by reciprocal, shared by encode94_decide.cu and
// encode94_select.cu (kernels.encode94_rdiv_check proves this one function
// on the card), and the host's query of a kernel's launch geometry that
// both report.
//
// Scale table.  Entry i < 64 is the scale factor of the scale code sc with
// sc & 63 == i: sf = max(1, mant[i & 3] >> (15 - (i >> 2 & 15))) (58
// distinct values, all < 2^16); entry 64 is sf = 1 (a dead band or code 0).
//
// Division by multiplication.  rdiv(a, sf) = sign(a) floor(n / d) with
// n = 2|a| + sf < 2^22 (|a| <= 2^20, sf < 2^16) and d = 2 sf in [2, 2^17).
// With s = floor(log2(d - 1)) (so 2^s < d <= 2^(s+1)) and m = ceil(2^(32+s)
// / d): m < 2^32 (2^s <= d - 1), and m d = 2^(32+s) + e with 0 <= e < d, so
// n m / 2^(32+s) = n/d + n e / (d 2^(32+s)) where n e < 2^22 2^(s+1) <=
// 2^(32+s); the excess is under 1/d and cannot reach the next integer
// above n/d: floor(n m / 2^(32+s)) = floor(n / d), that is
// __umulhi(n, m) >> s.  kernels.encode94_rdiv_check counts, on the card,
// the (a, entry) pairs where it differs from the integer division: all
// |a| <= 2^20 and all 65 entries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDead = 64;                // the scale table's sf = 1 entry

// entry i of the scale table: (sf, m, s) with sf of the scale code i & 63
// (i < 64) or 1 (i == 64), and the reciprocal of d = 2 sf (note above)
__device__ __forceinline__ int4 scale_entry(const int32_t* mant, int i) {
    int sf = 1;
    if (i < kDead) {
        sf = mant[i & 3] >> (15 - ((i >> 2) & 0xF));
        sf = sf < 1 ? 1 : sf;
    }
    const unsigned d = 2u * static_cast<unsigned>(sf);
    const int s = 31 - __clz(static_cast<int>(d - 1u));
    const unsigned long long m =
        ((1ull << (32 + s)) + d - 1u) / static_cast<unsigned long long>(d);
    return make_int4(sf, static_cast<int>(static_cast<unsigned>(m)), s, 0);
}

// sign(a) * floor((2|a| + sf) / 2sf) for |a| <= 2^20, by the reciprocal
__device__ __forceinline__ int rdiv(int a, int4 t) {
    const unsigned ua = a < 0 ? 0u - static_cast<unsigned>(a)
                              : static_cast<unsigned>(a);
    const unsigned n = 2u * ua + static_cast<unsigned>(t.x);
    const int q = static_cast<int>(
        __umulhi(n, static_cast<unsigned>(t.y)) >> t.z);
    return a < 0 ? -q : q;
}

// a kernel's geometry on this card, four ints: threads a block (as given),
// static shared bytes, registers a thread, resident blocks an SM
inline int kernel_geometry(const void* fn, int threads, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    int per_sm = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                            threads, 0);
    out[0] = threads;
    out[1] = err == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes) : 0;
    out[2] = err == cudaSuccess ? attr.numRegs : 0;
    out[3] = per_sm;
    return static_cast<int>(err);
}

// the SMs of the current card
inline int sm_count(int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    *out = 0;
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
    return static_cast<int>(err);
}

}  // namespace
