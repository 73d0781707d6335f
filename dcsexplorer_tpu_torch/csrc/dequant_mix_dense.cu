// Dense-slot dequant / scale / mix of the host-decode hybrid: each frame's
// 256 slots carry a sample value, a scale, an explicit frame-buffer index
// and a valid flag (the native host decode's output, at its own widths);
// each valid slot's accumulate is placed at its index in a 512-word frame
// buffer, then words 0 and 1 get the saturating first-sample delta fix-up.
//
// Replaces: the XLA stage dcsexplorer_tpu/ops/band_decode.py
// (dequant_mix_dense), the scatter form of the Pallas kernel's arithmetic
// (csrc/dequant_mix.cu) that the JAX hybrid_stage_device runs
// (dcsexplorer_tpu/models/batched.py).  It places by a one-hot reduce over
// the 512 words; here the placement is a shared-memory atomic add.
//
// What bounds it on the H100: memory.  The function needs, per frame, 256
// valid flags, the mix and 4 + 4 + 2 bytes of each valid slot (plus 512
// prior words and the active flag when given), and writes 512 words: at
// most ~4.9 KB for ~10 integer operations a valid slot.  The kernel also
// reads the indices of invalid slots: loaded beside the flags they cost
// bytes, loaded after them a round trip on every block's path, which was
// slower on the H100.  (The native decoder fills a frame's slots from
// slot 0 up, so dense and scale of an invalid tail warp are never read.)
//
// Design: one block of 256 threads a frame, a thread a slot, so every
// load of a slot column coalesces.  The frame's 512 words sit in shared
// memory as 64-bit cells, the placed sum in the low half and the number of
// slots that named the word in the high half: one atomicAdd a valid slot
// places its word and marks it hit, and slots that name one word sum, as
// the reference's one-hot reduce does.  After a barrier each thread writes
// words t and t + 256 (coalesced); threads 0 and 1 write the fixed-up
// words 0 and 1.  Every chain that can overflow runs in uint32_t
// (dcs_fixmath.cuh); a sum is at most 256 x $FFFF, below 2^32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"

namespace {

constexpr int kWords = 512;
constexpr int kSlots = 256;     // slots a frame, threads a block

__global__ void __launch_bounds__(kSlots)
dequant_mix_dense_kernel(const int *__restrict__ dense,
                         const int *__restrict__ scale,
                         const int16_t *__restrict__ fb_idx,
                         const uint8_t *__restrict__ valid,
                         const int *__restrict__ mix,
                         const int *__restrict__ fb_prev,
                         const uint8_t *__restrict__ active,
                         int *__restrict__ out) {
    __shared__ unsigned long long cell[kWords];
    const int f = blockIdx.x;
    const int t = threadIdx.x;
    const size_t slot = (size_t)f * kSlots + t;
    const int *prev = fb_prev ? fb_prev + (size_t)f * kWords : nullptr;
    const bool act = active ? active[f] != 0 : true;

    cell[t] = 0;
    cell[t + kSlots] = 0;
    __syncthreads();

    const int idx = fb_idx[slot];
    if (act && valid[slot] && idx >= 0 && idx < kWords) {
        const int scaled =
            (dcs::s16(dense[slot]) * (scale[slot] & dcs::kM16)) & dcs::kM16;
        const int old = prev ? prev[idx] : 0;
        const uint32_t word = (uint32_t)dcs::accum_word(old, scaled, mix[f]);
        atomicAdd(&cell[idx], (1ull << 32) | word);
    }
    __syncthreads();

    // the frame buffer before the fix-up: a placed sum, else the prior word
    auto placed = [&](int w) {
        const unsigned long long c = cell[w];
        return (c >> 32) ? (int)(uint32_t)c : (prev ? prev[w] : 0);
    };
    int *o = out + (size_t)f * kWords;
    const int outbuf1 = prev ? prev[1] : 0;
    if (t == 0) {
        const int fb0 = placed(0);
        const int delta = dcs::sat16(dcs::s16(placed(1)) - dcs::s16(outbuf1));
        o[0] = act ? dcs::sat16(dcs::s16(delta) + dcs::s16(fb0)) : fb0;
    } else if (t == 1) {
        o[1] = act ? outbuf1 : placed(1);
    } else {
        o[t] = placed(t);
    }
    o[t + kSlots] = placed(t + kSlots);
}

}  // namespace

extern "C" int dcs_dequant_mix_dense(const int *dense, const int *scale,
                                     const int16_t *fb_idx,
                                     const uint8_t *valid, const int *mix,
                                     const int *fb_prev,
                                     const uint8_t *active, int *out,
                                     int n_frames, cudaStream_t stream) {
    dequant_mix_dense_kernel<<<n_frames, kSlots, 0, stream>>>(
        dense, scale, fb_idx, valid, mix, fb_prev, active, out);
    return (int)cudaGetLastError();
}
