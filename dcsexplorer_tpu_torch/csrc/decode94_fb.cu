// Flat 1994+ decode from the compact catalog columns straight to frame
// buffers: band controls, the Huffman / raw symbol walk and the
// dequant/mix epilogue in one kernel.
//
// Replaces, in the JAX package: band_controls_dyn
// (dcsexplorer_tpu/models/flatsweep.py:42), _expand / slot_controls
// (dcsexplorer_tpu/ops/band_decode.py:240,259), the decode_flat scan
// (dcsexplorer_tpu/models/flatsweep.py:87-145) and dequant_mix, whose
// Pallas kernel is dequant_mix_pallas (dcsexplorer_tpu/ops/pallas_kernels.py
// :65-103, single-voice form).  Its plain version is
// ops/band_decode.decode94_fb_plain, and it is bit-identical to it.
//
// What bounds it on the H100: bytes.  Per frame it reads sid, start_bit and
// mix (4 B each), 16 band-type bytes and its stretch of the byte pool, and
// writes one 2 KB frame buffer.  At the flat94_music catalog (300,096
// frames, 24.4 MB pool) that is ~33 MB in and 614.6 MB out: 0.193 ms at
// 3.35 TB/s.  The integer work is a serial chain per frame (every step
// waits on the bit cursor of the step before), a few tens of instructions
// a position; with enough frames in flight it is issue-bound, not
// latency-bound.
//
// Design:
// - One thread per frame.  Each band's packed control word (the layout of
//   slot_controls: code | maxw<<5 | cb_base<<10 | 1<<20 | scale_code<<21 |
//   (out_inc-1)<<27 | start_parity<<28) is built in registers when the walk
//   reaches the band, from hdr_tab[sid], fmt/sub_tab[sid], the frame's band
//   types and the previous frame's (read from global memory, since that
//   frame may sit in another block).  No per-position tensor exists.
// - A 64-bit bit window per thread, refilled with one aligned 4-byte word
//   when fewer than 25 bits remain (a step needs at most 23).  That word is
//   loaded one refill ahead, so its latency hides behind the symbols in
//   between.  Bytes past the pool read as $FF; a load goes byte by byte only
//   at the pool's end, so nothing is read past it.
// - The dequant/mix epilogue runs per position as it is decoded (single
//   voice: the prior frame buffer is silence), and the word goes to shared
//   memory as u16.
// - Every 64 positions the warp flushes the staged words of its 32 frames
//   with 16-byte stores, the lanes on neighbouring addresses (half a warp
//   per 256-byte row); the words past n_steps are stored as zeros directly.
// - Block split: 128 threads = 128 frames per block, staging 64 words a
//   frame (row of 68 u16, 17 KB) plus the codec tables (6 KB, read with
//   divergent indices, so in shared memory): 23 KB a block.  Staging whole
//   rows (260 u16, 71 KB a block) fitted only 3 blocks, 12 warps, on an SM;
//   they walked in lockstep and then stored in a burst, and took 0.66 ms
//   on an H100 (700 W).  With 64-word chunks, registers (64 a thread, held
//   there by __launch_bounds__) allow 8 blocks, 32 warps, whose walks
//   overlap other warps' stores.  A row of 68 u16 (34 words) puts the 32
//   lanes of a warp on 16 banks when each stores its position: a 2-way
//   conflict.

// Semantics kept exactly (and tested against the plain version):
// - the $7F terminator ends the band list; type-1 band types translate
//   through xt/xa with codes clamped to 0..15, preadj only on bands < 3;
//   skipped bands (type 0) advance by the halved count; maxw/cb_base come
//   from the codebook tables only for codes 1..6, raw widths cap at 17;
//   code bits past bit 4 fall into the maxw field, as the packed word does;
// - a decimated ($40) band emits on every other position, starting at the
//   band start's parity; bands that share a start resolve to the last;
// - the lookup reads the 32-bit big-endian word at the cursor's byte, so
//   bits past 32 - (cursor & 7) read as 0;
// - a codebook lane's index clamps to the last entry; a filler position
//   clears the two-zero skip carry; positions at and past n_steps are 0;
// - scale = mant[sc & 3] >> (15 - ((sc >> 2) & 15)); the accumulate is
//   uint32 (dcs_fixmath.cuh:accum_word); word 0 gets the saturating delta
//   fix-up last and word 1 keeps the prior buffer's 0.

#include <cuda_runtime.h>

#include "dcs_fixmath.cuh"

namespace {

constexpr int kThreads = 128;          // = frames per block
constexpr int kChunk = 64;             // frame-buffer words staged per flush
constexpr int kStride = 68;            // staged u16 words per frame
constexpr int kCbLen = 940;            // flattened codebooks 1..6
constexpr int kWords = 512;

// shared-memory copy of the codec tables (int32 each)
struct Tables {
    int cb[kCbLen];
    int out_count[16];
    int xt[16 * 16];
    int xa[16 * 16];
    int preadj[2 * 16];
    int maxw[7];
    int cb_base[7];
    int mant[4];
};


__device__ __forceinline__ void copy_tab(int *dst, const int *__restrict__ src,
                                         int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// big-endian 32-bit pool word at byte i (a multiple of 4); $FF past the end
__device__ __forceinline__ uint32_t pool_word(const uint8_t *__restrict__ pool,
                                              long long len, long long i) {
    if (i >= 0 && i + 4 <= len) {
        uint32_t w = __ldg(reinterpret_cast<const unsigned int *>(pool + i));
        return __byte_perm(w, 0, 0x0123);
    }
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
        long long b = i + j;
        w = (w << 8) | (b >= 0 && b < len ? (uint32_t)__ldg(pool + b) : 0xFFu);
    }
    return w;
}

__device__ __forceinline__ int byte_of(uint4 v, int b) {
    uint32_t w = b < 8 ? (b < 4 ? v.x : v.y) : (b < 12 ? v.z : v.w);
    return (int)((w >> (8 * (b & 3))) & 0xFFu);
}

__global__ void __launch_bounds__(kThreads, 8)
decode94_fb_kernel(const uint8_t *__restrict__ pool, long long pool_len,
                   const int *__restrict__ sid,
                   const int *__restrict__ start_bit,
                   const uint8_t *__restrict__ bt_u8,
                   const int *__restrict__ mix,
                   const uint8_t *__restrict__ hdr_tab,
                   const uint8_t *__restrict__ fmt_tab,
                   const uint8_t *__restrict__ sub_tab, int n_streams,
                   const int *__restrict__ g_out_count,
                   const int *__restrict__ g_xt, const int *__restrict__ g_xa,
                   const int *__restrict__ g_preadj,
                   const int *__restrict__ g_maxw,
                   const int *__restrict__ g_cb_base,
                   const int *__restrict__ g_mant,
                   const int *__restrict__ g_cb, int *__restrict__ out,
                   int n_frames, int n_steps) {
    __shared__ __align__(16) uint16_t stage[kThreads * kStride];
    __shared__ Tables tb;
    copy_tab(tb.cb, g_cb, kCbLen);
    copy_tab(tb.out_count, g_out_count, 16);
    copy_tab(tb.xt, g_xt, 256);
    copy_tab(tb.xa, g_xa, 256);
    copy_tab(tb.preadj, g_preadj, 32);
    copy_tab(tb.maxw, g_maxw, 7);
    copy_tab(tb.cb_base, g_cb_base, 7);
    copy_tab(tb.mant, g_mant, 4);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp0 = threadIdx.x & ~31;
    const int f_warp = blockIdx.x * kThreads + warp0;
    // frames of this warp to write out; a lane past the last frame walks
    // the last frame again, in step with the warp, and writes nothing
    const int n_rows = min(32, n_frames - f_warp);
    const int f = min(f_warp + lane, n_frames - 1);
    uint16_t *row = stage + threadIdx.x * kStride;
    const uint16_t *wstage = stage + warp0 * kStride;

    // the warp writes words [64k, 64k + 64) of its frame buffers from the
    // staging, with the words past last_w (and word 1) as 0: 16-byte
    // stores, half a warp per 256-byte row
    const int c4 = 4 * (lane & 15);
    auto flush = [&](int k, int last_w) {
        __syncwarp();
        const int w = k * kChunk + c4;
        for (int r = lane >> 4; r < n_rows; r += 2) {
            const uint2 h =
                *reinterpret_cast<const uint2 *>(wstage + r * kStride + c4);
            int4 o;
            o.x = w <= last_w ? (int)(h.x & 0xFFFFu) : 0;
            o.y = w + 1 > 1 && w + 1 <= last_w ? (int)(h.x >> 16) : 0;
            o.z = w + 2 <= last_w ? (int)(h.y & 0xFFFFu) : 0;
            o.w = w + 3 <= last_w ? (int)(h.y >> 16) : 0;
            *reinterpret_cast<int4 *>(out + (size_t)(f_warp + r) * kWords +
                                      w) = o;
        }
        __syncwarp();
    };

    const int s = sid[f];
    if ((unsigned)s >= (unsigned)n_streams) __trap();
    const uint4 hdr = __ldg(reinterpret_cast<const uint4 *>(hdr_tab) + s);
    const bool type1 = fmt_tab[s] != 0;
    const int *preadj = tb.preadj + (sub_tab[s] != 0 ? 16 : 0);
    const uint4 bt = __ldg(reinterpret_cast<const uint4 *>(bt_u8) + f);
    const uint4 btp =
        (f > 0 && sid[f - 1] == s)
            ? __ldg(reinterpret_cast<const uint4 *>(bt_u8) + f - 1)
            : make_uint4(0, 0, 0, 0);
    const int mx = mix[f];

    // bit window: the top nb bits of win are the pool at the cursor, the
    // bits below them are 0; `ahead` is the next 4-byte word, loaded one
    // refill early so that its latency hides behind the steps before it
    long long cursor = start_bit[f];
    long long nxt = (cursor >> 3) & ~3LL;
    const int sh = (int)(cursor - nxt * 8);
    uint64_t win = (((uint64_t)pool_word(pool, pool_len, nxt) << 32) |
                    pool_word(pool, pool_len, nxt + 4)) << sh;
    int nb = 64 - sh;
    uint32_t ahead = pool_word(pool, pool_len, nxt + 8);
    nxt += 12;

    // the band under the walk
    int b = 0, band_start = 0, band_end = 0;
    int packed = 0, scale = 1;
    bool inc2 = false, done = false;
    bool skip = false;
    for (int w = 1; w <= n_steps; ++w) {
        const int t = w - 1;          // position t lands in word t + 1
        while (t == band_end && !done) {
            // next band's controls (band_controls_dyn + slot_controls)
            const int hb = b < 16 ? byte_of(hdr, b) : 0x7F;
            if ((hb & 0x7F) == 0x7F) {
                done = true;
                packed = 0;
                break;
            }
            const int cur = hb & 0x7F;
            inc2 = (cur & 0x40) != 0;
            int oc = tb.out_count[b];
            if (inc2) oc >>= 1;
            const int btv = byte_of(bt, b);
            int code = btv, sc = cur;
            if (type1) {
                const int c15 = min(btv, 15);
                code = tb.xt[b * 16 + c15];
                sc = cur + tb.xa[b * 16 + c15] +
                     (b < 3 ? preadj[min(byte_of(btp, b), 15)] : 0);
            }
            if (btv == 0) code = 0;
            band_start = band_end;
            band_end = band_start + (btv != 0 && inc2 ? 2 * oc : oc);
            packed = 0;
            if (code != 0) {
                const bool is_cb = code >= 1 && code <= 6;
                const int book = min(code, 6);
                const int maxw = is_cb ? tb.maxw[book] : min(code, 17);
                packed = code | (maxw << 5) | (tb.cb_base[book] << 10) |
                         (1 << 20) | ((sc & 0x3F) << 21) | ((int)inc2 << 27) |
                         ((band_start & 1) << 28);
            }
            const int sc6 = (packed >> 21) & 0x3F;
            scale = tb.mant[sc6 & 3] >> (15 - ((sc6 >> 2) & 0xF));
            ++b;
        }
        // a decimated band's off-parity positions are fillers
        const int p = (inc2 && ((t ^ band_start) & 1)) || done ? 0 : packed;

        int v = 0;
        if (p == 0 || skip) {
            skip = false;      // a filler or the second of two zeros
        } else {
            if (nb < 25) {
                win |= (uint64_t)ahead << (32 - nb);
                nb += 32;
                ahead = pool_word(pool, pool_len, nxt);
                nxt += 4;
            }
            const int c = p & 0x1F;
            const int mw = (p >> 5) & 0x1F;
            const int cb = (p >> 10) & 0x3FF;
            const uint32_t top = (uint32_t)(win >> 32) &
                                 (0xFFFFFFFFu << (int)(cursor & 7));
            const int look = mw ? (int)(top >> (32 - mw)) : 0;
            int sample, nbits;
            bool two_zero = false;
            if (c <= 6) {
                const int entry = tb.cb[min(cb + look, kCbLen - 1)];
                two_zero = (entry & 0x80) != 0;
                sample = (entry & 0x7F) - (1 << min(max(c - 1, 0), 14));
                nbits = entry >> 8;
            } else {
                const int mw1 = max(mw, 1);
                sample = look - ((look >> (mw1 - 1)) << mw1);
                nbits = mw;
            }
            win <<= nbits;
            nb -= nbits;
            cursor += nbits;
            skip = two_zero;
            v = two_zero ? 0 : (sample & dcs::kM16);
        }
        // dequant/mix epilogue (single voice: the prior buffer is silence)
        const int scaled = (dcs::s16(v) * (scale & dcs::kM16)) & dcs::kM16;
        const int word = dcs::accum_word(0, scaled, mx);
        if (w == 1) {
            // word 0: the saturating first-sample delta against the prior
            // buffer's word 1 (0), added to its word 0 (0); word 1 stays 0
            row[0] = (uint16_t)dcs::sat16(dcs::s16(dcs::sat16(dcs::s16(word))));
        } else {
            row[w & (kChunk - 1)] = (uint16_t)word;
        }
        if ((w & (kChunk - 1)) == kChunk - 1 || w == n_steps)
            flush(w / kChunk, n_steps);
    }
    // the words past n_steps are 0
    for (int k = n_steps ? n_steps / kChunk + 1 : 0; k < kWords / kChunk; ++k)
        for (int r = lane >> 4; r < n_rows; r += 2)
            *reinterpret_cast<int4 *>(out + (size_t)(f_warp + r) * kWords +
                                      k * kChunk + c4) = make_int4(0, 0, 0, 0);
}

}  // namespace

extern "C" int dcs_decode94_fb(const uint8_t *pool, long long pool_len,
                               const int *sid, const int *start_bit,
                               const uint8_t *bt_u8, const int *mix,
                               const uint8_t *hdr_tab, const uint8_t *fmt_tab,
                               const uint8_t *sub_tab, int n_streams,
                               const int *out_count, const int *xt,
                               const int *xa, const int *preadj,
                               const int *maxw, const int *cb_base,
                               const int *mant, const int *cb_flat, int *out,
                               int n_frames, int n_steps,
                               cudaStream_t stream) {
    // eight blocks an SM need the largest shared-memory carveout
    cudaError_t err = cudaFuncSetAttribute(
        decode94_fb_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n_frames + kThreads - 1) / kThreads;
    decode94_fb_kernel<<<blocks, kThreads, 0, stream>>>(
        pool, pool_len, sid, start_bit, bt_u8, mix, hdr_tab, fmt_tab, sub_tab,
        n_streams, out_count, xt, xa, preadj, maxw, cb_base, mant, cb_flat,
        out, n_frames, n_steps);
    return (int)cudaGetLastError();
}
