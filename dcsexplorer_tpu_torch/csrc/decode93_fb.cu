// 1993-family decode into frame buffers: the 93 bands (93b, 93a Type-0)
// and OS93a Type-1, from the bank columns of ops/decode93.py.  It computes
// exactly ops/decode93.decode93_fb_plain: each output frame starts from
// silence and folds its voices (bank rows) in channel order, each through
// the 93 body and then the 93a body of its row's kind.
//
// Replaces, in the JAX package: decode93_frames
// (dcsexplorer_tpu/ops/decode93.py:197-310) and decode93a_frames
// (dcsexplorer_tpu/ops/decode93a.py:162-239), chained per channel by
// device_decode93 (dcsexplorer_tpu/models/pipeline.py:244-270), and the
// compact-wire unpack of flat93_pipeline_packed / flat93a_pipeline_packed
// (dcsexplorer_tpu/models/catalogsweep.py:283-348); XLA stages on the TPU.
//
// What bounds it on the H100: bytes, in principle.  Per frame it writes a
// 512-word frame buffer (2 KB) and reads per voice one row of columns
// (~250 B) and a few hundred bytes of bitstream: ~2.3 KB a frame, 0.10 ms
// for the 150,048-frame dec93b sweep at 3.35 TB/s.  The work is serial per
// band (the Sigma / Sigma-Sigma chains run sample after sample), so the
// instruction count of the chains holds it above that.
//
// Design (a first, simple kernel):
// - One warp per output frame, 8 warps a block, blocks striding over the
//   frames; the frame buffer sits in shared memory (2 KB a warp) and goes
//   out in 16-byte stores at the end.  The pair table (2,048 u16) and the
//   93a input map are copied into shared memory once a block.
// - 93 body: lane b (< 16) takes band b.  Its output start is the 16-band
//   prefix sum of the bands' advances (shuffles), from the stream's band
//   table; the lane then walks its band's samples in order, reading each
//   w-bit field straight from the byte pool (two aligned big-endian words),
//   running the band's chain and accumulating into its target word.  The
//   targets of one voice's cells are distinct, so the lanes never collide.
//   Then lane 0 applies the first-sample fix-up of words 0 and 1.
// - 93a body: input j (band b, index i) of the frame's 127 goes to lane
//   j mod 32; its two outputs are words 2j and 2j + 1, with the pair at
//   (2 << w) + 2 * raw.
// - The row kind (0 silent, 1 93, 2 93a) picks the body: the reference runs
//   both bodies on every row, but a row of one kind is a no-op in the other
//   body.
//
// Semantics kept exactly (and tested against the plain version): sign
// extension (raw - ((raw >> (w-1)) << w)) & $FFFF; the chains mod 2^16;
// the subtype-1 repeat anomaly's closed form; the scale/mix accumulate and
// the 93a rounding (tie rule on the doubled product) in uint32, with no
// signed overflow; targets past word 511 are dropped; bands without data
// read no bit; bytes past the pool read as $FF; a kind, width, row or
// stream id out of range traps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"
#include "decode94_walk.cuh"      // dcs94::pool_word

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFbWords = 512;
constexpr int kCols = 18;               // row width of kw_u8, bit_rel, code_u8
constexpr int kBands93a = 18;
constexpr int kInputs93a = 127;
constexpr int kPairLen = 2048;
constexpr int kMaxWidth93 = 24, kMaxWidth93a = 9;
enum { K_NONE = 0, K_DATA0 = 1, K_DATA1 = 2, K_DATA2 = 3, K_REPEAT = 4,
       K_RAMP = 5 };
enum { ROW_SILENT = 0, ROW_93 = 1, ROW_93A = 2 };

struct Cols {
    const uint8_t *pool;
    long long pool_len;
    const int *frame_word, *sid;
    const uint8_t *kind, *kw;
    const int *bit_rel, *prv;
    const uint8_t *code;
    const int *band_tab;     // [n_streams, 16, 8]
    int n_streams;
};

struct Shared {
    int fb[kWarps][kFbWords];
    unsigned short pair[kPairLen];
    unsigned char in_band[128], in_idx[128];
    int mant[4];
};

// bits [bit, bit + w) of the pool, most significant first (1 <= w <= 24)
__device__ __forceinline__ uint32_t pool_bits(const Cols &c, long long bit,
                                              int w) {
    const long long a = (bit >> 3) & ~3LL;
    const uint64_t v =
        ((uint64_t)dcs94::pool_word(c.pool, c.pool_len, a) << 32) |
        dcs94::pool_word(c.pool, c.pool_len, a + 4);
    const int sh = (int)(bit - a * 8);      // 0..31, so sh + w <= 55
    return (uint32_t)((v << sh) >> (64 - w));
}

// one voice of the 93 band decode into the warp's frame buffer
__device__ __forceinline__ void voice93(const Cols &c, int *fb, int r, int m,
                                        int lane) {
    int kind = K_NONE, w = 0, n = 0, inc = 1, sc = 0, adv = 0, pre = 0;
    uint32_t p_in = 0, p_dl = 0;
    long long bit = 0;
    if (lane < 16) {
        const int kw = c.kw[(size_t)r * kCols + lane];
        kind = kw >> 5;
        w = kw & 31;
        if (kind > K_RAMP || w > kMaxWidth93) __trap();
        const int s = c.sid[r];
        if ((unsigned)s >= (unsigned)c.n_streams) __trap();
        const int4 *t = reinterpret_cast<const int4 *>(c.band_tab) +
                        2 * (s * 16 + lane);
        const int4 t0 = __ldg(t), t1 = __ldg(t + 1);
        sc = t0.x & dcs::kM16;
        n = t0.y;
        inc = t0.z;
        pre = t0.w;
        adv = pre + (kind == K_NONE ? t1.y : n * inc + t1.x);
        bit = (long long)c.frame_word[r] * 32 +
              c.bit_rel[(size_t)r * kCols + lane];
        const uint32_t prv = (uint32_t)c.prv[(size_t)r * 16 + lane];
        p_in = prv & 0xFFFFu;
        p_dl = prv >> 16;
    }
    // out_start = 1 + (the advances of the bands before) + pre
    int incl = adv;
    for (int d = 1; d < 16; d <<= 1) {
        const int o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += o;
    }
    const int out_start = 1 + incl - adv + pre;
    const int outbuf1 = fb[1];
    __syncwarp();

    if (kind != K_NONE) {
        // the repeat anomaly: the product's low word enters sample i as
        // (l0 + i * m_low) mod 2^16
        const int l0 = (dcs::s16((int)p_in) * sc) & dcs::kM16;
        const int pl = dcs::s16(l0);
        const int m_low = (pl * m) & dcs::kM16;
        const bool data = kind <= K_DATA2;
        uint32_t acc_in = p_in, acc_dl = p_dl;
        int tgt = out_start;
        for (int i = 0; i < n; ++i, tgt += inc) {
            uint32_t val = 0;
            if (data) {
                const uint32_t raw = pool_bits(c, bit + (long long)i * w, w);
                const uint32_t samp = raw - ((raw >> (w - 1)) << w);
                if (kind == K_DATA0) {
                    val = samp;
                } else if (kind == K_DATA1) {
                    acc_in += samp;
                    val = acc_in;
                } else {
                    acc_dl += samp;
                    acc_in += acc_dl;
                    val = acc_in;
                }
            } else if (kind == K_RAMP) {
                acc_in += p_dl;
                val = acc_in;
            }
            if ((unsigned)tgt >= (unsigned)kFbWords) continue;
            const int old = fb[tgt];
            uint32_t prod;
            if (kind == K_REPEAT) {
                prod = ((uint32_t)dcs::s16(old) << 16) |
                       ((uint32_t)(l0 + i * m_low) & 0xFFFFu);
                prod += (uint32_t)(pl * m);
            } else {
                const int scaled = (dcs::s16((int)val) * sc) & dcs::kM16;
                prod = ((uint32_t)dcs::s16(old) << 16) | (uint32_t)scaled;
                prod += (uint32_t)(dcs::s16(scaled) * m);
            }
            fb[tgt] = (int)(prod >> 16);
        }
    }
    __syncwarp();
    // first-sample delta fix-up (reference :2608-2611)
    if (lane == 0) {
        const int delta = dcs::sat16(dcs::s16(fb[1]) - dcs::s16(outbuf1));
        fb[0] = dcs::sat16(dcs::s16(delta) + dcs::s16(fb[0]));
        fb[1] = outbuf1;
    }
    __syncwarp();
}

// one voice of the OS93a Type-1 decode into the warp's frame buffer
__device__ __forceinline__ void voice93a(const Cols &c, const Shared &sh,
                                         int *fb, int r, int m, int lane) {
    const long long base = (long long)c.frame_word[r] * 32;
    for (int j = lane; j < kInputs93a; j += 32) {
        const int b = sh.in_band[j];
        const int w = c.kw[(size_t)r * kCols + b];
        if (w == 0) continue;
        if (w > kMaxWidth93a) __trap();
        const int code = c.code[(size_t)r * kCols + b];
        const uint32_t scale32 =
            code == 0xFF ? 0u
                         : (uint32_t)sh.mant[code & 3] << min(code >> 2, 14);
        const int eff = dcs::s16((int)(((scale32 >> 16) * (uint32_t)m) >> 15));
        const uint32_t raw =
            pool_bits(c, base + c.bit_rel[(size_t)r * kCols + b] +
                             (long long)sh.in_idx[j] * w, w);
        const int p = (2 << w) + 2 * (int)raw;
        for (int k = 0; k < 2; ++k) {
            int *word = fb + 2 * j + k;
            const uint32_t prod =
                (uint32_t)(dcs::s16((int)sh.pair[p + k]) * eff) << 1;
            uint32_t res = ((uint32_t)dcs::s16(*word) << 16) + prod + 0x8000u;
            if ((prod & 0xFFFFu) == 0x8000u) res &= ~0x10000u;
            *word = (int)(res >> 16);
        }
    }
    __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
decode93_fb_kernel(Cols c, const int *__restrict__ rows,
                   const int *__restrict__ mix, const int *__restrict__ pair,
                   const int *__restrict__ inputs, int *__restrict__ out,
                   int n_frames, int n_ch, int n_rows) {
    __shared__ __align__(16) Shared sh;
    for (int i = threadIdx.x; i < kPairLen; i += kThreads)
        sh.pair[i] = (unsigned short)__ldg(pair + i);
    if (threadIdx.x == 0) {
        sh.mant[0] = 0x8000;
        sh.mant[1] = 0x9838;
        sh.mant[2] = 0xB505;
        sh.mant[3] = 0xD745;
        int j = 0;
        for (int b = 0; b < kBands93a; ++b)
            for (int i = 0; i < __ldg(inputs + b); ++i, ++j) {
                if (j >= kInputs93a) __trap();
                sh.in_band[j] = (unsigned char)b;
                sh.in_idx[j] = (unsigned char)i;
            }
        if (j != kInputs93a) __trap();
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int *fb = sh.fb[warp];
    int4 *fb4 = reinterpret_cast<int4 *>(fb);
    for (int f = blockIdx.x * kWarps + warp; f < n_frames;
         f += gridDim.x * kWarps) {
        for (int q = lane; q < kFbWords / 4; q += 32)
            fb4[q] = make_int4(0, 0, 0, 0);
        __syncwarp();
        for (int ch = 0; ch < n_ch; ++ch) {
            const size_t at = (size_t)f * n_ch + ch;
            const int r = rows != nullptr ? rows[at] : f;
            if ((unsigned)r >= (unsigned)n_rows) __trap();
            const int m = mix[at] & dcs::kM16;
            const int kind = c.kind[r];
            if (kind == ROW_93)
                voice93(c, fb, r, m, lane);
            else if (kind == ROW_93A)
                voice93a(c, sh, fb, r, m, lane);
            else if (kind != ROW_SILENT)
                __trap();
        }
        int4 *dst = reinterpret_cast<int4 *>(out + (size_t)f * kFbWords);
        for (int q = lane; q < kFbWords / 4; q += 32) dst[q] = fb4[q];
        __syncwarp();
    }
}

}  // namespace

extern "C" int dcs_decode93_fb(const uint8_t *pool, long long pool_len,
                               const int *frame_word, const int *sid,
                               const uint8_t *kind, const uint8_t *kw,
                               const int *bit_rel, const int *prv,
                               const uint8_t *code, const int *band_tab,
                               int n_streams, const int *pair,
                               const int *inputs, const int *rows,
                               const int *mix, int *out, int n_frames,
                               int n_ch, int n_rows, cudaStream_t stream) {
    // rows null: the flat sweep, one voice a frame, row f for frame f
    const Cols c{pool, pool_len, frame_word, sid, kind, kw, bit_rel, prv,
                 code, band_tab, n_streams};
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int want = (n_frames + kWarps - 1) / kWarps;
    const int blocks = want < 8 * sms ? want : 8 * sms;
    decode93_fb_kernel<<<blocks, kThreads, 0, stream>>>(
        c, rows, mix, pair, inputs, out, n_frames, n_ch, n_rows);
    return (int)cudaGetLastError();
}
