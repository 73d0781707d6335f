// 1993-family decode, inverse transform and overlap resolve in one kernel:
// bank rows in, PCM out.  It computes exactly
// ops/decode93.decode93_pcm_plain, that is
// transform93_pcm_plain(decode93_fb_plain(cols, rows, mix, tabs), vol, sid,
// tabs, overlap0): its columns' instance with rows None and no overlap0,
// its session instance session93_pcm_plain, which equals it on the bank of
// the same columns.  Each output frame starts from silence and folds its
// voices (bank rows) in channel order, each through the 93 body or the
// OS93a Type-1 body of its row's kind; then the slot-0 magnitude fix-up, the
// 256 -> 512 expansion, seven radix-2 stages with wrapping arithmetic, the
// volume shift, the bit-reversed collection and the overlap blend.  The
// frame buffer lives only in shared memory, and the planes only in
// registers and shared memory.
//
// Two instances, chosen by what the caller gives.  The columns' instance
// (rows null: the flat sweep, each row decoded once, one voice a frame and
// no carried state) decodes each voice from its row's bitstream and
// prescan columns.  The session instance
// (rows given) folds each voice from the session bank (decode93_bank.cuh):
// the words of each row's decode that do not depend on the mix, decoded
// once per ROM by decode93_bank.cu, so that a voice-frame is two 8-byte
// loads a lane and a few multiply-adds a word instead of a bitstream
// decode (a session plays each row thousands of times a batch).  The two
// voice steps share no code; the transform, the collection, the tile, the
// halo and the overlap blend are the same.
//
// Replaces, in the JAX package: decode93_frames
// (dcsexplorer_tpu/ops/decode93.py:197-310) and decode93a_frames
// (dcsexplorer_tpu/ops/decode93a.py:162-239), chained per channel by
// device_decode93 (dcsexplorer_tpu/models/pipeline.py:244-272);
// _taylor_sqrt93 and transform93_raw (dcsexplorer_tpu/ops/transform.py
// :400-562) and overlap_resolve93_flat / overlap_resolve93 (:565-598); XLA
// stages on the TPU.  In this package it replaces the pair decode93_fb.cu ->
// transform93_pcm.cu on every 1993 path (both stay, on no path).
//
// What bounds it on the H100: integer operations, and in practice issue
// slots.  Per frame the columns' instance reads each voice's row of
// columns (~180 B) and a few hundred bytes of bitstream, the session
// instance 512-640 B of bank words a voice (from L2: a ROM's bank is a few
// MB), and both write 240 PCM words (960 B); a six-voice session frame
// needed ~3,000 integer operations to decode from the bitstream and needs
// ~15,000 to transform, so the operations over 33.5 TOP/s outweigh the
// bytes over 3.35 TB/s.  Each operation of the 1.15 fixed point costs several
// instructions (sign extension, the MAC's rounding quirk: ~20 for a
// butterfly), and nothing here maps onto the tensor cores, so the design
// cuts instructions and keeps 32 warps an SM (64 registers, no spills,
// 46 KB of shared memory a block).  Measured at six voices (PERF.md), the
// voice loop is bound by the instructions it runs and fetches, not by the
// latency of its loads: staging each voice's bitstream a voice ahead in
// shared memory (through registers or by cp.async) made it slower, while
// keeping the rare path of each field load (words past the pool's end)
// out of the common path's code made it a fifth faster.
//
// Design:
// - One warp per frame, 8 warps a block, a block per tile of kTile = 63
//   consecutive frames plus the halo frame before it, so that each warp
//   takes 8 frames.  The frame buffer is 256 words a warp in shared
//   memory: the transform reads words 0..255 only, so targets at 256 and
//   above are dropped (a test on the CPU holds that premise).  It is the
//   first of the warp's two exchange buffers; the second (xb) holds a 93
//   voice's partial and its band list during the decode.
// The columns' instance:
// - Voice headers: lanes 0..C-1 hold the frame's rows, mixes, row kinds,
//   frame words and row streams, loaded during the previous frame's
//   transform; each voice's band columns (kw, bit_rel, prv, code, its
//   stream's band table) load while the voice before it runs.
// - Each voice is decoded as an independent body into its own partial, and
//   the partials fold into the frame buffer in channel order (one voice a
//   frame in the flat sweep).  This rests on a premise that a CPU test holds
//   on random and edge words (tests/test_torch_decode93_pcm.py): words are
//   mod 2^16, the 93 body's write ((sx16(w) << 16 | lo) + X) >> 16 is w +
//   ((lo + X) >> 16), and the Type-1 body's round((w << 16) + prod) is w +
//   ((prod + $8000) >> 16) with bit 0 cleared where prod's low half is
//   $8000.  So a voice's deltas d (and its tie bits) read no word of the
//   frame: each voice's body computes its partial, and the partials fold
//   into the words in channel order, which keeps the two rules that depend
//   on order: the tie rule clears bit 0 of the running word, and after a 93
//   voice word 0 takes sat16(sat16(sx16(w1 + d1) - sx16(w1)) + sx16(w0))
//   while word 1 keeps its value (the first-sample fix-up, reference
//   :2608-2611).  Lane l owns words 4l..4l+3 and 128+4l..128+4l+3 of the
//   frame buffer during the decode and alone reads and writes them, so the
//   folds need no fence.  A 93 voice scatters its deltas as 256 halfwords
//   into xb (words 0..127, zero but at the voice's targets; its band list
//   after them); after one __syncwarp() each lane adds its halfwords to its
//   words (lane 0: the fix-up in place of word 1's delta) and clears them
//   for the next 93 voice.  A Type-1 voice's lane l takes inputs 2l, 2l+1,
//   64+2l and 65+2l (input j writes words 2j and 2j+1): its words are the
//   lane's own, so its partial stays in registers and folds at once.
// - 93 body on all 32 lanes: each lane takes a run of one band's samples,
//   8 of them (lane l: band l & 15) or, when at most 8 bands carry samples
//   (nine frames in ten of the real streams), 4 of them (lane l: the
//   (l & 7)-th such band).  Each lane extracts its own fields (independent
//   loads, checked against the pool's end once, issued before the chain),
//   runs the Sigma / Sigma-Sigma chain over its samples in registers, and
//   takes the chain state entering them from the band's other lanes by a
//   shuffle scan.  Ramps and repeats keep their closed forms.  The output
//   layout is a 16-lane prefix sum of the band table's advances.  A voice's
//   targets are distinct, so the accumulates need no order.
// - Type-1 body: lane b < 18 holds band b's width, scale and bit offset
//   and hands them over by shuffles; the pair table sits in shared memory
//   as 1,024 words of two entries, one load an input.
// The session instance: lanes 0..C-1 hold the frame's rows, mixes and
// bank kinds; each voice's bank words load while the voice before it
// folds; lane l's 8 words stay in registers over the voices and go to the
// frame buffer once (the fold's formulas: decode93_bank.cuh and the "session
// bank" section below).
// Both:
// - Transform in registers: 8 complex values a lane, held mod 2^16 without
//   reduction (only multiplied values are sign-extended).  Plane index e =
//   b7..b0; the stages run on bits 6..0 in order and never mix bit 7.  Step
//   A holds b6 b5 b4 locally (lane = b7 b3 b2 b1 b0) and runs three stages,
//   step B holds b3 b2 b1 (lane = b7 b6 b5 b4 b0) and runs three, step C
//   holds b2 b1 b0 (lane = b7..b3) and runs the last.  Step A's values come
//   straight from the frame buffer (two 8-byte loads each, the expansion's
//   sums and differences in registers).  Between steps the values go
//   through a re | im exchange buffer under __syncwarp(); pos() permutes
//   each index so that every exchange of the three layouts hits 32 distinct
//   banks, and is linear, so a lane's 8 addresses are one base XOR 8
//   constants.  The slot-0 square root is computed by every lane (uniform),
//   its 31-step normalize loop in closed form through __clz, which a test
//   on the card holds against the loop on all 2^32 inputs
//   (dcs_normalize93_check).
// - Collection: the output map br93_half is the 8-bit bit reversal, so
//   after step C lane l's value k is output 32 * rev3(k) + rev5(l): each
//   of the 8 stores a lane makes is one contiguous 128-byte row segment of
//   the warp.  Head and tail words go to shared memory.
// - Overlap: after one __syncthreads() a tile, 4 threads a frame blend the
//   heads with the previous frame's tails (zero at a stream start, or the
//   carried state) and write them as 16-byte words.  The tail of the frame
//   before the tile comes from the halo frame, which the block decodes and
//   transforms again when it lies in the same stream: at most 1/63 extra
//   work.
// - Carried state (the session path; overlap_resolve93): with overlap0
//   [G, 16], a run's first frame blends with overlap0[sid] instead of
//   zeros, and the last frame of each run writes its tail to last_ov[sid].
//   The carry is a template argument of the session instance.
//
// Semantics kept exactly (and tested against the plain version): sign
// extension (raw - ((raw >> (w-1)) << w)); the chains mod 2^16; the repeat
// anomaly's closed form; the scale/mix accumulate and the Type-1 rounding
// (tie rule on the doubled product) in uint32, with no signed overflow;
// clamped shifts; bytes past the pool read as $FF; bands without data read
// no bit; the floor halving of the even exponent and the AR == 0 bypass;
// the collisions re[192] = yr - xr and im[64] = yi - xi; the MAC tie rule
// on the second product; volume shifts clamp to 31; the blend in uint32;
// the carried words are the plain tail, not the blended output; a kind,
// width, row, stream or group id out of range traps (a bank kind above
// BANK_93R too).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcs_fixmath.cuh"
#include "decode93_bank.cuh"      // the columns, their fields, the bank

namespace {

using namespace dcs93;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 63;               // frames per block (kernels.py's
                                        // DECODE93_PCM_TILE): with the halo,
                                        // 8 frames a warp
constexpr int kPcmWords = 240;
constexpr int kPairLen = 2048;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kThreads >= 4 * kTile, "the blend takes 4 threads a frame");
static_assert((kTile + 1) % kWarps == 0, "every warp takes as many slots");

struct Tables {
    int2 cs[128];                       // {s16(cos[g]), s16(sin[g])}
    int4 cn[4], co[4];                  // ovl_new, ovl_old
    int mant[4];
    uint32_t pair2[kPairLen / 2];       // pair[2i] | pair[2i + 1] << 16
    unsigned short in_map[128];         // Type-1 input j: band | index << 8
};

struct Shared {
    // per warp: two exchange buffers of re[256] | im[256]; the first
    // starts as the frame buffer (words 0..255)
    int buf[kWarps][2][512];
    int heads[kTile][16];               // unblended head words
    int tails[kTile + 1][16];           // [0]: the halo frame's
    Tables tb;
};

// ---------------------------------------------------------------- decode

// a frame's controls: lane v < C holds voice v's
struct Ctl {
    int r, m, kind, fw, rs;
};

__device__ __forceinline__ Ctl load_ctl(const Cols &c,
                                        const int *__restrict__ rows,
                                        const int *__restrict__ mix, int f,
                                        int n_ch, int n_rows, int lane) {
    Ctl t{0, 0, ROW_SILENT, 0, 0};
    if (lane < n_ch) {
        const size_t at = (size_t)f * n_ch + lane;
        t.r = rows != nullptr ? rows[at] : f;
        if ((unsigned)t.r >= (unsigned)n_rows) __trap();
        t.m = mix[at] & dcs::kM16;
        t.kind = c.kind[t.r];
        if (t.kind > ROW_93A) __trap();
        t.fw = c.frame_word[t.r];
        t.rs = c.sid[t.r];
        if (t.kind == ROW_93 && (unsigned)t.rs >= (unsigned)c.n_streams)
            __trap();
    }
    return t;
}

// one voice's columns, loaded ahead of its body (its mix and frame word
// stay in the frame's controls)
struct Voice {
    int kind, kw, bit_rel, prv, code;
    int4 t0;                            // band_tab row of band lane & 15:
    int2 t1;                            // scale, n, inc, pre; fix, skip
};

// voice v's columns from the frame's controls; every lane calls this
__device__ __forceinline__ Voice load_voice(const Cols &c, const Ctl &t,
                                            int v, int lane) {
    Voice h;
    const int vr = __shfl_sync(kFull, t.r, v);
    h.kind = __shfl_sync(kFull, t.kind, v);
    const int vrs = __shfl_sync(kFull, t.rs, v);
    h.kw = h.bit_rel = h.prv = h.code = 0;
    h.t0 = make_int4(0, 0, 0, 0);
    h.t1 = make_int2(0, 0);
    if (h.kind == ROW_93) {
        const int b = lane & 15;
        h.kw = c.kw[(size_t)vr * kCols + b];
        h.bit_rel = c.bit_rel[(size_t)vr * kCols + b];
        h.prv = c.prv[(size_t)vr * 16 + b];
        const int *tab = c.band_tab + 8 * (vrs * 16 + b);
        h.t0 = __ldg(reinterpret_cast<const int4 *>(tab));
        h.t1 = __ldg(reinterpret_cast<const int2 *>(tab + 4));
    } else if (h.kind == ROW_93A && lane < kBands93a) {
        h.kw = c.kw[(size_t)vr * kCols + lane];
        h.bit_rel = c.bit_rel[(size_t)vr * kCols + lane];
        h.code = c.code[(size_t)vr * kCols + lane];
    }
    return h;
}

// the samples 8h' .. of one 93 band that a lane decodes, K of them from
// K * h (h = the lane's segment of the band; a band's 16 / K segments sit
// in lanes 32 * K / 16 apart), as deltas into the voice's partial (256
// halfwords at part).  kw (kind << 5 | width), sc, n, inc, ostart (its
// first sample's word), bit_rel and prv are the band's; kw 0 for a lane
// without a band
template <int K>
__device__ __forceinline__ void cells93(const Cols &c, unsigned short *part,
                                        int fw, int m, int kw, int sc, int n,
                                        int inc, int ostart, int bit_rel,
                                        int prv, int h) {
    constexpr int G = 16 / K;                  // segments (lanes) a band
    constexpr int S = 32 / G;                  // lanes between them
    const int kind = kw >> 5, w = kw & 31;
    const int i0 = K * h;
    const int t0 = ostart + i0 * inc;          // sample i0's word
    const uint32_t p_in = (uint32_t)prv & 0xFFFFu;
    const uint32_t p_dl = (uint32_t)prv >> 16;
    const bool data = kind >= K_DATA0 && kind <= K_DATA2;
    const int w1 = max(w, 1);
    const int kn = min(max(n - i0, 0), K);     // the lane's live samples

    // every field of the lane's samples first: independent loads, checked
    // against the pool's end once for all of them unless they cross it
    const int rel0 = bit_rel + i0 * w;
    const bool fast = (unsigned)(fw + ((rel0 + (K - 1) * w) >> 5) + 1) <
                      (unsigned)c.n_words;
    uint32_t samp[K];
    // the common case's loads in one block, the rare one (words past the
    // pool's whole words) out of its way
    if (__builtin_expect(fast, 1)) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const uint32_t raw =
                data && k < kn ? field<true>(c, fw, rel0 + k * w, w1) : 0u;
            samp[k] = raw - ((raw >> (w1 - 1)) << w1);
        }
    } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const uint32_t raw =
                data && k < kn ? field(c, fw, rel0 + k * w, w1) : 0u;
            samp[k] = raw - ((raw >> (w1 - 1)) << w1);
        }
    }
    // the Sigma and Sigma-Sigma sums entering sample i0: an exclusive scan
    // over the band's segments of (sum of samples, sum of running sums),
    // where (P1, P2) then (A1, A2) over n cells combine to
    // (P1 + A1, P2 + A2 + n * P1)
    uint32_t own1 = 0, own2 = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        own1 += samp[k];
        own2 += own1;
    }
    uint32_t a1 = own1, a2 = own2;
#pragma unroll
    for (int st = 1; st < G; st <<= 1) {
        const uint32_t q1 = __shfl_up_sync(kFull, a1, st * S);
        const uint32_t q2 = __shfl_up_sync(kFull, a2, st * S);
        if (h >= st) {
            a2 += q2 + (uint32_t)(st * K) * q1;
            a1 += q1;
        }
    }
    const uint32_t e1 = a1 - own1;
    const uint32_t e2 = a2 - own2 - (uint32_t)K * e1;
    const uint32_t in1 = p_in + e1;                            // K_DATA1
    const uint32_t dl2 = p_dl + e1;                            // K_DATA2
    const uint32_t in2 = p_in + (uint32_t)i0 * p_dl + e2;

    // the repeat anomaly: the product's low word enters sample i as
    // (l0 + i * m_low) mod 2^16
    const int l0 = (dcs::s16((int)p_in) * sc) & dcs::kM16;
    const int pl = sx16(l0);
    const int m_low = (pl * m) & dcs::kM16;

    // a voice's targets are distinct.  The delta is (lo + X) >> 16 for the
    // write ((old << 16 | lo) + X) >> 16
    const int kw_live = kind != K_NONE ? kn : 0;
    a1 = a2 = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = i0 + k, tgt = t0 + k * inc;
        a1 += samp[k];
        a2 += a1;
        if (k >= kw_live || (unsigned)tgt >= (unsigned)kFbWords) continue;
        int lo, x;                      // the low word and the mix product
        if (kind == K_REPEAT) {
            lo = (l0 + i * m_low) & dcs::kM16;
            x = pl * m;
        } else {
            const uint32_t val =
                kind == K_DATA0   ? samp[k]
                : kind == K_DATA1 ? in1 + a1
                : kind == K_DATA2 ? in2 + (uint32_t)(k + 1) * dl2 + a2
                                  : p_in + (uint32_t)(i + 1) * p_dl;
            lo = (sx16((int)val) * sc) & dcs::kM16;
            x = sx16(lo) * m;
        }
        part[tgt] = (unsigned short)((lo + x) >> 16);
    }
}

// one voice of the 93 band decode into its partial (256 halfwords at part;
// fold93 adds it and applies the fix-up).  With at most 8 bands that carry
// samples (most frames of the real streams), 4 lanes take each of them
// (lane l: the (l & 7)-th such band, samples 4h..4h+3, h = l >> 3);
// otherwise lane l takes band l & 15, samples 8h..8h+7, h = l >> 4.
// scratch: 8 words of the warp's shared memory
__device__ __forceinline__ void voice93(const Cols &c, unsigned short *part,
                                        int *scratch, const Voice &v, int m,
                                        int fw, int lane) {
    // band lane & 15's layout (lanes 16..31 repeat lanes 0..15)
    const int kind = v.kw >> 5, w = v.kw & 31;
    if (kind > K_RAMP || w > kMaxWidth93) __trap();
    const int sc = v.t0.x & dcs::kM16, n = v.t0.y, inc = v.t0.z;
    const int pre = v.t0.w;
    const int adv = pre + (kind == K_NONE ? v.t1.y : n * inc + v.t1.x);
    // out_start = 1 + (the advances of the bands before) + pre
    int incl = adv;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d, 16);
        if ((lane & 15) >= d) incl += o;
    }
    const int ostart = 1 + incl - adv + pre;
    const unsigned live = __ballot_sync(kFull, lane < 16 && kind != K_NONE);
    const int n_live = __popc(live);

    if (n_live <= 8) {
        // the live bands in order: band b is the popc(live below b)-th
        if (lane < 16 && (live >> lane & 1))
            scratch[__popc(live & ((1u << lane) - 1))] = lane;
        __syncwarp();
        const int slot = lane & 7;
        const bool on = slot < n_live;
        const int b = on ? scratch[slot] : 0;
        const int kw_sc = __shfl_sync(kFull, sc | v.kw << 16, b);
        const int bn = __shfl_sync(kFull, n, b);
        const int binc = __shfl_sync(kFull, inc, b);
        const int bstart = __shfl_sync(kFull, ostart, b);
        const int brel = __shfl_sync(kFull, v.bit_rel, b);
        const int bprv = __shfl_sync(kFull, v.prv, b);
        cells93<4>(c, part, fw, m, on ? kw_sc >> 16 : 0, kw_sc & dcs::kM16,
                   bn, binc, bstart, brel, bprv, lane >> 3);
    } else {
        __syncwarp();
        cells93<8>(c, part, fw, m, v.kw, sc, n, inc, ostart, v.bit_rel,
                   v.prv, lane >> 4);
    }
    __syncwarp();
}

// ----------------------------------------------------------------- folds
// Lane l alone reads and writes words 4l..4l+3 and 128+4l..128+4l+3 of the
// frame buffer during the decode (each in the low 16 bits of its int: the
// bits above are never read), so the voices need no fence between them.  A
// voice's body writes its partial, and the partial folds into those words
// in channel order.

// lane l's words of the frame buffer, and back
__device__ __forceinline__ void own_load(const int *fb, int lane,
                                         int (&w)[8]) {
    const int4 a = reinterpret_cast<const int4 *>(fb)[lane];
    const int4 b = reinterpret_cast<const int4 *>(fb)[32 + lane];
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
}

__device__ __forceinline__ void own_store(int *fb, int lane,
                                          const int (&w)[8]) {
    reinterpret_cast<int4 *>(fb)[lane] = make_int4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<int4 *>(fb)[32 + lane] =
        make_int4(w[4], w[5], w[6], w[7]);
}

// fold a 93 voice's partial (256 halfwords at part: zero where the voice
// wrote nothing, its targets are >= 1) into the lane's words, and clear the
// lane's halfwords of it for the next voice.  Word 1 keeps its value; lane 0
// applies the first-sample fix-up to word 0 (reference :2608-2611):
// w0 <- sat16(sat16(sx16(w1 + d1) - sx16(w1)) + sx16(w0))
__device__ __forceinline__ void fold93(int *fb, int *part, int lane) {
    int w[8];
    own_load(fb, lane, w);
    uint2 *p2 = reinterpret_cast<uint2 *>(part);
    const uint2 a = p2[lane], b = p2[32 + lane];
    p2[lane] = p2[32 + lane] = make_uint2(0u, 0u);
    const int d1 = (int)(a.x >> 16);
    const int delta = dcs::sat16(sx16(w[1] + d1) - sx16(w[1]));
    const int fix = dcs::sat16(sx16(delta) + sx16(w[0]));
    w[0] = lane == 0 ? fix : w[0] + (int)a.x;
    w[1] += lane == 0 ? 0 : d1;
    w[2] += (int)a.y;
    w[3] += (int)(a.y >> 16);
    w[4] += (int)b.x;
    w[5] += (int)(b.x >> 16);
    w[6] += (int)b.y;
    w[7] += (int)(b.y >> 16);
    own_store(fb, lane, w);
}

// one voice of the OS93a Type-1 decode folded straight into the lane's
// words: lane l takes inputs 2l, 2l+1, 64+2l and 65+2l of the frame's 127
// (input j writes words 2j and 2j+1), so its partial never leaves the
// lane.  The write round((old << 16) + prod) with the MAC's tie rule is
// old + ((prod + $8000) >> 16) with bit 0 cleared where prod's low half is
// $8000
__device__ __forceinline__ void voice93a(const Cols &c, const Tables &tb,
                                         int *fb, const Voice &v, int m,
                                         int fw, int lane) {
    // lane b < 18 holds band b
    int wb = 0, eff = 0;
    if (lane < kBands93a) {
        wb = v.kw;
        if (wb > kMaxWidth93a) __trap();
        const int code = v.code;
        const uint32_t scale32 =
            code == 0xFF ? 0u
                         : (uint32_t)tb.mant[code & 3] << min(code >> 2, 14);
        eff = sx16((int)(((scale32 >> 16) * (uint32_t)m) >> 15));
    }
    const uint32_t *map2 = reinterpret_cast<const uint32_t *>(tb.in_map);
    const uint32_t jm2[2] = {map2[lane], map2[32 + lane]};
    uint32_t raw[4];
    int bw[4], beff[4], rel[4];
    int top = 0;                        // the lane's last field's offset
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int jm = (int)(t & 1 ? jm2[t >> 1] >> 16
                                   : jm2[t >> 1] & 0xFFFFu);  // $FFFF: none
        const int b = jm & 0xFF;
        bw[t] = __shfl_sync(kFull, wb, b & 31);
        beff[t] = __shfl_sync(kFull, eff, b & 31);
        rel[t] = __shfl_sync(kFull, v.bit_rel, b & 31) + (jm >> 8) * bw[t];
        if (b >= kBands93a) bw[t] = 0;
        if (bw[t] != 0) top = max(top, rel[t]);
    }
    // the fields' words checked against the pool's end once; the common
    // case's loads in one block, the rare one out of its way
    const bool fast = (unsigned)(fw + (top >> 5) + 1) < (unsigned)c.n_words;
    if (__builtin_expect(fast, 1)) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
            raw[t] = bw[t] != 0 ? field<true>(c, fw, rel[t], bw[t]) : 0u;
    } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
            raw[t] = bw[t] != 0 ? field(c, fw, rel[t], bw[t]) : 0u;
    }
    int w[8];
    own_load(fb, lane, w);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        if (bw[t] == 0) continue;
        const uint32_t pv = tb.pair2[(1 << bw[t]) + raw[t]];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            // p8 = prod + $8000: a tie leaves its low half 0
            const int pk = k ? (int)pv >> 16 : sx16((int)pv);
            const uint32_t p8 =
                (uint32_t)pk * (uint32_t)(2 * beff[t]) + 0x8000u;
            int &x = w[2 * t + k];
            x += (int)(p8 >> 16);
            if ((p8 & 0xFFFFu) == 0u) x &= ~1;
        }
    }
    own_store(fb, lane, w);
}

// ------------------------------------------------------ the session bank
// The session instance (rows given) folds each voice from its row of the
// session bank (decode93_bank.cuh), built once per ROM by decode93_bank.cu:
// lane l loads its 8 words' bank halfwords, and the row's side word l where
// its kind needs it, a voice ahead; mixes them with m into deltas; and folds
// the deltas into its words, which stay in registers from the first voice
// to the last.  No partial goes through shared memory.

// a frame's controls: lane v < C holds voice v's row, mix and bank kind
__device__ __forceinline__ Ctl load_ctl_bank(const uint8_t *__restrict__ kind93,
                                             const int *__restrict__ rows,
                                             const int *__restrict__ mix,
                                             int f, int n_ch, int n_rows,
                                             int lane) {
    Ctl t{0, 0, BANK_SILENT, 0, 0};
    if (lane < n_ch) {
        const size_t at = (size_t)f * n_ch + lane;
        t.r = rows[at];
        if ((unsigned)t.r >= (unsigned)n_rows) __trap();
        t.m = mix[at] & dcs::kM16;
        t.kind = kind93[t.r];
        if (t.kind > BANK_93R) __trap();
    }
    return t;
}

// one voice's bank words, as lane l holds them
struct BankVoice {
    int kind, m;
    uint2 a, b;                         // words 4l..4l+3, 128+4l..128+4l+3
    uint32_t side;                      // side word l (BANK_93R, BANK_93A)
};

// voice v's bank words from the frame's controls; every lane calls this
__device__ __forceinline__ BankVoice load_bank_voice(
        const int *__restrict__ words, const Ctl &t, int v, int lane) {
    BankVoice h;
    const int vr = __shfl_sync(kFull, t.r, v);
    h.kind = __shfl_sync(kFull, t.kind, v);
    h.m = __shfl_sync(kFull, t.m, v);
    h.a = h.b = make_uint2(0u, 0u);
    h.side = 0u;
    const int *row = words + (size_t)vr * kBankWords;
    if (h.kind != BANK_SILENT) {
        const uint2 *row2 = reinterpret_cast<const uint2 *>(row);
        h.a = __ldg(row2 + lane);
        h.b = __ldg(row2 + 32 + lane);
    }
    if (h.kind == BANK_93R || h.kind == BANK_93A)
        h.side = (uint32_t)__ldg(row + kBankSide + lane);
    return h;
}

// a 93 voice folded into the lane's words: word k's delta is (lo' + P) >>
// 16 with P = sx16(lo) * m (kRep: lo' = lo + i * P's low half, i the word's
// repeat index; else lo' = lo); then lane 0 applies the first-sample fix-up
// to word 0 and word 1 keeps its value (reference :2608-2611):
// w0 <- sat16(sat16(sx16(w1 + d1) - sx16(w1)) + sx16(w0))
template <bool kRep>
__device__ __forceinline__ void fold93_bank(int (&w)[8], const BankVoice &v,
                                            int lane) {
    const uint32_t h[4] = {v.a.x, v.a.y, v.b.x, v.b.y};
    int d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint32_t two = h[k >> 1];
        int lo = (int)(k & 1 ? two >> 16 : two & 0xFFFFu);
        const int p = (k & 1 ? (int)two >> 16 : sx16((int)two)) * v.m;
        if (kRep)
            lo = (lo + (int)(v.side >> 4 * k & 15u) * (p & dcs::kM16)) &
                 dcs::kM16;
        d[k] = (lo + p) >> 16;
    }
    const int delta = dcs::sat16(sx16(w[1] + d[1]) - sx16(w[1]));
    const int fix = dcs::sat16(sx16(delta) + sx16(w[0]));
    w[0] = lane == 0 ? fix : w[0] + d[0];
    w[1] += lane == 0 ? 0 : d[1];
#pragma unroll
    for (int k = 2; k < 8; ++k) w[k] += d[k];
}

// a Type-1 voice folded into the lane's words: lane b < 18 computes band
// b's eff from its scale (side word b) and m, and each of the lane's four
// inputs takes its band's by a shuffle (bands: their bands, a byte each).
// Word k's write is w + (p8 >> 16) with p8 = pk * 2 * eff + $8000 mod 2^32,
// and bit 0 of w cleared where p8's low half is 0 (the MAC's tie rule)
__device__ __forceinline__ void fold93a_bank(int (&w)[8], const BankVoice &v,
                                             uint32_t bands) {
    const int eff = sx16((int)((v.side * (uint32_t)v.m) >> 15));
    const uint32_t h[4] = {v.a.x, v.a.y, v.b.x, v.b.y};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int beff = __shfl_sync(kFull, eff, (int)(bands >> 8 * t) & 31);
        const uint32_t b2 = (uint32_t)(2 * beff);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int pk = k ? (int)h[t] >> 16 : sx16((int)h[t]);
            const uint32_t p8 = (uint32_t)pk * b2 + 0x8000u;
            int &x = w[2 * t + k];
            x += (int)(p8 >> 16);
            if ((p8 & 0xFFFFu) == 0u) x &= ~1;
        }
    }
}

// ------------------------------------------------------------- transform

// MR1 of round((s16(a) * s16(b)) << 1) with the MAC's tie rule; the whole
// rounded accumulator in *res
__device__ __forceinline__ int mul_round93(int a, int b, uint32_t *res) {
    const uint32_t prod = (uint32_t)(dcs::s16(a) * dcs::s16(b)) << 1;
    uint32_t r = prod + 0x8000u;
    if ((prod & 0xFFFFu) == 0x8000u) r &= ~0x10000u;
    *res = r;
    return (int)(r >> 16);
}

// normalize32's shift count, as the reference walks it: 31 steps, each
// shifting while bit 30 equals bit 31 (and, for a non-negative value, while
// fewer than 31 shifts were made)
__device__ __forceinline__ int normalize93_loop(uint32_t v) {
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
    return -ex;
}

// the same count in closed form: the run of bits equal to bit 31 below it
// (31 for 0 and for $FFFFFFFF); dcs_normalize93_check holds it against the
// loop on every input
__device__ __forceinline__ int normalize93(uint32_t v) {
    return __clz((int)(v ^ (uint32_t)((int)v >> 31))) - 1;
}

// the slot-0 magnitude fix-up (reference :633-704), u16 storage
__device__ __forceinline__ int taylor_sqrt93(int fb0, int fb1) {
    int ar = dcs::s16(fb0);
    const bool neg = ar < 0;
    ar = (neg ? -ar : ar) & dcs::kM16;
    const uint32_t v = ((uint32_t)(dcs::s16(fb1) * dcs::s16(fb1)) +
                        (uint32_t)(dcs::s16(ar) * dcs::s16(ar))) << 1;
    const int nsh = normalize93(v);         // 0..31
    int ex = -nsh;
    const uint32_t mant = v << nsh;
    const int ar2 = (int)(mant >> 16);
    if (ar2 == 0) return 0;                 // AR == 0 skips the series

    // 5-term Taylor series in the accumulator
    uint32_t mr = 0x0D490000u + ((uint32_t)(0x5D1D * dcs::s16(ar2)) << 1);
    uint32_t unused;
    int mf = ar2;
    const int coef[4] = {-22035, 0x46D6, -8790, 0x072D};
#pragma unroll
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

// s16 of bits 16..31 of (acc << 1) + $8000 with the tie rule on p_b, the
// second product (dcs::mac_round, one shift shorter)
__device__ __forceinline__ int mac_round_s(uint32_t acc, uint32_t p_b) {
    uint32_t mr = (acc << 1) + 0x8000u;
    if (((p_b << 1) & 0xFFFFu) == 0x8000u) mr &= ~0x10000u;
    return (int)mr >> 16;
}

// one butterfly: t = round(b * (cos + i sin)), a <- a - t, b <- a + t,
// wrapping mod 2^16.  The values are held mod 2^16 and not reduced: only
// the multiplied ones are sign-extended (each stage adds less than 2^15 in
// magnitude, so seven stages stay far from overflow)
__device__ __forceinline__ void bf93(int &ar, int &ai, int &br, int &bi,
                                     int2 w) {
    const int xr = sx16(br), xi = sx16(bi);
    const uint32_t pb = (uint32_t)(xi * w.y);
    const int tr = mac_round_s((uint32_t)(xr * w.x) - pb, pb);
    const uint32_t pb2 = (uint32_t)(xr * w.y);
    const int ti = mac_round_s((uint32_t)(xi * w.x) + pb2, pb2);
    br = ar + tr;
    bi = ai + ti;
    ar -= tr;
    ai -= ti;
}

// plane index e (0..255) -> its word in a 256-word exchange plane: bits
// 0..3 are b0^b3, b1^b4, b2^b5, b3^b6, bit 4 is b7, bits 5..7 are b4..b6, so
// that each of the three layouts' exchanges hits 32 distinct banks.  It is
// linear over GF(2): pos(a ^ b) = pos(a) ^ pos(b)
__host__ __device__ constexpr int pos(int e) {
    return ((e ^ (e >> 3)) & 15) | ((e >> 7) << 4) | (((e >> 4) & 7) << 5);
}

// In each step value k of a lane has plane index base + S * k, where base
// and S * k share no bit: so base + S * k = base ^ S * k, its exchange word
// is pos(base) ^ pos(S * k) (a constant per k), and its group at any stage
// bit P is (base >> (P + 1)) + (S * k >> (P + 1)).

// the radix-2 stage on plane index bit P, which is bit J of k
template <int P, int J, int S>
__device__ __forceinline__ void stage(int (&r)[8], int (&m)[8], int base,
                                      const int2 *cs) {
    const int2 *g = cs + (base >> (P + 1));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if (k & (1 << J)) continue;
        bf93(r[k], m[k], r[k | (1 << J)], m[k | (1 << J)],
             g[(S * k) >> (P + 1)]);
    }
}

template <int S>
__device__ __forceinline__ void put(int *buf, const int (&r)[8],
                                    const int (&m)[8], int pb) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        buf[pb ^ pos(S * k)] = r[k];
        buf[256 + (pb ^ pos(S * k))] = m[k];
    }
}

template <int S>
__device__ __forceinline__ void get(const int *buf, int (&r)[8], int (&m)[8],
                                    int pb) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        r[k] = buf[pb ^ pos(S * k)];
        m[k] = buf[256 + (pb ^ pos(S * k))];
    }
}

// kBank: the session instance (rows given), folding each voice from the
// session bank (words, kind93); else the columns' instance, decoding each
// voice's bitstream
template <bool kCarry, bool kBank>
__global__ void __launch_bounds__(kThreads, 4)
decode93_pcm_kernel(Cols c, const int *__restrict__ rows,
                    const int *__restrict__ mix, const int *__restrict__ vol,
                    const int *__restrict__ fsid, const int *__restrict__ pair,
                    const int *__restrict__ inputs,
                    const int *__restrict__ cos_tab,
                    const int *__restrict__ sin_tab,
                    const int *__restrict__ ovl_new,
                    const int *__restrict__ ovl_old,
                    const int *__restrict__ overlap0,
                    int *__restrict__ last_ov, int n_groups,
                    int *__restrict__ pcm, int n_frames, int n_ch,
                    int n_rows, const int *__restrict__ words,
                    const uint8_t *__restrict__ kind93) {
    __shared__ __align__(16) Shared sh;
    Tables &tb = sh.tb;
    // the pair table only where the bitstream is decoded
    for (int i = threadIdx.x; i < (kBank ? 128 : kPairLen); i += kThreads) {
        if (!kBank && i < kPairLen / 2)
            tb.pair2[i] = ((uint32_t)__ldg(pair + 2 * i) & 0xFFFFu) |
                          (uint32_t)__ldg(pair + 2 * i + 1) << 16;
        if (i < 128)
            tb.cs[i] = make_int2(sx16(cos_tab[i]), sx16(sin_tab[i]));
        if (i < 16) {
            reinterpret_cast<int *>(tb.cn)[i] = ovl_new[i];
            reinterpret_cast<int *>(tb.co)[i] = ovl_old[i];
        }
    }
    if (threadIdx.x == 0) {
        tb.mant[0] = 0x8000;
        tb.mant[1] = 0x9838;
        tb.mant[2] = 0xB505;
        tb.mant[3] = 0xD745;
        int j = 0;
        for (int b = 0; b < kBands93a; ++b)
            for (int i = 0; i < __ldg(inputs + b); ++i, ++j) {
                if (j >= kInputs93a) __trap();
                tb.in_map[j] = (unsigned short)(b | i << 8);
            }
        if (j != kInputs93a) __trap();
        tb.in_map[kInputs93a] = 0xFFFF;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // the session instance: the bands of the lane's four Type-1 inputs
    // (2l, 2l+1, 64+2l, 65+2l; input 127, which no band has, takes lane
    // 31's eff, which is 0), a byte each
    uint32_t bands = 0;
    if (kBank) {
        const uint32_t *map2 = reinterpret_cast<const uint32_t *>(tb.in_map);
        const uint32_t jm2[2] = {map2[lane], map2[32 + lane]};
#pragma unroll
        for (int t = 0; t < 4; ++t)
            bands |= (jm2[t >> 1] >> 16 * (t & 1) & 31u) << 8 * t;
    }
    const int f0 = blockIdx.x * kTile;
    const bool halo = f0 > 0 && fsid[f0 - 1] == fsid[f0];
    int *fb = sh.buf[warp][0];
    int *xb = sh.buf[warp][1];

    // slot s holds frame f0 + s - 1; slot 0 is the halo.  Once a slot is
    // past the frames, every later one is too
    int s = warp;
    if (s == 0 && !halo) s += kWarps;
    Ctl ctl{0, 0, ROW_SILENT, 0, 0};
    Voice nxt{};
    BankVoice nxt_bank{};
    if (s <= kTile && f0 + s - 1 < n_frames) {
        if (kBank) {
            ctl = load_ctl_bank(kind93, rows, mix, f0 + s - 1, n_ch, n_rows,
                                lane);
            nxt_bank = load_bank_voice(words, ctl, 0, lane);
        } else {
            ctl = load_ctl(c, rows, mix, f0 + s - 1, n_ch, n_rows, lane);
            nxt = load_voice(c, ctl, 0, lane);
        }
    }
    for (; s <= kTile && f0 + s - 1 < n_frames; s += kWarps) {
        const int f = f0 + s - 1;
        const bool more = s + kWarps <= kTile && f + kWarps < n_frames;

        if (kBank) {
            // decode: the voices in channel order, each one's bank words
            // loaded during the one before, folded into the lane's words
            int w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            for (int v = 0; v < n_ch; ++v) {
                const BankVoice cur = nxt_bank;
                if (v + 1 < n_ch)
                    nxt_bank = load_bank_voice(words, ctl, v + 1, lane);
                if (cur.kind == BANK_93)
                    fold93_bank<false>(w, cur, lane);
                else if (cur.kind == BANK_93R)
                    fold93_bank<true>(w, cur, lane);
                else if (cur.kind == BANK_93A)
                    fold93a_bank(w, cur, bands);
            }
            own_store(fb, lane, w);
        } else {
            // decode: the voices in channel order, each one's columns
            // loaded during the one before.  The lane's words of the frame
            // buffer; in xb a 93 voice's partial (zero but where the voice
            // writes: words 0..127) and its band list (128..135)
            reinterpret_cast<int4 *>(fb)[lane] = make_int4(0, 0, 0, 0);
            reinterpret_cast<int4 *>(fb)[32 + lane] = make_int4(0, 0, 0, 0);
            reinterpret_cast<int4 *>(xb)[lane] = make_int4(0, 0, 0, 0);
            for (int v = 0; v < n_ch; ++v) {
                const Voice cur = nxt;
                if (v + 1 < n_ch) nxt = load_voice(c, ctl, v + 1, lane);
                const int m = __shfl_sync(kFull, ctl.m, v);
                const int fw = __shfl_sync(kFull, ctl.fw, v);
                if (cur.kind == ROW_93) {
                    voice93(c, reinterpret_cast<unsigned short *>(xb),
                            xb + 128, cur, m, fw, lane);
                    fold93(fb, xb, lane);
                } else if (cur.kind == ROW_93A) {
                    voice93a(c, tb, fb, cur, m, fw, lane);
                }
            }
        }
        __syncwarp();
        // the next frame's controls load during this frame's transform
        if (more)
            ctl = kBank ? load_ctl_bank(kind93, rows, mix, f + kWarps, n_ch,
                                        n_rows, lane)
                        : load_ctl(c, rows, mix, f + kWarps, n_ch, n_rows,
                                   lane);

        // transform step A: lane = b7 b3 b2 b1 b0, value k = b6 b5 b4.
        // Plane entry e' = 16k + q of half b7 comes from pair i of
        // x = (fb[2+2i], fb[3+2i]) and y = (fb[254-2i], fb[255-2i]):
        // re = x + y and im = +/-(x - y) in half 0, re = +/-(x - y) and
        // im = x + y in half 1, the sign flipping at e' = 64 (the later of
        // the two colliding writes); e' = 0 is the slot-0 fix-up
        const int ar = taylor_sqrt93(fb[0], fb[1]);
        const int b7 = lane >> 4, q = lane & 15;
        int re[8], im[8];
        {
            const int2 *fb2 = reinterpret_cast<const int2 *>(fb);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const bool hi = k >= 4;
                const int i = hi ? 127 - 16 * k - q : max(16 * k + q - 1, 0);
                const int2 x = fb2[1 + i], y = fb2[127 - i];
                const int xr = sx16(x.x), xi = sx16(x.y);
                const int yr = sx16(y.x), yi = sx16(y.y);
                const int dr = hi ? yr - xr : xr - yr;
                const int di = hi ? yi - xi : xi - yi;
                re[k] = b7 ? dr : xr + yr;
                im[k] = b7 ? xi + yi : di;
            }
            if (q == 0) {
                re[0] = ar;
                im[0] = 0;
            }
        }
        const int baseA = 128 * b7 + q;
        stage<6, 2, 16>(re, im, baseA, tb.cs);
        stage<5, 1, 16>(re, im, baseA, tb.cs);
        stage<4, 0, 16>(re, im, baseA, tb.cs);
        put<16>(xb, re, im, pos(baseA));
        __syncwarp();
        // step B: lane = b7 b6 b5 b4 b0, value k = b3 b2 b1
        const int baseB = 128 * b7 + 16 * ((lane >> 1) & 7) + (lane & 1);
        get<2>(xb, re, im, pos(baseB));
        stage<3, 2, 2>(re, im, baseB, tb.cs);
        stage<2, 1, 2>(re, im, baseB, tb.cs);
        stage<1, 0, 2>(re, im, baseB, tb.cs);
        put<2>(fb, re, im, pos(baseB));
        __syncwarp();
        // step C: lane = b7..b3, value k = b2 b1 b0
        get<1>(fb, re, im, pos(8 * lane));
        stage<0, 0, 1>(re, im, 8 * lane, tb.cs);
        // the next frame's first voice loads during the stores
        if (more) {
            if (kBank)
                nxt_bank = load_bank_voice(words, ctl, 0, lane);
            else
                nxt = load_voice(c, ctl, 0, lane);
        }

        // volume shift + collection: output j = re[rev8(j)], so value k of
        // lane l is output 32 * rev3(k) + rev5(l)
        const int vs = vol[f];
        int *out = pcm + (size_t)f * kPcmWords;
        const bool last_of_run =
            kCarry && s > 0 && (f + 1 == n_frames || fsid[f + 1] != fsid[f]);
        const int rev5 = (int)(__brev((unsigned)lane) >> 27);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int rk = ((k & 1) << 2) | (k & 2) | (k >> 2);
            const int j = 32 * rk + rev5;
            const int v = dcs::volume_shift(re[k], vs);
            if (rk == 7 && j >= kPcmWords) {
                sh.tails[s][j - kPcmWords] = v;
                // the carried state out: the tail of each run's last frame
                if (last_of_run) {
                    const int g = fsid[f];
                    if ((unsigned)g >= (unsigned)n_groups) __trap();
                    last_ov[16 * g + j - kPcmWords] = v;
                }
            } else if (s > 0) {
                if (rk == 0 && j < 16)
                    sh.heads[s - 1][j] = v;
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
    if (t < kTile && f < n_frames) {
        const int g = fsid[f];
        const bool carry = f > 0 && g == fsid[f - 1];
        const int4 h = reinterpret_cast<const int4 *>(sh.heads[t])[j];
        int4 p = make_int4(0, 0, 0, 0);
        if (carry) {
            p = reinterpret_cast<const int4 *>(sh.tails[t])[j];
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

// counts the inputs where normalize93 and normalize93_loop disagree
__global__ void normalize93_check_kernel(unsigned long long *bad) {
    unsigned long long n = 0;
    const uint64_t step = (uint64_t)gridDim.x * blockDim.x;
    for (uint64_t v = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
         v < (1ull << 32); v += step)
        n += normalize93((uint32_t)v) != normalize93_loop((uint32_t)v);
    if (n) atomicAdd(bad, n);
}

// one launch of an instance
template <bool kCarry, bool kBank>
int launch(const Cols &c, const int *rows, const int *mix, const int *vol,
           const int *fsid, const int *pair, const int *inputs,
           const int *cos_tab, const int *sin_tab, const int *ovl_new,
           const int *ovl_old, const int *overlap0, int *last_ov,
           int n_groups, int *pcm, int n_frames, int n_ch, int n_rows,
           const int *words, const uint8_t *kind93, cudaStream_t stream) {
    const int blocks = (n_frames + kTile - 1) / kTile;
    decode93_pcm_kernel<kCarry, kBank><<<blocks, kThreads, 0, stream>>>(
        c, rows, mix, vol, fsid, pair, inputs, cos_tab, sin_tab, ovl_new,
        ovl_old, overlap0, last_ov, n_groups, pcm, n_frames, n_ch, n_rows,
        words, kind93);
    return (int)cudaGetLastError();
}

}  // namespace

// the columns' instance, for the flat sweep: one voice a frame, row f for
// frame f with mix[f], no carried state.  The pool is 4-byte aligned
extern "C" int dcs_decode93_pcm(
    const uint8_t *pool, long long pool_len, const int *frame_word,
    const int *sid, const uint8_t *kind, const uint8_t *kw,
    const int *bit_rel, const int *prv, const uint8_t *code,
    const int *band_tab, int n_streams, const int *pair, const int *inputs,
    const int *mix, const int *vol, const int *fsid, const int *cos_tab,
    const int *sin_tab, const int *ovl_new, const int *ovl_old, int *pcm,
    int n_frames, cudaStream_t stream) {
    const Cols c = make_cols(pool, pool_len, frame_word, sid, kind, kw,
                             bit_rel, prv, code, band_tab, n_streams);
    return launch<false, false>(c, nullptr, mix, vol, fsid, pair, inputs,
                                cos_tab, sin_tab, ovl_new, ovl_old, nullptr,
                                nullptr, 0, pcm, n_frames, 1, n_frames,
                                nullptr, nullptr, stream);
}

// the session instance: the session bank's rows (words [n_rows, 160],
// kind93 [n_rows]) for rows [n_frames, n_ch] and their mixes; overlap0
// [n_groups, 16] and last_ov both given (the carried state) or both null.
// words is 8-byte aligned
extern "C" int dcs_decode93_pcm_bank(
    const int *words, const uint8_t *kind93, int n_rows, const int *inputs,
    const int *rows, const int *mix, const int *vol, const int *fsid,
    const int *cos_tab, const int *sin_tab, const int *ovl_new,
    const int *ovl_old, const int *overlap0, int *last_ov, int n_groups,
    int *pcm, int n_frames, int n_ch, cudaStream_t stream) {
    auto go = overlap0 != nullptr ? launch<true, true> : launch<false, true>;
    return go(Cols{}, rows, mix, vol, fsid, nullptr, inputs, cos_tab,
              sin_tab, ovl_new, ovl_old, overlap0, last_ov,
              overlap0 != nullptr ? n_groups : 0, pcm, n_frames, n_ch,
              n_rows, words, kind93, stream);
}

extern "C" int dcs_normalize93_check(unsigned long long *bad,
                                     cudaStream_t stream) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    normalize93_check_kernel<<<8 * sms, 256, 0, stream>>>(bad);
    return (int)cudaGetLastError();
}
