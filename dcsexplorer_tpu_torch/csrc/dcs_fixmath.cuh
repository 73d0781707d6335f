// ADSP-2105 fixed-point numerics shared by the kernels.
//
// Device twins of dcsexplorer_tpu_torch/ops/fixmath.py (and of the JAX
// reference dcsexplorer_tpu/ops/fixmath.py).  Values use u16-in-int32
// storage.  The reference relies on int32 wrap-around, which is undefined
// for signed types in C++, so every chain that can overflow runs in
// uint32_t and only the bits the reference keeps are read back.  Shift
// counts stay in 0..31.
#pragma once

#include <stdint.h>

namespace dcs {

constexpr int kM16 = 0xFFFF;

// low 16 bits reinterpreted as signed int16
__device__ __forceinline__ int s16(int x) {
    return ((x & kM16) ^ 0x8000) - 0x8000;
}

// saturate to the int16 range; u16 storage out
__device__ __forceinline__ int sat16(int v) {
    return min(max(v, -32768), 32767) & kM16;
}

// 1.15 signed x signed multiply -> MR1 word (|product| <= 2^30)
__device__ __forceinline__ int mulss(int a, int b) {
    return ((s16(a) * s16(b)) >> 15) & kM16;
}

// s16 of bits 16..31 of (acc << 1) + $8000, where acc is a two-product
// MAC chain computed mod 2^32 and p_b its SECOND product: the convergent-
// rounding quirk clears bit 16 when the low word of (p_b << 1) is $8000.
__device__ __forceinline__ int mac_round(uint32_t acc, uint32_t p_b) {
    uint32_t mr = (acc << 1) + 0x8000u;
    if (((p_b << 1) & 0xFFFFu) == 0x8000u) mr &= ~0x10000u;
    return s16((int)(mr >> 16));
}

// complex rotate with MAC rounding:
// t_re = round(a_re*cos - a_im*sin), t_im = round(a_im*cos + a_re*sin)
__device__ __forceinline__ void rotate_round(int a_re, int a_im, int c_cos,
                                             int c_sin, int &t_re,
                                             int &t_im) {
    int are = s16(a_re), aim = s16(a_im), cc = s16(c_cos), cs = s16(c_sin);
    uint32_t pb = (uint32_t)(aim * cs);
    t_re = mac_round((uint32_t)(are * cc) - pb, pb);
    uint32_t pb2 = (uint32_t)(are * cs);
    t_im = mac_round((uint32_t)(aim * cc) + pb2, pb2);
}

// scale-and-mix accumulate of one frame-buffer word: bits 16..31 of
// ((s16(old) << 16) | scaled) + s16(scaled) * u16(mix), mod 2^32
__device__ __forceinline__ int accum_word(int old, int scaled, int mix) {
    uint32_t prod = ((uint32_t)s16(old) << 16) | (uint32_t)scaled;
    prod += (uint32_t)(s16(scaled) * (mix & kM16));
    return (int)(prod >> 16);
}

// overlap-add blend round(new * c_new + old * c_old): bits 16..31 of
// (s16(new) * u16(c_new) << 1) + (s16(old) * u16(c_old) << 1) + $8000, mod
// 2^32 (each doubled product can reach 2^32)
__device__ __forceinline__ int overlap_mix(int nv, int ov, int c_new,
                                           int c_old) {
    const uint32_t a = (uint32_t)(s16(nv) * (c_new & kM16)) << 1;
    const uint32_t b = (uint32_t)(s16(ov) * (c_old & kM16)) << 1;
    return (int)(((a + b + 0x8000u) >> 16) & kM16);
}

// volume normalization s16(x) >> vs; counts >= 32 fill with the sign bit
// in the reference, which a count clamped to 31 reproduces
__device__ __forceinline__ int volume_shift(int x, int vs) {
    return (s16(x) >> min(max(vs, 0), 31)) & kM16;
}

// The 1994+ inverse transform's two building blocks (transform94.cu,
// transform94_pcm.cu).

// pre-passes 1 and 2 on complex pair i (frame-buffer words 2i, 2i+1 and
// $100-2i, $101-2i; pre-pass coefficients c0, c1 of pair i): fold the ends
// through +/- sums, negate via x$8000, twiddle with rounding.  fx0, fx1 come
// out as s16, fy0, fy1 in u16 storage
__device__ __forceinline__ void fold_pair(int w_x0, int w_x1, int w_y0,
                                          int w_y1, int c0, int c1, int &fx0,
                                          int &fx1, int &fy0, int &fy1) {
    const int x0 = s16(w_x0), x1 = s16(w_x1), y0 = s16(w_y0),
              y1 = s16(w_y1);
    const int n_x0 = s16(mulss(sat16(x0 + y0), 0x8000));
    const int n_y0 = s16(mulss(sat16(x0 - y0), 0x8000));
    const int n_x1 = s16(mulss(sat16(x1 - y1), 0x8000));
    const int n_y1 = s16(mulss(sat16(x1 + y1), 0x8000));
    const int sc0 = s16(c0), sc1 = s16(c1);
    const uint32_t pb0 = (uint32_t)(n_y0 * sc0);
    const int prod0 = mac_round((uint32_t)(n_y1 * sc1) - pb0, pb0);
    const uint32_t pb1 = (uint32_t)(n_y0 * sc1);
    const int prod1 = mac_round((uint32_t)(n_y1 * sc0) + pb1, pb1);
    fx0 = s16(sat16(prod1 + n_x0));
    fx1 = s16(sat16(prod0 + n_x1));
    fy0 = sat16(n_x0 - prod1);
    fy1 = sat16(prod0 - n_x1);
}

// one radix-2 stage butterfly: u <- sat(u - t), a <- sat(u + t) with
// t = round(a * (c_cos + i c_sin)); u16 storage in and out
__device__ __forceinline__ void butterfly(int &ur, int &ui, int &ar, int &ai,
                                          int c_cos, int c_sin) {
    int tr, ti;
    rotate_round(ar, ai, c_cos, c_sin, tr, ti);
    const int u_r = s16(ur), u_i = s16(ui);
    ur = sat16(u_r - tr);
    ar = sat16(u_r + tr);
    ui = sat16(u_i - ti);
    ai = sat16(u_i + ti);
}

}  // namespace dcs
