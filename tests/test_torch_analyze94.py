"""The premises of csrc/encode94_analyze.cu, on the CPU, through a PyTorch
model of its arithmetic (the kernel itself runs only on the card:
tests/test_torch_kernels_gpu.py):

- the plane split: any int16 v = 256*(v >> 8) + (v & 255), the high byte
  an s8 and the low byte a u8, -32768 included; the kernel's byte
  permutes of two samples a word give these bytes;
- a tile of 64 frames as rows of one contiguous span of 64*240 + 16
  samples (frame f's row starts f*240 into it), zero past the row's
  frames; tiles f0 - 64 and f0 share the 16 samples at f0*240;
- the four plane products as int32 matrix products over 32-tap chunks
  (one wgmma's depth) in slabs of 96 columns, in the kernel's order: p11
  into the second accumulator, scaled by 256, then p00 into the first
  and p01 and p10 into the second, a chunk at a time; every sum stays
  inside int32, and so does the sum of the terms' magnitudes (any order
  of adding them is safe);
- the epilogue's nested shift, (acc2 + ((acc1 + 2^20) >> 8)) >> 13,
  clipped to +-2^20.

The model equals analyze94_plain and an int64 product for adversarial and
random PCM, matrices all -32768, all 32767, random and the shipped one,
at frame counts that leave partial tiles; with the shipped matrix also the
JAX package's _analyze_device (jitted on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcsexplorer_tpu.encoder import device94 as j_d94
from dcsexplorer_tpu_torch.encoder import device94 as d94
from dcsexplorer_tpu_torch.encoder import encoder as enc
from tests.test_torch_kernels_gpu import _adversarial_pcm

TILE, SLAB, HOP, WIN, COLS = 64, 96, 240, 256, 255    # the kernel's
CHUNK = 32                                            # taps a wgmma
INT32 = (-(1 << 31), (1 << 31) - 1)


def in_int32(x, what):
    """x (int64) as int32, asserting it fits."""
    assert int(x.min()) >= INT32[0] and int(x.max()) <= INT32[1], what
    return x.to(torch.int32)


def planes(v):
    """(v & 255, v >> 8) of int16 values, as int32: the u8 and s8 planes."""
    v = v.to(torch.int32)
    return v & 255, v >> 8


def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of y:x."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((s >> 4 * i) & 7))) & 255) << (8 * i)
               for i in range(4))


def span_of(row, f0, fmax):
    """Tile f0's span of one PCM row, as the kernel stages it: samples
    f0*240 .. f0*240 + 64*240 + 15, those past the tile's last frame below
    Fmax zero (never read)."""
    span = torch.zeros(TILE * HOP + WIN - HOP, dtype=torch.int16)
    live = min(TILE, fmax - f0) * HOP + WIN - HOP
    span[:live] = row[f0 * HOP:f0 * HOP + live]
    return span


def kernel_model(pcm, fq):
    """csrc/encode94_analyze.cu's arithmetic: ci int32 [B, Fmax, 255]."""
    B, L = pcm.shape
    F = (L - HOP) // HOP
    n_pad = -(-COLS // SLAB) * SLAB                  # columns past 254: 0
    a0, a1 = planes(torch.cat(
        [fq, torch.zeros((WIN, n_pad - COLS), dtype=fq.dtype)], 1))
    tiles = range(0, F, TILE)
    rows = torch.arange(TILE)[:, None] * HOP + torch.arange(WIN)
    spans = torch.stack([span_of(pcm[b], f0, F) for b in range(B)
                         for f0 in tiles])
    x0, x1 = planes(spans[:, rows])                   # [B*T, 64, 256]
    mag = (256 * (x1.abs().long() @ a1.abs().long())
           + x0.long() @ a1.abs().long() + x1.abs().long() @ a0.long())
    in_int32(mag, "the magnitudes of acc2's terms")
    out = torch.empty((B * len(tiles), TILE, n_pad), dtype=torch.int32)
    for n0 in range(0, n_pad, SLAB):
        b0, b1 = a0[:, n0:n0 + SLAB], a1[:, n0:n0 + SLAB]
        acc1 = torch.zeros((B * len(tiles), TILE, SLAB), dtype=torch.int32)
        acc2 = torch.zeros_like(acc1)
        for k in range(0, WIN, CHUNK):
            ks = slice(k, k + CHUNK)
            acc2 = in_int32(acc2.long() + x1[..., ks] @ b1[ks], "p11")
        acc2 = in_int32(acc2.long() * 256, "256 p11")
        for k in range(0, WIN, CHUNK):
            ks = slice(k, k + CHUNK)
            acc1 = in_int32(acc1.long() + x0[..., ks] @ b0[ks], "p00")
            acc2 = in_int32(acc2.long() + x0[..., ks] @ b1[ks], "+ p01")
            acc2 = in_int32(acc2.long() + x1[..., ks] @ b0[ks], "+ p10")
        k1 = in_int32(acc2.long() + ((acc1 + (1 << 20)) >> 8),
                      "the epilogue's sum")
        out[..., n0:n0 + SLAB] = (k1 >> 13).clamp(-(1 << 20), 1 << 20)
    # each tile's frames below Fmax, each frame's first 255 columns
    return out.reshape(B, -1, n_pad)[:, :F, :COLS].contiguous()


def int64_analysis(pcm, fq):
    """The contract by an int64 numpy product."""
    F = (pcm.shape[1] - HOP) // HOP
    frames = np.stack([pcm[:, f * HOP:f * HOP + WIN] for f in range(F)],
                      axis=1).astype(np.int64)
    return np.clip((frames @ fq.astype(np.int64) + (1 << 20)) >> 21,
                   -(1 << 20), 1 << 20)


def test_plane_split_at_the_byte_edges():
    v = torch.tensor([-32768, -256, -255, -1, 0, 255, 256, 32767],
                     dtype=torch.int16)
    lo, hi = planes(v)
    assert lo.tolist() == [0, 0, 1, 255, 0, 255, 0, 255]
    assert hi.tolist() == [-128, -1, -1, -1, 0, 0, 1, 127]
    assert torch.equal(256 * hi + lo, v.to(torch.int32))
    # the kernel's permutes of four samples packed two a word
    u = v.to(torch.int64) & 0xFFFF
    for i in range(0, 8, 4):
        x = u[i] | (u[i + 1] << 16)
        y = u[i + 2] | (u[i + 3] << 16)
        got_lo, got_hi = byte_perm(x, y, 0x6420), byte_perm(x, y, 0x7531)
        for j in range(4):
            assert (got_lo >> 8 * j) & 255 == lo[i + j]
            assert ((got_hi >> 8 * j) & 255) - 256 * (
                ((got_hi >> 8 * j) & 255) >= 128) == hi[i + j]


def test_tiles_share_the_boundary_samples():
    """Frame 63 (tile 0) and frame 64 (tile 1) share samples 64*240 ..
    64*240 + 15: the end of tile 0's span and the start of tile 1's."""
    fmax = 65
    row = torch.from_numpy(np.random.default_rng(3).integers(
        -32768, 32768, size=fmax * HOP + HOP).astype(np.int16))
    s0, s1 = span_of(row, 0, fmax), span_of(row, TILE, fmax)
    assert torch.equal(s0[63 * HOP + HOP:63 * HOP + WIN], s1[:WIN - HOP])
    assert torch.equal(s1[:WIN], row[TILE * HOP:TILE * HOP + WIN])
    assert not s1[WIN:].any()                 # no frame of tile 1 past 64


MATRICES = ("min", "max", "random", "shipped")


def _matrix(kind):
    rng = np.random.default_rng(12)
    return {"min": lambda: np.full((WIN, COLS), -32768),
            "max": lambda: np.full((WIN, COLS), 32767),
            "random": lambda: rng.integers(-32768, 32768, size=(WIN, COLS)),
            "shipped": enc.forward_matrix_q}[kind]().astype(np.int16)


@pytest.mark.parametrize("fmax", [1, 17, 65])
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("rows", ["adversarial", "random"])
def test_kernel_model_equals_the_analysis(rows, matrix, fmax):
    L = fmax * HOP + HOP
    rng = np.random.default_rng(fmax)
    pcm = (_adversarial_pcm(L) if rows == "adversarial"
           else rng.integers(-32768, 32768, size=(7, L)).astype(np.int16))
    fq = _matrix(matrix)
    got = kernel_model(torch.from_numpy(pcm), torch.from_numpy(fq))
    assert torch.equal(got, d94.analyze94_plain(torch.from_numpy(pcm),
                                                torch.from_numpy(fq)))
    np.testing.assert_array_equal(got.numpy(), int64_analysis(pcm, fq))
    if matrix == "shipped":
        jax_ci = jax.jit(lambda x: j_d94._analyze_device(x, fmax))(
            jnp.asarray(pcm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ci))
