"""Port parity: the plain PyTorch inverse transform and overlap resolve of
dcsexplorer_tpu_torch equal the JAX reference (transform94_planar,
overlap_resolve_planar) bit for bit on random frame buffers, including
saturation and rounding edges and volume shifts past 31; so does the
transform-to-PCM stage of the flat sweep (transform94_pcm_plain), with
stream starts around the CUDA kernel's tile edges."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcsexplorer_tpu.ops import transform as jtf
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.ops import transform as ttf


def _random_frames(n, seed, max_vs=9):
    rng = np.random.default_rng(seed)
    fb = rng.integers(0, 0x10000, size=(n, 512)).astype(np.int32)
    vs = rng.integers(0, max_vs, size=(n,)).astype(np.int32)
    fb[0, :256] = 0x8000             # all -32768
    fb[1, :256] = 0x7FFF             # all +32767
    fb[2, :258] = 0x8000
    fb[3] = rng.choice([0x8000, 0x7FFF, 0, 1, 0xFFFF, 0x4000], size=512)
    return fb, vs


@pytest.fixture(scope="module")
def tabs():
    return tfs.codec_tables()


@pytest.mark.parametrize("seed,max_vs", [(31, 9), (32, 41)])
def test_transform94_planar_plain_matches_jax(tabs, seed, max_vs):
    fb, vs = _random_frames(64, seed, max_vs)
    want_re, want_im = jax.jit(jtf.transform94_planar)(jnp.asarray(fb),
                                                       jnp.asarray(vs))
    got_re, got_im = ttf.transform94_planar_plain(torch.from_numpy(fb),
                                                  torch.from_numpy(vs), tabs)
    assert got_re.dtype == got_im.dtype == torch.int32
    assert np.array_equal(np.asarray(want_re), got_re.numpy())
    assert np.array_equal(np.asarray(want_im), got_im.numpy())


def test_transform_cpu_dispatch_and_cuda_only_kernel(tabs):
    fb, vs = _random_frames(8, 5)
    fb_t, vs_t = torch.from_numpy(fb), torch.from_numpy(vs)
    before = dict(kernels.LAUNCHES)
    via = ttf.transform94_planar(fb_t, vs_t, tabs)
    plain = ttf.transform94_planar_plain(fb_t, vs_t, tabs)
    assert all(torch.equal(a, b) for a, b in zip(via, plain))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernels.transform94_planar(fb_t, vs_t, tabs["p2_c0"], tabs["p2_c1"],
                                   tabs["cos"], tabs["sin"])


@pytest.mark.parametrize("starts", [[0, 11, 19], [0], [3, 4, 5, 29]])
def test_overlap_resolve_planar_matches_jax(tabs, starts):
    # three streams on one flat axis: the carry resets at each start (a
    # first frame that is not a start carries zeros, as in the reference)
    F = 30
    fb, vs = _random_frames(F, 37)
    sstart = np.zeros(F, dtype=bool)
    sstart[starts] = True
    re, im = jax.jit(jtf.transform94_planar)(jnp.asarray(fb), jnp.asarray(vs))
    want = jax.jit(jtf.overlap_resolve_planar)(re, im, jnp.asarray(sstart))
    got = ttf.overlap_resolve_planar(torch.tensor(np.asarray(re)),
                                     torch.tensor(np.asarray(im)),
                                     torch.from_numpy(sstart), tabs)
    assert got.shape == (F, 240) and got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())


T = kernels.TRANSFORM94_PCM_TILE


def _sid_layout(name, n):
    if name == "one_stream":               # a stream starts at frame 0 only
        return np.zeros(n, np.int32)
    if name == "single_frame_streams":
        return np.arange(n, dtype=np.int32)
    if name == "tile_edges":               # starts at T-1, T, T+1 and 2T
        return np.searchsorted([T - 1, T, T + 1, 2 * T], np.arange(n),
                               side="right").astype(np.int32)
    rng = np.random.default_rng(7)         # runs of 1..2T frames
    return np.repeat(np.arange(n), rng.integers(1, 2 * T, size=n))[:n] \
        .astype(np.int32)


@pytest.mark.parametrize("layout", ["one_stream", "single_frame_streams",
                                    "tile_edges", "random_runs"])
def test_transform94_pcm_plain_matches_jax(tabs, layout):
    n = 2 * T + 3
    fb, vs = _random_frames(n, 41, max_vs=41)
    sid = _sid_layout(layout, n)
    sstart = np.concatenate([[True], sid[1:] != sid[:-1]])
    re, im = jax.jit(jtf.transform94_planar)(jnp.asarray(fb), jnp.asarray(vs))
    want = jax.jit(jtf.overlap_resolve_planar)(re, im, jnp.asarray(sstart))
    got = ttf.transform94_pcm_plain(torch.from_numpy(fb), torch.from_numpy(vs),
                                    torch.from_numpy(sid), tabs)
    assert got.shape == (n, 240) and got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())


def test_transform94_pcm_cpu_dispatch_and_cuda_only_kernel(tabs):
    fb, vs = _random_frames(8, 6, max_vs=41)
    sid = torch.tensor([0, 0, 0, 1, 2, 2, 2, 2], dtype=torch.int32)
    fb_t, vs_t = torch.from_numpy(fb), torch.from_numpy(vs)
    before = dict(kernels.LAUNCHES)
    via = ttf.transform94_pcm(fb_t, vs_t, sid, tabs)
    assert torch.equal(via, ttf.transform94_pcm_plain(fb_t, vs_t, sid, tabs))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernels.transform94_pcm(fb_t, vs_t, sid, tabs)
