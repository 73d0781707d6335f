"""Port parity for the cold catalog sweeps (models/coldsweep.py) and the
mixed-family catalog_pipeline (models/catalogsweep.py) on the CPU, where
the plain versions of the kernels run:

- concat_chunks and cold_flat94 over 1, 2 and 3 chunks (chunk pools whose
  lengths are not a multiple of 4, chunks of different n_steps) against the
  port's run_flat of the whole catalog and against the JAX
  flat_pipeline_packed on the same chunks, concatenated as
  bench.py:239-259 does (rebuilt here), bit for bit on & $FFFF;
- catalog_pipeline against the JAX catalog_pipeline on
  tests/test_catalog_e2e.py's streams, whole and with each family None;
- the checksum's int32 wrap against JAX's on a PCM whose sum passes 2^31;
- cold_catalog's per-family checksums and families keys against the JAX
  path;
- the cold entry points default to the card and raise without one."""

import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcsexplorer_tpu.models import catalogsweep as jcs
from dcsexplorer_tpu.models import flatsweep as jfs
from dcsexplorer_tpu_torch.models import catalogsweep as tcs
from dcsexplorer_tpu_torch.models import coldsweep as cold
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.ops import kernels

from .test_format93 import build_stream93a_type1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")


def _read(name):
    with open(os.path.join(ASSETS, name), "rb") as f:
        return f.read()


# Every 1994+ catalog of the chunk tests is STREAMS x COPIES in some
# chunking: one pool of 30,774 bytes a copy (2 mod 4), tone_low alone 6,867
# (3 mod 4) with n_steps 144 against the others' 208.
STREAMS = [_read("tone_low.dcs94"), _read("noise_sweep.dcs94")]
COPIES = 3
CATALOG = STREAMS * COPIES
# the JAX program compiles once for every chunking: the concatenated pool
# is padded with $FF to one length (each chunk adds 8 bytes of separator;
# no walk reads past a stream's $FF separator)
_JAX_FLAT = jax.jit(jfs.flat_pipeline_packed, static_argnums=(9,))
_JAX_CHECKSUM = jax.jit(lambda pcm: jnp.sum(pcm & 0xFF, dtype=jnp.int32))


def _jax_chunks(chunk_streams, pool_len):
    """The JAX pcm [N, 240] of the chunks (lists of streams), each packed by
    the JAX FlatSweep and concatenated as bench.py:239-259 does."""
    chunks = []
    for s in chunk_streams:
        sw = jfs.FlatSweep(s)
        sw.pack()
        chunks.append(sw.compact_host_arrays())
    boff = np.cumsum([0] + [a["pool_u8"].shape[0] for a in chunks[:-1]])
    soff = np.cumsum([0] + [a["hdr_tab"].shape[0] for a in chunks[:-1]])
    cat = lambda k: np.concatenate([a[k] for a in chunks])
    sid = np.concatenate([a["sid"].astype(np.int32) + np.int32(s)
                          for a, s in zip(chunks, soff)])
    start_bit = np.concatenate([a["start_bit"] + np.int32(b * 8)
                                for a, b in zip(chunks, boff)])
    n_steps = max([8] + [a["n_steps"] for a in chunks])
    pool = cat("pool_u8")
    assert pool.size <= pool_len
    pool = np.pad(pool, (0, pool_len - pool.size), constant_values=0xFF)
    return np.asarray(_JAX_FLAT(pool, sid, start_bit, cat("bt_u8"),
                                cat("mix_u16"), cat("vol_u8"), cat("hdr_tab"),
                                cat("fmt_tab"), cat("sub_tab"), n_steps))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whole():
    """The port's run_flat of CATALOG (int16), and the pool length every
    chunking pads to for the JAX program (up to 3 chunks)."""
    sweep = tfs.FlatSweep(CATALOG).pack()
    return tfs.run_flat(sweep, "cpu"), sweep.pool_u8.size + 16


def _chunks_at(bounds):
    """CATALOG cut before the stream indices ``bounds``."""
    edges = [0, *bounds, len(CATALOG)]
    return [CATALOG[a:b] for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("bounds", [(), (1,), (1, 4)],
                         ids=["1 chunk", "2 chunks", "3 chunks"])
def test_concat_chunks_matches_run_flat_and_jax(bounds, whole):
    want16, pool_len = whole
    chunk_streams = _chunks_at(bounds)
    sweeps = [tfs.FlatSweep(s).pack() for s in chunk_streams]
    # chunk pools that are no multiple of 4; chunks of different n_steps
    assert all(sw.pool_u8.size % 4 for sw in sweeps)
    if bounds:
        assert len({sw.n_steps for sw in sweeps}) == 2
    args = cold.concat_chunks([
        tfs.packed_to_device(sw.compact_host_arrays(), "cpu")
        for sw in sweeps])
    assert args["n_steps"] == max(sw.n_steps for sw in sweeps)
    assert args["sid"].dtype == args["start_bit"].dtype == torch.int32
    pcm = tfs.FlatPipeline("cpu")(**args)
    assert np.array_equal(tfs.to_int16(pcm), want16)
    assert np.array_equal(_jax_chunks(chunk_streams, pool_len) & 0xFFFF,
                          pcm.numpy())


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_cold_flat94_matches_run_flat_and_jax(n_chunks, whole):
    want16, pool_len = whole
    before = dict(kernels.LAUNCHES)
    r = cold.cold_flat94(STREAMS, COPIES, n_chunks, device="cpu")
    assert kernels.LAUNCHES == before          # the plain versions ran
    assert np.array_equal(tfs.to_int16(r["pcm"]), want16)
    chunk_streams = cold.split_copies(STREAMS, COPIES, n_chunks)
    assert len(chunk_streams) == len(r["chunks"]) == n_chunks
    # chunk pools that are no multiple of 4 (two chunks: 2 and 0 mod 4)
    assert any(tfs.FlatSweep(s).pool_u8.size % 4 for s in chunk_streams)
    jpcm = _jax_chunks(chunk_streams, pool_len)
    assert np.array_equal(jpcm & 0xFFFF, r["pcm"].numpy())
    assert r["checksum"] == int(_JAX_CHECKSUM(jpcm))
    assert r["audio_samples"] == want16.size
    for c in r["chunks"]:
        assert set(c) == {"pack_ms", "enqueue_ms", "upload_ms"}
        assert min(c.values()) >= 0
    assert r["device_ms"] >= 0 and r["fetch_ms"] >= 0


def test_split_copies_as_bench():
    # bench.py:232-237: per = copies // n_chunks, the last takes the rest
    sizes = lambda c, n: [len(x) for x in cold.split_copies(["a", "b"], c, n)]
    assert sizes(24, 4) == [12, 12, 12, 12]
    assert sizes(7, 3) == [4, 4, 6]
    assert sizes(2, 5) == [2, 2]
    assert cold.split_copies(["a", "b"], 3, 1) == [["a", "b"] * 3]


# tests/test_catalog_e2e.py:95-127's mixed catalog
S94 = [_read("music_a.dcs94"), _read("tone_low.dcs94")]
S93 = [_read("music_a.dcs93b"), _read("music_b.dcs93a")]
S93A = [build_stream93a_type1(n_frames=9, n_bands=10, selector=1, seed=5)]
_JAX_93 = {t1: jax.jit(lambda a, nw, t1=t1: jnp.sum(
    jcs.run_flat93_pcm(a, t1, nw) & 0xFF, dtype=jnp.int32),
    static_argnums=(1,)) for t1 in (False, True)}


def _wrap(x):
    return int(tcs.wrap_int32(torch.tensor(x)))


@pytest.fixture(scope="module")
def jax_catalog():
    """The JAX catalog_pipeline's total over S94 + S93 + S93A."""
    sw94 = jfs.FlatSweep(S94)
    sw94.pack()
    a94 = sw94.compact_host_arrays()
    n_steps = a94.pop("n_steps")
    sw93 = jcs.Flat93Sweep(S93, t1=False)
    sw93a = jcs.Flat93Sweep(S93A, t1=True)
    fn = jax.jit(jcs.catalog_pipeline, static_argnums=(3, 4, 5))
    return int(fn(a94, sw93.compact_host_arrays(),
                  sw93a.compact_host_arrays(), n_steps, sw93.nwords,
                  sw93a.nwords))


@pytest.fixture(scope="module")
def jax_families93():
    """The JAX per-family checksums of the 1993 families (bench.py's f93,
    f93a) over S93 and S93A."""
    out = {}
    for name, streams, t1 in (("93b", S93, False), ("93a1", S93A, True)):
        sw = jcs.Flat93Sweep(streams, t1=t1)
        out[name] = int(_JAX_93[t1](sw.compact_host_arrays(), sw.nwords))
    return out


def _port_catalog_args():
    sw94 = tfs.FlatSweep(S94).pack()
    return {"94": tfs.packed_to_device(sw94.compact_host_arrays(), "cpu"),
            "93b": tcs.packed93_to_device(
                tcs.Flat93Sweep(S93, False).compact_host_arrays(), "cpu"),
            "93a1": tcs.packed93_to_device(
                tcs.Flat93Sweep(S93A, True).compact_host_arrays(), "cpu")}


@pytest.mark.parametrize("dropped", [None, "94", "93b", "93a1"])
def test_catalog_pipeline_matches_jax(dropped, jax_catalog, jax_families93):
    args = _port_catalog_args()
    if dropped is not None:
        args[dropped] = None
    cd = cold.ColdDevice("cpu")
    got = tcs.catalog_pipeline(cd.pipe94, cd.pipe93, args["94"], args["93b"],
                               args["93a1"])
    assert got.dtype == torch.int32 and got.shape == ()
    # the JAX program sums int32 checksums: a family's is the total less
    # the others'
    fam = dict(jax_families93)
    fam["94"] = _wrap(jax_catalog - fam["93b"] - fam["93a1"])
    want = jax_catalog if dropped is None else _wrap(
        sum(v for k, v in fam.items() if k != dropped))
    assert int(got) == want


def test_checksum_wraps_as_jax_int32():
    # low bytes >= $80 in 48,000 frames: the sum passes 2^31
    rng = np.random.default_rng(3)
    pcm = (rng.integers(0x80, 0x100, (48000, 240))
           | (rng.integers(0, 0x100, (48000, 240)) << 8)).astype(np.int32)
    assert int((pcm & 0xFF).astype(np.int64).sum()) > 2 ** 31
    got = tcs.checksum(torch.from_numpy(pcm))
    assert got.dtype == torch.int32
    assert int(got) == int(_JAX_CHECKSUM(jnp.asarray(pcm))) < 0
    assert _wrap(2 ** 31) == -2 ** 31 and _wrap(-2 ** 31 - 1) == 2 ** 31 - 1


def test_cold_catalog_matches_jax(whole, jax_families93):
    r = cold.cold_catalog(CATALOG, S93, S93A, device="cpu")
    jpcm = _jax_chunks([CATALOG], whole[1])
    want = dict(jax_families93, **{"94": int(_JAX_CHECKSUM(jpcm))})
    assert r["checksums"] == {k: want[k] for k in ("94", "93b", "93a1")}
    assert r["checksum"] == _wrap(sum(want.values()))
    # bench.py's families: the same keys, frames and audio seconds
    assert list(r["families"]) == ["94", "93b", "93a1"]
    frames = {"94": jpcm.shape[0],
              "93b": jcs.Flat93Sweep(S93, t1=False).n_frames_total,
              "93a1": jcs.Flat93Sweep(S93A, t1=True).n_frames_total}
    for k, f in r["families"].items():
        assert set(f) == {"host_ms", "frames", "audio_s"}
        assert f["frames"] == frames[k]
        assert f["audio_s"] == frames[k] * 240 / 31250
        assert f["host_ms"] > 0
    assert r["audio_samples"] == sum(frames.values()) * 240
    # the same catalog through catalog_pipeline
    sw94 = tfs.FlatSweep(CATALOG).pack()
    cd = cold.ColdDevice("cpu")
    total = tcs.catalog_pipeline(
        cd.pipe94, cd.pipe93,
        tfs.packed_to_device(sw94.compact_host_arrays(), "cpu"),
        tcs.packed93_to_device(
            tcs.Flat93Sweep(S93, False).compact_host_arrays(), "cpu"),
        tcs.packed93_to_device(
            tcs.Flat93Sweep(S93A, True).compact_host_arrays(), "cpu"))
    assert int(total) == r["checksum"]


def test_cold_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (cold.cold_flat94, cold.cold_catalog, cold.ColdDevice):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for call in (cold.ColdDevice,
                 lambda: cold.cold_flat94(STREAMS, 1, 1),
                 lambda: cold.cold_catalog(STREAMS, S93, S93A)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
