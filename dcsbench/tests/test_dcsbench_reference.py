"""The plain reference against the scalar decoder (its frozen copy of the
port's ``ReferenceDecoder``), frame by frame, on the frozen streams and
ROMs at small sizes; and against the program's own plain path."""

import os

import numpy as np
import pytest
import torch

from dcsbench.harness import traffic as gen
from dcsbench.reference import codec
from dcsbench.reference import decoder as rd
from dcsbench.reference import zipload

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
N = 24                      # frames held against the scalar decoder


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _int16(pcm):
    return ((np.asarray(pcm, np.int64) & 0xFFFF) ^ 0x8000) - 0x8000


def _scalar_standalone(stream, os_v, level, volume, n):
    dec = rd.ReferenceDecoder()
    dec.default_volume = volume
    dec.init_standalone(os_v)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(stream), mixing_level=level)
    return np.array(dec.next_samples(n * 240), np.int64)


@pytest.mark.parametrize("name, os_v, t1", [
    ("music_a.dcs94", rd.OS94, None), ("music_b.dcs94", rd.OS94, None),
    ("music_a.dcs93b", rd.OS93B, False), ("music_b.dcs93a", rd.OS93B, False),
    ("dense_t1.dcs93a1", rd.OS93A, True),
    ("dense_t1b.dcs93a1", rd.OS93A, True)])
def test_standalone_stream_equals_the_scalar_decoder(name, os_v, t1):
    torch.set_num_threads(1)
    s = _read(name)
    bank = codec.Bank94() if t1 is None else codec.Bank93()
    if t1 is None:
        bank.add(name, s)
        state = bank.decode("cpu")
    else:
        bank.add(name, s, 0, t1)
        state = bank.arrays("cpu")
    F = bank.n_rows - 1
    mix, vol = codec.standalone_controls(s, os_v, 0x5A, 0x90, F)
    fn = codec.pcm94 if t1 is None else codec.pcm93
    pcm = fn(state, np.arange(1, F + 1)[:, None], mix[:, None], vol,
             np.zeros(F), "cpu").numpy()
    want = _scalar_standalone(s, os_v, 0x5A, 0x90, N)
    np.testing.assert_array_equal(_int16(pcm[:N]).reshape(-1), want)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("rom, voice_tracks", [
    ("rom94.zip", [[1 + v + 6 * k for k in range(40)] for v in range(6)]),
    ("session93a.zip", [[1 + v] for v in range(6)])])
def test_session_equals_the_scalar_decoder(rom, voice_tracks):
    torch.set_num_threads(1)
    traffic = dict(sessions=2, frames=N, voices=6, interval=261,
                   master_volume=[64, 127])
    events = gen.session_batch(voice_tracks, traffic, 2 ** 31 + 5, 0)[1]
    rs, _ = zipload.load_zip_file(os.path.join(DATA, rom))
    assert rs.check() == 1
    plays, mix, vol = codec.session_controls(rs, events, N, 6, 0x67)
    images = codec.chip_images(rs)
    fam93 = rs.os_version in (rd.OS93A, rd.OS93B)
    bank = codec.Bank93() if fam93 else codec.Bank94()
    for row in plays:
        for p in row:
            if p is not None:
                mem = images[p[0][0]]
                if fam93:
                    bank.add(p[0], mem, p[0][1],
                             codec.is_type1(rs.os_version, mem, p[0][1]))
                else:
                    bank.add(p[0], mem, p[0][1])
    state = bank.arrays("cpu") if fam93 else bank.decode("cpu")
    fn = codec.pcm93 if fam93 else codec.pcm94
    pcm = fn(state, bank.rows(plays, 6), mix, vol, np.zeros(N), "cpu")
    dec = rd.ReferenceDecoder()
    dec.default_volume = 0x67
    dec.load_rom_set(rs)
    dec.soft_boot()
    want = []
    for f in range(N):
        for b in events.get(f, ()):
            dec.write_data_port(b)
        want.extend(dec.next_samples(240))
    want = np.array(want, np.int64)
    np.testing.assert_array_equal(_int16(pcm.numpy()).reshape(-1), want)
    assert np.abs(want).max() > 0
    assert sum(p is not None for row in plays for p in row) > 0


def test_reference_equals_the_programs_plain_sweep():
    """The whole stream through the program's plain CPU path (its
    FlatSweep + FlatPipeline) gives the reference's PCM."""
    from dcsexplorer_tpu_torch.models import flatsweep as fs
    torch.set_num_threads(1)
    s = _read("music_b.dcs94")
    bank = codec.Bank94()
    bank.add("b", s)
    F = bank.n_rows - 1
    mix, vol = codec.standalone_controls(s, rd.OS94, 0x44, 0xC0, F)
    pcm = codec.pcm94(bank.decode("cpu"), np.arange(1, F + 1)[:, None],
                      mix[:, None], vol, np.zeros(F), "cpu")
    sw = fs.FlatSweep([s], 0x44, 0xC0).pack()
    np.testing.assert_array_equal(sw.mix_u16.astype(np.int32), mix)
    np.testing.assert_array_equal(sw.vol_u8.astype(np.int32), vol)
    got = fs.FlatPipeline("cpu")(**fs.packed_to_device(
        sw.compact_host_arrays(), "cpu"))
    assert torch.equal(got, pcm)


def test_digest_sees_a_changed_word_and_swapped_frames():
    from dcsbench.reference import digest
    g = np.random.default_rng(0)
    pcm = g.integers(0, 1 << 16, (6, 240)).astype(np.int32)
    base = digest.digest_np(pcm)
    t = torch.tensor(pcm)
    on_card = digest.stream_digests(t, *digest.stream_ends([6]))[0].numpy()
    np.testing.assert_array_equal(on_card, base)
    two = digest.stream_digests(t, *digest.stream_ends([2, 4])).numpy()
    np.testing.assert_array_equal(two[0], digest.digest_np(pcm[:2]))
    np.testing.assert_array_equal(two[1], digest.digest_np(pcm[2:]))
    np.testing.assert_array_equal(digest.session_digests(
        t.reshape(1, -1), digest.weights(torch.arange(1, 7)))[0].numpy(),
        base)
    one = pcm.copy()
    one[3, 17] ^= 1
    assert (digest.digest_np(one) != base).any()
    swapped = pcm[[0, 1, 3, 2, 4, 5]]
    assert (digest.digest_np(swapped) != base).any()


@pytest.mark.parametrize("order", ["pairs_reversed", "bit_reversed",
                                   "pair_swapped", "words_swapped"])
def test_digest_sees_words_moved_inside_a_frame(order):
    """A wrong extraction order moves words inside a frame, keeping each
    word's parity: the frame's hash, and so the digest, has to change, on
    the card's side and the reference's alike."""
    from dcsbench.reference import digest
    g = np.random.default_rng(1)
    pcm = g.integers(0, 1 << 16, (5, 240)).astype(np.int32)
    moved = pcm.copy()
    pairs = moved[2].reshape(120, 2)
    if order == "pairs_reversed":
        pairs[:] = pairs[::-1]
    elif order == "bit_reversed":
        idx = [int(f"{i:07b}"[::-1], 2) for i in range(128)]
        pairs[:] = pairs[[i for i in idx if i < 120]]
    elif order == "pair_swapped":
        pairs[[5, 77]] = pairs[[77, 5]]
    else:
        moved[2, [10, 12]] = moved[2, [12, 10]]
    assert not np.array_equal(moved, pcm)
    assert (digest.digest_np(moved) != digest.digest_np(pcm)).any()
    card = digest.stream_digests(torch.tensor(moved),
                                 *digest.stream_ends([5]))[0].numpy()
    np.testing.assert_array_equal(card, digest.digest_np(moved))


def test_digest_wraps_alike_on_both_sides():
    """Full-scale words over a long stream: the weighted sum passes 2**63
    and wraps, in torch and numpy alike."""
    from dcsbench.reference import digest
    pcm = np.full((3000, 240), 0xFFFF, np.int32)
    pcm[::7] = 0x8000
    got = digest.stream_digests(torch.tensor(pcm),
                                *digest.stream_ends([1000, 2000])).numpy()
    np.testing.assert_array_equal(got[1], digest.digest_np(pcm[1000:]))
    got = digest.stream_digests(torch.tensor(pcm),
                                *digest.stream_ends([3000]))[0].numpy()
    np.testing.assert_array_equal(got, digest.digest_np(pcm))
    cols = pcm[:1].view(np.int8).astype(np.int64) @ \
        digest.BYTE_W.astype(np.int64)
    assert max(abs(int(c) * int(m)) for c, m in zip(cols[0], digest.COL_M)) \
        > 2 ** 63


def test_traffic_gives_every_seed_the_same_work():
    tracks = [[1 + v + 6 * k for k in range(40)] for v in range(6)]
    traffic = dict(sessions=320, frames=1000, voices=6, interval=261,
                   master_volume=[64, 127])

    def work(seed):
        ev = gen.session_batch(tracks, traffic, seed, 3)
        starts = sorted((f, len(b)) for e in ev for f, b in e.items())
        played = sorted(int(b[i]) << 8 | int(b[i + 1]) for e in ev
                        for f, b in e.items()
                        for i in range(4 if f == 0 else 0, len(b), 2))
        return starts, played

    assert work(1) == work(2 ** 31 + 77)
    a = gen.session_batch(tracks, traffic, 1, 3)
    b = gen.session_batch(tracks, traffic, 2, 3)
    assert a != b
    cat = gen.catalog_variants([{"streams": [["x", 3], ["y", 2]]}],
                               dict(variants=2, mixing_level=[64, 127],
                                    master_volume=[64, 255]), 9)
    assert all(sorted(v["order"]) == ["x"] * 3 + ["y"] * 2 for v in cat[0])
