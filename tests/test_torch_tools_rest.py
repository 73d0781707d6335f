"""The port's last tools against the JAX package's, on the CPU:
tools/make_bench_assets.py (the generators and a whole run, every byte),
tools/test_all.py (markers, logs, stdout and return codes over synthetic
ROM zips, a corrupted one and an empty directory; --versions) and
format/extract_tables.py (both extractors on a source rendered from the
port's tables_data.npz; the real extraction where the reference tree is)."""

import io
import os
import zipfile

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.format import extract_tables as jextract
from dcsexplorer_tpu.tools import make_bench_assets as jassets
from dcsexplorer_tpu.tools import test_all as jtest_all
from dcsexplorer_tpu_torch.format import extract_tables as textract
from dcsexplorer_tpu_torch.tools import make_bench_assets as tassets
from dcsexplorer_tpu_torch.tools import test_all as ttest_all

from .test_romgen import _make_spec
from .test_tables import REF_ROOT

NPZ = os.path.join(os.path.dirname(textract.__file__), "tables_data.npz")
CAP = ["--max-track-frames", "20"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


# ---------------------------------------------------------------- assets

@pytest.mark.parametrize("seconds,seed,root", [(8.0, 11, 220.0),
                                               (8.0, 23, 174.6),
                                               (0.7, 5, 330.0)])
def test_synth_music_equals_the_jax_generator(seconds, seed, root):
    got = tassets.synth_music(seconds, seed=seed, root=root)
    want = jassets.synth_music(seconds, seed=seed, root=root)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want) and got.tobytes() == want.tobytes()
    assert np.abs(got).max() > 20000


@pytest.mark.parametrize("kw", [dict(selector=1, seed=5),
                                dict(selector=2, seed=17),
                                dict(n_frames=30, n_bands=12, selector=3,
                                     seed=9)])
def test_type1_stream_equals_the_jax_builder(kw):
    got = tassets.build_stream93a_type1(**kw)
    assert got == jassets.build_stream93a_type1(**kw)
    assert len(got) > 3 + 8


def test_main_writes_the_jax_generators_bytes(tmp_path, monkeypatch,
                                               capsys):
    """One whole run on the CPU (the 1994+ music through the encoder
    kernels' plain versions) against the JAX tool's run into another
    directory: every file and the manifest byte for byte, and the same
    lines printed.  (Four of them differ from the committed assets, which
    predate later encoder changes: neither run writes there.)"""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jassets, "ASSETS", str(jdir))
    jassets.main()
    want_out = capsys.readouterr().out
    assert tassets.main(["--out", str(tdir), "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    want, got = _files(jdir), _files(tdir)
    assert sorted(got) == sorted(want) == sorted(
        ["music_a.dcs94", "music_b.dcs94", "music_a.dcs93b",
         "music_b.dcs93a", "dense_t1.dcs93a1", "dense_t1b.dcs93a1",
         "manifest.json"])
    for name in want:
        assert got[name] == want[name], name
    assert got_out == want_out


def test_main_needs_a_card_unless_told_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tassets.main(["--out", str(tmp_path / "out")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------- test_all

@pytest.fixture(scope="module")
def roms_dir(tmp_path_factory):
    """Two synthetic ROM zips and one whose U2 checksum is broken."""
    d = tmp_path_factory.mktemp("roms")
    data = romgen.RomBuilder(_make_spec()).build_zip()
    (d / "synth_a.zip").write_bytes(data)
    (d / "synth_b.zip").write_bytes(data)
    src = zipfile.ZipFile(io.BytesIO(data))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as zf:
        for n in src.namelist():
            img = bytearray(src.read(n))
            img[0x100] ^= 0xFF              # outside the chip index
            zf.writestr(n, bytes(img))
    (d / "corrupt.zip").write_bytes(out.getvalue())
    return d


def _run(tool, argv, capsys):
    rc = tool.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def test_test_all_equals_the_jax_tool(roms_dir, tmp_path, capsys):
    """Both tools over the same directory: the same return code, stdout,
    markers and logs (the two good zips are one image, so the JAX tool
    compiles its session decode once)."""
    jres, tres = tmp_path / "jax", tmp_path / "port"
    want = _run(jtest_all, [str(roms_dir), str(jres), *CAP], capsys)
    got = _run(ttest_all, [str(roms_dir), str(tres), *CAP, "--device",
                           "cpu"], capsys)
    assert got == want
    assert got[0] == 1
    lines = got[1].splitlines()
    assert "synth_a: Validation Succeeded" in lines
    assert "synth_b: Validation Succeeded" in lines
    assert "corrupt: FAILED" in lines
    assert lines[-1] == "2/3 ROMs validated successfully"
    assert _files(tres) == _files(jres)
    assert sorted(_files(tres)) == [
        "corrupt.diff", "corrupt.log", "synth_a.log", "synth_a.success",
        "synth_b.log", "synth_b.success"]
    assert (tres / "corrupt.log").read_text() == (
        "Validation FAILED: ROM failed POST checks (code 2)\n")
    assert (tres / "synth_a.log").read_text().endswith(
        "Validation Succeeded\n")


def test_test_all_replaces_stale_markers(roms_dir, tmp_path, capsys):
    good = tmp_path / "good"
    good.mkdir()
    (good / "synth_a.zip").write_bytes((roms_dir / "synth_a.zip")
                                       .read_bytes())
    res = tmp_path / "res"
    res.mkdir()
    (res / "synth_a.diff").write_text("")
    rc, out, _ = _run(ttest_all, [str(good), str(res), *CAP, "--device",
                                  "cpu"], capsys)
    assert rc == 0 and out.splitlines()[-1] == (
        "1/1 ROMs validated successfully")
    assert sorted(os.listdir(res)) == ["synth_a.log", "synth_a.success"]


def test_test_all_versions_equals_the_jax_tool(roms_dir, tmp_path, capsys):
    want = _run(jtest_all, [str(roms_dir), str(tmp_path / "j"),
                            "--versions"], capsys)
    got = _run(ttest_all, [str(roms_dir), str(tmp_path / "t"),
                           "--versions"], capsys)
    assert got == want and got[0] == 0
    assert got[1].splitlines()[0] == "corrupt: Hardware type not " \
        "detected, Unknown  (POST code 2)"
    assert len(got[1].splitlines()) == 3


def test_test_all_empty_directory(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    want = _run(jtest_all, [str(empty), str(tmp_path / "j")], capsys)
    got = _run(ttest_all, [str(empty), str(tmp_path / "t")], capsys)
    assert got == want and got[0] == 2
    assert got[2] == f"no ROM zips found in {empty}\n"
    assert os.listdir(tmp_path / "t") == []


def test_test_all_needs_a_card_unless_told_the_cpu(roms_dir, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(ttest_all, [str(roms_dir), str(tmp_path / "t")],
                        capsys)
    assert rc == 2 and out == "" and "no CUDA device" in err
    assert os.listdir(tmp_path / "t") == []


# ---------------------------------------------------------- extract_tables

def _c_array(name, values, hexa):
    words = [(f"-0x{-v:X}" if v < 0 else f"0x{v:X}") if hexa else str(v)
             for v in values]
    rows = [", ".join(words[k:k + 8]) for k in range(0, len(words), 8)]
    return (f"// {name}: table of the format\n"
            f"static const int {name}[] = {{  /* {len(words)} entries */\n"
            + "".join(f"    {r},  // row {k}\n" for k, r in enumerate(rows))
            + "};\n")


def _render_source(tables):
    """A DCSDecoderNative.cpp that holds each table under the name the
    extractor looks for, with hex literals, comments and code between, and
    the two trees both named huffTree, the 1994+ one first."""
    names = [("overlapCoefficients", "overlap_coeff"),
             ("bitRev9", "bitrev9"), ("ifftCoefficients", "ifft_coeff"),
             ("huffTree", "hufftree94"), ("preAdjMap0", "preadj0"),
             ("preAdjMap3", "preadj3"), ("xlatBand02", "xlat02"),
             ("xlatBand35", "xlat35"), ("xlatBand6F", "xlat6f"),
             ("outputCountTab", "band_output_count"),
             ("maxBitWidthTab", "max_bit_width")]
    names += [(f"codebook{i}", f"codebook{i}") for i in range(1, 7)]
    names += [("scalingFactorTable", "scale_mantissa"),
              ("huffTree", "hufftree93"),
              ("os93a_type1_samplePairTable", "os93a_pair_table"),
              ("inputsPerBand", "os93a_inputs_per_band"),
              ("bandBitsCodebooks", "os93a_band_bits_codebooks"),
              ("scaleCodebook", "os93a_scale_codebook")]
    parts = ["// synthetic decoder source\n#include <stdint.h>\n"]
    for k, (cname, key) in enumerate(names):
        vals = [int(v) for v in np.asarray(tables[key]).reshape(-1)]
        parts.append(_c_array(cname, vals, hexa=k % 2 == 0))
        parts.append(f"void step{k}(int *p) {{ if (p) {{ *p += {k}; }} }}\n")
    assert len(parts) == 1 + 2 * len(names)
    return "".join(parts)


def test_extract_equals_the_jax_extractor_on_a_rendered_source(tmp_path):
    npz = np.load(NPZ)
    tables = {k: npz[k] for k in npz.files}
    src = tmp_path / textract.REF_NATIVE
    src.parent.mkdir(parents=True)
    src.write_text(_render_source(tables))
    got = textract.extract(str(tmp_path))
    want = jextract.extract(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(tables)
    for k in tables:
        assert got[k].dtype == want[k].dtype == tables[k].dtype, k
        assert got[k].shape == want[k].shape == tables[k].shape, k
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(got[k], tables[k]), k
    out = tmp_path / "out.npz"
    textract.main([str(tmp_path), str(out)])
    again = np.load(out)
    assert sorted(again.files) == sorted(tables)
    assert all(np.array_equal(again[k], tables[k]) for k in tables)


def test_extract_without_the_reference_writes_nothing(tmp_path):
    missing = tmp_path / "no_reference"
    out = tmp_path / "out.npz"
    with pytest.raises(FileNotFoundError) as e:
        textract.main([str(missing), str(out)])
    assert os.path.join(str(missing), textract.REF_NATIVE) in str(e.value)
    assert not out.exists()
    # the reference root has no default: no argument is a usage error that
    # leaves the committed tables as they are
    with open(NPZ, "rb") as f:
        before = os.stat(NPZ).st_mtime_ns, f.read()
    with pytest.raises(SystemExit) as e:
        textract.main([])
    assert str(e.value) == textract.USAGE
    with open(NPZ, "rb") as f:
        assert (os.stat(NPZ).st_mtime_ns, f.read()) == before


@pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_ROOT, textract.REF_NATIVE)),
    reason="reference tree not available")
def test_the_real_extraction_equals_the_ports_npz():
    fresh = textract.extract(REF_ROOT)
    committed = np.load(NPZ)
    assert sorted(fresh) == sorted(committed.files)
    for k in fresh:
        assert np.array_equal(fresh[k], committed[k]), k
