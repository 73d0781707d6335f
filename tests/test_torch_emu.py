"""The port's ADSP-2105 emulator (dcsexplorer_tpu_torch/emu/: adsp2105,
native_cpu, board, speedup, debugger), its registry entries and the
explorer's emulator backends, against the JAX package's, on the CPU.

ROMs are built by the port's romgen (compiler/romgen.py), as
tests/test_emu_decode.py builds its own: firmware94 on both board maps
(OS94, DCS-95), firmware93 in its 93b and 93a variants, and a stream that
spills onto U3 on both maps.  On each, the port's EmulatedDecoder equals
the JAX one in every PCM sample and every data-port byte: the native core
strict and fast (emulator-fast), and the Python core on a short track.
Also: speedup's detection and region handlers, a failed native build that
raises instead of falling back to the Python core, the registry, the
explorer's --backend emulator-* commands, and the debugger."""

import io
import os

import numpy as np
import pytest

from dcsexplorer_tpu.compiler import romgen as jromgen
from dcsexplorer_tpu.emu import speedup as jspeedup
from dcsexplorer_tpu.emu.adsp2105 import ADSP2105 as JADSP
from dcsexplorer_tpu.emu.board import EmulatedDecoder as JEmu
from dcsexplorer_tpu.emu.debugger import Debugger as JDebugger
from dcsexplorer_tpu.refdec import registry as jregistry
from dcsexplorer_tpu.rom import zipload as jzipload
from dcsexplorer_tpu.tools import explorer as jx
from dcsexplorer_tpu_torch import native as tnative
from dcsexplorer_tpu_torch.compiler import romgen as tromgen
from dcsexplorer_tpu_torch.emu import speedup as tspeedup
from dcsexplorer_tpu_torch.emu.adsp2105 import ADSP2105 as TADSP
from dcsexplorer_tpu_torch.emu.board import EmulatedDecoder as TEmu
from dcsexplorer_tpu_torch.emu.debugger import Debugger as TDebugger
from dcsexplorer_tpu_torch.emu.native_cpu import make_native_cpu
from dcsexplorer_tpu_torch.encoder.encoder import (CompressionParams,
                                                   encode_pcm)
from dcsexplorer_tpu_torch.format import tables as T
from dcsexplorer_tpu_torch.refdec import decoder as rd
from dcsexplorer_tpu_torch.refdec import registry as tregistry
from dcsexplorer_tpu_torch.rom import tracks as rtracks
from dcsexplorer_tpu_torch.rom import zipload as tzipload
from dcsexplorer_tpu_torch.tools import explorer as tx

from .test_debugger import _program
from .test_format93 import build_stream93a_type1
from .test_romgen import _make_spec
from .torch_native_guard import reference_native_lib


@pytest.fixture(scope="module", autouse=True)
def reference_lib():
    return reference_native_lib()


def _music(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    pcm = (7000 * np.sin(2 * np.pi * 330 * t / 31250)
           + 3000 * np.sin(2 * np.pi * 990 * t / 31250)
           * np.sin(2 * np.pi * 3 * t / 31250) + rng.normal(0, 500, n))
    return pcm.astype(np.float32)


def _streams(kind):
    """The streams of a ROM kind, encoded once by the port's host encoder."""
    if kind.startswith("u3"):
        rng = np.random.default_rng(6)
        s, _ = encode_pcm((rng.standard_normal(240 * 30) * 8000)
                          .astype(np.int16))
        return {"pad": bytes(bytearray([0, 1, 0x80, 0x80, 0x80])
                             + bytearray(0x14000)), "s": bytes(s)}
    osv = ROMS[kind]
    enc_os = osv if osv in (rd.OS93A, rd.OS93B) else None
    s1, _ = encode_pcm(_music(2400, 1), os_version=enc_os)
    if osv == rd.OS93A:
        s2 = build_stream93a_type1(n_frames=12, n_bands=12, selector=2,
                                   seed=9)
    else:
        s2, _ = encode_pcm(_music(1700, 2),
                           CompressionParams(stream_format_type=1),
                           os_version=enc_os)
    return {"s1": bytes(s1), "s2": bytes(s2)}


def _spec(g, kind, streams):
    """tests/test_emu_decode.py's ROM specs, for romgen module g."""
    osv = ROMS[kind]
    if kind.startswith("u3"):
        spec = g.RomSpec(os_version=osv, num_channels=6, chip_size=0x20000)
        spec.streams = dict(streams)
        spec.tracks = [
            g.TrackSpec(0, steps=[g.op_end()]),
            g.TrackSpec(1, channel=0, steps=[
                g.op_mix(0, 0, 0x64), g.op_play(0, "s", repeat=1),
                g.op_wait_forever()])]
        return spec
    spec = g.RomSpec(os_version=osv, num_channels=6)
    spec.streams = dict(streams)
    spec.tracks = [
        g.TrackSpec(0, steps=[g.op_end()]),
        g.TrackSpec(1, channel=0, steps=[
            g.op_mix(0, 0, 0x64), g.op_play(0, "s1", repeat=1),
            g.op_wait_forever()]),
        g.TrackSpec(2, channel=1, steps=[
            g.op_mix(0, 1, 0x55), g.op_mix_fade(1, 1, 0x18, 60, delay=2),
            g.op_play(1, "s2", repeat=2, delay=1), g.op_wait_forever()]),
    ]
    if osv == rd.OS93A:
        spec.tracks[1] = g.TrackSpec(1, channel=0, steps=[
            g.op_mix(0, 0, 0x64), g.op_play(0, "s1", repeat=1),
            g.op_write_port93a(0x42, counter=5, delay=1),
            g.op_wait_forever()])
    return spec


ROMS = {"os94": rd.OS94, "os95": rd.OS95, "os93b": rd.OS93B,
        "os93a": rd.OS93A, "u3_os94": rd.OS94, "u3_os95": rd.OS95}
SCRIPT = {0: [0x00, 0x01], 720: [0x00, 0x02],
          1680: [0x55, 0xAA, 0x70, 0x8F], 2880: [0x55, 0xAC, 0x60, 0x9F]}
_CACHE = {}


def _roms(kind):
    """(port RomSet, JAX RomSet) of the port romgen's zip, which must equal
    the JAX romgen's image for image."""
    if kind not in _CACHE:
        streams = _streams(kind)
        data = tromgen.RomBuilder(_spec(tromgen, kind, streams)).build_zip()
        jdata = jromgen.RomBuilder(_spec(jromgen, kind, streams)).build_zip()
        rs, _ = tzipload.load_zip_data(data)
        jrs, _ = jzipload.load_zip_data(jdata)
        assert [bytes(c) if c is not None else None for c in rs.chips] == \
            [bytes(c) if c is not None else None for c in jrs.chips]
        assert rs.check() == jrs.check() == 1 and rs.os_version == ROMS[kind]
        if kind.startswith("u3"):
            shift = 21 if ROMS[kind] == rd.OS95 else 20
            assert any((a >> shift) & 7
                       for a in rtracks.list_streams(rs, rs.os_version))
        _CACHE[kind] = rs, jrs
    return _CACHE[kind]


def _boot(cls, rs, **kw):
    dec = cls(**kw)
    dec.load_rom_set(rs)
    dec.default_volume = 0xCC
    dec.soft_boot()
    assert dec.state == rd.ST_RUNNING, dec.error_message
    return dec


def _drive(dec, script, n_frames):
    """The decoder's n_frames x 240 samples, with script's port bytes
    written before the sample they are keyed by."""
    out = []
    for k in range(n_frames * 240):
        for b in script.get(k, ()):
            dec.write_data_port(b)
        out.append(dec.get_next_sample())
    return out


@pytest.mark.parametrize("kind", list(ROMS))
def test_native_core_equals_the_jax_emulator(kind):
    rs, jrs = _roms(kind)
    n = 8 if kind.startswith("u3") else 16
    script = {0: [0x00, 0x01]} if kind.startswith("u3") else SCRIPT
    want = _drive(_boot(JEmu, jrs), script, n)
    jfast = _boot(JEmu, jrs, enable_speedup=True)
    strict = _boot(TEmu, rs)
    fast = _boot(TEmu, rs, enable_speedup=True)
    assert strict.native_cpu and fast.native_cpu
    assert strict.hw_version == (3 if ROMS[kind] == rd.OS95 else 2)
    got_s, got_f = _drive(strict, script, n), _drive(fast, script, n)
    assert any(want), "the JAX emulator played silence"
    assert got_s == want and got_f == want == _drive(jfast, script, n)
    assert strict.host.rx == fast.host.rx == jfast.host.rx
    # speedup's detection found the same region in both packages
    (si, ji) = fast.speedup_info, jfast.speedup_info
    assert (si.kind, si.entry, si.exit, si.geom) == \
        (ji.kind, ji.entry, ji.exit, ji.geom)
    assert si.kind == (tspeedup.KIND_SYNTH93 if ROMS[kind] in (
        rd.OS93A, rd.OS93B) else tspeedup.KIND_SYNTH94)
    pm = list(strict.cpu.pm)
    assert repr(tspeedup.detect(pm)) == repr(jspeedup.detect(pm))


@pytest.mark.parametrize("kind,fast", [("os94", False), ("os94", True),
                                       ("os93b", False)])
def test_python_core_equals_the_jax_emulator(kind, fast):
    rs, jrs = _roms(kind)
    got = _boot(TEmu, rs, use_native=False, enable_speedup=fast)
    want = _boot(JEmu, jrs, use_native=False, enable_speedup=fast)
    assert not got.native_cpu and not want.native_cpu
    script = {0: [0x00, 0x01], 240: [0x55, 0xC2]}
    pcm = _drive(got, script, 3)
    assert pcm == _drive(want, script, 3) and any(pcm)
    assert got.host.rx == want.host.rx
    assert got.cpu.state_vec() == want.cpu.state_vec()


def test_os95_version_query_port():
    rs, jrs = _roms("os95")
    decs = [_boot(TEmu, rs), _boot(JEmu, jrs)]
    for dec in decs:
        for b in (0x55, 0xC2, 0x55, 0xC3):
            dec.write_data_port(b)
        _drive(dec, {}, 2)
    assert bytes(decs[0].host.rx) == bytes(decs[1].host.rx) == b"\x01\x06"


@pytest.mark.parametrize("kind,seed", [
    (tspeedup.KIND_SYNTH94, 3), (tspeedup.KIND_SYNTH93, 5),
    (tspeedup.KIND_ORIG94, 7), (tspeedup.KIND_ORIG93, 9)])
def test_speedup_region_handlers(kind, seed):
    """Each region's Python handler equals the JAX package's and the port's
    native accelerator (adsp2105.cpp accelRun) on a random DM/PM state."""
    rng = np.random.default_rng(seed)
    coeff = [int(v) & 0xFFFF for v in T.IFFT_COEFF]
    dm, pm = [0] * 0x4000, [0] * 0x4000
    rand = lambda n: [int(x) for x in rng.integers(0, 0x10000, n)]
    if kind in (tspeedup.KIND_SYNTH94, tspeedup.KIND_SYNTH93):
        fb, vsa, ts, tc, tb = 0x40, 0x700, 0x400, 0x480, 0x500
        dm[ts:ts + 128], dm[tc:tc + 128] = coeff[:128], coeff[128:]
        dm[tb:tb + 256] = [int(v) for v in T.BITREV9[:256]]
        dm[fb:fb + 0x200] = rand(0x200)
        dm[vsa] = int(rng.integers(0, 4))
        geom = [fb, vsa, ts, tc, tb]
        name = ("apply_synth94" if kind == tspeedup.KIND_SYNTH94
                else "apply_synth93")
        outs = []
        for mod in (tspeedup, jspeedup):
            d = list(dm)
            getattr(mod, name)(d, geom)
            outs.append(d)
    elif kind == tspeedup.KIND_ORIG94:
        ram1, ram2, va = 0x1000, 0x2000, 0x1390
        dm[ram1:ram1 + 0x100] = coeff
        dm[ram2:ram2 + 0x100] = rand(0x100)
        dm[va] = rand(1)[0]
        geom = [ram1, ram2, va]
        outs = []
        for mod in (tspeedup, jspeedup):
            d = list(dm)
            mod.apply_orig94(d, geom)
            outs.append(d)
    else:
        fb, va, ps, pcs = 0x3800, 0x1390, 0x1700, 0x1780
        for k in range(128):
            pm[ps + k] = (coeff[k] << 8) | int(rng.integers(0, 256))
            pm[pcs + k] = (coeff[128 + k] << 8) | int(rng.integers(0, 256))
        dm[fb:fb + 0x200] = rand(0x200)
        dm[va] = rand(1)[0]
        geom = [fb, va, ps, pcs]
        outs = []
        for mod in (tspeedup, jspeedup):
            d = list(dm)
            mod.apply_orig93(d, pm, geom)
            outs.append(d)
    cpu = make_native_cpu()
    cpu.dm, cpu.pm = dm, pm
    cpu.accel_run(kind, geom)
    assert outs[0] == outs[1] == cpu.dm[0:0x4000]
    assert outs[0] != dm


def test_speedup_detects_the_original_rom_signatures():
    cases = []
    for sig, at, mem in ((0x2B41, 0x43, 0x1234), (0x00E4, 0x43, 0x0391)):
        pm = [0] * 0x4000
        pm[sig:sig + 3] = [0x000000, 0x0C0080, 0x0C2000]
        pm[sig + at] = 0x800000 | (mem << 4) | 4
        cases.append(pm)
    pm = [0] * 0x4000
    pm[0xE4:0xE7] = [0x378FE1, 0x379002, 0x379FE3]
    pm[0xE4 + 0x4C] = 0x800000 | (0x2345 << 4) | 4
    cases.append(pm)
    cases.append([0x0D02A3] * 0x200 + [0] * 0x3E00)
    got = [repr(tspeedup.detect(pm)) for pm in cases]
    assert got == [repr(jspeedup.detect(pm)) for pm in cases]
    assert got[-1] == "None" and "kind=3" in got[0] and "kind=4" in got[2]


def test_a_failed_native_build_raises_and_does_not_fall_back(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed (1):\nsimulated")

    rs, _ = _roms("os94")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build", broken)
    for make in (TEmu, lambda: TEmu(use_native=True),
                 lambda: TEmu(enable_speedup=True),
                 lambda: tregistry.create("emulator-strict"),
                 lambda: tregistry.create("emulator-f"), make_native_cpu):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            make()
    # the Python core is a choice, never a fallback
    dec = _boot(TEmu, rs, use_native=False)
    assert not dec.native_cpu and isinstance(dec.cpu, TADSP)


def test_registry_equals_the_jax_registry():
    def listing(reg):
        return [(r.name, r.description) for r in reg.registrations()]

    assert listing(tregistry) == listing(jregistry)
    assert [r for r, _ in listing(tregistry)] == [
        "emulator-fast", "emulator-strict", "native"]
    for prefix in ("nat", "NATIVE", "EMULATOR-STRICT", "emulator-s",
                   "emulator-f", "emulator-fast"):
        assert tregistry.resolve(prefix).name == \
            jregistry.resolve(prefix).name
    for prefix, err in (("gpu", KeyError),
                        ("e", tregistry.AmbiguousBackendError)):
        with pytest.raises(err):
            tregistry.resolve(prefix)
    assert type(tregistry.create("nat")).__name__ == "ReferenceDecoder"
    strict = tregistry.create("emulator-st")
    fast = tregistry.create("emulator-f")
    assert isinstance(strict, TEmu) and not strict.enable_speedup
    assert isinstance(fast, TEmu) and fast.enable_speedup


@pytest.fixture(scope="module")
def synth_zip(tmp_path_factory):
    path = tmp_path_factory.mktemp("rom") / "synth.zip"
    path.write_bytes(tromgen.RomBuilder(_make_spec()).build_zip())
    return str(path)


def _cli(cli, argv, capsys):
    rc = cli.main(argv)
    out, _ = capsys.readouterr()
    return rc, out


@pytest.mark.parametrize("backend", ["emulator-strict", "emulator-f"])
def test_explorer_extracts_tracks_as_the_jax_cli(synth_zip, backend,
                                                 tmp_path, capsys):
    got = {}
    for name, cli in (("jax", jx), ("port", tx)):
        d = tmp_path / name
        d.mkdir()
        rc, out = _cli(cli, [synth_zip, "--backend", backend,
                             "--extract-tracks", str(d / "t"),
                             "--max-track-frames", "60"], capsys)
        assert rc == 0
        got[name] = (out.replace(str(d), "D"),
                     {n: (d / n).read_bytes() for n in sorted(os.listdir(d))})
    assert got["port"] == got["jax"]
    assert "track $0001" in got["port"][0] and len(got["port"][1]) == 3


def test_explorer_interactive_on_the_emulator(synth_zip, tmp_path,
                                              monkeypatch, capsys):
    outs = []
    for cli, name in ((jx, "j.wav"), (tx, "t.wav")):
        monkeypatch.setattr("sys.stdin", io.StringIO("0001\nv80\n0002\nq\n"))
        rc, out = _cli(cli, [synth_zip, "--interactive",
                             str(tmp_path / name), "--backend", "emulator-s",
                             "--seconds-per-command", "0.1"], capsys)
        assert rc == 0
        outs.append((out.replace(name, "X"), (tmp_path / name).read_bytes()))
    assert outs[0] == outs[1] and "track $0002" in outs[1][0]


def test_explorer_backend_list(synth_zip, capsys):
    rc, want = _cli(jx, [synth_zip, "--backend", "?"], capsys)
    assert rc == 0
    rc, got = _cli(tx, [synth_zip, "--backend", "?"], capsys)
    assert rc == 0
    want = want.replace(f"    {'tpu':<16} batched TPU device pipeline",
                        f"    {'cuda':<16} batched CUDA device pipeline")
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 5


def _program_on(cpu):
    for k, w in enumerate(_program().pm[:8]):
        cpu.pm[k] = w
    return cpu


def test_debugger_equals_the_jax_debugger():
    outs = []
    for adsp, dbg_cls in ((TADSP, TDebugger), (JADSP, JDebugger)):
        cpu = adsp()
        cpu.reset()
        dbg = dbg_cls(_program_on(cpu))
        rec = [dbg.disasm(0, count=8), dbg.regs()]
        rec.append(dbg.step(1))
        rec.append(dbg.step_over())
        rec.append(dbg.step_over())
        rec += [dbg.cpu.pc, dbg.cpu.core.ar, dbg.regs()]
        dbg.cpu.dm[0x100] = 0xBEEF
        rec += [dbg.dump_dm(0x100, 8), dbg.dump_pm(4, 1)]
        cpu2 = adsp()
        cpu2.reset()
        dbg2 = dbg_cls(_program_on(cpu2))
        dbg2.set_bp(6)
        rec += [dbg2.cont(), dbg2.cpu.pc, dbg2.cont()]
        cpu3 = adsp()
        cpu3.reset()
        cmds = iter(["s", "r", "b 6", "g", "u 0", "dm 0 8", "bl", "n", "q"])
        lines = []
        dbg_cls(_program_on(cpu3)).repl(input_fn=lambda _: next(cmds),
                                        print_fn=lines.append)
        rec.append(lines)
        outs.append(rec)
    assert outs[0] == outs[1]
    assert "CNTR" in outs[0][0] and "*" in outs[0][0]
    assert outs[0][-4][1] == "breakpoint" and outs[0][-3] == 6
    assert outs[0][-2][1] == "trap"
    assert "breakpoint" in "\n".join(outs[0][-1])
