"""Audio container IO: WAV read/write and the raw `.dcs` stream container.

WAV: minimal RIFF PCM (the 44-byte header form the reference's extractors
emit, DCSExplorer.cpp:1670-1739).  Raw .dcs: the "DCSa" interchange container
(format spec: reference DCSExplorer/README.md:274-297).

The port's copy of ``dcsexplorer_tpu/utils/audioio.py``: WAV, the raw
stream container, and the FLAC, MP3 and Ogg Vorbis readers over the port's
native decoders (native/src/flac.cpp, mp3.cpp, vorbis.cpp), which raise
when the native runtime does not build."""

import struct

import numpy as np

from ..refdec.decoder import OS93A, OS93B, OS94, OS95

DCS_SAMPLE_RATE = 31250

_OS_TO_FMTVER = {OS93A: 0x9301, OS93B: 0x9302, OS94: 0x9400, OS95: 0x9400}
_FMTVER_TO_OS = {0x9301: OS93A, 0x9302: OS93B, 0x9400: OS94}


def write_wav(path, pcm, sample_rate=DCS_SAMPLE_RATE):
    """Write mono int16 PCM as a 44-byte-header RIFF WAV."""
    pcm = np.asarray(pcm, dtype="<i2")
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def read_wav(path_or_bytes):
    """Read a PCM WAV (8/16/24/32-bit int or float32); returns
    (float32 mono array in [-1, 1), sample_rate)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF WAV file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, n_ch, rate, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        a = np.frombuffer(pcm, dtype="<f4").astype(np.float32)
    elif audio_fmt in (1, 0xFFFE):
        if bits == 16:
            a = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            a = (np.frombuffer(pcm, dtype=np.uint8).astype(np.float32) - 128) / 128.0
        elif bits == 24:
            raw = np.frombuffer(pcm, dtype=np.uint8).reshape(-1, 3)
            v = (raw[:, 0].astype(np.int32)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            v = (v ^ 0x800000) - 0x800000
            a = v.astype(np.float32) / 8388608.0
        elif bits == 32:
            a = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported WAV bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format {audio_fmt}")
    if n_ch > 1:
        a = a.reshape(-1, n_ch).mean(axis=1)
    return a, rate


def write_dcs_raw(path, stream_bytes, os_version):
    """Write a raw DCS stream in the 'DCSa' interchange container."""
    hdr = b"DCSa" + struct.pack(">HHH", _OS_TO_FMTVER[os_version], 1, DCS_SAMPLE_RATE)
    hdr += b"\x00" * 22
    hdr += struct.pack(">I", len(stream_bytes))
    with open(path, "wb") as f:
        f.write(hdr + bytes(stream_bytes))


def read_dcs_raw(path_or_bytes):
    """Read a 'DCSa' container; returns (stream bytes, os_version)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"DCSa":
        raise ValueError("not a DCSa raw stream file")
    if len(data) < 36:
        raise ValueError(
            f"truncated DCSa container ({len(data)} bytes; 36-byte header "
            "required)")
    fmtver = struct.unpack(">H", data[4:6])[0]
    size = struct.unpack(">I", data[32:36])[0]
    if len(data) < 36 + size:
        raise ValueError(
            f"truncated DCSa container (header declares {size} stream bytes, "
            f"file holds {len(data) - 36})")
    return data[36:36 + size], _FMTVER_TO_OS.get(fmtver, OS94)


def is_dcs_raw(path):
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"DCSa"
    except OSError:
        return False


def _read_bytes(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def read_flac(path_or_bytes):
    """Read a FLAC file via the native decoder (native/src/flac.cpp);
    returns (float32 mono array in [-1, 1), sample_rate).

    Counterpart of the reference's libnyquist input path
    (DCSEncoder/DCSEncodeFile.cpp:6-21)."""
    from .. import native
    samples, rate, bits = native.flac_decode(_read_bytes(path_or_bytes))
    a = samples.astype(np.float32) / float(1 << (bits - 1))
    if a.shape[1] > 1:
        a = a.mean(axis=1)
    return a.reshape(-1), rate


def read_mp3(path_or_bytes):
    """Read an MPEG-1 Layer III file via the from-scratch native decoder
    (native/src/mp3.cpp); returns (float32 mono array in [-1, 1),
    sample_rate).

    Counterpart of the reference's libnyquist/minimp3 input path
    (DCSEncoder/DCSEncodeFile.cpp:55-59)."""
    from .. import native
    samples, rate = native.mp3_decode(_read_bytes(path_or_bytes))
    a = samples.astype(np.float32) / 32768.0
    if a.shape[1] > 1:
        a = a.mean(axis=1)
    return a.reshape(-1), rate


def read_ogg(path_or_bytes):
    """Read an Ogg Vorbis file via the from-scratch native decoder
    (native/src/vorbis.cpp); returns (float32 mono array in [-1, 1),
    sample_rate).

    Counterpart of the reference's libnyquist/libvorbis input path
    (DCSEncoder/DCSEncodeFile.cpp:55-59)."""
    from .. import native
    samples, rate = native.vorbis_decode(_read_bytes(path_or_bytes))
    a = samples.astype(np.float32)
    if a.shape[1] > 1:
        a = a.mean(axis=1)
    return a.reshape(-1), rate


def read_audio(path_or_bytes):
    """Read any supported audio input by magic bytes; returns
    (float32 mono array in [-1, 1), sample_rate).

    Supported: WAV (all common PCM layouts), FLAC, MP3 (MPEG-1
    Layer III, native/src/mp3.cpp), and Ogg Vorbis
    (native/src/vorbis.cpp) — the reference's libnyquist input set."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:4])
    else:
        with open(path_or_bytes, "rb") as f:
            head = f.read(4)
    if head[:4] == b"fLaC":
        return read_flac(path_or_bytes)
    if head[:4] == b"RIFF":
        return read_wav(path_or_bytes)
    if head[:3] == b"ID3" or head[:2] in (b"\xff\xfb", b"\xff\xfa",
                                          b"\xff\xf3", b"\xff\xf2"):
        return read_mp3(path_or_bytes)
    if head[:4] == b"OggS":
        return read_ogg(path_or_bytes)
    raise ValueError(
        "unrecognized audio format (supported: WAV, FLAC, MP3, Ogg)")
