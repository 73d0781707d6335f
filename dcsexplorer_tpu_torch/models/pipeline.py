"""Session decode pipeline: host VM control + device numerics.

Counterpart of ``dcsexplorer_tpu/models/pipeline.py``.  The branchy runtime
(track byte-code VM, command queue, mixer fades, volume) runs on the host as
a control tracer that skips all per-sample math and emits per-frame control
vectors: which bank row plays on which channel at what mixing multiplier,
plus the global volume shift.  The device then runs the numerics for all
frames at once:

1994+ family (OS94, OS95):
    bank (once per ROM):  decode94_bank -> scaled rows [R, 256]
    per session batch:    session_mix94 (the channels' multi-voice
                          dequant/mix) -> transform94_pcm (with a carried
                          overlap state where the caller gives one) -> PCM
1993 family (OS93a, OS93b; ``device_decode93`` of the reference):
    bank (once per ROM):  the streams' bytes and their prescan index as the
                          bank columns of ops/decode93.py, then
                          decode93_bank -> each row's words that do not
                          depend on the mix [R, 160] (the session bank)
    per session batch:    decode93_pcm's session instance (each frame's
                          voices mixed from the session bank in channel
                          order, then the transform and overlap resolve,
                          with a carried state likewise) -> PCM

``StreamBank`` holds every stream a ROM's tracks play (row 0 silent);
``SessionDecoder`` and ``SessionDecoder93`` are the device halves as
``nn.Module``s whose buffers are the codec tables and the bank, and
``session_decoder`` picks one by the bank's family.  On CUDA tensors each
stage is a hand-written kernel (``ops/kernels.py``); on CPU tensors their
plain PyTorch versions run.  The entry points run on the card unless the
caller names another device.  Bit-exact with the JAX
reference and the scalar decoder.
"""

import numpy as np
import torch
from torch import nn

from ..ops import band_decode as bd
from ..ops import decode93, decode93a, prescan
from ..ops import transform as tf
from ..refdec import decoder as rd
from ..vm.tracer import ControlTracer
from . import catalogsweep as cs
from . import flatsweep as fs
from .flatsweep import _device, codec_tables


def _prescan(os_version, mem, pos):
    """The index of the stream at mem[pos] and its row kind (True for
    OS93a Type-1), with the walker of the ROM's family."""
    if os_version == rd.OS93A and (int(mem[pos + 2]) & 0x80) != 0:
        return decode93a.prescan93a(mem, pos), True
    if os_version in (rd.OS93A, rd.OS93B):
        return decode93.prescan93(mem, pos), False
    return prescan.prescan94(mem, pos), False


class StreamBank:
    """Prescanned streams, one row per stream frame, indexed by
    ``offsets[key] + frame`` (row 0 is the silent dummy).  A 1994+ bank
    decodes every row into ``scaled`` [R, 256] (u16 storage in int16); a
    1993 bank decodes from the bitstream and its index, the bank columns
    ``cols`` (ops/decode93.py, kept on the host), ``bank93``, the session
    bank (decode93.decode93_bank_plain), which the session decode
    mixes."""

    def __init__(self, os_version):
        self.os_version = os_version
        self.family93 = os_version in (rd.OS93A, rd.OS93B)
        self.keys = {}
        self._streams = []

    def add(self, mem, pos=0):
        """Register the stream whose header starts at ``mem[pos]``; returns
        its key (id(mem), pos)."""
        key = (id(mem), pos)
        if key in self.keys:
            return key
        idx, t1 = _prescan(self.os_version, mem, pos)
        if getattr(idx, "error_frame", -1) >= 0:
            raise ValueError(f"stream error at frame {idx.error_frame}")
        self.keys[key] = len(self._streams)
        self._streams.append((idx, mem, pos, t1))
        return key

    def _set_offsets(self):
        """Each stream's first row (key -> row), in the order of
        registration after the silent row 0."""
        self.offsets, total = {}, 1
        for key, si in self.keys.items():
            self.offsets[key] = total
            total += self._streams[si][0].n_frames

    def columns(self):
        """The bank's compact decode columns (numpy): those of
        flatsweep.decode_columns94 over the streams that have frames
        (pool_u8, sid, start_bit, bt_u8, hdr_tab, fmt_tab, sub_tab,
        n_steps); row r + 1 decodes frame r.  Sets ``offsets``."""
        played = [st for st in self._streams if st[0].n_frames]
        cols = fs.decode_columns94([m for _, m, _, _ in played],
                                   [i for i, _, _, _ in played],
                                   [p for _, _, p, _ in played])
        cols["sid"] = cols["sid"].astype(np.int32)
        cols["bt_u8"] = fs.narrow_band_types(cols.pop("bt"))
        self._set_offsets()
        return cols

    def columns93(self):
        """A 1993 bank's columns (numpy; ops/decode93.py's layout, row 0
        silent): those of catalogsweep.pool_columns93 over each stream's
        bytes up to 12 past its last frame's end byte, one row a stream
        frame, and band_tab, each stream's 93 band layout (zeros for OS93a
        Type-1).  Sets ``offsets``."""
        streams = self._streams
        bodies = []
        for idx, mem, pos, _ in streams:
            end = int(idx.end_bit[-1] // 8) + 12 if idx.n_frames else pos + 22
            bodies.append(bytes(mem[pos:end]))
        pool, cols, tabs = cs.pool_columns93(
            bodies, [st[0] for st in streams], [st[3] for st in streams],
            [st[2] for st in streams])
        z = cs.rows93(dict(frame_word=np.zeros(1), bit_rel=np.zeros((1, 16)),
                           kw=np.zeros((1, 16)), prv_in=np.zeros((1, 16)),
                           prv_dl=np.zeros((1, 16))), False)
        z["kind_u8"][:] = decode93.ROW_SILENT
        parts = [dict(z, sid=np.zeros(1, np.int32))]
        for si, ((idx, _, _, t1), c) in enumerate(zip(streams, cols)):
            parts.append(dict(cs.rows93(c, t1),
                              sid=np.full(idx.n_frames, si, np.int32)))
        out = {k: np.concatenate([c[k] for c in parts]) for k in parts[0]}
        out["pool_u8"] = pool
        out["band_tab"] = (np.stack([np.zeros((16, 8), np.int32) if t is None
                                     else cs.band_table(t) for t in tabs])
                           if tabs else np.zeros((1, 16, 8), np.int32))
        self._set_offsets()
        return out

    def decode_all(self, device="cuda"):
        """Build the bank on ``device`` (the card unless given).  1994+:
        decode every registered stream into ``scaled`` [R, 256], one
        decode94_bank launch on a card.  1993: decode the session bank
        ``bank93`` from the bank columns, one decode93_bank launch on a
        card; the columns stay on the host as ``cols`` (CPU tensors), and
        the card keeps only the session bank.  The bank stays on the
        device."""
        dev = _device(device)
        self.device = dev
        if self.family93:
            self.cols = {k: torch.tensor(np.ascontiguousarray(v))
                         for k, v in self.columns93().items()}
            tabs = {k: t.to(dev) for k, t in cs.codec_tables93().items()}
            self.bank93 = decode93.decode93_bank(
                {k: v.to(dev) for k, v in self.cols.items()}, tabs)
            return self
        cols = self.columns()
        n_steps = cols.pop("n_steps")
        args = {k: torch.tensor(v, device=dev) for k, v in cols.items()}
        tabs = {k: t.to(dev) for k, t in codec_tables().items()}
        self.scaled = bd.decode94_bank(**args, n_steps=n_steps, tabs=tabs)
        return self

    def total_rows(self):
        """Number of rows (incl. the silent dummy row 0)."""
        return 1 + sum(
            self._streams[si][0].n_frames for si in self.keys.values())


class SessionDecoder(nn.Module):
    """The device half of the session path.  Buffers: the codec tables
    (codec_tables) and the bank's rows (``scaled``), on ``device`` (the
    bank's unless given)."""

    def __init__(self, bank, device=None):
        super().__init__()
        dev = bank.device if device is None else _device(device)
        for name, t in codec_tables().items():
            self.register_buffer(name, t.to(dev))
        self.register_buffer("scaled", bank.scaled.to(dev))

    def forward(self, rows, mix, vol_shift, sid, overlap0=None):
        """rows/mix [F, C] int32 (bank row and mixing multiplier per frame
        and channel), vol_shift [F] int32, sid [F] int32 (each frame's
        session; one run of frames each), overlap0 [G, 16] int32 carried
        state per session, or None for a zero state.  Returns pcm [F, 240]
        without overlap0, (pcm, last_ov [G, 16]) with it; int32, u16
        storage."""
        fb = bd.session_mix94(self.scaled, rows, mix)
        return tf.transform94_pcm(fb, vol_shift, sid,
                                  dict(self.named_buffers()), overlap0)


class SessionDecoder93(nn.Module):
    """The device half of the 1993 session path (the reference's
    ``device_decode93``).  Buffers: the bank's session bank (``words93``,
    ``kind93``) and the codec tables of codec_tables93, on ``device`` (the
    bank's unless given); every row is in the session bank, so the
    bitstream stays with the bank."""

    def __init__(self, bank, device=None):
        super().__init__()
        dev = bank.device if device is None else _device(device)
        for name, t in list(bank.bank93.items()) + list(
                cs.codec_tables93().items()):
            self.register_buffer(name, t.to(dev))

    def forward(self, rows, mix, vol_shift, sid, overlap0=None):
        """As SessionDecoder.forward: rows/mix [F, C], vol_shift [F], sid
        [F], overlap0 [G, 16] or None.  Each frame starts from silence and
        mixes its voices' session-bank rows in channel order."""
        bufs = dict(self.named_buffers())
        return decode93.session93_pcm(bufs, rows, mix, vol_shift, sid, bufs,
                                      overlap0)


def session_decoder(bank, device=None):
    """The session decoder of the bank's family, on ``device`` (the
    bank's unless given)."""
    cls = SessionDecoder93 if bank.family93 else SessionDecoder
    return cls(bank, device)


def assemble_controls(tracer: ControlTracer, bank: StreamBank):
    """Convert the VM trace into dense control arrays.

    Returns (rows [T, 8] bank row per channel (0 = silent),
             mix [T, 8], vol_shift [T]), int32 numpy."""
    T_ = len(tracer.trace_vol_shift)
    rows = np.zeros((T_, rd.MAX_CHANNELS), dtype=np.int32)
    mix = np.zeros((T_, rd.MAX_CHANNELS), dtype=np.int32)
    for t, entries in enumerate(tracer.trace_entries):
        for (c, key, fidx, m) in entries:
            rows[t, c] = bank.offsets[key] + fidx
            mix[t, c] = m
    vol = np.asarray(tracer.trace_vol_shift, dtype=np.int32)
    return rows, mix, vol


def device_decode(decoder, rows, mix, vol_shift, overlap0=None):
    """Decode T frames of one session on the decoder's device; bit-exact
    with the scalar decoder.

    decoder: a session_decoder; rows/mix [T, C] (C <= 8), vol_shift [T],
    overlap0 [16] carried state (zeros when None); numpy or tensors.
    Returns (pcm [T, 240], last_ov [16]) int32 tensors, u16 storage."""
    dev = next(decoder.buffers()).device
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    rows, mix, vol_shift = as_t(rows), as_t(mix), as_t(vol_shift)
    ov = (torch.zeros((1, 16), dtype=torch.int32, device=dev)
          if overlap0 is None else as_t(overlap0).reshape(1, 16))
    sid = torch.zeros(rows.shape[0], dtype=torch.int32, device=dev)
    pcm, last_ov = decoder(rows, mix, vol_shift, sid, ov)
    return pcm, last_ov[0]


def to_int16(pcm):
    """u16-storage words (int32, 0..$FFFF) -> int16 PCM, on the words'
    device, in one pass: the narrowing cast keeps the low 16 bits (two's
    complement), which is the signed sample."""
    return pcm.to(torch.int16)


def decode_standalone(streams, os_version=rd.OS94, default_volume=0x67,
                      n_frames=None, events=None, device="cuda"):
    """End-to-end standalone decode on ``device`` (the card unless given).

    streams: list of (mem, channel, mixing_level) loaded at frame 0.
    Returns int16 PCM [n_frames * 240] (numpy)."""
    bank = StreamBank(os_version)
    for (mem, _, _) in streams:
        bank.add(mem, 0)
    bank.decode_all(device)

    tracer = ControlTracer()
    tracer.default_volume = default_volume
    tracer.init_standalone(os_version)
    tracer.soft_boot()
    for (mem, ch, lvl) in streams:
        tracer.load_audio_stream(ch, mem, mixing_level=lvl)
    if n_frames is None:
        n_frames = 4 + max(_prescan(os_version, mem, 0)[0].n_frames
                           for (mem, _, _) in streams)
    tracer.trace_frames(n_frames, events=events)

    rows, mix, vol = assemble_controls(tracer, bank)
    pcm, _ = device_decode(session_decoder(bank), rows, mix, vol)
    return to_int16(pcm).reshape(-1).cpu().numpy()
