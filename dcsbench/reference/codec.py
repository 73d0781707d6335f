"""The benchmark's plain reference decode, composed from its frozen parts.

Everything here works from the raw inputs (stream bytes, ROM images, the
traffic's commands) and never from anything the program under test made:

- ``standalone_controls`` and ``session_controls`` run the scalar decoder's
  VM (``tracer.ControlTracer``) to get each frame's mixing multipliers,
  volume shift and (for sessions) the stream frame each channel plays;
- ``Bank94`` and ``Bank93`` index streams with the scalar Python walkers
  (``prescan94``, ``decode93``, ``decode93a``) and lay their frames out as
  rows (row 0 silent);
- ``pcm94`` and ``pcm93`` decode rows, mix voices in channel order and
  transform to PCM with the plain frame-parallel PyTorch stages.

PCM is int32 words in u16 storage, [frames, 240].  ``tests/`` holds these
against the scalar decoder (``decoder.ReferenceDecoder``) frame by frame.
"""

import numpy as np
import torch

from . import cache, decode93, decode93a, decode94, prescan94
from . import decoder as rd
from . import tables as T
from . import transform as tf
from .bitreader import PaddedView
from .tracer import ControlTracer


for _cls in (prescan94.StreamIndex, decode93.Stream93Index,
             decode93a.Stream93aIndex):
    cache.register(_cls)


def codec_tables():
    """The 1994+ codec's constant tables as int32 CPU tensors (the
    reference decoder's band maps, codebooks, twiddles and windows)."""
    cb_sizes = [4, 8, 32, 128, 256, 512]
    cb_base = np.zeros(7, np.int64)
    for i in range(2, 7):
        cb_base[i] = cb_base[i - 1] + cb_sizes[i - 2]
    band_group = np.array([0] * 3 + [1] * 3 + [2] * 10)
    xlat = [np.asarray(t) for t in (T.XLAT02, T.XLAT35, T.XLAT6F)]
    br = np.asarray(T.BITREV9, np.int64)
    ifft = np.asarray(T.IFFT_COEFF, np.int64)
    ovl = np.asarray(T.OVERLAP_COEFF, np.int64)
    tabs = {
        "cb_flat": np.concatenate([np.asarray(T.CODEBOOKS[i])
                                   for i in range(1, 7)]),
        "maxw": np.asarray(T.MAX_BIT_WIDTH),
        "cb_base": cb_base,
        "xt_by_band": np.stack([x[:, 0] for x in xlat])[band_group],
        "xa_by_band": np.stack([x[:, 1] for x in xlat])[band_group],
        "preadj": np.stack([np.asarray(T.PREADJ0), np.asarray(T.PREADJ3)]),
        "out_count": np.asarray(T.BAND_OUTPUT_COUNT),
        "scale_mant": np.asarray(T.SCALE_MANTISSA),
        "p2_c0": ifft[br[2 + 4 * np.arange(64)]],
        "p2_c1": ifft[br[4 * np.arange(64)]],
        "sin": ifft[:128],
        "cos": ifft[128:],
        "ovl_new": ovl,
        "ovl_old": ovl[::-1],
        # output k of 240 (and of the 16 overlap words) lives at storage
        # word br[2*(k//2)] + k%2; the planar index of that pair is br >> 1
        "ext_half": br[0:240:2] >> 1,
        "ovl_half": br[0:16:2] >> 1,
        "save_half": br[240:256:2] >> 1,
    }
    return {k: torch.tensor(np.ascontiguousarray(v).astype(np.int32))
            for k, v in tabs.items()}


def codec_tables93():
    """The 1993 family's constant tables as int32 CPU tensors."""
    br = np.asarray(T.BITREV9, np.int64)
    ifft = np.asarray(T.IFFT_COEFF, np.int64)
    ovl = np.asarray(T.OVERLAP_COEFF, np.int64)
    tabs = {"cos": ifft[128:], "sin": ifft[:128], "ovl_new": ovl,
            "ovl_old": ovl[::-1], "br93_half": br[:256] >> 1,
            "pair": decode93a.PAIR, "inputs": decode93a.INPUTS}
    return {k: torch.tensor(np.ascontiguousarray(v).astype(np.int32))
            for k, v in tabs.items()}


def _tables(fn, device):
    return {k: v.to(device) for k, v in fn().items()}


# -- controls: the scalar decoder's VM ---------------------------------

def standalone_controls(stream, os_version, mixing_level, master_volume,
                        n_frames):
    """Per-frame (mix multiplier, volume shift) of a stream played alone on
    channel 0 from the scalar decoder's standalone boot, as int32 numpy
    arrays [n_frames] (mix 0 in a frame where the channel is idle)."""
    tr = ControlTracer()
    tr.default_volume = master_volume
    tr.init_standalone(os_version)
    tr.soft_boot()
    tr.load_audio_stream(0, bytes(stream), mixing_level=mixing_level)
    tr.trace_frames(n_frames)
    mix = np.zeros(n_frames, np.int32)
    for f, entries in enumerate(tr.trace_entries):
        for (ch, _, _, m) in entries:
            if ch == 0:
                mix[f] = m
    return mix, np.asarray(tr.trace_vol_shift, np.int32)


def _event_calls(events):
    """{frame: [port bytes]} -> {frame: callable(decoder)}."""
    return {f: (lambda d, bs=tuple(bs): [d.write_data_port(b) for b in bs])
            for f, bs in events.items()}


def session_controls(rom_set, events, n_frames, n_ch, default_volume):
    """One session's VM trace from a fresh decoder: (plays [T, C] of
    (stream key, frame index) or None, mix [T, C], vol [T]), keys
    (id(chip image), stream position) as ``Bank*.add`` takes them."""
    tr = ControlTracer()
    tr.default_volume = default_volume
    tr.load_rom_set(rom_set)
    tr.soft_boot()
    tr.trace_frames(n_frames, events=_event_calls(events))
    plays = [[None] * n_ch for _ in range(n_frames)]
    mix = np.zeros((n_frames, n_ch), np.int32)
    for t, entries in enumerate(tr.trace_entries):
        for (ch, key, fidx, m) in entries:
            if ch >= n_ch:
                raise ValueError(f"channel {ch} plays; the cell traces "
                                 f"{n_ch}")
            plays[t][ch] = (key, fidx)
            mix[t, ch] = m
    return plays, mix, np.asarray(tr.trace_vol_shift, np.int32)


def chip_images(rom_set):
    """{id(image): image} of a ROM set's chips, the memories session keys
    name."""
    out = {}
    for c in rom_set.chips:
        if c is not None:
            m = c.mem if isinstance(c, PaddedView) else c
            out[id(m)] = m
    return out


# -- banks -----------------------------------------------------------

class _Bank:
    def __init__(self, index_cache=None):
        self.cache = index_cache
        self.first = {}          # key -> first row
        self.n_rows = 1          # row 0 is silent
        self._pool = []
        self._n_pool = 0

    def rows(self, plays, n_ch):
        """plays [T][C] of (key, frame) or None -> rows [T, C] int32."""
        out = np.zeros((len(plays), n_ch), np.int32)
        for t, row in enumerate(plays):
            for c, p in enumerate(row):
                if p is not None:
                    key, f = p
                    out[t, c] = self.first[key] + f
        return out

    def _index(self, walker, mem, pos):
        if self.cache is None:
            return walker(mem, pos)
        return self.cache.index(walker, mem, pos)

    def _append(self, key, raw, n_frames):
        self.first[key] = self.n_rows
        self.n_rows += n_frames
        self._pool.append(raw)
        self._n_pool += len(raw)

    def pool(self, device):
        data = b"".join(self._pool) + b"\xff" * 8
        return torch.tensor(np.frombuffer(data, np.uint8), device=device)


class Bank94(_Bank):
    """1994+ streams as rows of dequantized samples (decode94_bank_plain's
    rows: mix-independent, one a stream frame)."""

    def __init__(self, index_cache=None):
        super().__init__(index_cache)
        self._cols = []
        self._steps = 8

    def add(self, key, mem, pos=0):
        if key in self.first:
            return self.first[key]
        idx = self._index(prescan94.prescan94_python, mem, pos)
        if idx.error_frame >= 0:
            raise ValueError(f"stream error at frame {idx.error_frame}")
        F = idx.n_frames
        end = int(idx.end_bit[-1] // 8 + 8) if F else pos + 18
        raw = bytes(mem[pos:end + 4]) + b"\xff" * 8
        self._cols.append(dict(
            start=(self._n_pool * 8 + idx.start_bit - pos * 8),
            bt=np.asarray(idx.band_type, np.int64), hdr=idx.header,
            fmt=idx.fmt_type, sub=idx.sub_type, n=F))
        if F:
            self._steps = max(self._steps, min(256, (int(
                prescan94.scan_totals(idx).max()) + 7) & ~7))
        self._append(key, raw, F)
        return self.first[key]

    def _columns(self, device):
        cols = self._cols
        as_t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt,
                                          device=device)
        sid = np.repeat(np.arange(len(cols)), [c["n"] for c in cols])
        return dict(
            pool_u8=self.pool(device), sid=as_t(sid, torch.int32),
            start_bit=as_t(np.concatenate([c["start"] for c in cols]),
                           torch.int32),
            bt_u8=as_t(np.concatenate([c["bt"] for c in cols]), torch.uint8),
            hdr_tab=as_t(np.stack([c["hdr"] for c in cols]), torch.uint8),
            fmt_tab=as_t([c["fmt"] for c in cols], torch.uint8),
            sub_tab=as_t([c["sub"] for c in cols], torch.uint8))

    def decode(self, device):
        """scaled [R, 256] int16 rows (row 0 silent) on ``device``."""
        return decode94.decode94_bank_plain(
            **self._columns(device), n_steps=self._steps,
            tabs=_tables(codec_tables, device))

    def row_symbols(self, device):
        """[R] int64: the symbols the decode of each row reads (its
        positions that consume bits; 0 for row 0)."""
        c = self._columns(device)
        header, fmt, sub, bt, btp, _ = decode94.unpack_columns(
            c["sid"], c["bt_u8"], c["hdr_tab"], c["fmt_tab"], c["sub_tab"])
        packed, _, _ = decode94.slot_controls(decode94.band_controls_dyn(
            header, fmt, sub, bt, btp, _tables(codec_tables, device)),
            _tables(codec_tables, device))
        n = (packed != 0).sum(1)
        return torch.cat([n.new_zeros(1), n])


class Bank93(_Bank):
    """1993-family streams (93b / OS93a Type-0 and OS93a Type-1) as rows of
    the plain decodes' per-frame index fields (zeros on rows of the other
    kind; row 0 silent)."""

    def __init__(self, index_cache=None):
        super().__init__(index_cache)
        self._a93, self._a93a, self._nf = [], [], []

    def add(self, key, mem, pos=0, t1=False):
        if key in self.first:
            return self.first[key]
        idx = self._index(decode93a.prescan93a_python if t1
                          else decode93.prescan93_python, mem, pos)
        F = idx.n_frames
        end = int(idx.end_bit[-1] // 8 + 8) if F else pos + 18
        raw = bytes(mem[pos:end + 4]) + b"\xff" * 8
        base = (self._n_pool - pos) * 8
        if t1:
            self._a93a.append(decode93a.index_arrays(idx, base))
            self._a93.append(None)
        else:
            self._a93.append(decode93.index_arrays(idx, base))
            self._a93a.append(None)
        self._nf.append(F)
        self._append(key, raw, F)
        return self.first[key]

    def row_work(self, device):
        """([R] 93 band cells, [R] OS93a Type-1 inputs) that the decode of
        each row reads (zeros for row 0)."""
        _, a93, a93a = self.arrays(device)
        cells = torch.where(a93["kind"] != decode93.K_NONE,
                            a93["n_samp"], 0).sum(1)
        ins = torch.as_tensor(decode93a.INPUTS, device=device)
        return cells.long(), torch.where(a93a["bits"] > 0, ins[None, :],
                                         0).sum(1).long()

    def arrays(self, device):
        """(pool, arrs93, arrs93a): the [R, ...] fields on ``device``."""
        def stack(parts, shapes):
            out = {}
            for k, shape in shapes.items():
                blocks = [np.zeros((1,) + shape, np.int32)]
                for p, F in zip(parts, self._nf):
                    blocks.append(np.zeros((F,) + shape, np.int32)
                                  if p is None else
                                  np.asarray(p[k], np.int32).reshape(
                                      (F,) + shape))
                out[k] = torch.tensor(np.concatenate(blocks), device=device)
            return out
        s93 = {k: (16,) for k in ("kind", "width", "n_samp", "bit_start",
                                  "out_start", "out_inc", "scale", "prv_in",
                                  "prv_dl")}
        s93["frame_word"] = ()
        s93a = {"bits": (18,), "bit_start": (18,), "scale32": (18,),
                "frame_word": ()}
        return (self.pool(device), stack(self._a93, s93),
                stack(self._a93a, s93a))


# -- decode + transform ------------------------------------------------

def pcm94(scaled, rows, mix, vol, sid, device):
    """PCM [F, 240] of frames that mix bank rows: rows/mix [F, C] (numpy or
    tensors; channel order), vol [F], sid [F] (the overlap carry resets
    where it changes)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                     device=device)
    fb = decode94.session_mix94_plain(scaled, as_t(rows), as_t(mix))
    return tf.transform94_pcm_plain(fb, as_t(vol), as_t(sid),
                                    _tables(codec_tables, device))


def pcm93(bank_arrays, rows, mix, vol, sid, device):
    """PCM [F, 240] of 1993-family frames: each frame starts from silence
    and decodes its channels in order, the 93 body then the Type-1 body of
    each row, then the 1993 transform and overlap resolve."""
    pool, a93, a93a = bank_arrays
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                     device=device)
    rows, mix = as_t(rows).long(), as_t(mix)
    tabs = _tables(codec_tables93, device)
    fb = None
    for c in range(rows.shape[1]):
        r = rows[:, c]
        arr = {k: v[r] for k, v in a93.items()}
        fb = decode93.decode93_frames_plain(pool, arr, mix[:, c], fb)
        arr = {k: v[r] for k, v in a93a.items()}
        fb = decode93a.decode93a_frames_plain(pool, arr, mix[:, c],
                                              tabs["pair"], fb)
    return tf.transform93_pcm_plain(fb, as_t(vol), as_t(sid), tabs)


def is_type1(os_version, mem, pos):
    """Whether the stream at mem[pos] is an OS93a Type-1 stream."""
    return os_version == rd.OS93A and (int(mem[pos + 2]) & 0x80) != 0
