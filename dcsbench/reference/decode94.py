"""1994+ frame decode over the frame axis, plain PyTorch: band controls,
slot controls, symbol decode, dequant/mix.

The benchmark's frozen copy of the port's plain 1994+ decode (its
``ops/band_decode.py`` without the kernel dispatchers).  Every frame is
independent once the prescan (``prescan94.py``) has found its bit offset
and band types:

- ``unpack_columns`` widens per-stream headers and uint8 band types to
  per-frame columns; ``band_controls_dyn`` derives each frame's 16 band
  controls;
- ``slot_controls`` expands them to one packed control word per
  frame-buffer POSITION;
- ``decode94_symbols_plain`` walks a per-frame bit cursor through the byte
  pool and emits position-ordered sample values;
- ``_scaled`` and ``_mix_voice`` scale, mix and accumulate those values into
  512-word frame buffers; ``decode94_bank_plain`` keeps the dequantized
  rows apart and ``session_mix94_plain`` mixes up to 8 of them a frame.

All values use u16-in-int32 storage (reference: DCSDecoderNative.cpp
:1679-2261).
"""

import torch

from .fixmath import M16, s16, sat16

# packed per-position control word (same layout as the reference):
#   code | maxw<<5 | cb_base<<10 | valid<<20 | scale_code<<21
#   | (out_inc-1)<<27 | start_parity<<28
_P_CODE, _P_MAXW, _P_CB, _P_VALID, _P_SCALE = 0, 5, 10, 20, 21
_P_INC2, _P_PAR = 27, 28


def unpack_columns(sid, bt_u8, hdr_tab, fmt_tab, sub_tab):
    """Per-frame columns from the compact wire: header [N, 16], fmt [N],
    sub [N], band_type [N, 16], band_type_prev [N, 16] (the previous
    frame's band types within a stream, zero at stream starts) and
    stream_start [N] (where sid changes)."""
    sid = sid.long()
    bt = bt_u8.long()
    sstart = stream_starts(sid)
    btp = torch.where(sstart[:, None], 0, torch.cat([bt[:1], bt[:-1]], 0))
    return (hdr_tab.long()[sid], fmt_tab.long()[sid], sub_tab.long()[sid],
            bt, btp, sstart)


def stream_starts(sid):
    """[N] bool: True where a frame's stream id differs from the frame
    before it (and at frame 0)."""
    return sid != torch.cat([sid[:1] - 1, sid[:-1]])


def band_controls_dyn(header, fmt_type, sub_type, band_type, band_type_prev,
                      tabs):
    """Per-band controls with per-frame header [N, 16] and format
    fmt_type/sub_type [N]; band_type/_prev [N, 16].  Returns a dict of
    [N, 16] int64 tensors: code, scale_code, dense, out_inc, advance."""
    dev = header.device
    hdr = header.long()
    band_type = band_type.long()
    active = (hdr & 0x7F) != 0x7F
    # the $7F terminator ends the band list
    active = torch.cumprod(active.long(), dim=1).bool()

    cur_hdr = hdr & 0x7F
    out_inc = torch.where((cur_hdr & 0x40) != 0, 2, 1)
    out_count = tabs["out_count"].long().reshape(1, 16).expand_as(hdr)
    out_count = torch.where(out_inc == 2, out_count // 2, out_count)

    # type-1 path: band types translate through per-band-group tables
    btp = band_type_prev.long().clamp(0, 15)
    preadj = tabs["preadj"].long()
    pre = torch.where((sub_type != 0)[:, None], preadj[1][btp], preadj[0][btp])
    band = torch.arange(16, device=dev).reshape(1, 16)
    pre = torch.where(band < 3, pre, 0)
    bt = band_type.clamp(0, 15)
    code1 = tabs["xt_by_band"].long()[band, bt]
    scale_code1 = cur_hdr + pre + tabs["xa_by_band"].long()[band, bt]

    is1 = (fmt_type != 0)[:, None]
    code = torch.where(is1, code1, band_type)
    scale_code = torch.where(is1, scale_code1, cur_hdr)
    code = torch.where(band_type == 0, 0, code)

    has_data = active & (band_type != 0)
    code = torch.where(has_data, code, 0)
    dense = torch.where(has_data, out_count, 0)
    # skipped bands advance by the halved count, decoded ones by count*inc
    advance = torch.where(active & (band_type == 0), out_count,
                          torch.where(has_data, out_count * out_inc, 0))
    return {"code": code, "scale_code": scale_code, "dense": dense,
            "out_inc": out_inc, "advance": advance}


def _expand(starts, values, n_slots):
    """Piecewise-constant expansion:
    out[f, d] = values[f, max b: starts[f, b] <= d] (0 where no band starts
    at or before d).  starts [F, 16] nondecreasing; bands sharing a start
    resolve to the last one, as the reference's telescoping sum does."""
    d = torch.arange(n_slots, device=starts.device, dtype=starts.dtype)
    d = d.reshape(1, n_slots).expand(starts.shape[0], n_slots).contiguous()
    b = torch.searchsorted(starts.contiguous(), d, right=True) - 1
    picked = torch.gather(values, 1, b.clamp(min=0))
    return torch.where(b >= 0, picked, 0)


def slot_controls(ctl, tabs, n_slots=256):
    """Expand per-band controls ([F, 16] dict from band_controls_dyn) to
    per-position slot controls.

    Returns (packed [F, n_slots] control words, scale [F, n_slots],
    total [F] position counts), all int32.  Filler and out-of-range
    positions hold packed word 0 (emit 0, consume nothing) and scale 1.
    """
    adv = ctl["advance"].long()
    bounds = torch.cumsum(adv, dim=1)
    total = bounds[:, -1]
    band_start = bounds - adv

    code_b = ctl["code"].long()
    is_cb_b = (code_b >= 1) & (code_b <= 6)
    book = code_b.clamp(0, 6)
    maxw_b = torch.where(is_cb_b, tabs["maxw"].long()[book],
                         code_b.clamp(0, 17))
    cb_b = tabs["cb_base"].long()[book]
    packed_b = (code_b | (maxw_b << _P_MAXW) | (cb_b << _P_CB)
                | (1 << _P_VALID)
                | ((ctl["scale_code"].long() & 0x3F) << _P_SCALE)
                | ((ctl["out_inc"].long() - 1) << _P_INC2)
                | ((band_start & 1) << _P_PAR))
    packed_b = torch.where(code_b != 0, packed_b, 0)

    packed = _expand(band_start, packed_b, n_slots)
    # the scale value depends only on the low 6 bits of the scale code
    sc = (packed >> _P_SCALE) & 0x3F
    mant = tabs["scale_mant"].long()[sc & 3]
    scale = mant >> (15 - ((sc >> 2) & 0xF))
    dgrid = torch.arange(n_slots, device=packed.device).reshape(1, n_slots)
    inc2 = (packed >> _P_INC2) & 1
    par = (packed >> _P_PAR) & 1
    on_symbol = (inc2 == 0) | ((dgrid & 1) == par)
    valid = dgrid < total[:, None]
    packed = torch.where(valid & on_symbol, packed, 0)
    return packed.int(), scale.int(), total.int()


def decode94_symbols_plain(pool_u8, start_bit, packed, n_steps, cb_flat):
    """Symbol decode: the walk that the decode94_fb kernel fuses.

    pool_u8 [L] uint8 byte pool (bytes past its end read as $FF, as the
    reference's padded windows do); start_bit [F] int32 global bit offsets;
    packed [F, 256] int32 slot control words; n_steps covers the largest
    position count; cb_flat [940] int32 flattened codebooks 1..6.
    Returns position-ordered sample values [F, 256] int32 (u16 storage),
    zero at and past n_steps.

    One step per frame-buffer position: read mw bits big-endian at the
    cursor, decode them (codebook entry or sign-extended raw field), and
    advance the cursor by the bits consumed.  A codeword flagged "two zeros"
    emits 0 and makes the next position emit 0 without consuming.
    """
    F = start_bit.shape[0]
    dev = packed.device
    pool = torch.cat([pool_u8.long(),
                      torch.full((4,), 0xFF, dtype=torch.long, device=dev)])
    last = pool.numel() - 4
    n_cb = cb_flat.numel()
    cb_flat = cb_flat.long()
    cursor = start_bit.long()
    skip = torch.zeros(F, dtype=torch.bool, device=dev)
    out = torch.zeros((F, 256), dtype=torch.int32, device=dev)
    one = torch.ones(F, dtype=torch.long, device=dev)
    for t in range(min(n_steps, 256)):
        p = packed[:, t].long()
        ok = p != 0
        c = p & 0x1F
        mw = (p >> _P_MAXW) & 0x1F
        cb = (p >> _P_CB) & 0x3FF
        b = (cursor >> 3).clamp(max=last)
        word = ((pool[b] << 24) | (pool[b + 1] << 16) | (pool[b + 2] << 8)
                | pool[b + 3])
        look = ((word << (cursor & 7)) & 0xFFFFFFFF) >> (32 - mw)
        is_cb = c <= 6
        # an index past the table (raw-width lanes) reads the last entry
        entry = cb_flat[(cb + look).clamp(max=n_cb - 1)]
        two_zero = is_cb & ((entry & 0x80) != 0)
        sample_cb = (entry & 0x7F) - (one << (c - 1).clamp(0, 14))
        mw1 = mw.clamp(min=1)
        sample_raw = look - ((look >> (mw1 - 1)) << mw1)
        consume = ok & ~skip
        nbits = torch.where(is_cb, entry >> 8, mw)
        sample = torch.where(is_cb, sample_cb, sample_raw) & M16
        sample = torch.where(two_zero | skip | ~ok, 0, sample)
        cursor = cursor + torch.where(consume, nbits, 0)
        skip = ~skip & consume & two_zero
        out[:, t] = sample.int()
    return out


def _scaled(pos_vals, scale, total, active=None):
    """The dequantized samples (u16 storage): s16(value) * u16(scale),
    zero at and past each frame's position count and in frames where the
    voice is not active."""
    S = pos_vals.shape[1]
    pos = torch.arange(S, device=pos_vals.device).reshape(1, S)
    valid = pos < total.long()[:, None]
    if active is not None:
        valid = valid & active[:, None]
    scaled = (s16(pos_vals) * (scale.long() & M16)) & M16
    return torch.where(valid, scaled, 0)


def _mix_voice(fb, scaled, mix):
    """Accumulate one voice into frame buffers fb [F, 512] (int64, in
    place): scaled [F, S] samples (u16 storage) for positions 1..S at
    mixing multiplier mix [F], then the saturating first-sample delta
    fix-up of words 0 and 1 (reference: DCSDecoderNative.cpp:2244-2257).
    A zero scaled word passes its accumulator word through exactly, and an
    all-zero row leaves words 0 and 1 as they were: a silent voice needs
    no mask."""
    S = scaled.shape[1]
    mixprod = s16(scaled) * (mix.long()[:, None] & M16)
    new_val = ((((s16(fb[:, 1:1 + S]) << 16) | scaled) + mixprod)
               >> 16) & M16
    outbuf1 = fb[:, 1].clone()
    fb[:, 1:1 + S] = new_val
    delta = sat16(s16(new_val[:, 0]) - s16(outbuf1))
    fb[:, 0] = sat16(s16(delta) + s16(fb[:, 0]))
    fb[:, 1] = outbuf1


def decode94_bank_plain(pool_u8, sid, start_bit, bt_u8, hdr_tab, fmt_tab,
                        sub_tab, n_steps, tabs):
    """Plain version of the decode94_bank kernel: a session bank's decode,
    mix-independent, one row per stream frame.

    The compact columns of decode94_fb_plain without the mix (N frames of
    S streams).  Returns scaled [N + 1, 256] int16 holding u16 storage:
    row 0 is the silent dummy (all zero), row 1 + f is frame f's
    (s16(value) * u16(scale)) & $FFFF per position, zero at and past the
    frame's position count.  That row is all that dequant/mix reads of a
    frame (session_mix94_plain)."""
    header, fmt, sub, bt, btp, _ = unpack_columns(sid, bt_u8, hdr_tab,
                                                  fmt_tab, sub_tab)
    packed, scale, total = slot_controls(
        band_controls_dyn(header, fmt, sub, bt, btp, tabs), tabs)
    vals = decode94_symbols_plain(pool_u8, start_bit, packed, n_steps,
                                  tabs["cb_flat"])
    out = torch.zeros((sid.shape[0] + 1, 256), dtype=torch.int16,
                      device=pool_u8.device)
    out[1:] = s16(_scaled(vals, scale, total)).to(torch.int16)
    return out


def session_mix94_plain(scaled, rows, mix):
    """Plain version of the session_mix94 kernel: the session path's
    multi-voice dequant/mix (pipeline.device_decode's channel loop).

    scaled [R, 256] int16 bank rows (decode94_bank); rows [F, C] int32
    bank row per frame and channel (0: silent); mix [F, C] int32 mixing
    multipliers.  Each frame starts from silence and folds channels
    0..C-1 in order.  Returns frame buffers [F, 512] int32 (u16 storage),
    zero past word 256."""
    F = rows.shape[0]
    bank = scaled.long() & M16
    fb = torch.zeros((F, 512), dtype=torch.long, device=rows.device)
    for c in range(rows.shape[1]):
        _mix_voice(fb, bank[rows[:, c].long()], mix[:, c])
    return fb.int()


