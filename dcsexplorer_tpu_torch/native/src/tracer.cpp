// Native DCS runtime control tracer — the serving-path host half.
//
// A copy of dcsexplorer_tpu/native/src/tracer.cpp, kept in the port so
// that it builds and loads without the JAX package (native/__init__.py).
//
// C++ twin of vm/tracer.py + the runtime portions of refdec/decoder.py:
// the track byte-code VM, command queue, IRQ2 data-port protocol, mixing
// matrix with fades, master/channel volume curves, volShift headroom, and
// the stream playback lifecycle — with every per-sample numeric skipped.
// One call traces a whole session (N frames plus scheduled data-port
// events) and emits the per-frame control vectors the device pipeline
// consumes: (stream address, frame index, mixing multiplier) per channel
// plus the global volume shift.
//
// Behavior is the Python tracer's, field for field (fuzz-compared in
// tests/test_native_tracer.py).  Reference semantics anchors:
// DCSDecoderNative.cpp:89-306 (main loop), :848-1228 (track VM),
// :3042-3135 (mixing levels), :3250-3291 (volume), :3297-3437 (IRQ2).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr int NCH = 8;
constexpr uint32_t M16 = 0xFFFF;

enum { OS93A = 1, OS93B = 2, OS94 = 3, OS95 = 4 };
enum { ST_HARD_BOOT = 0, ST_RUNNING = 2 };

struct Rom {
    const uint8_t* chips[8] = {nullptr};
    int64_t sizes[8] = {0};
    int addr_shift = 20;
    int64_t track_index = 0;
    int64_t indirect_index = 0;
    int n_tracks = 0;

    uint8_t byte(int chip, int64_t pos) const {
        if (chip < 0 || chip >= 8 || !chips[chip]) return 0xFF;
        if (pos < 0 || pos >= sizes[chip]) return 0xFF;
        return chips[chip][pos];
    }
};

struct Ptr {
    int chip = 0;
    int64_t pos = 0;

    uint8_t u8(const Rom& r) { return r.byte(chip, pos++); }
    uint16_t u16(const Rom& r) {
        uint16_t hi = u8(r);
        return static_cast<uint16_t>((hi << 8) | u8(r));
    }
    uint32_t u24(const Rom& r) {
        uint32_t hi = u8(r);
        return (hi << 16) | u16(r);
    }
};

struct Mix {
    int32_t cur = 0, target = 0, delta = 0, steps = 0;
    void reset() { cur = target = steps = 0; }
};

struct Stream {
    bool playing = false;
    uint32_t addr = 0;            // u24 header address (host-side identity)
    uint16_t num_frames = 0, frame_counter = 0, loop_counter = 0;
};

struct Loop {
    uint16_t count;
    Ptr p;
};

struct Chan {
    bool has_track = false;
    Ptr track;
    uint16_t track_counter = 0;
    int next_track_type = 0;
    uint16_t next_track_link = 0;
    bool stop = false;
    Stream stream;
    int source_channel = -1;
    Mix mixer[NCH];
    bool max_override = false;
    uint16_t mixing_multiplier = 0x7FFF;
    uint8_t channel_volume = 0xFF;
    uint8_t ht_data = 0;
    uint16_t ht_interval = 0, ht_counter = 0;
    std::vector<Loop> loop_stack;

    void ht_clear() { ht_interval = ht_counter = 0; }
    void ht_set(uint8_t d, uint16_t iv) {
        ht_data = d;
        ht_interval = ht_counter = iv;
    }
};

// ADSP EXP: redundant-sign-bit count of a 32-bit value (refdec/fixed.py)
static int calc_exp32(uint32_t xop) {
    int res = 0;
    if (xop & 0x80000000u) {
        while (xop & 0x40000000u) {
            --res;
            xop <<= 1;
        }
    } else {
        while (res > -31 && !(xop & 0x40000000u)) {
            --res;
            xop <<= 1;
        }
    }
    return res;
}

struct Tracer {
    Rom rom;
    int os_version = OS94;
    int state = ST_HARD_BOOT;
    bool is_totan = false;
    int nominal_version = 0;
    int reported_version = 0x0106;
    int default_volume = 0x67;

    int nominal_volume = 0x67;
    uint16_t volume_multiplier = 0x0391;

    Chan ch[NCH];
    uint32_t channel_mask = 0;
    uint8_t variables[256] = {0};

    std::deque<uint16_t> command_queue;
    std::deque<uint8_t> port_queue;
    uint8_t last_port_byte = 0;
    uint16_t data_port_word = 0;
    uint16_t data_port_ext = 0;
    int n_data_port_bytes = 0;
    int data_port_timeout = 0;

    std::vector<uint8_t> host_rx;
    bool reset_error = false;

    Ptr make_ptr(uint32_t linear) const {
        Ptr p;
        p.chip = (linear >> rom.addr_shift) & 7;
        int64_t size = rom.sizes[p.chip];
        // power-of-two chip sizes wrap like the hardware (rom/image.py
        // make_pointer); standalone pools of arbitrary size pass through
        p.pos = (size > 0 && (size & (size - 1)) == 0)
                    ? (linear & (size - 1)) : linear;
        return p;
    }

    // ---- volume (refdec set_master_volume) ---------------------------
    void set_master_volume(int vol) {
        nominal_volume = vol > 255 ? 255 : vol < 0 ? 0 : vol;
        if (vol != 0) {
            uint32_t s = static_cast<uint32_t>(vol) & M16;
            uint32_t x = 0x3FFF, y = 0x7D98;
            for (int i = 0; i < 8; ++i) {
                if ((s & 1) == 0) x = ((x * y) >> 15) & M16;
                y = ((y * y) >> 15) & M16;
                s >>= 1;
            }
            volume_multiplier = static_cast<uint16_t>((x << 1) & M16);
        } else {
            volume_multiplier = 0;
        }
    }

    void set_channel_volume(int c, int level) {
        if (0 <= c && c < NCH) ch[c].channel_volume = level & 0xFF;
    }

    // ---- data port (refdec irq2_handler) -----------------------------
    void write_port(int b) {
        if (state == ST_HARD_BOOT) {
            soft_boot();
            return;
        }
        port_queue.push_back(static_cast<uint8_t>(b & 0xFF));
    }

    uint8_t read_port() {
        if (!port_queue.empty()) {
            last_port_byte = port_queue.front();
            port_queue.pop_front();
        }
        return last_port_byte;
    }

    void irq2() {
        uint8_t data = read_port();
        if (data_port_timeout >= 13) n_data_port_bytes = 0;
        int n = n_data_port_bytes;
        if (n == 0) {
            data_port_word = static_cast<uint16_t>(data << 8);
            n_data_port_bytes = 1;
        } else if (n == 1) {
            uint16_t w = data_port_word | data;
            data_port_word = w;
            if ((0x55AA <= w && w <= 0x55B2)
                || (0x55BA <= w && w <= 0x55C1)) {
                data_port_ext = w;
                n_data_port_bytes = 2;
            } else if (0x55B2 < w && w < 0x55BA) {
                n_data_port_bytes = 0;
            } else if (w == 0x55C2 || w == 0x55C3) {
                int v = w == 0x55C2 ? (reported_version >> 8)
                                    : reported_version;
                host_rx.push_back(static_cast<uint8_t>(v & 0xFF));
                n_data_port_bytes = 0;
            } else if (w & 0x8000) {
                n_data_port_bytes = 0;
            } else if (w == 0x03E7 && is_totan) {
                host_rx.push_back(0x11);
                n_data_port_bytes = 0;
            } else {
                command_queue.push_back(w);
                n_data_port_bytes = 0;
            }
        } else if (n == 2) {
            data_port_word = data;
            n_data_port_bytes = 3;
        } else {
            if (data_port_word == (data ^ 0xFF)) {
                uint16_t ext = data_port_ext;
                if (ext == 0x55AA) {
                    set_master_volume(data_port_word & 0xFF);
                } else if (ext <= 0x55B2) {
                    set_channel_volume(ext - 0x55AB, data_port_word & 0xFF);
                }
                // 55BA..C1 mystery params: ignored
            }
            n_data_port_bytes = 0;
        }
        data_port_timeout = 0;
    }

    // ---- boot --------------------------------------------------------
    void soft_boot() {
        for (int i = 0; i < NCH; ++i) {
            ch[i].stop = false;
            ch[i].channel_volume = 0xFF;
        }
        set_master_volume(default_volume);
        port_queue.clear();
        last_port_byte = 0;
        n_data_port_bytes = 0;
        state = ST_RUNNING;
    }

    // Fresh-session reset: what a NEW decoder object starts with
    // (soft_boot alone is the reference's soft reboot and deliberately
    // keeps tracks/streams/mixers running, DCSDecoder.cpp semantics —
    // batch serving needs independent sessions, so session b must not
    // inherit session b-1's playing state).
    void full_reset() {
        for (int i = 0; i < NCH; ++i) ch[i] = Chan{};
        channel_mask = 0;
        std::memset(variables, 0, sizeof variables);
        command_queue.clear();
        port_queue.clear();
        last_port_byte = 0;
        data_port_word = 0;
        data_port_ext = 0;
        n_data_port_bytes = 0;
        data_port_timeout = 0;
        host_rx.clear();
        reset_error = false;
        state = ST_HARD_BOOT;
        soft_boot();
    }

    // ---- mixing helpers ---------------------------------------------
    void reset_mixing_levels(int chno) {
        for (int i = 0; i < NCH; ++i) ch[i].mixer[chno].reset();
    }

    void mixing_level_op(int cur, Ptr& p, int mode, bool fade) {
        int target = p.u8(rom);
        int raw = p.u8(rom);
        int param = ((raw & 0x80) ? raw - 0x100 : raw) << 6;
        int steps = fade ? p.u16(rom) : 0;
        Mix& m = ch[target & 7].mixer[cur];
        m.steps = steps;
        int old = m.cur;
        int nv = mode == 0 ? param : mode == 1 ? old + param : old - param;
        int delta = nv - old;
        if (nv > 8191) nv = 8191;
        else if (nv < -8191) nv = -8191;
        m.target = nv;
        if (steps != 0) {
            int q = (delta < 0 ? -delta : delta) / steps;
            m.delta = delta < 0 ? -q : q;
        } else {
            m.cur = nv;
        }
    }

    // ---- stream lifecycle (decode stubbed) ---------------------------
    void load_audio_stream(int stream_ch, int source_ch, int loop_count,
                           uint32_t addr) {
        Chan& c = ch[stream_ch & 7];
        Stream& st = c.stream;
        Ptr p = make_ptr(addr);
        uint16_t nf = static_cast<uint16_t>((rom.byte(p.chip, p.pos) << 8)
                                            | rom.byte(p.chip, p.pos + 1));
        st.addr = addr;
        st.num_frames = nf;
        st.frame_counter = nf;
        st.playing = true;
        if (nf == 0)       // refdec returns before loop/source bookkeeping
            return;        // (playing, loop_counter keep their values)
        st.loop_counter = static_cast<uint16_t>(loop_count);
        int old_src = c.source_channel;
        if (old_src >= 0 && old_src != source_ch)
            c.mixer[old_src].reset();
        c.source_channel = source_ch;
    }

    void decode_stream(int i) {
        Stream& st = ch[i].stream;
        if (!st.playing) return;
        st.frame_counter = static_cast<uint16_t>((st.frame_counter - 1)
                                                 & M16);
        if (st.frame_counter != 0) return;
        st.frame_counter = st.num_frames;
        if (st.loop_counter == 0) return;
        st.loop_counter = static_cast<uint16_t>((st.loop_counter - 1) & M16);
        if (st.loop_counter != 0) return;
        st.playing = false;
        ch[i].source_channel = -1;
    }

    // ---- track VM (refdec _exec_track) -------------------------------
    void load_track(int chno, const Ptr& p) {
        Chan& c = ch[chno & 7];
        c.has_track = true;
        c.track = p;
        c.stream.playing = false;
        c.track_counter = 0;
        c.ht_clear();
        c.loop_stack.clear();
        channel_mask &= ~(1u << (chno & 7));
        reset_mixing_levels(chno & 7);
    }

    bool exec_track(int cur) {
        Chan& chan = ch[cur];
        if (!chan.has_track) return true;
        Ptr p = chan.track;
        for (;;) {
            uint16_t count_prefix = p.u16(rom);
            if (count_prefix == 0xFFFF
                || chan.track_counter != count_prefix) {
                p.pos -= 2;
                chan.track = p;
                return true;
            }
            chan.track_counter = 0;
            uint8_t op = p.u8(rom);
            switch (op) {
            case 0x00:
                chan.has_track = false;
                chan.stream.playing = false;
                chan.loop_stack.clear();
                chan.ht_clear();
                reset_mixing_levels(cur);
                return true;
            case 0x01: {
                int stream_ch = p.u8(rom);
                if (stream_ch == 5) ch[5].max_override = false;
                uint32_t addr = p.u24(rom);
                int loop_count = p.u8(rom);
                load_audio_stream(stream_ch & 7, cur, loop_count, addr);
                break;
            }
            case 0x02: {
                int target = p.u8(rom) & 7;
                Chan& tc = ch[target];
                if (tc.stream.playing) {
                    tc.stream.playing = false;
                    reset_mixing_levels(target);
                }
                tc.has_track = false;
                tc.ht_clear();
                if (!chan.has_track) return true;
                break;
            }
            case 0x03:
                command_queue.push_back(p.u16(rom));
                break;
            case 0x04:
                if (os_version == OS93A) {
                    uint8_t cmd_byte = p.u8(rom);
                    uint16_t counter = p.u16(rom);
                    if (cmd_byte == 0) {
                        chan.ht_clear();
                    } else {
                        host_rx.push_back(cmd_byte);
                        if (counter != 0) chan.ht_set(cmd_byte, counter);
                        else chan.ht_clear();
                    }
                } else {
                    uint8_t b = p.u8(rom);
                    host_rx.push_back(b);
                    if (nominal_version == 0x0105) {
                        if (b == 0x69) ch[5].max_override = true;
                        else if (b == 0x6A) ch[5].max_override = false;
                    }
                }
                break;
            case 0x05: {
                int target = p.u8(rom) & 7;
                Chan& tc = ch[target];
                int ttype = tc.next_track_type;
                if (ttype == 0) break;
                tc.next_track_type = 0;
                if (ttype == 2) {
                    command_queue.push_back(tc.next_track_link);
                } else if (ttype == 3) {
                    uint16_t link = tc.next_track_link;
                    int lo = link & 0xFF, hi = (link >> 8) & 0xFF;
                    uint8_t var = variables[hi];
                    Ptr t;
                    {
                        Ptr ix;
                        ix.chip = 0;
                        ix.pos = rom.indirect_index + lo * 3;
                        uint32_t taddr = ix.u24(rom);
                        t = make_ptr(taddr);
                    }
                    t.pos += var * 2;
                    command_queue.push_back(t.u16(rom));
                }
                break;
            }
            case 0x06:
                if (os_version == OS93A || os_version == OS93B) {
                    // 1993 software: a no-op with no operands
                } else {
                    uint8_t idx = p.u8(rom);
                    variables[idx] = p.u8(rom);
                }
                break;
            case 0x07: case 0x08: case 0x09:
                mixing_level_op(cur, p, op - 0x07, false);
                break;
            case 0x0A: case 0x0B: case 0x0C:
                mixing_level_op(cur, p, op - 0x0A, true);
                break;
            case 0x0D:
                break;
            case 0x0E: {
                Loop l;
                l.count = p.u8(rom);
                l.p = p;
                chan.loop_stack.push_back(l);
                break;
            }
            case 0x0F:
                if (!chan.loop_stack.empty()) {
                    Loop& l = chan.loop_stack.back();
                    if (l.count == 0) {
                        p = l.p;
                    } else if (l.count == 1) {
                        chan.loop_stack.pop_back();
                    } else {
                        --l.count;
                        p = l.p;
                    }
                }
                break;
            case 0x10:
                p.u8(rom);
                p.u8(rom);
                break;
            case 0x11: case 0x12:
                p.u8(rom);
                p.u8(rom);
                p.u16(rom);
                break;
            default:
                reset_error = true;
                return false;
            }
        }
    }

    // ---- main loop (refdec main_loop) --------------------------------
    bool main_loop(int32_t* out_stream, int32_t* out_fidx,
                   int32_t* out_mix, int32_t* out_vshift) {
        // forced-stop flags
        for (int i = 0; i < NCH; ++i) {
            Chan& c = ch[i];
            if (c.stop) {
                c.stop = false;
                if (c.stream.playing) {
                    c.stream.playing = false;
                    reset_mixing_levels(i);
                }
                c.ht_clear();
                c.has_track = false;
            }
        }
        // pending commands → track loads
        while (!command_queue.empty()) {
            uint16_t cmd = command_queue.front();
            command_queue.pop_front();
            if (cmd >= rom.n_tracks) continue;
            Ptr ix;
            ix.chip = 0;
            ix.pos = rom.track_index + static_cast<int64_t>(cmd) * 3;
            uint32_t track_ofs = ix.u24(rom);
            if ((track_ofs & 0xFF0000u) == 0xFF0000u) continue;
            Ptr p = make_ptr(track_ofs);
            uint8_t ttype = p.u8(rom);
            uint8_t chno = p.u8(rom);
            if (ttype == 1) {
                load_track(chno, p);
            } else if (ttype <= 3) {
                ch[chno & 7].next_track_type = ttype;
                ch[chno & 7].next_track_link = p.u16(rom);
            } else {
                reset_error = true;
                return false;
            }
        }
        // run all track programs to quiescence
        const uint32_t all_done = (1u << NCH) - 1;
        channel_mask = 0;
        int chno = 0;
        while (channel_mask != all_done) {
            if (!(channel_mask & (1u << chno))) {
                if (!exec_track(chno)) return false;
                channel_mask |= 1u << chno;
            }
            chno = (chno + 1) % NCH;
        }
        // volShift headroom
        uint64_t mixing_sum = 0;
        for (int i = 0; i < NCH; ++i) {
            if (ch[i].max_override)
                mixing_sum += static_cast<uint64_t>(ch[i].mixing_multiplier)
                              * 0x7FFE;
            else if (ch[i].stream.playing)
                mixing_sum += static_cast<uint64_t>(ch[i].mixing_multiplier)
                              * volume_multiplier;
        }
        mixing_sum >>= 2;
        int vol_shift = -(calc_exp32(static_cast<uint32_t>(mixing_sum))
                          + 3);
        if (vol_shift < 0) vol_shift = 0;
        else if (vol_shift > 8) vol_shift = 8;
        for (int i = 0; i < NCH; ++i) {
            uint32_t v = ch[i].max_override ? 0x7FFE : volume_multiplier;
            uint64_t m = (static_cast<uint64_t>(ch[i].mixing_multiplier)
                          * v) << 1;
            ch[i].mixing_multiplier =
                static_cast<uint16_t>(((m << vol_shift) >> 16) & M16);
        }
        // record + stream lifecycle (vm/tracer.py _decode_and_transform)
        for (int i = 0; i < NCH; ++i) {
            Stream& st = ch[i].stream;
            if (st.playing && st.num_frames > 0) {
                out_stream[i] = static_cast<int32_t>(st.addr);
                out_fidx[i] = (st.num_frames - st.frame_counter)
                              % st.num_frames;
                out_mix[i] = ch[i].mixing_multiplier;
            } else {
                out_stream[i] = -1;
                out_fidx[i] = 0;
                out_mix[i] = 0;
            }
            decode_stream(i);
        }
        *out_vshift = vol_shift;
        // fades / multipliers / track counters / host event timers
        update_mixing_levels();
        // data-port timeout tick
        if (++data_port_timeout > 13) data_port_timeout = 13;
        return true;
    }

    void update_mixing_levels() {
        for (int i = 0; i < NCH; ++i) {
            for (int j = 0; j < NCH; ++j) {
                Mix& m = ch[i].mixer[j];
                if (m.steps == 1) {
                    m.steps = 0;
                    m.cur = m.target;
                } else if (m.steps > 1) {
                    --m.steps;
                    m.cur += m.delta;
                    if (m.cur > 8191) m.cur = 8191;
                    else if (m.cur < -8191) m.cur = -8191;
                }
            }
        }
        for (int i = 0; i < NCH; ++i) {
            int mixer_sum = 0;
            for (int j = 0; j < NCH; ++j) mixer_sum += ch[i].mixer[j].cur;
            if (mixer_sum > 8191) mixer_sum = 8191;
            else if (mixer_sum < -8191) mixer_sum = -8191;
            uint32_t mixer_exp = ((mixer_sum >> 6) & 0x3FF) + 0x80;
            uint32_t multiplier;
            if (os_version == OS93A) multiplier = 0x7FFF;
            else multiplier = (static_cast<uint32_t>(ch[i].channel_volume)
                               << 7) & M16;
            if (ch[i].max_override) multiplier = (0xFFu << 7) & M16;
            uint32_t prod = 0x7C94;
            uint32_t bit = 1;
            for (int k = 0; k < 8; ++k) {
                if ((mixer_exp & bit) == 0)
                    multiplier = ((multiplier * prod) >> 15) & M16;
                prod = ((prod * prod) >> 15) & M16;
                bit <<= 1;
            }
            ch[i].mixing_multiplier =
                static_cast<uint16_t>((multiplier << 1) & M16);
        }
        for (int i = 0; i < NCH; ++i) {
            ch[i].track_counter =
                static_cast<uint16_t>((ch[i].track_counter + 1) & M16);
            Chan& c = ch[i];
            if (c.ht_interval != 0) {
                c.ht_counter = static_cast<uint16_t>((c.ht_counter - 1)
                                                     & M16);
                if (c.ht_counter == 0) {
                    c.ht_counter = c.ht_interval;
                    host_rx.push_back(c.ht_data);
                }
            }
        }
    }
};

}  // namespace

extern "C" {

void* dcstr_create(int os_version, int is_totan, int nominal_version,
                   int reported_version, int default_volume) {
    Tracer* t = new Tracer();
    t->os_version = os_version;
    t->is_totan = is_totan != 0;
    t->nominal_version = nominal_version;
    t->reported_version = reported_version;
    t->default_volume = default_volume;
    return t;
}

void dcstr_destroy(void* h) { delete static_cast<Tracer*>(h); }

void dcstr_add_chip(void* h, int idx, const uint8_t* data, long long size) {
    Tracer* t = static_cast<Tracer*>(h);
    if (0 <= idx && idx < 8) {
        t->rom.chips[idx] = data;
        t->rom.sizes[idx] = size;
    }
}

void dcstr_set_catalog(void* h, long long track_index,
                       long long indirect_index, int n_tracks,
                       int addr_shift) {
    Tracer* t = static_cast<Tracer*>(h);
    t->rom.track_index = track_index;
    t->rom.indirect_index = indirect_index;
    t->rom.n_tracks = n_tracks;
    t->rom.addr_shift = addr_shift;
}

void dcstr_soft_boot(void* h) { static_cast<Tracer*>(h)->soft_boot(); }

// Fresh-session reset (what a newly constructed decoder starts with);
// soft_boot alone is the reference's soft REBOOT and keeps tracks,
// streams, and mixer fades running across it.
void dcstr_full_reset(void* h) { static_cast<Tracer*>(h)->full_reset(); }

// Standalone stream playback (refdec load_audio_stream public API): play
// the stream at `addr` on `chno` with the given mixing level — the
// flat-sweep and EncoderTester shapes, no ROM tracks involved.
void dcstr_load_stream(void* h, int chno, unsigned addr, int mixing_level,
                       int loop_count) {
    Tracer* t = static_cast<Tracer*>(h);
    chno &= 7;
    Chan& c = t->ch[chno];
    c.has_track = false;
    t->load_audio_stream(chno, chno, loop_count, addr);
    Mix& m = c.mixer[chno];
    m.reset();
    m.cur = m.target = mixing_level << 6;
}

void dcstr_write_port(void* h, int b) {
    static_cast<Tracer*>(h)->write_port(b);
}

// Trace n_frames of the runtime.  ev_frame/ev_byte schedule data-port
// bytes before the given frame indices (sorted by frame).  Outputs are
// [n_frames*8] (stream u24 address or -1, frame index, mixing
// multiplier) and [n_frames] volume shifts.  Returns 0, or -2 on a
// ResetError-class fault (invalid opcode / track type).
int dcstr_trace(void* h, int n_frames, const int32_t* ev_frame,
                const uint8_t* ev_byte, int n_ev, int32_t* out_stream,
                int32_t* out_fidx, int32_t* out_mix, int32_t* out_vshift) {
    Tracer* t = static_cast<Tracer*>(h);
    int e = 0;
    for (int f = 0; f < n_frames; ++f) {
        while (e < n_ev && ev_frame[e] == f) {
            t->write_port(ev_byte[e]);
            ++e;
        }
        while (!t->port_queue.empty()) t->irq2();
        if (!t->main_loop(out_stream + static_cast<size_t>(f) * NCH,
                          out_fidx + static_cast<size_t>(f) * NCH,
                          out_mix + static_cast<size_t>(f) * NCH,
                          out_vshift + f))
            return -2;
    }
    return 0;
}

// Fused trace + control assembly for the serving path: trace n_frames
// and emit device-ready rows directly — row id via binary search of the
// sorted stream-address table (addr_tab -> off_tab, row base of each
// stream in the host's dense StreamBank), narrowed in place to the
// u16/u16/u8 link dtypes the device batch uses.  Replaces the
// per-session numpy assembly pass, the largest host term in end-to-end
// session serving.  Returns 0; -2 on a ResetError-class fault; -3 if a
// traced stream address is missing from the table; -6 if a row id does not
// fit u16 (a bank of 64Ki rows or more: the segment trace's wide wire).
int dcstr_trace_rows(void* h, int n_frames, const int32_t* ev_frame,
                     const uint8_t* ev_byte, int n_ev,
                     const int64_t* addr_tab, const int32_t* off_tab,
                     int n_tab, uint16_t* out_rows, uint16_t* out_mix,
                     uint8_t* out_vshift) {
    Tracer* t = static_cast<Tracer*>(h);
    int e = 0;
    int32_t s[NCH], fi[NCH], m[NCH], v;
    for (int f = 0; f < n_frames; ++f) {
        while (e < n_ev && ev_frame[e] == f) {
            t->write_port(ev_byte[e]);
            ++e;
        }
        while (!t->port_queue.empty()) t->irq2();
        if (!t->main_loop(s, fi, m, &v)) return -2;
        uint16_t* rr = out_rows + static_cast<size_t>(f) * NCH;
        uint16_t* mm = out_mix + static_cast<size_t>(f) * NCH;
        for (int i = 0; i < NCH; ++i) {
            if (s[i] < 0) {
                rr[i] = 0;
                mm[i] = 0;
                continue;
            }
            const int64_t a = s[i];
            const int64_t* lo = std::lower_bound(addr_tab, addr_tab + n_tab,
                                                 a);
            if (lo == addr_tab + n_tab || *lo != a) return -3;
            const int32_t row = off_tab[lo - addr_tab] + fi[i];
            if (row > 0xFFFF) return -6;
            rr[i] = static_cast<uint16_t>(row);
            mm[i] = static_cast<uint16_t>(m[i]);
        }
        out_vshift[f] = static_cast<uint8_t>(v);
    }
    return 0;
}

}  // extern "C"

namespace {

// Fused trace + control-plane SEGMENT emission — the compressed serving
// path (models/romplay.py).  A playing lane's dense-row id advances by
// 0/1 per frame and its mix multiplier is piecewise constant, so each
// (channel) lane collapses to a few linear segments
// ``row[t] = base + slope*(t - f0)`` with a constant mix.  This emits
// those segments DURING the trace — no dense [T,C] arrays are ever
// built on the host, and the wire carries only the tiny per-segment
// parameter tables (the device derives the per-frame segment index from
// f0; romplay.reconstruct_from_segments).
//
// Outputs (caller-allocated, C-contiguous): f0/mixv uint16 and base Base
// [n_ch, max_segs], slope uint8 [n_ch, max_segs], vshift uint8
// [n_frames].  Unused f0 entries are left at 0xFFFF so a device-side
// ``f0 <= t`` count needs no segment-count column.  Returns 0; -2 on a
// ResetError-class fault; -3 on a stream address missing from the
// table; -4 if any lane needs more than max_segs segments (caller falls
// back to the dense upload); -5 if a lane >= n_ch goes live (the caller
// promised those channels idle).
//
// Base is the base column's type: uint16_t for the wire of a bank under
// 64Ki rows, uint32_t for the wide wire of a bank under 2^24 rows
// (dcstr_trace_segs32_batch).  The caller picks the wire from
// the bank's row count, so every row id fits its column.
template <typename Base>
int trace_segs(void* h, int n_frames, const int32_t* ev_frame,
               const uint8_t* ev_byte, int n_ev,
               const int64_t* addr_tab, const int32_t* off_tab,
               int n_tab, int n_ch, int max_segs,
               uint16_t* out_f0, Base* out_base,
               uint8_t* out_slope, uint16_t* out_mixv,
               uint8_t* out_vshift) {
    Tracer* t = static_cast<Tracer*>(h);
    if (n_ch < 1 || n_ch > NCH || max_segs < 1 || n_frames >= 0xFFFF)
        return -1;
    std::memset(out_f0, 0xFF,
                static_cast<size_t>(n_ch) * max_segs * sizeof(uint16_t));
    std::memset(out_base, 0,
                static_cast<size_t>(n_ch) * max_segs * sizeof(Base));
    std::memset(out_mixv, 0,
                static_cast<size_t>(n_ch) * max_segs * sizeof(uint16_t));
    std::memset(out_slope, 0, static_cast<size_t>(n_ch) * max_segs);
    struct Lane {
        int nseg = 0;
        bool have_slope = false;
        int slope = 0;
        int prev_row = 0;
        int seg_mix = 0;
        bool have_prev_d = false;
        int prev_d = 0;
    } lane[NCH];
    int e = 0;
    int32_t s[NCH], fi[NCH], m[NCH], v;
    for (int f = 0; f < n_frames; ++f) {
        while (e < n_ev && ev_frame[e] == f) {
            t->write_port(ev_byte[e]);
            ++e;
        }
        while (!t->port_queue.empty()) t->irq2();
        if (!t->main_loop(s, fi, m, &v)) return -2;
        for (int i = 0; i < NCH; ++i) {
            int row = 0, mix = 0;
            if (s[i] >= 0) {
                if (i >= n_ch) return -5;
                const int64_t a = s[i];
                const int64_t* lo = std::lower_bound(addr_tab,
                                                     addr_tab + n_tab, a);
                if (lo == addr_tab + n_tab || *lo != a) return -3;
                row = off_tab[lo - addr_tab] + fi[i];
                mix = m[i];
            }
            if (i >= n_ch) continue;
            Lane& L = lane[i];
            uint16_t* f0 = out_f0 + static_cast<size_t>(i) * max_segs;
            Base* ba = out_base + static_cast<size_t>(i) * max_segs;
            uint8_t* sl = out_slope + static_cast<size_t>(i) * max_segs;
            uint16_t* mx = out_mixv + static_cast<size_t>(i) * max_segs;
            if (f == 0) {
                f0[0] = 0;
                ba[0] = static_cast<Base>(row);
                mx[0] = static_cast<uint16_t>(mix);
                L = Lane{1, false, 0, row, mix, false, 0};
            } else {
                const int d = row - L.prev_row;
                // break rule IDENTICAL to compress_controls (the delta
                // comparison is local — it crosses segment boundaries),
                // so native and numpy segmentation match table-for-table
                const bool brk = mix != L.seg_mix || d < 0 || d > 1
                                 || (L.have_prev_d && d != L.prev_d);
                if (!brk) {
                    if (!L.have_slope) {
                        // first continuing step pins the segment slope
                        // (all later in-segment deltas equal it)
                        L.have_slope = true;
                        L.slope = d;
                        sl[L.nseg - 1] = static_cast<uint8_t>(d);
                    }
                } else {
                    if (L.nseg >= max_segs) return -4;
                    f0[L.nseg] = static_cast<uint16_t>(f);
                    ba[L.nseg] = static_cast<Base>(row);
                    mx[L.nseg] = static_cast<uint16_t>(mix);
                    ++L.nseg;
                    L.have_slope = false;
                    L.slope = 0;
                    L.seg_mix = mix;
                }
                L.have_prev_d = true;
                L.prev_d = d;
                L.prev_row = row;
            }
        }
        out_vshift[f] = static_cast<uint8_t>(v);
    }
    return 0;
}

// Batched segment trace: S INDEPENDENT sessions through ONE runtime
// handle (full_reset between sessions — fresh-decoder state, not the
// reference's state-preserving soft reboot; the chip set is shared, so
// the caller keeps a single handle instead of S), each with its own event
// slice (ev_off: [S+1] prefix offsets into ev_frame/ev_byte) and its own
// slices of the batch output arrays (f0/base/mixv [S, n_ch, max_segs],
// slope [S, n_ch, max_segs], vshift [S, n_frames]).  One C call per
// BATCH replaces S Python-loop calls — the serving path's host stage is
// pure C end-to-end (bench.bench_session6.prepare).  Returns 0, or the
// first session's error code (same codes as dcstr_trace_segs).
template <typename Base>
int trace_segs_batch(void* h, int n_sessions, int n_frames,
                     const int32_t* ev_off, const int32_t* ev_frame,
                     const uint8_t* ev_byte,
                     const int64_t* addr_tab, const int32_t* off_tab,
                     int n_tab, int n_ch, int max_segs,
                     uint16_t* out_f0, Base* out_base,
                     uint8_t* out_slope, uint16_t* out_mixv,
                     uint8_t* out_vshift) {
    const size_t seg = static_cast<size_t>(n_ch) * max_segs;
    for (int b = 0; b < n_sessions; ++b) {
        static_cast<Tracer*>(h)->full_reset();
        const int e0 = ev_off[b], e1 = ev_off[b + 1];
        const int rc = trace_segs<Base>(
            h, n_frames, ev_frame + e0, ev_byte + e0, e1 - e0,
            addr_tab, off_tab, n_tab, n_ch, max_segs,
            out_f0 + seg * b, out_base + seg * b, out_slope + seg * b,
            out_mixv + seg * b,
            out_vshift + static_cast<size_t>(n_frames) * b);
        if (rc != 0) return rc;
    }
    return 0;
}

}  // namespace

extern "C" {

// The segment traces: one session or a batch with base u16 (the wire of a
// bank under 64Ki rows), a batch with base u32 (the wide wire).
int dcstr_trace_segs(void* h, int n_frames, const int32_t* ev_frame,
        const uint8_t* ev_byte, int n_ev, const int64_t* addr_tab,
        const int32_t* off_tab, int n_tab, int n_ch, int max_segs,
        uint16_t* out_f0, uint16_t* out_base, uint8_t* out_slope,
        uint16_t* out_mixv, uint8_t* out_vshift) {
    return trace_segs<uint16_t>(
        h, n_frames, ev_frame, ev_byte, n_ev, addr_tab, off_tab, n_tab, n_ch,
        max_segs, out_f0, out_base, out_slope, out_mixv, out_vshift);
}

int dcstr_trace_segs_batch(void* h, int n_sessions, int n_frames,
        const int32_t* ev_off, const int32_t* ev_frame,
        const uint8_t* ev_byte, const int64_t* addr_tab,
        const int32_t* off_tab, int n_tab, int n_ch, int max_segs,
        uint16_t* out_f0, uint16_t* out_base, uint8_t* out_slope,
        uint16_t* out_mixv, uint8_t* out_vshift) {
    return trace_segs_batch<uint16_t>(
        h, n_sessions, n_frames, ev_off, ev_frame, ev_byte, addr_tab, off_tab,
        n_tab, n_ch, max_segs, out_f0, out_base, out_slope, out_mixv,
        out_vshift);
}

int dcstr_trace_segs32_batch(void* h, int n_sessions, int n_frames,
        const int32_t* ev_off, const int32_t* ev_frame,
        const uint8_t* ev_byte, const int64_t* addr_tab,
        const int32_t* off_tab, int n_tab, int n_ch, int max_segs,
        uint16_t* out_f0, uint32_t* out_base, uint8_t* out_slope,
        uint16_t* out_mixv, uint8_t* out_vshift) {
    return trace_segs_batch<uint32_t>(
        h, n_sessions, n_frames, ev_off, ev_frame, ev_byte, addr_tab, off_tab,
        n_tab, n_ch, max_segs, out_f0, out_base, out_slope, out_mixv,
        out_vshift);
}

int dcstr_read_host(void* h, uint8_t* out, int cap) {
    Tracer* t = static_cast<Tracer*>(h);
    int n = static_cast<int>(t->host_rx.size());
    if (n > cap) n = cap;
    std::memcpy(out, t->host_rx.data(), n);
    t->host_rx.erase(t->host_rx.begin(), t->host_rx.begin() + n);
    return n;
}

}  // extern "C"
