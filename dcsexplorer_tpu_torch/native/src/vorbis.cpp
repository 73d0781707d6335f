// From-scratch Ogg Vorbis (Vorbis I) decoder for the encoder's audio-input
// path — the counterpart of the reference's libnyquist/libvorbis input
// (reference: DCSEncoder/DCSEncodeFile.cpp:55-59).
//
// Implemented from the Vorbis I specification (Ogg framing, setup-header
// codebooks, floor types 0 and 1, residue types 0/1/2, square-polar
// channel coupling, IMDCT, lapped windowing).  No code is taken from
// libvorbis/libnyquist; the one literal spec table (FLOOR1_fromdB_LOOKUP,
// spec sect. 10) is extracted into vorbis_tables.h by a transparent
// generator, and tests/test_vorbis.py compares whole-file PCM against the
// reference decoder compiled out-of-tree — including a hand-built
// floor-0 stream (no modern encoder emits one).

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "vorbis_tables.h"

namespace vorbis {

// ---------------------------------------------------------------------
// Ogg container: collect the logical packets of the first stream.

struct Packet {
    std::vector<uint8_t> bytes;
    int64_t granule = -1;     // granule of the page this packet ENDS on
    bool eos = false;
};

static bool parse_ogg(const uint8_t* data, int64_t len,
                      std::vector<Packet>& out) {
    int64_t pos = 0;
    uint32_t serial = 0;
    bool have_serial = false;
    std::vector<uint8_t> partial;
    bool continued_open = false;
    while (pos + 27 <= len) {
        if (memcmp(data + pos, "OggS", 4) != 0) {
            ++pos;               // resync
            continue;
        }
        const uint8_t* h = data + pos;
        if (h[4] != 0) return false;            // stream_structure_version
        uint8_t flags = h[5];
        int64_t granule;
        memcpy(&granule, h + 6, 8);             // little-endian host assumed
        uint32_t ser;
        memcpy(&ser, h + 14, 4);
        int nseg = h[26];
        if (pos + 27 + nseg > len) break;
        const uint8_t* lace = h + 27;
        int64_t body = pos + 27 + nseg;
        int64_t body_len = 0;
        for (int i = 0; i < nseg; i++) body_len += lace[i];
        if (body + body_len > len) break;
        if (!have_serial) { serial = ser; have_serial = true; }
        if (ser != serial) { pos = body + body_len; continue; }

        if (!(flags & 0x01) && continued_open) {
            // continuation promised but page says fresh: drop the partial
            partial.clear();
            continued_open = false;
        }
        const uint8_t* p = data + body;
        int last_pkt_on_page = -1;
        for (int i = 0; i < nseg; i++) {
            partial.insert(partial.end(), p, p + lace[i]);
            p += lace[i];
            if (lace[i] < 255) {
                Packet pk;
                pk.bytes = std::move(partial);
                partial.clear();
                out.push_back(std::move(pk));
                last_pkt_on_page = (int)out.size() - 1;
            }
        }
        continued_open = (nseg > 0 && lace[nseg - 1] == 255);
        if (last_pkt_on_page >= 0) {
            out[last_pkt_on_page].granule = granule;
            if (flags & 0x04) out[last_pkt_on_page].eos = true;
        }
        pos = body + body_len;
        if (flags & 0x04) break;
    }
    return !out.empty();
}

// ---------------------------------------------------------------------
// LSB-first bit reader (Vorbis bitpacking convention).

struct BitReader {
    const uint8_t* d;
    size_t nbytes;
    size_t bit = 0;
    bool eop = false;        // end-of-packet condition

    BitReader(const uint8_t* p, size_t n) : d(p), nbytes(n) {}

    uint32_t read(int n) {
        if (bit + n > nbytes * 8) {
            // partial-read semantics at end of packet: return the
            // available low bits without consuming (callers check eop)
            uint32_t v = 0;
            for (int i = 0; i < n; i++) {
                size_t b = bit + i;
                if (b >= nbytes * 8) { eop = true; return v; }
                v |= (uint32_t)((d[b >> 3] >> (b & 7)) & 1) << i;
            }
            bit += n;
            return v;
        }
        // LSB-first packing = consecutive bits ascend in significance of a
        // little-endian load
        size_t byte = bit >> 3;
        uint64_t w = 0;
        size_t take = nbytes - byte < 8 ? nbytes - byte : 8;
        memcpy(&w, d + byte, take);
        uint32_t v = (uint32_t)(w >> (bit & 7));
        if (n < 32) v &= (1u << n) - 1;
        bit += n;
        return v;
    }
    int read1() {
        if (bit >= nbytes * 8) { eop = true; return 0; }
        int v = (d[bit >> 3] >> (bit & 7)) & 1;
        bit++;
        return v;
    }
};

static int ilog(uint32_t v) {
    int r = 0;
    while (v) { r++; v >>= 1; }
    return r;
}

static double float32_unpack(uint32_t x) {
    double mant = (double)(x & 0x1fffff);
    int exp = (int)((x & 0x7fe00000) >> 21);
    if (x & 0x80000000u) mant = -mant;
    return ldexp(mant, exp - 788);
}

// ---------------------------------------------------------------------
// Codebooks.

struct Codebook {
    int dims = 0;
    int entries = 0;
    int lookup_type = 0;
    bool sequence_p = false;
    std::vector<float> vq;             // entries*dims (expanded)
    // decode tree: node i holds two children; negative = ~entry leaf
    std::vector<int32_t> tree;         // pairs: tree[2*i], tree[2*i+1]

    bool tree_add(uint32_t code, int len, int entry) {
        int node = 0;
        for (int depth = len - 1; depth >= 0; depth--) {
            int bit = (int)((code >> depth) & 1);
            size_t si = 2 * (size_t)node + bit;     // index, not a ref —
            if (depth == 0) {                       // push_back reallocates
                if (tree[si] != 0) return false;
                tree[si] = ~entry;
                return true;
            }
            if (tree[si] == 0) {
                int next = (int)tree.size() / 2;
                tree.push_back(0);
                tree.push_back(0);
                tree[si] = next;
            } else if (tree[si] < 0) {
                return false;          // prefix collision
            }
            node = tree[si];
        }
        return false;
    }

    // Spec codeword assignment: entries in order each take the lowest
    // available codeword of their length (Vorbis I sect. 3.2.1).
    bool build_tree(const std::vector<int>& lengths) {
        tree.assign(2, 0);
        uint32_t avail[33] = {0};      // MSB-aligned free subtree roots
        bool first = true;
        int used = 0;
        for (int e = 0; e < entries; e++) {
            int len = lengths[e];
            if (len <= 0) continue;
            used++;
            uint32_t code32;
            if (first) {
                first = false;
                code32 = 0;
                for (int k = 1; k <= len; k++)
                    avail[k] = 1u << (32 - k);
            } else {
                int z = len;
                while (z > 0 && !avail[z]) z--;
                if (z == 0) return false;     // over-subscribed
                code32 = avail[z];
                avail[z] = 0;
                // split the claimed subtree back into deeper leavings
                for (int y = z + 1; y <= len; y++)
                    avail[y] = code32 + (1u << (32 - y));
            }
            if (!tree_add(code32 >> (32 - len), len, e)) return false;
        }
        if (used == 1) {
            // single-entry book: spec decodes it with a single bit read
            return true;
        }
        return used > 0;
    }

    // accel table over the first 8 bits: >0 → (entry<<8)|len resolved,
    // <0 → -(node+1) to continue the walk, 0 → invalid prefix
    std::vector<int32_t> fast;

    void build_fast(int node, int depth, int prefix) {
        if (fast.empty()) fast.assign(256, 0);
        for (int b = 0; b < 2; b++) {
            int32_t slot = tree[2 * node + b];
            int p2 = prefix | (b << depth);
            if (slot < 0) {
                int32_t f = ((~slot) << 8) | (depth + 1);
                for (int v = p2; v < 256; v += 1 << (depth + 1))
                    fast[v] = f;
            } else if (slot > 0) {
                if (depth + 1 == 8)
                    fast[p2] = -(slot + 1);
                else
                    build_fast(slot, depth + 1, p2);
            }
        }
    }

    int walk(BitReader& br, int node) const {
        for (int guard = 0; guard < 33; guard++) {
            int bit = br.read1();
            if (br.eop) return -1;
            int32_t slot = tree[2 * node + bit];
            if (slot < 0) return ~slot;
            if (slot == 0) return -1;         // invalid codeword path
            node = slot;
        }
        return -1;
    }

    int decode(BitReader& br) const {
        if (!fast.empty() && br.bit + 8 <= br.nbytes * 8) {
            size_t byte = br.bit >> 3;
            uint32_t hi = byte + 1 < br.nbytes ? br.d[byte + 1] : 0;
            uint32_t v8 = (((uint32_t)br.d[byte] | (hi << 8))
                           >> (br.bit & 7)) & 0xFF;
            int32_t f = fast[v8];
            if (f > 0) {
                br.bit += f & 0xFF;
                return f >> 8;
            }
            if (f < 0) {
                br.bit += 8;
                return walk(br, -f - 1);
            }
            return -1;                        // invalid 8-bit prefix
        }
        return walk(br, 0);
    }
};

static bool read_codebook(BitReader& br, Codebook& cb) {
    if (br.read(24) != 0x564342) return false;      // "BCV" sync
    cb.dims = (int)br.read(16);
    cb.entries = (int)br.read(24);
    if (cb.dims <= 0 || cb.entries <= 0 || cb.entries > (1 << 22))
        return false;
    // cap the expanded VQ table: adversarial dims x entries would ask for
    // gigabytes (real streams stay well under a few MB)
    if ((int64_t)cb.dims * cb.entries > (1 << 24)) return false;
    std::vector<int> lengths(cb.entries, 0);
    int ordered = br.read1();
    if (!ordered) {
        int sparse = br.read1();
        for (int i = 0; i < cb.entries; i++) {
            if (sparse) {
                if (br.read1()) lengths[i] = (int)br.read(5) + 1;
            } else {
                lengths[i] = (int)br.read(5) + 1;
            }
        }
    } else {
        int cur_len = (int)br.read(5) + 1;
        int cur = 0;
        while (cur < cb.entries) {
            int num = (int)br.read(ilog((uint32_t)(cb.entries - cur)));
            if (cur + num > cb.entries) return false;
            for (int i = 0; i < num; i++) lengths[cur + i] = cur_len;
            cur += num;
            cur_len++;
            if (cur_len > 32) break;
        }
    }
    if (br.eop) return false;
    if (!cb.build_tree(lengths)) return false;
    cb.build_fast(0, 0, 0);

    cb.lookup_type = (int)br.read(4);
    if (cb.lookup_type == 0) return true;
    if (cb.lookup_type > 2) return false;

    double minv = float32_unpack(br.read(32));
    double delta = float32_unpack(br.read(32));
    int value_bits = (int)br.read(4) + 1;
    cb.sequence_p = br.read1() != 0;
    int lookup_values;
    if (cb.lookup_type == 1) {
        // largest integer v with v^dims <= entries
        lookup_values = 0;
        while (true) {
            double p = pow((double)(lookup_values + 1), (double)cb.dims);
            if (p > (double)cb.entries) break;
            lookup_values++;
        }
    } else {
        lookup_values = cb.entries * cb.dims;
    }
    std::vector<uint32_t> mult((size_t)lookup_values);
    for (int i = 0; i < lookup_values; i++) mult[i] = br.read(value_bits);
    if (br.eop) return false;

    // expand to entries x dims (VQ tables are small; memory is fine)
    cb.vq.assign((size_t)cb.entries * cb.dims, 0.0f);
    for (int e = 0; e < cb.entries; e++) {
        double last = 0.0;
        if (cb.lookup_type == 1) {
            int divisor = 1;
            for (int j = 0; j < cb.dims; j++) {
                int moff = (e / divisor) % lookup_values;
                double v = mult[moff] * delta + minv + last;
                cb.vq[(size_t)e * cb.dims + j] = (float)v;
                if (cb.sequence_p) last = v;
                divisor *= lookup_values;
            }
        } else {
            for (int j = 0; j < cb.dims; j++) {
                double v = mult[(size_t)e * cb.dims + j] * delta + minv
                    + last;
                cb.vq[(size_t)e * cb.dims + j] = (float)v;
                if (cb.sequence_p) last = v;
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------
// Setup structures.

struct Floor1 {
    int partitions = 0;
    int multiplier = 1;
    std::vector<int> partition_class;              // [partitions]
    std::vector<int> class_dims, class_subs, class_masterbook;
    std::vector<std::vector<int>> class_books;     // [class][1<<subs]
    std::vector<int> X;                            // posts
};

struct Floor0 {
    int order = 0;
    long rate = 0;
    int bark_map_size = 0;
    int amplitude_bits = 0;
    int amplitude_offset = 0;
    std::vector<int> books;
};

struct FloorCfg {
    int type = 1;
    Floor1 f1;
    Floor0 f0;
};

struct Residue {
    int type = 0;
    int begin = 0, end = 0;
    int partition_size = 0;
    int classifications = 0;
    int classbook = 0;
    std::vector<uint32_t> cascade;                 // [classifications]
    std::vector<int> books;                        // [classifications*8]
};

struct Mapping {
    int submaps = 1;
    std::vector<int> mag, ang;                     // coupling steps
    std::vector<int> mux;                          // [channels]
    std::vector<int> submap_floor, submap_residue;
};

struct Mode {
    int blockflag = 0;
    int mapping = 0;
};

struct Setup {
    int channels = 0;
    long rate = 0;
    int blocksize[2] = {0, 0};
    std::vector<Codebook> books;
    std::vector<FloorCfg> floors;
    std::vector<Residue> residues;
    std::vector<Mapping> mappings;
    std::vector<Mode> modes;
};

static bool read_floor1(BitReader& br, Floor1& f) {
    f.partitions = (int)br.read(5);
    f.partition_class.resize(f.partitions);
    int maxclass = -1;
    for (int i = 0; i < f.partitions; i++) {
        f.partition_class[i] = (int)br.read(4);
        if (f.partition_class[i] > maxclass) maxclass = f.partition_class[i];
    }
    int nclass = maxclass + 1;
    f.class_dims.resize(nclass);
    f.class_subs.resize(nclass);
    f.class_masterbook.assign(nclass, -1);
    f.class_books.resize(nclass);
    for (int i = 0; i < nclass; i++) {
        f.class_dims[i] = (int)br.read(3) + 1;
        f.class_subs[i] = (int)br.read(2);
        if (f.class_subs[i]) f.class_masterbook[i] = (int)br.read(8);
        int n = 1 << f.class_subs[i];
        f.class_books[i].resize(n);
        for (int k = 0; k < n; k++)
            f.class_books[i][k] = (int)br.read(8) - 1;
    }
    f.multiplier = (int)br.read(2) + 1;
    int rangebits = (int)br.read(4);
    f.X.clear();
    f.X.push_back(0);
    f.X.push_back(1 << rangebits);
    for (int i = 0; i < f.partitions; i++) {
        int c = f.partition_class[i];
        for (int k = 0; k < f.class_dims[c]; k++)
            f.X.push_back((int)br.read(rangebits));
    }
    return !br.eop && f.X.size() <= 65;
}

static bool read_setup(BitReader& br, Setup& s) {
    int nbooks = (int)br.read(8) + 1;
    s.books.resize(nbooks);
    for (int i = 0; i < nbooks; i++)
        if (!read_codebook(br, s.books[i])) return false;

    // time domain transforms (placeholders, must read 0)
    int ntimes = (int)br.read(6) + 1;
    for (int i = 0; i < ntimes; i++)
        if (br.read(16) != 0) return false;

    int nfloors = (int)br.read(6) + 1;
    s.floors.resize(nfloors);
    for (int i = 0; i < nfloors; i++) {
        int type = (int)br.read(16);
        s.floors[i].type = type;
        if (type == 1) {
            if (!read_floor1(br, s.floors[i].f1)) return false;
        } else if (type == 0) {
            Floor0& f = s.floors[i].f0;      // spec sect. 6.2 (LSP floor)
            f.order = (int)br.read(8);
            f.rate = (long)br.read(16);
            f.bark_map_size = (int)br.read(16);
            f.amplitude_bits = (int)br.read(6);
            f.amplitude_offset = (int)br.read(8);
            int nbo = (int)br.read(4) + 1;
            f.books.resize(nbo);
            for (int k = 0; k < nbo; k++) f.books[k] = (int)br.read(8);
            if (f.order <= 0 || f.rate <= 0 || f.bark_map_size <= 0)
                return false;
        } else {
            return false;
        }
    }

    int nres = (int)br.read(6) + 1;
    s.residues.resize(nres);
    for (int i = 0; i < nres; i++) {
        Residue& r = s.residues[i];
        r.type = (int)br.read(16);
        if (r.type > 2) return false;
        r.begin = (int)br.read(24);
        r.end = (int)br.read(24);
        r.partition_size = (int)br.read(24) + 1;
        r.classifications = (int)br.read(6) + 1;
        r.classbook = (int)br.read(8);
        r.cascade.resize(r.classifications);
        for (int j = 0; j < r.classifications; j++) {
            uint32_t high = 0;
            uint32_t low = br.read(3);
            if (br.read1()) high = br.read(5);
            r.cascade[j] = (high << 3) | low;
        }
        r.books.assign((size_t)r.classifications * 8, -1);
        for (int j = 0; j < r.classifications; j++)
            for (int k = 0; k < 8; k++)
                if (r.cascade[j] & (1u << k))
                    r.books[(size_t)j * 8 + k] = (int)br.read(8);
    }

    int nmaps = (int)br.read(6) + 1;
    s.mappings.resize(nmaps);
    for (int i = 0; i < nmaps; i++) {
        Mapping& m = s.mappings[i];
        if (br.read(16) != 0) return false;        // mapping type 0 only
        m.submaps = br.read1() ? (int)br.read(4) + 1 : 1;
        if (br.read1()) {
            int steps = (int)br.read(8) + 1;
            int bits = ilog((uint32_t)(s.channels - 1));
            m.mag.resize(steps);
            m.ang.resize(steps);
            for (int k = 0; k < steps; k++) {
                m.mag[k] = (int)br.read(bits);
                m.ang[k] = (int)br.read(bits);
                if (m.mag[k] == m.ang[k] || m.mag[k] >= s.channels
                    || m.ang[k] >= s.channels)
                    return false;
            }
        }
        if (br.read(2) != 0) return false;         // reserved
        m.mux.assign(s.channels, 0);
        if (m.submaps > 1)
            for (int c = 0; c < s.channels; c++)
                m.mux[c] = (int)br.read(4);
        m.submap_floor.resize(m.submaps);
        m.submap_residue.resize(m.submaps);
        for (int k = 0; k < m.submaps; k++) {
            br.read(8);                            // unused time config
            m.submap_floor[k] = (int)br.read(8);
            m.submap_residue[k] = (int)br.read(8);
        }
    }

    int nmodes = (int)br.read(6) + 1;
    s.modes.resize(nmodes);
    for (int i = 0; i < nmodes; i++) {
        s.modes[i].blockflag = br.read1();
        if (br.read(16) != 0) return false;        // windowtype
        if (br.read(16) != 0) return false;        // transformtype
        s.modes[i].mapping = (int)br.read(8);
        if (s.modes[i].mapping >= nmaps) return false;
    }
    if (br.read1() != 1) return false;             // framing
    if (br.eop) return false;

    // cross-validate every index a malformed stream could aim out of
    // bounds: codebook references, submap floor/residue numbers
    for (const FloorCfg& fc : s.floors) {
        if (fc.type == 0) {
            for (int b : fc.f0.books) {
                if (b < 0 || b >= nbooks) return false;
                if (s.books[b].lookup_type == 0 || s.books[b].dims <= 0)
                    return false;
            }
            if (fc.f0.books.empty()) return false;
            continue;
        }
        const Floor1& f = fc.f1;
        for (size_t c = 0; c < f.class_dims.size(); c++) {
            if (f.class_subs[c]
                && (f.class_masterbook[c] < 0
                    || f.class_masterbook[c] >= nbooks))
                return false;
            for (int b : f.class_books[c])
                if (b >= nbooks) return false;
        }
    }
    for (const Residue& r : s.residues) {
        if (r.classbook < 0 || r.classbook >= nbooks) return false;
        if (s.books[r.classbook].dims <= 0) return false;
        for (int b : r.books) {
            if (b >= nbooks) return false;
            if (b >= 0 && s.books[b].dims <= 0) return false;
        }
        if (r.partition_size <= 0 || r.end < r.begin) return false;
    }
    for (const Mapping& m : s.mappings) {
        for (int c : m.mux)
            if (c >= m.submaps) return false;
        for (int k = 0; k < m.submaps; k++) {
            if (m.submap_floor[k] >= (int)s.floors.size()) return false;
            if (m.submap_residue[k] >= (int)s.residues.size())
                return false;
        }
    }
    return true;
}

// ---------------------------------------------------------------------
// Floor 1 curve decode + synthesis.

static int low_neighbor(const std::vector<int>& X, int i) {
    int best = -1, n = 0;
    for (int j = 0; j < i; j++)
        if (X[j] < X[i] && (best < 0 || X[j] > X[best])) best = j;
    (void)n;
    return best < 0 ? 0 : best;
}

static int high_neighbor(const std::vector<int>& X, int i) {
    int best = -1;
    for (int j = 0; j < i; j++)
        if (X[j] > X[i] && (best < 0 || X[j] < X[best])) best = j;
    return best < 0 ? 0 : best;
}

static int render_point(int x0, int y0, int x1, int y1, int X) {
    int dy = y1 - y0;
    int adx = x1 - x0;
    int ady = dy < 0 ? -dy : dy;
    int err = ady * (X - x0);
    int off = adx ? err / adx : 0;
    return dy < 0 ? y0 - off : y0 + off;
}

static void render_line(int x0, int y0, int x1, int y1, float* d, int n) {
    int dy = y1 - y0;
    int adx = x1 - x0;
    int ady = dy < 0 ? -dy : dy;
    int base = adx ? dy / adx : 0;
    int sy = dy < 0 ? base - 1 : base + 1;
    int abase = base < 0 ? -base : base;
    ady -= abase * adx;
    int x = x0, y = y0, err = 0;
    if (x1 > n) x1 = n;
    if (x >= 0 && x < x1) d[x] *= kFloor1FromDb[y < 0 ? 0 : (y > 255 ? 255 : y)];
    for (x = x0 + 1; x < x1; x++) {
        err += ady;
        if (err >= adx) { err -= adx; y += sy; } else { y += base; }
        int yc = y < 0 ? 0 : (y > 255 ? 255 : y);
        d[x] *= kFloor1FromDb[yc];
    }
}

// ---------------------------------------------------------------------
// Floor 0 (LSP floor, spec sect. 6).  Decode reads an amplitude and LSP
// coefficients through a VQ codebook; synthesis evaluates the LSP filter
// response on a bark-scale map.  Behavior-matched to the reference
// (floor0.c/lsp.c float path); implemented from the spec formulas.

static double to_bark(double n) {
    return 13.1 * atan(0.00074 * n) + 2.24 * atan(n * n * 1.85e-8)
        + 1e-4 * n;
}

// returns false for "unused channel"; err set on end-of-packet
static bool floor0_decode(BitReader& br, const Setup& s, const Floor0& f,
                          const std::vector<int>& map, int n2, float* curve,
                          bool& err) {
    int ampraw = (int)br.read(f.amplitude_bits);
    if (br.eop) { err = true; return false; }
    if (ampraw <= 0) return false;
    long maxval = (1L << f.amplitude_bits) - 1;
    double amp = (double)ampraw / maxval * f.amplitude_offset;
    int booknum = (int)br.read(ilog((uint32_t)f.books.size()));
    if (booknum >= (int)f.books.size()) return false;   // paranoia (ref)
    const Codebook& b = s.books[f.books[booknum]];

    std::vector<double> lsp((size_t)f.order + b.dims + 1, 0.0);
    for (int j = 0; j < f.order; j += b.dims) {
        int e = b.decode(br);
        if (e < 0) { err = true; return false; }
        for (int k = 0; k < b.dims; k++)
            lsp[(size_t)j + k] = b.vq[(size_t)e * b.dims + k];
    }
    double last = 0.0;
    for (int j = 0; j < f.order;) {
        for (int k = 0; k < b.dims && j < f.order; k++, j++)
            lsp[j] += last;
        last = lsp[j - 1];
    }

    // LSP -> spectral envelope (cos domain, pairwise products)
    int m = f.order;
    std::vector<double> lc(m);
    for (int j = 0; j < m; j++) lc[j] = 2.0 * cos(lsp[j]);
    double wdel = M_PI / f.bark_map_size;
    int i = 0;
    while (i < n2) {
        int k = map[i];
        double p = 0.5, q = 0.5;
        double w = 2.0 * cos(wdel * k);
        int j;
        for (j = 1; j < m; j += 2) {
            q *= w - lc[j - 1];
            p *= w - lc[j];
        }
        if (j == m) {          // odd order
            q *= w - lc[j - 1];
            p *= p * (4.0 - w * w);
            q *= q;
        } else {               // even order
            p *= p * (2.0 - w);
            q *= q * (2.0 + w);
        }
        double den = sqrt(p + q);
        double v = exp((amp / (den > 0 ? den : 1e-30)
                        - f.amplitude_offset) * 0.11512925);
        curve[i] = (float)v;
        while (++i < n2 && map[i] == k) curve[i] = (float)v;
    }
    return true;
}

// returns false for "unused channel" (zero floor)
static bool floor1_decode(BitReader& br, const Setup& s, const Floor1& f,
                          int n2, float* curve, bool& err) {
    static const int kRange[4] = {256, 128, 86, 64};
    if (!br.read1()) return false;
    int range = kRange[f.multiplier - 1];
    int posts = (int)f.X.size();
    std::vector<int> Y(posts, 0);
    int ybits = ilog((uint32_t)(range - 1));
    Y[0] = (int)br.read(ybits);
    Y[1] = (int)br.read(ybits);
    int offset = 2;
    for (int i = 0; i < f.partitions; i++) {
        int cls = f.partition_class[i];
        int cdim = f.class_dims[cls];
        int cbits = f.class_subs[cls];
        int csub = (1 << cbits) - 1;
        int cval = 0;
        if (cbits) {
            cval = s.books[f.class_masterbook[cls]].decode(br);
            if (cval < 0) { err = true; return false; }
        }
        for (int k = 0; k < cdim; k++) {
            int book = f.class_books[cls][cval & csub];
            cval >>= cbits;
            if (book >= 0) {
                int v = s.books[book].decode(br);
                if (v < 0) { err = true; return false; }
                Y[offset + k] = v;
            } else {
                Y[offset + k] = 0;
            }
        }
        offset += cdim;
    }
    if (br.eop) { err = true; return false; }

    // amplitude synthesis (spec 7.2.4 step 1)
    std::vector<int> finalY(posts);
    std::vector<bool> step2(posts, false);
    finalY[0] = Y[0];
    finalY[1] = Y[1];
    step2[0] = step2[1] = true;
    for (int i = 2; i < posts; i++) {
        int lo = low_neighbor(f.X, i);
        int hi = high_neighbor(f.X, i);
        int predicted = render_point(f.X[lo], finalY[lo], f.X[hi],
                                     finalY[hi], f.X[i]);
        int val = Y[i];
        int highroom = range - predicted;
        int lowroom = predicted;
        int room = (highroom < lowroom ? highroom : lowroom) * 2;
        if (val) {
            step2[lo] = true;
            step2[hi] = true;
            step2[i] = true;
            if (val >= room) {
                finalY[i] = highroom > lowroom ? val - lowroom + predicted
                                               : predicted - val + highroom - 1;
            } else {
                finalY[i] = (val & 1) ? predicted - ((val + 1) >> 1)
                                      : predicted + (val >> 1);
            }
        } else {
            step2[i] = false;
            finalY[i] = predicted;
        }
        if (finalY[i] < 0) finalY[i] = 0;
        if (finalY[i] > range - 1) finalY[i] = range - 1;
    }

    // curve synthesis (step 2): sort posts by X, render lines between the
    // step2 points in the multiplied (0..255) domain
    std::vector<int> order(posts);
    for (int i = 0; i < posts; i++) order[i] = i;
    for (int i = 1; i < posts; i++) {      // insertion sort (posts <= 65)
        int t = order[i], j = i - 1;
        while (j >= 0 && f.X[order[j]] > f.X[t]) {
            order[j + 1] = order[j];
            j--;
        }
        order[j + 1] = t;
    }
    for (int i = 0; i < n2; i++) curve[i] = 1.0f;
    int hx = 0, hy = 0;
    int lx = 0, ly = finalY[order[0]] * f.multiplier;
    for (int oi = 1; oi < posts; oi++) {
        int i = order[oi];
        if (!step2[i]) continue;
        hx = f.X[i];
        hy = finalY[i] * f.multiplier;
        render_line(lx, ly, hx, hy, curve, n2);
        lx = hx;
        ly = hy;
    }
    if (hx < n2) {
        // extend the last value to the end
        int yc = ly < 0 ? 0 : (ly > 255 ? 255 : ly);
        for (int x = hx < 0 ? 0 : hx; x < n2; x++)
            curve[x] *= kFloor1FromDb[yc];
    }
    return true;
}

// ---------------------------------------------------------------------
// Residue decode.

static bool residue_partition(BitReader& br, const Codebook& cb, int format,
                              float* v, int offset, int psize) {
    if (format == 0) {
        int step = psize / cb.dims;
        for (int i = 0; i < step; i++) {
            int e = cb.decode(br);
            if (e < 0) return false;
            for (int j = 0; j < cb.dims; j++)
                v[offset + i + j * step] += cb.vq[(size_t)e * cb.dims + j];
        }
    } else {                                   // formats 1 and 2
        int i = 0;
        while (i < psize) {
            int e = cb.decode(br);
            if (e < 0) return false;
            for (int j = 0; j < cb.dims && i < psize; j++, i++)
                v[offset + i] += cb.vq[(size_t)e * cb.dims + j];
        }
    }
    return true;
}

// ch_vec: the channel vectors to fill; do_not: per-vector skip flags.
static bool residue_decode(BitReader& br, const Setup& s, const Residue& r,
                           std::vector<float*>& ch_vec,
                           const std::vector<bool>& do_not, int n2) {
    int nvec = (int)ch_vec.size();
    int type = r.type;
    std::vector<float> interleaved;
    std::vector<float*> vecs = ch_vec;
    std::vector<bool> skip = do_not;
    int actual_size = n2;
    if (type == 2) {
        actual_size = n2 * nvec;
        bool all_skip = true;
        for (bool b : skip) all_skip = all_skip && b;
        if (all_skip) return true;
        interleaved.assign((size_t)actual_size, 0.0f);
        vecs.assign(1, interleaved.data());
        skip.assign(1, false);
        nvec = 1;
    }
    int begin = r.begin < actual_size ? r.begin : actual_size;
    int end = r.end < actual_size ? r.end : actual_size;
    int psize = r.partition_size;
    int parts = (end - begin) / psize;
    if (parts <= 0) {
        // nothing to decode; fall through to deinterleave for type 2
    } else {
        const Codebook& classbook = s.books[r.classbook];
        int cw = classbook.dims;
        std::vector<std::vector<int>> classes(
            nvec, std::vector<int>(parts + cw, 0));
        for (int pass = 0; pass < 8; pass++) {
            int pc = 0;
            while (pc < parts) {
                if (pass == 0) {
                    for (int j = 0; j < nvec; j++) {
                        if (skip[j]) continue;
                        int temp = classbook.decode(br);
                        if (temp < 0) return true;   // EOP = done (spec)
                        for (int i = cw - 1; i >= 0; i--) {
                            classes[j][pc + i] = temp % r.classifications;
                            temp /= r.classifications;
                        }
                    }
                }
                for (int i = 0; i < cw && pc < parts; i++, pc++) {
                    for (int j = 0; j < nvec; j++) {
                        if (skip[j]) continue;
                        int vq = classes[j][pc];
                        int book = r.books[(size_t)vq * 8 + pass];
                        if (book < 0) continue;
                        if (!residue_partition(br, s.books[book],
                                               type == 0 ? 0 : 1, vecs[j],
                                               begin + pc * psize, psize))
                            return true;             // EOP mid-partition
                    }
                }
            }
        }
    }
    if (type == 2) {
        // deinterleave into every submap channel (spec: a type-2 residue
        // decodes all channels together once any of them is audible)
        for (int i = 0; i < n2; i++)
            for (int j = 0; j < (int)ch_vec.size(); j++)
                ch_vec[j][i] = interleaved[(size_t)i * ch_vec.size() + j];
    }
    return true;
}

// ---------------------------------------------------------------------
// IMDCT (direct form; spec 4.3.6) with an N/4 pre-twiddled FFT fast path.

struct Imdct {
    // IMDCT via one positive-exponent complex FFT of size n/4.
    //
    // With M = n/2 spectral inputs and outputs y[i], i in [0, n):
    //   y[i] = sum_k X[k] cos(pi/M (i + 1/2 + M/2)(k + 1/2))   (spec 4.3.6)
    // Pairing k = 2j with M-1-2j and using e^{i phi M} = i (even i, M/2
    // even) gives  y[2p] = Re( w[p] * F[p mod M/2] )  where
    //   z[j]  = X[2j] - i X[M-1-2j]
    //   z'[j] = z[j] (-1)^j e^{i pi j / M}
    //   F     = positive-exponent DFT_{M/2}(z')
    //   w[p]  = e^{i pi (2p + 1/2 + M/2) / (2M)}
    // and the odd outputs follow from the IMDCT symmetries
    //   y[i] = -y[M-1-i] (i < M),  y[q] = y[3M-1-q] (q >= M).
    // Verified against the direct spec formula (vorbis_imdct_selftest).
    int n = 0;
    std::vector<double> pre_re, pre_im;    // (-1)^j e^{i pi j/M}, j < M/2
    std::vector<double> post_re, post_im;  // w[p], p < M
    std::vector<int> rev;

    void init(int n_) {
        n = n_;
        int M = n / 2, M2 = n / 4;
        pre_re.resize(M2);
        pre_im.resize(M2);
        for (int j = 0; j < M2; j++) {
            double a = M_PI * j / M;
            double s = (j & 1) ? -1.0 : 1.0;
            pre_re[j] = s * cos(a);
            pre_im[j] = s * sin(a);
        }
        post_re.resize(M);
        post_im.resize(M);
        for (int p = 0; p < M; p++) {
            double a = M_PI * (2.0 * p + 0.5 + M / 2.0) / (2.0 * M);
            post_re[p] = cos(a);
            post_im[p] = sin(a);
        }
        int bits = 0;
        while ((1 << bits) < M2) bits++;
        rev.resize(M2);
        for (int i = 0; i < M2; i++) {
            int r = 0;
            for (int b = 0; b < bits; b++)
                r |= ((i >> b) & 1) << (bits - 1 - b);
            rev[i] = r;
        }
    }

    // in: spectral X[0..n/2); out: y[0..n)
    void run(const float* X, float* y) const {
        int M = n / 2, M2 = n / 4;
        std::vector<double> fre(M2), fim(M2);
        for (int j = 0; j < M2; j++) {
            int jj = rev[j];
            double a = X[2 * jj];
            double b = -X[M - 1 - 2 * jj];          // z = a + ib with b<0
            fre[j] = a * pre_re[jj] - b * pre_im[jj];
            fim[j] = a * pre_im[jj] + b * pre_re[jj];
        }
        for (int len = 2; len <= M2; len <<= 1) {
            double ang = 2.0 * M_PI / len;          // positive exponent
            double wr = cos(ang), wi = sin(ang);
            for (int i = 0; i < M2; i += len) {
                double cr = 1.0, ci = 0.0;
                for (int j = 0; j < len / 2; j++) {
                    int a_ = i + j, b_ = i + j + len / 2;
                    double tr = fre[b_] * cr - fim[b_] * ci;
                    double ti = fre[b_] * ci + fim[b_] * cr;
                    fre[b_] = fre[a_] - tr;
                    fim[b_] = fim[a_] - ti;
                    fre[a_] += tr;
                    fim[a_] += ti;
                    double ncr = cr * wr - ci * wi;
                    ci = cr * wi + ci * wr;
                    cr = ncr;
                }
            }
        }
        for (int p = 0; p < M; p++) {
            int q = p & (M2 - 1);
            y[2 * p] = (float)(post_re[p] * fre[q] - post_im[p] * fim[q]);
        }
        for (int i = 1; i < M; i += 2) y[i] = -y[M - 1 - i];
        for (int q = M + 1; q < 2 * M; q += 2) y[q] = y[3 * M - 1 - q];
    }

    // direct O(n^2) reference (spec formula); used for self-checking
    void run_direct(const float* X, float* y) const {
        int n2 = n / 2;
        for (int i = 0; i < n; i++) {
            double acc = 0;
            for (int k = 0; k < n2; k++)
                acc += X[k] * cos(M_PI / (2.0 * n)
                                  * (2.0 * i + 1.0 + n2) * (2.0 * k + 1.0));
            y[i] = (float)acc;
        }
    }
};

// ---------------------------------------------------------------------
// Full stream decoder.

struct Decoder {
    Setup s;
    Imdct imdct[2];
    std::vector<std::vector<float>> win;   // [4] windows: see get_window

    // lapping state
    std::vector<float> acc;                // accumulation from watermark
    int64_t acc_start = 0;                 // absolute sample pos of acc[0]
    int64_t center = 0;                    // center of current block
    int64_t watermark = -1;                // emitted-up-to marker (-1: none)
    bool have_prev = false;
    int prev_bs = 0;

    std::vector<float> out;                // interleaved emitted samples

    const char* error = nullptr;

    // cached floor0 bark-scale maps, keyed by (floor index, blockflag)
    std::vector<std::array<std::vector<int>, 2>> f0_maps;

    const std::vector<int>& f0_map(int fi, int bf, int n2) {
        if (f0_maps.empty()) f0_maps.resize(s.floors.size());
        std::vector<int>& m = f0_maps[fi][bf];
        if (m.empty()) {
            const Floor0& f = s.floors[fi].f0;
            double scale = f.bark_map_size / to_bark(f.rate / 2.0);
            m.resize(n2);
            for (int j = 0; j < n2; j++) {
                int val = (int)floor(
                    to_bark((f.rate / 2.0) / n2 * j) * scale);
                if (val >= f.bark_map_size) val = f.bark_map_size - 1;
                m[j] = val;
            }
        }
        return m;
    }

    // window slope value: sin(pi/2 * sin^2(pi/n (i+.5)))
    static float slope(int i, int n) {
        double x = sin(M_PI / n * (i + 0.5));
        return (float)sin(M_PI / 2.0 * x * x);
    }

    bool headers(const std::vector<Packet>& pk, int& audio_first) {
        int hdr = 0;
        size_t i = 0;
        for (; i < pk.size() && hdr < 3; i++) {
            const auto& b = pk[i].bytes;
            if (b.size() < 7) continue;
            if (memcmp(b.data() + 1, "vorbis", 6) != 0) continue;
            BitReader br(b.data() + 7, b.size() - 7);
            if (b[0] == 1 && hdr == 0) {
                if (br.read(32) != 0) return false;        // version
                s.channels = (int)br.read(8);
                s.rate = (long)br.read(32);
                br.read(32); br.read(32); br.read(32);     // bitrates
                int bs = (int)br.read(4);
                int bs1 = (int)br.read(4);
                s.blocksize[0] = 1 << bs;
                s.blocksize[1] = 1 << bs1;
                if (s.channels <= 0 || s.rate <= 0) return false;
                if (s.blocksize[0] < 64 || s.blocksize[1] < s.blocksize[0]
                    || s.blocksize[1] > 8192)
                    return false;
                hdr = 1;
            } else if (b[0] == 3 && hdr == 1) {
                hdr = 2;                                   // comments: skip
            } else if (b[0] == 5 && hdr == 2) {
                if (!read_setup(br, s)) return false;
                hdr = 3;
            }
        }
        if (hdr != 3) return false;
        audio_first = (int)i;
        imdct[0].init(s.blocksize[0]);
        imdct[1].init(s.blocksize[1]);
        return true;
    }

    // windows, cached per (n, left_slope_n, right_slope_n)
    std::vector<std::pair<uint64_t, std::vector<float>>> win_cache;

    const std::vector<float>& get_window(int n, int ls_n, int rs_n) {
        uint64_t key = ((uint64_t)n << 32) | ((uint64_t)ls_n << 16) | rs_n;
        for (auto& kv : win_cache)
            if (kv.first == key) return kv.second;
        std::vector<float> w((size_t)n, 1.0f);
        int ls = n / 4 - ls_n / 4;
        int le = n / 4 + ls_n / 4;
        int rs = 3 * n / 4 - rs_n / 4;
        int re = 3 * n / 4 + rs_n / 4;
        for (int i = 0; i < ls; i++) w[i] = 0.0f;
        for (int i = ls; i < le; i++) w[i] = slope(i - ls, ls_n);
        for (int i = rs; i < re; i++) w[i] = slope(re - 1 - i, rs_n);
        for (int i = re; i < n; i++) w[i] = 0.0f;
        win_cache.emplace_back(key, std::move(w));
        return win_cache.back().second;
    }

    void apply_window(std::vector<float>& y, int n, int ls_n, int rs_n) {
        const std::vector<float>& w = get_window(n, ls_n, rs_n);
        for (int i = 0; i < n; i++) y[i] *= w[i];
    }

    bool audio_packet(const std::vector<uint8_t>& b) {
        BitReader br(b.data(), b.size());
        if (br.read1() != 0) return true;          // not audio: ignore
        int mode_bits = ilog((uint32_t)(s.modes.size() - 1));
        int mode_i = (int)br.read(mode_bits);
        if (mode_i >= (int)s.modes.size()) return true;
        const Mode& mode = s.modes[mode_i];
        int bf = mode.blockflag;
        int n = s.blocksize[bf];
        int n2 = n / 2;
        int prev_flag = 1, next_flag = 1;
        if (bf) {
            prev_flag = br.read1();
            next_flag = br.read1();
        }
        const Mapping& map = s.mappings[mode.mapping];

        // floors
        int ch = s.channels;
        std::vector<std::vector<float>> floors(
            ch, std::vector<float>((size_t)n2));
        std::vector<bool> nonzero(ch, false);
        for (int c = 0; c < ch; c++) {
            int fi = map.submap_floor[map.mux[c]];
            const FloorCfg& fc = s.floors[fi];
            bool err = false;
            if (fc.type == 1) {
                nonzero[c] = floor1_decode(br, s, fc.f1, n2,
                                           floors[c].data(), err);
            } else {
                nonzero[c] = floor0_decode(br, s, fc.f0,
                                           f0_map(fi, bf, n2),
                                           n2, floors[c].data(), err);
            }
            if (err) {
                // end-of-packet during floor: whole frame is silence
                for (int k = 0; k < ch; k++) nonzero[k] = false;
                break;
            }
        }

        // coupling propagation
        std::vector<bool> decode_ch = nonzero;
        for (size_t k = 0; k < map.mag.size(); k++)
            if (decode_ch[map.mag[k]] || decode_ch[map.ang[k]]) {
                decode_ch[map.mag[k]] = true;
                decode_ch[map.ang[k]] = true;
            }

        // residues per submap
        std::vector<std::vector<float>> res(
            ch, std::vector<float>((size_t)n2, 0.0f));
        for (int sm = 0; sm < map.submaps; sm++) {
            std::vector<float*> vecs;
            std::vector<bool> skip;
            std::vector<int> chans;
            for (int c = 0; c < ch; c++)
                if (map.mux[c] == sm) {
                    vecs.push_back(res[c].data());
                    skip.push_back(!decode_ch[c]);
                    chans.push_back(c);
                }
            const Residue& r = s.residues[map.submap_residue[sm]];
            residue_decode(br, s, r, vecs, skip, n2);
        }

        // inverse coupling (square polar; spec 4.3.4 step 5)
        for (int k = (int)map.mag.size() - 1; k >= 0; k--) {
            float* M = res[map.mag[k]].data();
            float* A = res[map.ang[k]].data();
            for (int i = 0; i < n2; i++) {
                float m = M[i], a = A[i];
                float nm, na;
                if (m > 0) {
                    if (a > 0) { nm = m; na = m - a; }
                    else { na = m; nm = m + a; }
                } else {
                    if (a > 0) { nm = m; na = m + a; }
                    else { na = m; nm = m - a; }
                }
                M[i] = nm;
                A[i] = na;
            }
        }

        // floor multiply + IMDCT + window + lap.  Block centers advance by
        // prev_n/4 + n/4 (the granule rule), placing each block's left
        // slope exactly over the previous block's right slope.
        if (have_prev) center += prev_bs / 4 + n / 4;
        int64_t block_start = center - n2;
        int ls_n = prev_flag ? n : s.blocksize[0];
        int rs_n = next_flag ? n : s.blocksize[0];
        if (!bf) { ls_n = n; rs_n = n; }
        int rs_off = 3 * n / 4 - rs_n / 4;
        int re_off = 3 * n / 4 + rs_n / 4;
        int ls_off = n / 4 - ls_n / 4;

        // grow acc to cover this block
        if (watermark < 0 && !have_prev) {
            acc_start = block_start;
            acc.assign((size_t)(ch * n), 0.0f);
        }
        int64_t need_end = block_start + re_off;
        int64_t have_end = acc_start + (int64_t)(acc.size() / ch);
        if (need_end > have_end)
            acc.resize((size_t)(ch * (need_end - acc_start)), 0.0f);

        int64_t acc_frames = (int64_t)(acc.size() / ch);
        std::vector<float> y((size_t)n);
        for (int c = 0; c < ch; c++) {
            if (nonzero[c] || decode_ch[c]) {
                std::vector<float> spec((size_t)n2, 0.0f);
                if (nonzero[c])
                    for (int i = 0; i < n2; i++)
                        spec[i] = res[c][i] * floors[c][i];
                imdct[bf].run(spec.data(), y.data());
                apply_window(y, n, ls_n, rs_n);
                int64_t off0 = block_start - acc_start;
                for (int i = ls_off; i < re_off; i++) {
                    int64_t t = off0 + i;     // guard: corrupt window
                    if (t < 0 || t >= acc_frames) continue;   // flags can
                    acc[(size_t)(t * ch + c)] += y[i];        // misalign
                }
            }
        }

        // emit finished samples [watermark, block_start + rs_off)
        int64_t fin = block_start + rs_off;
        if (fin > acc_start + acc_frames) fin = acc_start + acc_frames;
        if (!have_prev) {
            watermark = center;            // first frame returns nothing
        } else {
            if (watermark < acc_start) watermark = acc_start;
            for (int64_t t = watermark; t < fin; t++)
                for (int c = 0; c < ch; c++)
                    out.push_back(acc[(size_t)((t - acc_start) * ch + c)]);
            if (fin > watermark) watermark = fin;
        }
        // drop emitted prefix
        int64_t drop = watermark - acc_start;
        if (drop > 0) {
            acc.erase(acc.begin(), acc.begin() + (size_t)(drop * ch));
            acc_start = watermark;
        }
        have_prev = true;
        prev_bs = n;
        return true;
    }

    bool decode_all(const uint8_t* data, int64_t len) {
        std::vector<Packet> pk;
        if (!parse_ogg(data, len, pk)) { error = "not an Ogg stream"; return false; }
        int first = 0;
        if (!headers(pk, first)) { error = "bad Vorbis headers"; return false; }
        int64_t final_granule = -1;
        for (size_t i = first; i < pk.size(); i++) {
            if (pk[i].bytes.empty()) continue;
            if (pk[i].bytes[0] & 1) continue;      // header packet: skip
            if (!audio_packet(pk[i].bytes)) return false;
            if (pk[i].granule >= 0) final_granule = pk[i].granule;
        }
        // trim to the final granule (total valid samples)
        if (final_granule >= 0) {
            size_t want = (size_t)final_granule * s.channels;
            if (out.size() > want) out.resize(want);
        }
        return true;
    }
};

}  // namespace vorbis

// ---------------------------------------------------------------------
// C ABI (mirrors mp3.cpp / flac.cpp)

extern "C" {

// meta = [sample_rate, channels, 0, 0].  0 ok, -1 not Ogg/Vorbis.
int vorbis_probe(const uint8_t* data, int64_t len, int32_t* meta) {
    std::vector<vorbis::Packet> pk;
    if (!vorbis::parse_ogg(data, len, pk)) return -1;
    vorbis::Decoder d;
    int first = 0;
    if (!d.headers(pk, first)) return -1;
    meta[0] = (int32_t)d.s.rate;
    meta[1] = (int32_t)d.s.channels;
    meta[2] = 0;
    meta[3] = 0;
    return 0;
}

// Decode the whole stream to float32 interleaved.  Returns the total
// per-channel sample count, or -1 on error.  If out is null, only counts.
int64_t vorbis_decode(const uint8_t* data, int64_t len, float* out,
                      int64_t max_samples) {
    vorbis::Decoder d;
    if (!d.decode_all(data, len)) return -1;
    int64_t frames = (int64_t)(d.out.size() / d.s.channels);
    if (out != nullptr) {
        int64_t n = frames < max_samples ? frames : max_samples;
        memcpy(out, d.out.data(),
               (size_t)(n * d.s.channels) * sizeof(float));
        frames = n;
    }
    return frames;
}

// Self-check hook for tests: run the fast IMDCT and the direct spec
// formula on the same random spectrum; returns max abs error.
double vorbis_imdct_selftest(int n, const float* X, float* y_fast,
                             float* y_direct) {
    vorbis::Imdct im;
    im.init(n);
    im.run(X, y_fast);
    im.run_direct(X, y_direct);
    double m = 0;
    for (int i = 0; i < n; i++) {
        double e = fabs((double)y_fast[i] - (double)y_direct[i]);
        if (e > m) m = e;
    }
    return m;
}

}  // extern "C"
