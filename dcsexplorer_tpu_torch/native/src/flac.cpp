// From-scratch FLAC decoder for the encoder's audio-input path.
//
// Counterpart of the reference's vendored libnyquist input layer
// (reference: DCSEncoder/DCSEncodeFile.cpp:6-21 uses libnyquist for
// MP3/Ogg/FLAC/WAV decode).  This framework vendors nothing: WAV parses in
// Python (utils/audioio.py) and FLAC — the one compressed input format that
// matters for an encoder toolchain, being lossless — decodes here.
// Written from the FLAC format specification (RFC 9639); supports
// constant/verbatim/fixed/LPC subframes, Rice/Rice2 residuals with escape
// partitions, wasted bits, and left/right/mid-side stereo decorrelation.
// Validated losslessly against a test-built encoder (tests/test_audioio.py).

#include <stdint.h>
#include <string.h>

namespace {

struct FlacBits {
    const uint8_t* d;
    int64_t len;
    int64_t pos;    // bit position
    bool bad;

    void init(const uint8_t* data, int64_t l, int64_t bytepos) {
        d = data; len = l; pos = bytepos * 8; bad = false;
    }
    inline int64_t bytePos() const { return pos >> 3; }
    inline bool atEnd() const { return pos >= len * 8; }
    inline uint32_t bit() {
        if (pos >= len * 8) { bad = true; return 0; }
        uint32_t v = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        ++pos;
        return v;
    }
    uint32_t bits(int n) {            // n <= 32
        uint32_t v = 0;
        while (n > 0 && !bad) {
            if (pos >= len * 8) { bad = true; break; }
            int avail = 8 - static_cast<int>(pos & 7);
            int take = n < avail ? n : avail;
            uint32_t byte = d[pos >> 3];
            uint32_t chunk = (byte >> (avail - take)) & ((1u << take) - 1);
            v = (v << take) | chunk;
            pos += take;
            n -= take;
        }
        return v;
    }
    uint64_t bits64(int n) {
        if (n <= 32) return bits(n);
        uint64_t hi = bits(n - 32);
        return (hi << 32) | bits(32);
    }
    int64_t signedBits(int n) {
        uint64_t v = bits64(n);
        if (n == 0) return 0;
        return (static_cast<int64_t>(v << (64 - n))) >> (64 - n);
    }
    uint32_t unary() {
        uint32_t q = 0;
        while (!bad && bit() == 0) ++q;
        return q;
    }
    void alignByte() { pos = (pos + 7) & ~7ll; }
};

// Rice-coded residual into res[0..count)
bool readResidual(FlacBits& b, int64_t* res, int blocksize, int order) {
    int method = static_cast<int>(b.bits(2));
    if (method > 1) return false;
    int pbits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0xF : 0x1F;
    int po = static_cast<int>(b.bits(4));
    int nparts = 1 << po;
    if (blocksize % nparts != 0) return false;
    int idx = order;
    for (int p = 0; p < nparts; ++p) {
        int n = blocksize >> po;
        if (p == 0) n -= order;
        if (n < 0) return false;
        int param = static_cast<int>(b.bits(pbits));
        if (param == escape) {
            int raw = static_cast<int>(b.bits(5));
            for (int i = 0; i < n; ++i) res[idx++] = b.signedBits(raw);
        } else {
            for (int i = 0; i < n; ++i) {
                uint32_t q = b.unary();
                uint64_t v = (static_cast<uint64_t>(q) << param)
                    | b.bits(param);
                res[idx++] = static_cast<int64_t>(v >> 1)
                    ^ -static_cast<int64_t>(v & 1);
            }
        }
        if (b.bad) return false;
    }
    return true;
}

bool readSubframe(FlacBits& b, int64_t* x, int blocksize, int bps) {
    if (b.bit() != 0) return false;               // zero pad bit
    int type = static_cast<int>(b.bits(6));
    int wasted = 0;
    if (b.bit()) wasted = static_cast<int>(b.unary()) + 1;
    bps -= wasted;
    if (bps <= 0 || bps > 33) return false;

    if (type == 0) {                               // constant
        int64_t v = b.signedBits(bps);
        for (int i = 0; i < blocksize; ++i) x[i] = v;
    } else if (type == 1) {                        // verbatim
        for (int i = 0; i < blocksize; ++i) x[i] = b.signedBits(bps);
    } else if (type >= 8 && type <= 12) {          // fixed, order 0..4
        int order = type - 8;
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) x[i] = b.signedBits(bps);
        if (!readResidual(b, x, blocksize, order)) return false;
        for (int i = order; i < blocksize; ++i) {
            int64_t p = 0;
            switch (order) {
                case 0: p = 0; break;
                case 1: p = x[i-1]; break;
                case 2: p = 2*x[i-1] - x[i-2]; break;
                case 3: p = 3*x[i-1] - 3*x[i-2] + x[i-3]; break;
                case 4: p = 4*x[i-1] - 6*x[i-2] + 4*x[i-3] - x[i-4]; break;
            }
            x[i] += p;
        }
    } else if (type >= 32) {                       // LPC, order 1..32
        int order = (type & 0x1F) + 1;
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) x[i] = b.signedBits(bps);
        int prec = static_cast<int>(b.bits(4)) + 1;
        if (prec == 16) return false;              // invalid per spec
        int shift = static_cast<int>(b.signedBits(5));
        if (shift < 0) return false;
        int64_t coef[32];
        for (int i = 0; i < order; ++i) coef[i] = b.signedBits(prec);
        if (!readResidual(b, x, blocksize, order)) return false;
        for (int i = order; i < blocksize; ++i) {
            int64_t p = 0;
            for (int j = 0; j < order; ++j) p += coef[j] * x[i-1-j];
            x[i] += p >> shift;
        }
    } else {
        return false;                              // reserved types
    }
    if (wasted)
        for (int i = 0; i < blocksize; ++i) x[i] <<= wasted;
    return !b.bad;
}

// skip the UTF-8-coded frame/sample number
bool skipUtf8(FlacBits& b) {
    uint32_t first = b.bits(8);
    int cont = 0;
    if (first < 0x80) cont = 0;
    else if (first >= 0xC0 && first < 0xE0) cont = 1;
    else if (first < 0xF0) cont = 2;
    else if (first < 0xF8) cont = 3;
    else if (first < 0xFC) cont = 4;
    else if (first < 0xFE) cont = 5;
    else if (first == 0xFE) cont = 6;
    else return false;
    for (int i = 0; i < cont; ++i) {
        if ((b.bits(8) & 0xC0) != 0x80) return false;
    }
    return !b.bad;
}

const int kRates[12] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                        24000, 32000, 44100, 48000, 96000};
const int kBits[8] = {0, 8, 12, 0, 16, 20, 24, 32};

}  // namespace

extern "C" {

// Parse the STREAMINFO of a FLAC file.
// meta: [rate, channels, bits, max_blocksize]; total: samples per channel
// (0 if the encoder did not record it).  Returns 0, or <0 on error.
int flac_info(const uint8_t* data, int64_t len, int32_t* meta,
              int64_t* total) {
    if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
    FlacBits b;
    b.init(data, len, 4);
    bool sawInfo = false;
    for (;;) {
        uint32_t last = b.bits(1);
        uint32_t type = b.bits(7);
        uint32_t size = b.bits(24);
        if (b.bad) return -2;
        if (type == 0) {
            if (size < 34) return -2;
            b.bits(16);                           // min block size
            uint32_t maxBlock = b.bits(16);
            b.bits(24); b.bits(24);               // min/max frame size
            uint32_t rate = b.bits(20);
            uint32_t nch = b.bits(3) + 1;
            uint32_t bps = b.bits(5) + 1;
            uint64_t tot = b.bits64(36);
            b.pos += (size - 18) * 8;             // md5 + any extension
            if (meta) {
                meta[0] = static_cast<int32_t>(rate);
                meta[1] = static_cast<int32_t>(nch);
                meta[2] = static_cast<int32_t>(bps);
                meta[3] = static_cast<int32_t>(maxBlock);
            }
            if (total) *total = static_cast<int64_t>(tot);
            sawInfo = true;
        } else {
            b.pos += static_cast<int64_t>(size) * 8;
        }
        if (b.pos > len * 8) return -2;
        if (last) break;
    }
    return sawInfo ? 0 : -2;
}

// Decode all frames.  out: interleaved int32, capacity out_cap samples
// (all channels combined).  Returns the number of samples written (per
// all channels), or <0 on error (-3: capacity exceeded, -4: bad frame).
int64_t flac_decode(const uint8_t* data, int64_t len,
                    int32_t* out, int64_t out_cap) {
    int32_t meta[4];
    int64_t total;
    int rc = flac_info(data, len, meta, &total);
    if (rc != 0) return rc;
    int streamBits = meta[2];
    int streamRate = meta[0];

    // skip the metadata section again to find the first frame
    FlacBits b;
    b.init(data, len, 4);
    for (;;) {
        uint32_t last = b.bits(1);
        b.bits(7);
        uint32_t size = b.bits(24);
        b.pos += static_cast<int64_t>(size) * 8;
        if (b.bad || b.pos > len * 8) return -2;
        if (last) break;
    }

    static const int kMaxCh = 8;
    // 8 ch x 65536 samples of workspace; heap-allocated so concurrent
    // decodes from the Python thread pool stay independent
    int64_t* chanBuf = new int64_t[kMaxCh * 65536];
    int64_t* chan[kMaxCh];
    for (int c = 0; c < kMaxCh; ++c) chan[c] = chanBuf + c * 65536;
    int64_t written = 0;
    struct Free { int64_t* p; ~Free() { delete[] p; } } freer{chanBuf};

    while (!b.atEnd()) {
        b.alignByte();
        if (b.len * 8 - b.pos < 32) break;        // trailing padding
        uint32_t sync = b.bits(14);
        if (sync != 0x3FFE) break;                // not a frame: stop
        b.bits(1);                                // reserved
        b.bits(1);                                // blocking strategy
        int bsCode = static_cast<int>(b.bits(4));
        int srCode = static_cast<int>(b.bits(4));
        int chAsgn = static_cast<int>(b.bits(4));
        int ssCode = static_cast<int>(b.bits(3));
        b.bits(1);                                // reserved
        if (!skipUtf8(b)) return -4;

        int blocksize;
        switch (bsCode) {
            case 0: return -4;
            case 1: blocksize = 192; break;
            case 6: blocksize = static_cast<int>(b.bits(8)) + 1; break;
            case 7: blocksize = static_cast<int>(b.bits(16)) + 1; break;
            default:
                blocksize = bsCode <= 5 ? 576 << (bsCode - 2)
                                        : 256 << (bsCode - 8);
        }
        if (blocksize > 65536) return -4;
        if (srCode == 12) b.bits(8);
        else if (srCode == 13 || srCode == 14) b.bits(16);
        else if (srCode == 15) return -4;
        (void)streamRate; (void)kRates;
        b.bits(8);                                // CRC-8 (not validated)

        int bps = ssCode == 0 ? streamBits : kBits[ssCode];
        if (bps == 0) return -4;

        int nch;
        if (chAsgn < 8) nch = chAsgn + 1;
        else if (chAsgn <= 10) nch = 2;
        else return -4;
        if (nch > kMaxCh) return -4;

        for (int c = 0; c < nch; ++c) {
            int cbps = bps;
            if ((chAsgn == 8 && c == 1) || (chAsgn == 9 && c == 0)
                || (chAsgn == 10 && c == 1))
                ++cbps;                           // side channel
            if (!readSubframe(b, chan[c], blocksize, cbps)) return -4;
        }
        b.alignByte();
        b.bits(16);                               // CRC-16 (not validated)
        if (b.bad) return -4;

        // stereo decorrelation
        if (chAsgn == 8) {                        // left/side
            for (int i = 0; i < blocksize; ++i)
                chan[1][i] = chan[0][i] - chan[1][i];
        } else if (chAsgn == 9) {                 // side/right
            for (int i = 0; i < blocksize; ++i)
                chan[0][i] = chan[0][i] + chan[1][i];
        } else if (chAsgn == 10) {                // mid/side
            for (int i = 0; i < blocksize; ++i) {
                int64_t s = chan[1][i];
                int64_t m = (chan[0][i] << 1) | (s & 1);
                chan[0][i] = (m + s) >> 1;
                chan[1][i] = (m - s) >> 1;
            }
        }

        if (out) {
            if (written + static_cast<int64_t>(blocksize) * nch > out_cap)
                return -3;
            for (int i = 0; i < blocksize; ++i)
                for (int c = 0; c < nch; ++c)
                    out[written + static_cast<int64_t>(i) * nch + c] =
                        static_cast<int32_t>(chan[c][i]);
        }
        written += static_cast<int64_t>(blocksize) * nch;
    }
    return written;
}

}  // extern "C"
