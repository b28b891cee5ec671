// Baseline JPEG decoder whose pixels equal libjpeg-turbo's (the library
// behind Pillow and imageio, which the JAX package reads images with):
// the same "islow" integer IDCT (jidctint.c), the same YCbCr -> RGB
// tables (jdcolor.c) and the same fancy upsampling (jdsample.c), edges
// included.
//
// Decodes: SOF0, and SOF1 at 8-bit precision; DQT (8- and 16-bit
// tables); DHT (any valid tables, optimized ones included);
// interleaved and non-interleaved scans; DRI and RST0-7 (the DC
// predictors reset); 0xFF00 stuffing and 0xFF fill bytes; APPn and COM
// skipped (no EXIF orientation is applied, as imageio.v2 applies none).
// Output: 1 component as grey (H, W); 3 components stored as YCbCr as
// RGB (H, W, 3). Sampling: each component at 1:1, 2:1 (h2v1) or 2:2
// (h2v2) of the largest factors, i.e. 4:4:4, 4:2:2 and 4:2:0.
//
// Refuses, with a message naming the reason: progressive (SOF2),
// lossless (SOF3), hierarchical (SOF5-7, 13-15), arithmetic coding
// (SOF9-15, DAC), other than 8-bit samples, other than 1 or 3
// components (CMYK), RGB stored without YCbCr (an Adobe transform of
// 0, or component ids 'R', 'G', 'B', without a JFIF marker), any other
// sampling layout, and truncated or corrupt entropy data.
//
// Host code, one thread: the entropy decoding of a scan is serial.
// Built at first use by data/jpeg.py: g++ -O3 -shared -fPIC ->
// _build/libjpeg_decode.so. Plain C interface:
//   jpeg_header(data, n, dims[3], err, err_cap): height, width and
//     output channels (1 or 3), after checking the mode;
//   jpeg_decode(data, n, out, out_cap, err, err_cap): the pixels,
//     row-major, uint8.
// Both return 0, or 1 with a message in err.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Refusal {
    std::string msg;
};

[[noreturn]] void refuse(const char* fmt, ...) {
    char buf[400];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw Refusal{buf};
}

// Zigzag index -> natural (row-major) index (jutils.c).
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    // Indexed by the next 16 bits: (code length << 8) | symbol, 0 for
    // no code.
    std::vector<uint16_t> lut;
    int max_symbol = 0;
    bool defined = false;
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;               // the current scan's tables
    int ds_w = 0, ds_h = 0;           // downsampled size (real samples)
    int pw = 0, ph = 0;               // plane size (whole MCUs)
    std::vector<uint8_t> plane;
    bool scanned = false;
};

struct Frame {
    int sof = -1, precision = 0, width = 0, height = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    std::vector<Component> comps;
    uint16_t quant[4][64];            // natural order
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    int restart_interval = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
};

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// ---------------------------------------------------------------------------
// Markers
// ---------------------------------------------------------------------------

void read_dqt(Frame& f, const uint8_t* p, int len) {
    int i = 0;
    while (i < len) {
        int pq = p[i] >> 4, tq = p[i] & 15;
        if (pq > 1 || tq > 3) refuse("bad DQT segment (precision %d, table %d)", pq, tq);
        int need = 1 + 64 * (pq + 1);
        if (i + need > len) refuse("truncated DQT segment");
        for (int k = 0; k < 64; ++k)
            f.quant[tq][kNatural[k]] = pq ? u16(p + i + 1 + 2 * k) : p[i + 1 + k];
        f.quant_defined[tq] = true;
        i += need;
    }
}

void read_dht(Frame& f, const uint8_t* p, int len) {
    int i = 0;
    while (i < len) {
        if (i + 17 > len) refuse("truncated DHT segment");
        int tc = p[i] >> 4, th = p[i] & 15;
        if (tc > 1 || th > 3) refuse("bad DHT segment (class %d, table %d)", tc, th);
        const uint8_t* counts = p + i + 1;
        int total = 0;
        for (int l = 0; l < 16; ++l) total += counts[l];
        if (total > 256 || i + 17 + total > len) refuse("bad DHT segment (%d codes)", total);
        const uint8_t* vals = p + i + 17;
        Huffman& t = tc ? f.ac[th] : f.dc[th];
        t.lut.assign(65536, 0);
        t.max_symbol = 0;
        uint32_t code = 0;
        int k = 0;
        for (int l = 1; l <= 16; ++l) {
            for (int c = 0; c < counts[l - 1]; ++c, ++k, ++code) {
                if (code >= (1u << l)) refuse("bad Huffman table (code overflow)");
                uint32_t lo = code << (16 - l), hi = (code + 1) << (16 - l);
                uint16_t e = static_cast<uint16_t>((l << 8) | vals[k]);
                for (uint32_t x = lo; x < hi; ++x) t.lut[x] = e;
                if (vals[k] > t.max_symbol) t.max_symbol = vals[k];
            }
            code <<= 1;
        }
        t.defined = true;
        i += 17 + total;
    }
}

const char* sof_refusal(int m) {
    switch (m) {
        case 0xC2: return "progressive JPEG (SOF2)";
        case 0xC3: return "lossless JPEG (SOF3)";
        case 0xC5: return "hierarchical JPEG (SOF5)";
        case 0xC6: return "hierarchical progressive JPEG (SOF6)";
        case 0xC7: return "hierarchical lossless JPEG (SOF7)";
        case 0xC9: return "arithmetic-coded JPEG (SOF9)";
        case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
        case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
        case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
        case 0xCE: return "arithmetic-coded hierarchical progressive JPEG (SOF14)";
        case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
        default: return nullptr;
    }
}

const char* kSupported = "baseline or extended sequential Huffman (SOF0, SOF1) only";

void read_sof(Frame& f, int m, const uint8_t* p, int len) {
    if (const char* why = sof_refusal(m)) refuse("%s is not supported: %s", why, kSupported);
    if (f.sof >= 0) refuse("a second frame header (SOF)");
    if (len < 6) refuse("truncated SOF segment");
    f.sof = m;
    f.precision = p[0];
    f.height = u16(p + 1);
    f.width = u16(p + 3);
    int nf = p[5];
    if (f.precision != 8)
        refuse("%d-bit samples (SOF%d) are not supported: 8-bit only", f.precision, m - 0xC0);
    if (nf == 4)
        refuse("4 components (CMYK or YCCK) are not supported: grey or YCbCr only");
    if (nf != 1 && nf != 3)
        refuse("%d components are not supported: grey or YCbCr only", nf);
    if (f.height == 0) refuse("a height defined by a DNL marker is not supported");
    if (f.width == 0) refuse("zero image width");
    if (len < 6 + 3 * nf) refuse("truncated SOF segment");
    f.comps.resize(nf);
    for (int c = 0; c < nf; ++c) {
        Component& k = f.comps[c];
        k.id = p[6 + 3 * c];
        k.h = p[7 + 3 * c] >> 4;
        k.v = p[7 + 3 * c] & 15;
        k.tq = p[8 + 3 * c];
        if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
            refuse("bad component %d in SOF (sampling %dx%d, table %d)", c, k.h, k.v, k.tq);
    }
}

void read_app(Frame& f, int m, const uint8_t* p, int len) {
    // jdmarker.c: a JFIF APP0 of at least 14 bytes; an Adobe APP14 of
    // at least 12, its transform flag the 12th.
    if (m == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) f.jfif = true;
    if (m == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
        f.adobe = true;
        f.adobe_transform = p[11];
    }
}

// The frame's geometry and colour space, checked once its first scan
// starts (where libjpeg decides them).
void setup_frame(Frame& f) {
    if (f.sof < 0) refuse("no frame header (SOF) before the first scan");
    for (auto& c : f.comps) {
        if (c.h > f.hmax) f.hmax = c.h;
        if (c.v > f.vmax) f.vmax = c.v;
    }
    if (f.comps.size() == 3) {
        // jdapimin.c default_decompress_parms.
        bool rgb;
        const char* why = "";
        if (f.jfif) {
            rgb = false;
        } else if (f.adobe) {
            rgb = f.adobe_transform == 0;
            why = "an Adobe transform of 0";
        } else {
            rgb = f.comps[0].id == 82 && f.comps[1].id == 71 && f.comps[2].id == 66;
            why = "component ids R, G, B";
        }
        if (rgb)
            refuse("RGB stored without YCbCr (%s) is not supported: YCbCr only", why);
        for (auto& c : f.comps) {
            bool ok = f.hmax % c.h == 0 && f.vmax % c.v == 0;
            int rh = f.hmax / c.h, rv = f.vmax / c.v;
            ok = ok && ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
            if (!ok) {
                char layout[64];
                snprintf(layout, sizeof layout, "%dx%d,%dx%d,%dx%d", f.comps[0].h,
                         f.comps[0].v, f.comps[1].h, f.comps[1].v, f.comps[2].h,
                         f.comps[2].v);
                refuse("sampling layout %s is not supported: 4:4:4, 4:2:2 (h2v1) "
                       "or 4:2:0 (h2v2) only", layout);
            }
        }
    }
    f.mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    f.mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    for (auto& c : f.comps) {
        c.ds_w = static_cast<int>((static_cast<int64_t>(f.width) * c.h + f.hmax - 1) / f.hmax);
        c.ds_h = static_cast<int>((static_cast<int64_t>(f.height) * c.v + f.vmax - 1) / f.vmax);
        c.pw = f.mcux * c.h * 8;
        c.ph = f.mcuy * c.v * 8;
    }
}

// ---------------------------------------------------------------------------
// Entropy decoding
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* buf;   // de-stuffed data, 8 zero bytes past its end
    uint64_t pos = 0;     // in bits

    uint32_t peek16() const {
        const uint8_t* p = buf + (pos >> 3);
        uint32_t w = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                     (uint32_t(p[2]) << 8) | uint32_t(p[3]);
        return (w << (pos & 7)) >> 16;
    }
    int bits(int n) {   // 1 <= n <= 16
        int v = static_cast<int>(peek16() >> (16 - n));
        pos += n;
        return v;
    }
    int decode(const Huffman& t) {
        uint16_t e = t.lut[peek16()];
        if (!e) refuse("corrupt entropy data (no Huffman code matches)");
        pos += e >> 8;
        return e & 0xFF;
    }
};

int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------------------
// IDCT: jidctint.c's jpeg_idct_islow, CONST_BITS 13, PASS1_BITS 2.
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c prepare_range_limit_table, as the IDCT indexes it: the
// descaled value masked to 10 bits, read as signed, plus 128, clamped.
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int j = 0; j < 1024; ++j) {
            int x = (j < 512 ? j : j - 1024) + 128;
            t[j] = static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {   // pass 1: columns
        const int16_t* in = coef + c;
        const uint16_t* qt = q + c;
        int* w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int dc = (int(in[0]) * int(qt[0])) * (1 << kPass1Bits);
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = int(in[16]) * int(qt[16]), z3 = int(in[48]) * int(qt[48]);
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * -F1_847759065;
        int64_t tmp3 = z1 + z2 * F0_765366865;
        z2 = int(in[0]) * int(qt[0]);
        z3 = int(in[32]) * int(qt[32]);
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int(in[56]) * int(qt[56]);
        tmp1 = int(in[40]) * int(qt[40]);
        tmp2 = int(in[24]) * int(qt[24]);
        tmp3 = int(in[8]) * int(qt[8]);
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175875602;
        tmp0 *= F0_298631336;
        tmp1 *= F2_053119869;
        tmp2 *= F3_072711026;
        tmp3 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int s = kConstBits - kPass1Bits;
        w[0] = int(descale(tmp10 + tmp3, s));
        w[56] = int(descale(tmp10 - tmp3, s));
        w[8] = int(descale(tmp11 + tmp2, s));
        w[48] = int(descale(tmp11 - tmp2, s));
        w[16] = int(descale(tmp12 + tmp1, s));
        w[40] = int(descale(tmp12 - tmp1, s));
        w[24] = int(descale(tmp13 + tmp0, s));
        w[32] = int(descale(tmp13 - tmp0, s));
    }
    for (int r = 0; r < 8; ++r) {   // pass 2: rows
        const int* w = ws + 8 * r;
        uint8_t* o = out + r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t dc = kRange.t[int(descale(w[0], kPass1Bits + 3)) & 1023];
            for (int c = 0; c < 8; ++c) o[c] = dc;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * -F1_847759065;
        int64_t tmp3 = z1 + z2 * F0_765366865;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175875602;
        tmp0 *= F0_298631336;
        tmp1 *= F2_053119869;
        tmp2 *= F3_072711026;
        tmp3 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int s = kConstBits + kPass1Bits + 3;
        o[0] = kRange.t[int(descale(tmp10 + tmp3, s)) & 1023];
        o[7] = kRange.t[int(descale(tmp10 - tmp3, s)) & 1023];
        o[1] = kRange.t[int(descale(tmp11 + tmp2, s)) & 1023];
        o[6] = kRange.t[int(descale(tmp11 - tmp2, s)) & 1023];
        o[2] = kRange.t[int(descale(tmp12 + tmp1, s)) & 1023];
        o[5] = kRange.t[int(descale(tmp12 - tmp1, s)) & 1023];
        o[3] = kRange.t[int(descale(tmp13 + tmp0, s)) & 1023];
        o[4] = kRange.t[int(descale(tmp13 - tmp0, s)) & 1023];
    }
}

// ---------------------------------------------------------------------------
// Scans
// ---------------------------------------------------------------------------

// The entropy-coded data from p on, de-stuffed and split at its RST
// markers: seg_end[i] is segment i's end (bytes into `clean`), rst[i]
// the number of the marker that ends it. Returns the position of the
// marker that ends the scan, or n at the end of the data.
size_t collect_segments(const uint8_t* d, size_t n, size_t p, std::vector<uint8_t>& clean,
                        std::vector<size_t>& seg_end, std::vector<int>& rst) {
    while (p < n) {
        uint8_t b = d[p];
        if (b != 0xFF) {
            clean.push_back(b);
            ++p;
            continue;
        }
        if (p + 1 >= n) {
            p = n;
            break;
        }
        uint8_t m = d[p + 1];
        if (m == 0x00) {
            clean.push_back(0xFF);
            p += 2;
        } else if (m == 0xFF) {
            ++p;   // a fill byte
        } else if (m >= 0xD0 && m <= 0xD7) {
            seg_end.push_back(clean.size());
            rst.push_back(m - 0xD0);
            p += 2;
        } else {
            break;
        }
    }
    seg_end.push_back(clean.size());
    rst.push_back(-1);
    clean.insert(clean.end(), 8, 0);
    return p;
}

void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred,
                  const uint16_t* q, uint8_t* out, int stride) {
    int16_t coef[64];
    memset(coef, 0, sizeof coef);
    int s = br.decode(dc);
    int diff = s ? extend(br.bits(s), s) : 0;
    pred += diff;
    coef[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) refuse("corrupt entropy data (coefficient past the block)");
            coef[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    idct_islow(coef, q, out, stride);
}

// Decodes the scan whose header is at p (len bytes); returns the
// position of the marker after its data.
size_t decode_scan(Frame& f, const uint8_t* d, size_t n, size_t p, int len) {
    int ns = d[p];
    if (ns < 1 || ns > 4 || len < 1 + 2 * ns + 3) refuse("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
        int id = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
        Component* c = nullptr;
        for (auto& k : f.comps)
            if (k.id == id) c = &k;
        if (!c) refuse("a scan names component %d, which the frame lacks", id);
        c->td = tables >> 4;
        c->ta = tables & 15;
        if (c->td > 3 || c->ta > 3) refuse("bad SOS segment (tables %d/%d)", c->td, c->ta);
        if (!f.dc[c->td].defined || !f.ac[c->ta].defined)
            refuse("a scan uses an undefined Huffman table");
        if (f.dc[c->td].max_symbol > 15) refuse("bad Huffman table (DC symbol above 15)");
        if (!f.quant_defined[c->tq]) refuse("a scan uses an undefined quantization table");
        if (c->plane.empty()) c->plane.assign(size_t(c->pw) * c->ph, 0);
        sc.push_back(c);
    }
    const uint8_t* ss = d + p + 1 + 2 * ns;
    if (ss[0] != 0 || ss[1] != 63 || ss[2] != 0) refuse("bad SOS segment (spectral selection)");
    if (ns > 1) {
        int blocks = 0;
        for (auto* c : sc) blocks += c->h * c->v;
        if (blocks > 10) refuse("bad SOS segment (%d blocks an MCU)", blocks);
    }

    std::vector<uint8_t> clean;
    std::vector<size_t> seg_end;
    std::vector<int> rst;
    size_t end = collect_segments(d, n, p + len, clean, seg_end, rst);
    bool eof = end >= n;

    int64_t bx = 0, total;
    if (ns == 1) {
        bx = (sc[0]->ds_w + 7) / 8;
        total = bx * ((sc[0]->ds_h + 7) / 8);
    } else {
        total = int64_t(f.mcux) * f.mcuy;
    }
    BitReader br{clean.data()};
    size_t seg = 0;
    int preds[4] = {0, 0, 0, 0};
    auto overrun = [&]() {
        if (seg + 1 == seg_end.size() && eof)
            refuse("truncated data (the file ends inside the scan)");
        refuse("corrupt entropy data (a segment ends inside an MCU)");
    };
    const int ri = f.restart_interval;
    for (int64_t mcu = 0; mcu < total; ++mcu) {
        if (ri && mcu && mcu % ri == 0) {
            if (seg + 1 >= seg_end.size()) {
                if (eof) refuse("truncated data (the file ends inside the scan)");
                refuse("corrupt data (a restart marker is missing)");
            }
            if (rst[seg] != static_cast<int>(seg % 8))
                refuse("corrupt data (restart marker RST%d where RST%d belongs)", rst[seg],
                       static_cast<int>(seg % 8));
            br.pos = uint64_t(seg_end[seg]) * 8;
            ++seg;
            for (int& x : preds) x = 0;
        }
        if (ns == 1) {
            Component* c = sc[0];
            int64_t x = mcu % bx, y = mcu / bx;
            decode_block(br, f.dc[c->td], f.ac[c->ta], preds[0], f.quant[c->tq],
                         c->plane.data() + (y * 8) * c->pw + x * 8, c->pw);
        } else {
            int64_t mx = mcu % f.mcux, my = mcu / f.mcux;
            for (int i = 0; i < ns; ++i) {
                Component* c = sc[i];
                for (int v = 0; v < c->v; ++v)
                    for (int h = 0; h < c->h; ++h) {
                        int64_t x = mx * c->h + h, y = my * c->v + v;
                        decode_block(br, f.dc[c->td], f.ac[c->ta], preds[i], f.quant[c->tq],
                                     c->plane.data() + (y * 8) * c->pw + x * 8, c->pw);
                    }
            }
        }
        if (br.pos > uint64_t(seg_end[seg]) * 8) overrun();
    }
    for (auto* c : sc) c->scanned = true;
    return end;
}

// ---------------------------------------------------------------------------
// Upsampling (jdsample.c) and colour conversion (jdcolor.c)
// ---------------------------------------------------------------------------

// Component c at full size (width x height) into out.
void upsample(const Frame& f, const Component& c, uint8_t* out) {
    const int W = f.width, H = f.height;
    const int rh = f.hmax / c.h, rv = f.vmax / c.v;
    const int dw = c.ds_w, dh = c.ds_h;
    const uint8_t* pl = c.plane.data();
    std::vector<uint8_t> row(size_t(2) * dw + 2);
    // libjpeg-turbo: fancy upsampling only when the component is more
    // than 2 samples wide; otherwise plain replication.
    const bool fancy = dw > 2;
    for (int y = 0; y < H; ++y) {
        uint8_t* o = out + size_t(y) * W;
        if (rh == 1 && rv == 1) {
            memcpy(o, pl + size_t(y) * c.pw, W);
            continue;
        }
        if (rv == 1) {   // h2v1
            const uint8_t* in = pl + size_t(y) * c.pw;
            if (!fancy) {
                for (int x = 0; x < W; ++x) o[x] = in[x >> 1];
                continue;
            }
            uint8_t* r = row.data();
            r[0] = in[0];
            r[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; ++x) {
                int v = in[x] * 3;
                r[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
                r[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
            }
            r[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
            r[2 * dw - 1] = in[dw - 1];
            memcpy(o, r, W);
            continue;
        }
        // h2v2: the nearer input row and the next nearer one (the edge
        // row itself past the first and the last real rows).
        int iy = y >> 1;
        const uint8_t* in0 = pl + size_t(iy) * c.pw;
        if (!fancy) {
            for (int x = 0; x < W; ++x) o[x] = in0[x >> 1];
            continue;
        }
        int ny = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
        const uint8_t* in1 = pl + size_t(ny) * c.pw;
        uint8_t* r = row.data();
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        r[0] = uint8_t((this_sum * 4 + 8) >> 4);
        r[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; ++x) {
            next_sum = in0[x + 1] * 3 + in1[x + 1];
            r[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
            r[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
        }
        r[2 * dw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        r[2 * dw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
        memcpy(o, r, W);
    }
}

struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        constexpr int kScale = 16;
        constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
        auto fix = [](double x) { return int64_t(x * double(int64_t(1) << kScale) + 0.5); };
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
            cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + kHalf;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int x) { return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x)); }

void to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, size_t n, uint8_t* out) {
    for (size_t i = 0; i < n; ++i) {
        int Y = y[i], b = cb[i], r = cr[i];
        out[3 * i] = clamp255(Y + kYcc.cr_r[r]);
        out[3 * i + 1] = clamp255(Y + int((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
        out[3 * i + 2] = clamp255(Y + kYcc.cb_b[b]);
    }
}

// ---------------------------------------------------------------------------
// The file
// ---------------------------------------------------------------------------

// Walks the markers; with `decode`, decodes every scan up to EOI, else
// stops at the first SOS.
void parse(const uint8_t* d, size_t n, Frame& f, bool decode) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) refuse("not a JPEG file");
    size_t p = 2;
    bool first_scan = true;
    while (true) {
        // next_marker: skip any bytes up to an 0xFF, then fill bytes.
        while (p < n && d[p] != 0xFF) ++p;
        while (p < n && d[p] == 0xFF) ++p;
        if (p >= n) {   // Pillow refuses a file without its EOI too
            refuse(first_scan ? "truncated data (the file ends before the first scan)"
                              : "truncated data (the file ends before its EOI marker)");
        }
        int m = d[p++];
        if (m == 0xD9) {   // EOI
            if (first_scan) refuse("no scan before the end of the image (EOI)");
            for (auto& c : f.comps)
                if (!c.scanned) refuse("no scan for component %d", c.id);
            return;
        }
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;   // TEM, stray RSTn
        if (m == 0xD8) refuse("a second start of image (SOI)");
        if (p + 2 > n) refuse("truncated data (inside a marker segment)");
        int len = u16(d + p);
        if (len < 2 || p + len > n) refuse("truncated data (inside a marker segment)");
        const uint8_t* body = d + p + 2;
        int blen = len - 2;
        if (m == 0xCC) refuse("arithmetic-coded JPEG (DAC) is not supported: %s", kSupported);
        if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
            (m >= 0xCD && m <= 0xCF)) {
            read_sof(f, m, body, blen);
        } else if (m == 0xC4) {
            read_dht(f, body, blen);
        } else if (m == 0xDB) {
            read_dqt(f, body, blen);
        } else if (m == 0xDD) {
            if (blen < 2) refuse("truncated DRI segment");
            f.restart_interval = u16(body);
        } else if (m >= 0xE0 && m <= 0xEF) {
            read_app(f, m, body, blen);
        } else if (m == 0xDC) {
            refuse("a DNL marker is not supported");
        } else if (m == 0xDA) {
            if (first_scan) {
                setup_frame(f);
                first_scan = false;
                if (!decode) return;
            }
            p = decode_scan(f, d, n, p + 2, blen);
            continue;
        }
        p += len;
    }
}

int report(const Refusal& r, char* err, int err_cap) {
    if (err && err_cap > 0) snprintf(err, size_t(err_cap), "%s", r.msg.c_str());
    return 1;
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t n, int32_t* dims, char* err, int32_t err_cap) {
    try {
        Frame f;
        parse(data, size_t(n), f, false);
        dims[0] = f.height;
        dims[1] = f.width;
        dims[2] = static_cast<int32_t>(f.comps.size());
        return 0;
    } catch (const Refusal& r) {
        return report(r, err, err_cap);
    }
}

int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_cap, char* err,
                int32_t err_cap) {
    try {
        Frame f;
        parse(data, size_t(n), f, true);
        const size_t hw = size_t(f.width) * f.height;
        if (out_cap < int64_t(hw * f.comps.size())) refuse("output buffer too small");
        if (f.comps.size() == 1) {
            const Component& c = f.comps[0];
            for (int y = 0; y < f.height; ++y)
                memcpy(out + size_t(y) * f.width, c.plane.data() + size_t(y) * c.pw, f.width);
            return 0;
        }
        std::vector<uint8_t> full(3 * hw);
        for (int i = 0; i < 3; ++i) upsample(f, f.comps[i], full.data() + i * hw);
        to_rgb(full.data(), full.data() + hw, full.data() + 2 * hw, hw, out);
        return 0;
    } catch (const Refusal& r) {
        return report(r, err, err_cap);
    } catch (const std::bad_alloc&) {
        return report(Refusal{"out of memory"}, err, err_cap);
    }
}

}  // extern "C"
