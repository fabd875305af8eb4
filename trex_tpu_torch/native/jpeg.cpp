// The JPEG decoder's hot loops (trex_tpu_torch/io/image_decode.py parses
// the markers and calls these), as libjpeg-turbo 3.1 computes them under
// the defaults OpenCV 5.0.0's imread leaves it (tests/test_torch_jpeg.py
// holds every path to cv2 bit for bit):
//
// - trex_jpeg_scan: one scan's Huffman-coded segment into the frame's
//   coefficient buffers, sequential (baseline or extended) or
//   progressive (DC first and refine, AC first and refine with EOB runs,
//   jdphuff.c), with restart markers. A code that no table holds, data
//   that runs out before the scan's last block, or a wrong RSTn marker
//   fails the scan; nothing is filled in as libjpeg's warnings would.
// - trex_jpeg_idct: dequantisation and libjpeg's JDCT_ISLOW integer
//   IDCT (CONST_BITS 13, PASS1_BITS 2) of a component's blocks into its
//   plane, in the 16-bit lanes of libjpeg-turbo's x86 vector code.
// - trex_jpeg_output: upsampling as jdsample.c chooses it with
//   do_fancy_upsampling on (the triangle filters of h2v1 and h2v2 where
//   the component is wider than 2 samples, of h1v2 always; replication
//   otherwise; the context rows above the first and below the last
//   sample row duplicate them), then jdcolor.c's fixed-point conversion
//   to BGR or grey.
//
// Built with -ffp-contract=off like the rest of the host library; every
// step here is integer arithmetic.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zig-zag position -> natural position, padded as jutils.c pads it so
// that a corrupt run past 63 stays inside the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 9;  // bits of the lookup table

struct Huff {
    bool present = false;
    uint16_t look[1 << kLook];  // (length << 8) | value, 0: longer code
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
};

// jpeg_make_d_derived_tbl: canonical codes from the 16 counts
bool build_huff(const uint8_t* spec, Huff& t) {
    const uint8_t* bits = spec;  // bits[1..16]
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    if (count > 256) return false;
    std::memcpy(t.vals, spec + 17, 256);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) return false;
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (bits[l]) {
            t.valoffset[l] = p - huffcode[p];
            p += bits[l];
            t.maxcode[l] = huffcode[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0x7FFFFFFF;
    std::memset(t.look, 0, sizeof(t.look));
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
        for (int i = 0; i < bits[l]; ++i, ++p) {
            const int lookbits = huffcode[p] << (kLook - l);
            for (int c = 0; c < (1 << (kLook - l)); ++c)
                t.look[lookbits + c] = (uint16_t)((l << 8) | t.vals[p]);
        }
    }
    t.present = true;
    return true;
}

// The entropy-coded segment's bits, byte stuffing (FF 00) undone. At a
// marker the reader stops and supplies zeros, counting them: a scan that
// reads one of them ran out of data.
struct Bits {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;  // left-aligned
    int cnt = 0;
    int fake = 0;  // zero bits supplied past a marker, still in buf
    bool at_marker = false;

    void fill() {
        while (cnt <= 56) {
            uint64_t b = 0;
            if (p >= end) at_marker = true;  // the data ends: as a marker
            if (!at_marker) {
                if (*p == 0xFF) {
                    if (p + 1 < end && p[1] == 0x00) {
                        b = 0xFF;
                        p += 2;
                    } else {
                        at_marker = true;
                    }
                } else {
                    b = *p++;
                }
            }
            if (at_marker) fake += 8;
            buf |= b << (56 - cnt);
            cnt += 8;
        }
    }
    uint32_t peek(int n) {
        if (cnt < n) fill();
        return (uint32_t)(buf >> (64 - n));
    }
    void skip(int n) {
        buf <<= n;
        cnt -= n;
    }
    uint32_t get(int n) {
        if (n == 0) return 0;
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    bool overrun() const { return fake > cnt; }
    // drop the bits left in a restart interval
    void reset() {
        buf = 0;
        cnt = 0;
        fake = 0;
        at_marker = false;
    }
};

inline int decode(Bits& b, const Huff& t) {
    const uint32_t look = b.peek(kLook);
    const uint16_t e = t.look[look];
    if (e) {
        b.skip(e >> 8);
        return e & 0xFF;
    }
    // codes longer than the lookup: jdhuff.c's jpeg_huff_decode
    uint32_t code = b.peek(16);
    for (int l = kLook + 1; l <= 16; ++l) {
        const int32_t c = (int32_t)(code >> (16 - l));
        if (c <= t.maxcode[l]) {
            b.skip(l);
            const int idx = c + t.valoffset[l];
            if (idx < 0 || idx > 255) return -1;
            return t.vals[idx];
        }
    }
    return -1;
}

inline int extend(uint32_t x, int s) {
    return (int)x < (1 << (s - 1)) ? (int)x + (int)((-1u << s) + 1) : (int)x;
}

struct ScanComp {
    int h, v, dc, ac, stride, bw, bh;
    int16_t* coef;
};

}  // namespace

extern "C" {

// Decode one scan. `data`/`len` is the whole file, `pos` the first byte
// after the SOS header. `huff`: 8 tables (DC 0-3, AC 0-3) of 17 + 256
// bytes (the DHT counts at [1..16], the values from [17]), `present` a
// bit a table. `comp`: 7 ints a scan component (h, v, DC table, AC table,
// blocks a row of its buffer, blocks wide and high it covers), `coef`
// its buffer (64 int16 a block, natural order). Returns the offset of
// the marker that ends the scan, or -1 (a code no table holds), -2 (data
// ran out), -3 (a missing or wrong RSTn), -4 (a missing table).
int64_t trex_jpeg_scan(const uint8_t* data, int64_t len, int64_t pos,
                       const uint8_t* huff, int32_t present, int32_t ncomp,
                       const int32_t* comp, int16_t** coef, int32_t mcus_x,
                       int32_t mcus_y, int32_t progressive, int32_t ss,
                       int32_t se, int32_t ah, int32_t al, int32_t restart) {
    std::vector<Huff> tables(8);
    for (int i = 0; i < 8; ++i)
        if ((present >> i) & 1)
            if (!build_huff(huff + i * 273, tables[i])) return -4;
    std::vector<ScanComp> sc(ncomp);
    for (int c = 0; c < ncomp; ++c) {
        const int32_t* q = comp + 7 * c;
        sc[c] = ScanComp{q[0], q[1], q[2], q[3], q[4], q[5], q[6], coef[c]};
        const bool need_dc = !progressive || (ss == 0 && ah == 0);
        const bool need_ac = !progressive || ss > 0;
        if (need_dc && !tables[sc[c].dc].present) return -4;
        if (need_ac && !tables[4 + sc[c].ac].present) return -4;
    }
    Bits b{data + pos, data + len};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const int p1 = 1 << al, m1 = -(1 << al);
    const bool single = ncomp == 1;
    const int64_t n_mcu = single ? (int64_t)sc[0].bw * sc[0].bh
                                 : (int64_t)mcus_x * mcus_y;
    int next_rst = 0;
    int64_t to_go = restart;

    auto block_decode = [&](ScanComp& c, int16_t* blk) -> int {
        if (!progressive) {
            int s = decode(b, tables[c.dc]);
            if (s < 0) return -1;
            int diff = s ? extend(b.get(s), s) : 0;
            int& pr = pred[&c - sc.data()];
            pr += diff;
            blk[0] = (int16_t)pr;
            const Huff& t = tables[4 + c.ac];
            for (int k = 1; k < 64; ++k) {
                int rs = decode(b, t);
                if (rs < 0) return -1;
                const int r = rs >> 4;
                s = rs & 15;
                if (s) {
                    k += r;
                    blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return 0;
        }
        if (ss == 0) {  // DC scans
            if (ah == 0) {
                int s = decode(b, tables[c.dc]);
                if (s < 0) return -1;
                int diff = s ? extend(b.get(s), s) : 0;
                int& pr = pred[&c - sc.data()];
                pr += diff;
                blk[0] = (int16_t)((uint32_t)pr << al);
            } else if (b.get(1)) {
                blk[0] = (int16_t)(blk[0] | p1);
            }
            return 0;
        }
        const Huff& t = tables[4 + c.ac];
        if (ah == 0) {  // AC first
            if (eobrun > 0) {
                --eobrun;
                return 0;
            }
            for (int k = ss; k <= se; ++k) {
                int rs = decode(b, t);
                if (rs < 0) return -1;
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    blk[kNatural[k]] =
                        (int16_t)((uint32_t)extend(b.get(s), s) << al);
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun = 1 << r;
                    if (r) eobrun += (int)b.get(r);
                    --eobrun;
                    break;
                }
            }
            return 0;
        }
        // AC refine
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                int rs = decode(b, t);
                if (rs < 0) return -1;
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = b.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += (int)b.get(r);
                    break;
                }
                do {
                    int16_t* th = blk + kNatural[k];
                    if (*th != 0) {
                        if (b.get(1) && (*th & p1) == 0)
                            *th = (int16_t)(*th >= 0 ? *th + p1 : *th + m1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) blk[kNatural[k]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t* th = blk + kNatural[k];
                if (*th != 0 && b.get(1) && (*th & p1) == 0)
                    *th = (int16_t)(*th >= 0 ? *th + p1 : *th + m1);
            }
            --eobrun;
        }
        return 0;
    };

    for (int64_t m = 0; m < n_mcu; ++m) {
        if (restart) {
            if (to_go == 0) {
                if (b.overrun()) return -2;
                // skip what is left of the interval up to its RSTn
                const uint8_t* p = b.p;
                while (p + 1 < b.end && !(p[0] == 0xFF && p[1] != 0x00 &&
                                          p[1] != 0xFF))
                    ++p;
                if (p + 1 >= b.end || p[1] != 0xD0 + next_rst) return -3;
                b.p = p + 2;
                b.reset();
                next_rst = (next_rst + 1) & 7;
                pred[0] = pred[1] = pred[2] = pred[3] = 0;
                eobrun = 0;
                to_go = restart;
            }
            --to_go;
        }
        if (single) {
            ScanComp& c = sc[0];
            const int64_t by = m / c.bw, bx = m % c.bw;
            if (block_decode(c, c.coef + (by * c.stride + bx) * 64) < 0)
                return -1;
        } else {
            const int64_t my = m / mcus_x, mx = m % mcus_x;
            for (auto& c : sc)
                for (int y = 0; y < c.v; ++y)
                    for (int x = 0; x < c.h; ++x) {
                        const int64_t by = my * c.v + y, bx = mx * c.h + x;
                        if (block_decode(c, c.coef +
                                                (by * c.stride + bx) * 64) < 0)
                            return -1;
                    }
        }
    }
    if (b.overrun()) return -2;
    // the segment ends at the next marker that is no RSTn padding
    const uint8_t* p = b.p;
    while (p + 1 < b.end &&
           !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
             !(p[1] >= 0xD0 && p[1] <= 0xD7)))
        ++p;
    return (int64_t)(p - data);
}

// jpeg_idct_islow over bw x bh blocks (a row of `stride` blocks) into
// `out` (bh * 8 rows of `out_stride` bytes), as libjpeg-turbo's SSE2 and
// AVX2 versions compute it (jidctint-sse2.asm, jidctint-avx2.asm), which
// OpenCV's build runs on an x86 host. `q`: the quantisation table in
// natural order. jidctint.c's arithmetic with the vector code's 16-bit
// lanes: each coefficient dequantised to the low 16 bits of its product;
// a block whose AC coefficients are all zero takes the DC value shifted
// by PASS1_BITS in 16 bits; the sums in0 + in4, in0 - in4, in3 + in7 and
// in1 + in5 of each pass wrap at 16 bits (the rotations multiply pairs
// into 32 bits); pass 1 saturates its outputs to 16 bits and pass 2 its
// samples to -128..127 before adding 128. On well-formed data this is
// jidctint.c's result; it departs only where coefficients overflow 16
// bits or a sample falls 384 outside 0..255 (jidctint.c's range-limit
// table wraps there).
void trex_jpeg_idct(const int16_t* coef, int32_t bw, int32_t bh,
                    int32_t stride, const uint16_t* q, uint8_t* out,
                    int64_t out_stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto w16 = [](int32_t x) { return (int32_t)(int16_t)(uint16_t)x; };
    auto sat16 = [](int32_t x) {
        return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
    };
    // one 1-D pass over 8 values at x[0], x[step], ..., 16-bit inputs;
    // outputs before the descale
    auto pass = [&](const int32_t* x, int step, int32_t* o) {
        const int32_t i0 = x[0], i1 = x[step], i2 = x[2 * step],
                      i3 = x[3 * step], i4 = x[4 * step], i5 = x[5 * step],
                      i6 = x[6 * step], i7 = x[7 * step];
        const int32_t tmp3e = i2 * (F0541 + F0765) + i6 * F0541;
        const int32_t tmp2e = i2 * F0541 + i6 * (F0541 - F1847);
        const int32_t tmp0e = w16(i0 + i4) * (1 << CB);
        const int32_t tmp1e = w16(i0 - i4) * (1 << CB);
        const int32_t t10 = tmp0e + tmp3e, t13 = tmp0e - tmp3e,
                      t11 = tmp1e + tmp2e, t12 = tmp1e - tmp2e;
        const int32_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
        const int32_t z3r = z3 * (F1175 - F1961) + z4 * F1175;
        const int32_t z4r = z3 * F1175 + z4 * (F1175 - F0390);
        const int32_t tmp0 = i7 * (F0298 - F0899) + i1 * -F0899 + z3r;
        const int32_t tmp3 = i7 * -F0899 + i1 * (F1501 - F0899) + z4r;
        const int32_t tmp1 = i5 * (F2053 - F2562) + i3 * -F2562 + z4r;
        const int32_t tmp2 = i5 * -F2562 + i3 * (F3072 - F2562) + z3r;
        o[0] = t10 + tmp3;
        o[7] = t10 - tmp3;
        o[1] = t11 + tmp2;
        o[6] = t11 - tmp2;
        o[2] = t12 + tmp1;
        o[5] = t12 - tmp1;
        o[3] = t13 + tmp0;
        o[4] = t13 - tmp0;
    };
    int16_t qt[64];
    for (int i = 0; i < 64; ++i) qt[i] = (int16_t)q[i];
    for (int32_t by = 0; by < bh; ++by)
        for (int32_t bx = 0; bx < bw; ++bx) {
            const int16_t* in = coef + ((int64_t)by * stride + bx) * 64;
            uint8_t* o0 = out + (int64_t)by * 8 * out_stride + bx * 8;
            int32_t d[64], ws[64], t[8];
            bool ac = false;
            for (int i = 8; i < 64; ++i) ac |= in[i] != 0;
            for (int i = 0; i < 64; ++i) d[i] = w16((int32_t)in[i] * qt[i]);
            if (!ac) {
                for (int c = 0; c < 8; ++c) {
                    const int32_t v = w16(d[c] * (1 << P1));
                    for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
                }
            } else {
                for (int c = 0; c < 8; ++c) {
                    pass(d + c, 8, t);
                    for (int r = 0; r < 8; ++r)
                        ws[8 * r + c] = sat16(
                            (t[r] + (1 << (CB - P1 - 1))) >> (CB - P1));
                }
            }
            constexpr int S = CB + P1 + 3;
            for (int r = 0; r < 8; ++r) {
                if (!ac && r > 0) {  // every row of ws is row 0
                    std::memcpy(o0 + r * out_stride, o0, 8);
                    continue;
                }
                pass(ws + 8 * r, 1, t);
                uint8_t* o = o0 + r * out_stride;
                for (int c = 0; c < 8; ++c) {
                    int32_t v = (t[c] + (1 << (S - 1))) >> S;
                    v = v < -128 ? -128 : (v > 127 ? 127 : v);
                    o[c] = (uint8_t)(v + 128);
                }
            }
        }
}

// Upsample each component's plane to width x height and convert. `comp`:
// 5 ints a component (plane stride, downsampled width and height, h, v).
// mode 0: grey of component 0 (Y or grey), 1: BGR of YCbCr, 2: BGR of
// RGB, 3: BGR of grey, 4: grey of RGB (jdcolor.c's rgb_gray_convert).
// Returns -1 for sampling factors that do not divide the largest.
int32_t trex_jpeg_output(const uint8_t** planes, const int32_t* comp,
                         int32_t ncomp, int32_t hmax, int32_t vmax,
                         int32_t width, int32_t height, int32_t mode,
                         uint8_t* out) {
    const int n = (mode == 0 || mode == 3) ? 1 : ncomp;
    std::vector<std::vector<uint8_t>> full(n);
    for (int c = 0; c < n; ++c) {
        const int32_t* q = comp + 5 * c;
        const uint8_t* src = planes[c];
        const int stride = q[0], dw = q[1], dh = q[2], h = q[3], v = q[4];
        if (h <= 0 || v <= 0 || hmax % h || vmax % v) return -1;
        const int he = hmax / h, ve = vmax / v;
        // a row of the upsampled plane may run past `width`: the upsampler
        // writes dw * he samples
        const int ow = dw * he;
        std::vector<uint8_t>& dst = full[c];
        dst.assign((size_t)ow * height, 0);
        auto row = [&](int y) {
            y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
            return src + (int64_t)y * stride;
        };
        for (int oy = 0; oy < height; ++oy) {
            uint8_t* o = dst.data() + (size_t)oy * ow;
            if (he == 1 && ve == 1) {
                std::memcpy(o, row(oy), dw);
            } else if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy
                const uint8_t* in = row(oy);
                int iv = in[0];
                o[0] = (uint8_t)iv;
                o[1] = (uint8_t)((iv * 3 + in[1] + 2) >> 2);
                for (int x = 1; x < dw - 1; ++x) {
                    iv = in[x] * 3;
                    o[2 * x] = (uint8_t)((iv + in[x - 1] + 1) >> 2);
                    o[2 * x + 1] = (uint8_t)((iv + in[x + 1] + 2) >> 2);
                }
                iv = in[dw - 1];
                o[2 * dw - 2] = (uint8_t)((iv * 3 + in[dw - 2] + 1) >> 2);
                o[2 * dw - 1] = (uint8_t)iv;
            } else if (he == 1 && ve == 2) {  // h1v2_fancy
                const int iy = oy >> 1, up = oy & 1;
                const uint8_t* i0 = row(iy);
                const uint8_t* i1 = row(up ? iy + 1 : iy - 1);
                const int bias = up ? 2 : 1;
                for (int x = 0; x < dw; ++x)
                    o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
            } else if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy
                const int iy = oy >> 1, up = oy & 1;
                const uint8_t* i0 = row(iy);
                const uint8_t* i1 = row(up ? iy + 1 : iy - 1);
                int this_s = i0[0] * 3 + i1[0];
                int next_s = i0[1] * 3 + i1[1];
                o[0] = (uint8_t)((this_s * 4 + 8) >> 4);
                o[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
                int last_s = this_s;
                this_s = next_s;
                for (int x = 1; x < dw - 1; ++x) {
                    next_s = i0[x + 1] * 3 + i1[x + 1];
                    o[2 * x] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
                    o[2 * x + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
                    last_s = this_s;
                    this_s = next_s;
                }
                o[2 * dw - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
                o[2 * dw - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
            } else {  // int_upsample, h2v1_upsample, h2v2_upsample
                const uint8_t* in = row(oy / ve);
                for (int x = 0; x < dw; ++x)
                    std::memset(o + x * he, in[x], he);
            }
        }
    }
    auto at = [&](int c, int y) {
        return full[c].data() + (size_t)y * (comp[5 * c + 1] * (hmax /
                                                                comp[5 * c + 3]));
    };
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << SB) + 0.5); };
    auto clamp = [](int64_t x) {
        return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
    };
    if (mode == 0) {
        for (int y = 0; y < height; ++y)
            std::memcpy(out + (int64_t)y * width, at(0, y), width);
    } else if (mode == 3) {
        for (int y = 0; y < height; ++y) {
            const uint8_t* g = at(0, y);
            uint8_t* o = out + (int64_t)y * width * 3;
            for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] =
                o[3 * x + 2] = g[x];
        }
    } else if (mode == 1) {
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
            cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + HALF;
        }
        for (int y = 0; y < height; ++y) {
            const uint8_t *Y = at(0, y), *Cb = at(1, y), *Cr = at(2, y);
            uint8_t* o = out + (int64_t)y * width * 3;
            for (int x = 0; x < width; ++x) {
                const int yy = Y[x], cb = Cb[x], cr = Cr[x];
                o[3 * x + 2] = clamp(yy + cr_r[cr]);
                o[3 * x + 1] = clamp(yy + ((cb_g[cb] + cr_g[cr]) >> SB));
                o[3 * x] = clamp(yy + cb_b[cb]);
            }
        }
    } else if (mode == 2) {
        for (int y = 0; y < height; ++y) {
            const uint8_t *R = at(0, y), *G = at(1, y), *B = at(2, y);
            uint8_t* o = out + (int64_t)y * width * 3;
            for (int x = 0; x < width; ++x) {
                o[3 * x] = B[x];
                o[3 * x + 1] = G[x];
                o[3 * x + 2] = R[x];
            }
        }
    } else {
        const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
        for (int y = 0; y < height; ++y) {
            const uint8_t *R = at(0, y), *G = at(1, y), *B = at(2, y);
            uint8_t* o = out + (int64_t)y * width;
            for (int x = 0; x < width; ++x)
                o[x] = (uint8_t)((ry * R[x] + gy * G[x] + by * B[x] + HALF) >>
                                 SB);
        }
    }
    return 0;
}

}  // extern "C"
