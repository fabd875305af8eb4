// LZO1X codec — fresh implementation of the public LZO1X bitstream
// (format documented in the Linux kernel's Documentation/lzo.txt and the
// LZO homepage). Needed because the reference .pv container compresses
// frame payloads with lzo1x (reference: Application/src/ProcessedVideo/
// pv.cpp:713-774 compress, :322-334 decompress). This file implements the
// format from its public specification; it shares no code with minilzo.
//
// Exported C API (used from Python via ctypes):
//   trex_lzo1x_decompress(in, in_len, out, out_cap, &out_len) -> 0 on ok
//   trex_lzo1x_compress(in, in_len, out, out_cap, &out_len)   -> 0 on ok
//   trex_lzo1x_worst_case(in_len)                             -> bound
//
// Error codes: 0 ok, -1 input overrun, -2 output overrun, -3 lookbehind
// underrun, -4 stream corrupt / missing EOS, -5 bad args.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

size_t trex_lzo1x_worst_case(size_t in_len) {
    // matches the classic bound: len + len/16 + 64 + 3
    return in_len + in_len / 16 + 64 + 3;
}

// ---------------------------------------------------------------------
// Decompressor
// ---------------------------------------------------------------------
int trex_lzo1x_decompress(const uint8_t* in, size_t in_len,
                          uint8_t* out, size_t out_cap, size_t* out_len) {
    if (!in || !out || !out_len) return -5;
    const uint8_t* ip = in;
    const uint8_t* const in_end = in + in_len;
    uint8_t* op = out;
    uint8_t* const out_end = out + out_cap;

#define NEED_IN(n)   do { if ((size_t)(in_end - ip) < (size_t)(n)) return -1; } while (0)
#define NEED_OUT(n)  do { if ((size_t)(out_end - op) < (size_t)(n)) return -2; } while (0)

    size_t t;          // current instruction value / literal count
    size_t state = 0;  // trailing-literal count semantics

    NEED_IN(1);
    t = *ip;
    if (t > 17) {
        // first byte > 17: copy (t - 17) literals
        ip++;
        t -= 17;
        NEED_IN(t);
        NEED_OUT(t);
        std::memcpy(op, ip, t);
        op += t; ip += t;
        state = t < 4 ? t : 4;
        if (state == 4) {
            // next instruction must be read fresh below
        }
    }

    for (;;) {
        NEED_IN(1);
        t = *ip++;
        if (t < 16) {
            if (state == 0) {
                // long literal run: length = 3 + (t ? t : 15 + zeros*255 + nz)
                size_t len = t;
                if (len == 0) {
                    len = 15;
                    for (;;) {
                        NEED_IN(1);
                        uint8_t b = *ip++;
                        if (b == 0) {
                            len += 255;
                            if (len > (size_t)1 << 30) return -4;
                        } else {
                            len += b;
                            break;
                        }
                    }
                }
                len += 3;
                NEED_IN(len);
                NEED_OUT(len);
                std::memcpy(op, ip, len);
                op += len; ip += len;
                state = 4;
                continue;
            } else if (state < 4) {
                // 2-byte match, distance <= 1024 (+ trailing literals)
                NEED_IN(1);
                size_t h = *ip++;
                size_t dist = (h << 2) + (t >> 2) + 1;
                if ((size_t)(op - out) < dist) return -3;
                NEED_OUT(2);
                const uint8_t* m = op - dist;
                op[0] = m[0]; op[1] = m[1];
                op += 2;
                state = t & 3;
            } else {
                // state == 4: 3-byte match, distance 2049..3072
                NEED_IN(1);
                size_t h = *ip++;
                size_t dist = (h << 2) + (t >> 2) + 2049;
                if ((size_t)(op - out) < dist) return -3;
                NEED_OUT(3);
                const uint8_t* m = op - dist;
                op[0] = m[0]; op[1] = m[1]; op[2] = m[2];
                op += 3;
                state = t & 3;
            }
        } else if (t >= 64) {
            // M2: 1 opcode + 1 byte, distance <= 2048
            size_t len = (t >= 128) ? 5 + ((t >> 5) & 3) : 3 + ((t >> 5) & 1);
            NEED_IN(1);
            size_t h = *ip++;
            size_t dist = (h << 3) + ((t >> 2) & 7) + 1;
            if ((size_t)(op - out) < dist) return -3;
            NEED_OUT(len);
            const uint8_t* m = op - dist;
            for (size_t i = 0; i < len; i++) op[i] = m[i];
            op += len;
            state = t & 3;
        } else if (t >= 32) {
            // M3: distance <= 16384, run-length extension
            size_t len = t & 31;
            if (len == 0) {
                len = 31;
                for (;;) {
                    NEED_IN(1);
                    uint8_t b = *ip++;
                    if (b == 0) {
                        len += 255;
                        if (len > (size_t)1 << 30) return -4;
                    } else {
                        len += b;
                        break;
                    }
                }
            }
            len += 2;
            NEED_IN(2);
            size_t d16 = (size_t)ip[0] | ((size_t)ip[1] << 8);
            ip += 2;
            size_t dist = (d16 >> 2) + 1;
            if ((size_t)(op - out) < dist) return -3;
            NEED_OUT(len);
            const uint8_t* m = op - dist;
            for (size_t i = 0; i < len; i++) op[i] = m[i];
            op += len;
            state = d16 & 3;
        } else {
            // M4 (16..31): distance 16384..49151; dist==16384 => EOS
            size_t len = t & 7;
            if (len == 0) {
                len = 7;
                for (;;) {
                    NEED_IN(1);
                    uint8_t b = *ip++;
                    if (b == 0) {
                        len += 255;
                        if (len > (size_t)1 << 30) return -4;
                    } else {
                        len += b;
                        break;
                    }
                }
            }
            len += 2;
            NEED_IN(2);
            size_t d16 = (size_t)ip[0] | ((size_t)ip[1] << 8);
            ip += 2;
            size_t dist = 16384 + (((t >> 3) & 1) << 14) + (d16 >> 2);
            if (dist == 16384) {
                // end of stream: a well-formed EOS is opcode 17 with no
                // run-length extension and d16 == 0; trailing bytes
                // after EOS mean corruption, not success
                *out_len = (size_t)(op - out);
                return (ip == in_end) ? 0 : -4;
            }
            if ((size_t)(op - out) < dist) return -3;
            NEED_OUT(len);
            const uint8_t* m = op - dist;
            for (size_t i = 0; i < len; i++) op[i] = m[i];
            op += len;
            state = d16 & 3;
        }

        // copy trailing literals indicated by state (1..3)
        if (state > 0 && state < 4) {
            NEED_IN(state);
            NEED_OUT(state);
            for (size_t i = 0; i < state; i++) op[i] = ip[i];
            op += state; ip += state;
            // keep state as-is: next opcode 0..15 means 2-byte match
        }
    }
#undef NEED_IN
#undef NEED_OUT
}

// ---------------------------------------------------------------------
// Compressor: greedy hash-chain parse emitting M2/M3/M4 + literal runs.
// ---------------------------------------------------------------------
namespace {

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 0x9E3779B1u) >> 18;  // 14-bit hash
}

constexpr size_t HASH_SIZE = 1u << 14;
constexpr size_t MAX_DIST = 49151;   // M4 limit
constexpr size_t MIN_MATCH = 3;

struct Emitter {
    uint8_t* out;
    size_t cap;
    size_t pos = 0;
    // position of the byte carrying the SS bits of the last match opcode
    // (valid when have_fixup). minilzo-style: always out[pos_of_match_end-2].
    bool have_fixup = false;
    size_t fixup_pos = 0;
    bool first = true;

    bool put(uint8_t b) {
        if (pos >= cap) return false;
        out[pos++] = b;
        return true;
    }
    bool put_run_length(size_t rem) {
        // emit zeros*255 + final nonzero byte (final in 1..255)
        while (rem > 255) {
            if (!put(0)) return false;
            rem -= 255;
        }
        if (rem == 0) {
            // cannot happen by construction (callers ensure rem >= 1)
            return false;
        }
        return put((uint8_t)rem);
    }

    bool literals(const uint8_t* src, size_t t) {
        if (t == 0) return true;
        if (t <= 3 && !first) {
            if (!have_fixup) return false;
            out[fixup_pos] |= (uint8_t)t;
        } else if (first && t <= 238) {
            if (!put((uint8_t)(17 + t))) return false;
        } else if (t <= 18) {
            if (!put((uint8_t)(t - 3))) return false;
        } else {
            if (!put(0)) return false;
            if (!put_run_length(t - 18)) return false;
        }
        if (pos + t > cap) return false;
        std::memcpy(out + pos, src, t);
        pos += t;
        first = false;
        return true;
    }

    bool match(size_t len, size_t dist) {
        // caller guarantees len >= 3, 1 <= dist <= MAX_DIST
        first = false;
        if (dist <= 2048 && len <= 8 && (len >= 5 || len <= 4)) {
            size_t d = dist - 1;
            uint8_t op;
            if (len <= 4)
                op = (uint8_t)(64 | ((len - 3) << 5) | ((d & 7) << 2));
            else
                op = (uint8_t)(128 | ((len - 5) << 5) | ((d & 7) << 2));
            if (!put(op)) return false;
            if (!put((uint8_t)(d >> 3))) return false;
            fixup_pos = pos - 2;  // SS bits live in the opcode byte
            have_fixup = true;
            return true;
        }
        if (dist <= 16384) {
            if (len <= 33) {
                if (!put((uint8_t)(32 | (len - 2)))) return false;
            } else {
                if (!put(32)) return false;
                if (!put_run_length(len - 2 - 31)) return false;
            }
            size_t d16 = (dist - 1) << 2;
            if (!put((uint8_t)(d16 & 0xFF))) return false;
            if (!put((uint8_t)(d16 >> 8))) return false;
            fixup_pos = pos - 2;  // SS bits in low byte of LE16
            have_fixup = true;
            return true;
        }
        {
            size_t d = dist - 16384;
            uint8_t h = (uint8_t)((d >> 14) & 1);
            if (len <= 9) {
                if (!put((uint8_t)(16 | (h << 3) | (len - 2)))) return false;
            } else {
                if (!put((uint8_t)(16 | (h << 3)))) return false;
                if (!put_run_length(len - 2 - 7)) return false;
            }
            size_t d16 = (d & 0x3FFF) << 2;
            if (!put((uint8_t)(d16 & 0xFF))) return false;
            if (!put((uint8_t)(d16 >> 8))) return false;
            fixup_pos = pos - 2;
            have_fixup = true;
            return true;
        }
    }

    bool eos() {
        // M4 with distance == 16384: bytes {17, 0, 0}
        return put(17) && put(0) && put(0);
    }
};

}  // namespace

int trex_lzo1x_compress(const uint8_t* in, size_t in_len,
                        uint8_t* out, size_t out_cap, size_t* out_len) {
    if (!out || !out_len || (!in && in_len)) return -5;
    Emitter e{out, out_cap};
    static thread_local uint32_t table[HASH_SIZE];
    std::memset(table, 0, sizeof(table));

    size_t lit_start = 0;
    size_t i = 0;
    if (in_len >= MIN_MATCH + 1) {
        const size_t limit = in_len - MIN_MATCH;  // last pos where 4-byte load fits in_len>=4
        while (i <= (in_len >= 4 ? in_len - 4 : 0) && i <= limit) {
            uint32_t v = load32(in + i);
            uint32_t h = hash4(v);
            size_t cand = table[h];
            table[h] = (uint32_t)i + 1;  // store pos+1; 0 = empty
            bool matched = false;
            if (cand) {
                size_t c = cand - 1;
                size_t dist = i - c;
                if (c < i && dist <= MAX_DIST && load32(in + c) == v) {
                    // extend the match
                    size_t len = 4;
                    size_t max_len = in_len - i;
                    while (len < max_len && in[c + len] == in[i + len]) len++;
                    // require len >= 4 generally; for large dist require >= 5
                    if (len >= 4 || (len >= 3 && dist <= 2048)) {
                        if (!e.literals(in + lit_start, i - lit_start)) return -2;
                        if (!e.match(len, dist)) return -2;
                        // seed hash table sparsely inside the match
                        size_t end = i + len;
                        for (size_t k = i + 1; k + 4 <= end && k + 4 <= in_len; k += 2)
                            table[hash4(load32(in + k))] = (uint32_t)k + 1;
                        i = end;
                        lit_start = i;
                        matched = true;
                    }
                }
            }
            if (!matched) i++;
        }
    }
    if (!e.literals(in + lit_start, in_len - lit_start)) return -2;
    if (!e.eos()) return -2;
    *out_len = e.pos;
    return 0;
}

}  // extern "C"
