// The TIFF decoder's codecs (trex_tpu_torch/io/image_decode.py reads the
// IFD and calls these once a file), as libtiff 4.7 decodes them:
//
// - trex_tiff_lzw: compression 5. A stream that starts with a zero byte
//   whose next byte has its low bit set is the old "compat" LZW (codes
//   least significant bit first, the width growing once the table is full
//   at 512, 1024 and 2048 entries); any other is TIFF 6.0's (most
//   significant bit first, the width growing one code early, at 511, 1023
//   and 2047), as tif_lzw.c's LZWPreDecode tells them apart.
// - trex_tiff_packbits: compression 32773 (tif_packbits.c).
// - trex_tiff_chunks: every strip or tile of a file, uncompressed, LZW
//   or PackBits, one after another into one buffer.
// - trex_tiff_predict: predictor 2 (tif_predict.c's horizontal
//   accumulation) over rows of 8- or 16-bit samples in either byte order.
//
// The codecs fill `out` with exactly `n` bytes and return 0, or -1 where
// the data ends first or holds an impossible code.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int32_t trex_tiff_lzw(const uint8_t* src, int64_t len, uint8_t* out,
                      int64_t n) {
    constexpr int kClear = 256, kEoi = 257, kFirst = 258;
    constexpr int kSize = 4096 + 1024;  // tif_lzw.c's CSIZE
    // an entry's string is always a run of the output already written:
    // the previous code's string and the first byte after it
    std::vector<int64_t> start(kSize);
    std::vector<int32_t> length(kSize, 1);
    const bool compat = len >= 2 && src[0] == 0 && (src[1] & 1);
    int64_t pos = 0;  // next input byte
    uint64_t acc = 0;
    int bits = 0;
    int nbits = 9;
    int free_ent = kFirst;
    int64_t maxcode = compat ? 511 : 510;  // the last code of this width
    int old = -1;
    int64_t old_at = 0;  // where the previous code's string was written
    int64_t o = 0;
    auto next_code = [&]() -> int {
        while (bits < nbits) {
            if (pos >= len) return kEoi;
            if (compat)
                acc |= (uint64_t)src[pos++] << bits;
            else
                acc = (acc << 8) | src[pos++];
            bits += 8;
        }
        int code;
        if (compat) {
            code = (int)(acc & ((1u << nbits) - 1));
            acc >>= nbits;
        } else {
            code = (int)((acc >> (bits - nbits)) & ((1u << nbits) - 1));
        }
        bits -= nbits;
        return code;
    };
    // write `code`'s string at o (a KwKwK string overlaps its source by
    // one byte, so the copy runs forward a byte at a time there)
    auto emit = [&](int code) -> bool {
        if (code < 256) {
            if (o >= n) return false;
            out[o] = (uint8_t)code;
        } else {
            const int64_t l = length[code], from = start[code];
            if (o + l > n) return false;
            if (from + l <= o)
                std::memcpy(out + o, out + from, l);
            else
                for (int64_t i = 0; i < l; ++i) out[o + i] = out[from + i];
        }
        old_at = o;
        o += code < 256 ? 1 : length[code];
        return true;
    };
    while (o < n) {
        int code = next_code();
        if (code == kEoi) break;
        if (code == kClear) {
            free_ent = kFirst;
            nbits = 9;
            maxcode = compat ? 511 : 510;
            do {
                code = next_code();
            } while (code == kClear);
            if (code == kEoi) break;
            if (code >= 256) return -1;
            if (!emit(code)) return -1;
            old = code;
            continue;
        }
        if (old < 0 || code > free_ent || free_ent >= kSize) return -1;
        // the new entry: the previous string and the next byte
        start[free_ent] = old_at;
        length[free_ent] = (old < 256 ? 1 : length[old]) + 1;
        ++free_ent;
        if (free_ent > maxcode) {
            if (nbits < 12) ++nbits;
            maxcode = compat ? (1 << nbits) - 1 : (1 << nbits) - 2;
        }
        if (!emit(code)) return -1;
        old = code;
    }
    return o == n ? 0 : -1;
}

int32_t trex_tiff_packbits(const uint8_t* src, int64_t len, uint8_t* out,
                           int64_t n) {
    int64_t i = 0, o = 0;
    while (o < n && i < len) {
        const int c = (int8_t)src[i++];
        if (c >= 0) {
            const int64_t k = c + 1;
            if (i + k > len || o + k > n) return -1;
            std::memcpy(out + o, src + i, k);
            i += k;
            o += k;
        } else if (c != -128) {
            const int64_t k = 1 - c;
            if (i >= len || o + k > n) return -1;
            std::memset(out + o, src[i++], k);
            o += k;
        }
    }
    return o == n ? 0 : -1;
}

// Decode `n` chunks (strips or tiles) of `data`: chunk i's `counts[i]`
// bytes at `offsets[i]` into `sizes[i]` bytes of `out`, one after another.
// `comp`: 1 (none), 5 (LZW) or 32773 (PackBits). Returns -1, or the index
// of the first chunk that lies past the data or fails to decode.
int64_t trex_tiff_chunks(const uint8_t* data, int64_t len,
                         const int64_t* offsets, const int64_t* counts,
                         const int64_t* sizes, int64_t n, int32_t comp,
                         uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t off = offsets[i], count = counts[i], size = sizes[i];
        if (off < 0 || count < 0 || off > len || count > len - off)
            return i;
        const uint8_t* src = data + off;
        if (comp == 1) {
            if (count < size) return i;
            std::memcpy(out, src, size);
        } else if (comp == 5) {
            if (trex_tiff_lzw(src, count, out, size) != 0) return i;
        } else if (comp == 32773) {
            if (trex_tiff_packbits(src, count, out, size) != 0) return i;
        } else {
            return i;
        }
        out += size;
    }
    return -1;
}

// Undo predictor 2 in place over `rows` rows of `pixels` pixels of `spp`
// (at most 8) samples of `bps` (8 or 16) bits, 16-bit samples big-endian
// where `big_endian`: each sample adds the same sample of the pixel
// before it, modulo 2^bps.
void trex_tiff_predict(uint8_t* data, int64_t rows, int64_t pixels,
                       int32_t spp, int32_t bps, int32_t big_endian) {
    if (spp < 1 || spp > 8) return;
    const int64_t n = pixels * spp;
    uint32_t acc[8];
    if (bps == 8) {
        for (int64_t r = 0; r < rows; ++r) {
            uint8_t* row = data + r * n;
            for (int k = 0; k < spp; ++k) acc[k] = row[k];
            for (int64_t i = spp; i < n; i += spp)
                for (int k = 0; k < spp; ++k) {
                    acc[k] += row[i + k];
                    row[i + k] = (uint8_t)acc[k];
                }
        }
        return;
    }
    const int hi = big_endian ? 0 : 1, lo = 1 - hi;
    for (int64_t r = 0; r < rows; ++r) {
        uint8_t* row = data + r * n * 2;
        for (int k = 0; k < spp; ++k)
            acc[k] = (row[2 * k + hi] << 8) | row[2 * k + lo];
        for (int64_t i = spp; i < n; i += spp)
            for (int k = 0; k < spp; ++k) {
                uint8_t* a = row + 2 * (i + k);
                acc[k] += (a[hi] << 8) | a[lo];
                a[hi] = (uint8_t)(acc[k] >> 8);
                a[lo] = (uint8_t)acc[k];
            }
    }
}

}  // extern "C"
