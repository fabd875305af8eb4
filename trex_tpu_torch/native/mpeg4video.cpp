// Video decoding without OpenCV (trex_tpu_torch/io/video_decode.py drives
// these), as OpenCV 5.0.0's FFmpeg (libavcodec 62.28, libswscale 9.5)
// computes it on an x86-64 host (tests/test_torch_video_decode.py holds
// every path to cv2 bit for bit):
//
// - trex_m4v_*: MPEG-4 Part 2 (ISO/IEC 14496-2) as FFmpeg's `mpeg4`
//   decoder decodes the streams its own encoder writes under `mp4v` and
//   `XVID`: rectangular progressive VOLs with H.263 quantisation, I- and
//   P-VOPs, intra DC/AC prediction, the intra and inter VLCs with their
//   three escapes, one and four motion vectors with median prediction,
//   half-pel motion compensation under vop_rounding_type, unrestricted
//   vectors over the replicated edge
//   of the macroblock-aligned picture, not-coded macroblocks, resync
//   markers and video packets, the simple IDCT. What the decoder does not
//   decode it names from the headers (trex_m4v_headers), which the Python
//   side reads before it decodes a file.
// - trex_mjpeg_idct: FFmpeg's `mjpeg` decoder's dequantisation (DC
//   prediction from 1024, products kept to 16 bits) and simple IDCT of a
//   component's blocks into its plane.
// - trex_yuv420_bgr: libswscale's unscaled yuv420p/yuvj420p -> bgr24 as
//   its x86 SIMD (yuv_2_rgb.asm) computes it: 16-bit fixed point, pmulhw
//   products, chroma repeated over each 2x2 block; or that BGR's grey
//   as cvtColor(COLOR_BGR2GRAY) computes it.
// - trex_m4v_enc_*: the port's own MPEG-4 Part 2 encoder of the streams
//   the decoder above reads (trex_tpu_torch/io/video_encode.py drives it;
//   tests/test_torch_video_encode.py holds cv2's decode, the decoder's and
//   its reconstruction equal).
//
// Built with -ffp-contract=off like the rest of the host library; every
// step here is integer arithmetic but the encoder's rate control, whose
// few double operations IEEE fixes: the same bits on every host.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Tables (ISO/IEC 14496-2 Annex B, in the order libavcodec lists them)
// ---------------------------------------------------------------------------

// TCOEF VLCs: (code, length) of each (last, run, level) entry, the escape
// last. The inter table is H.263's (B-17), the intra table MPEG-4's (B-16).
const uint16_t kInterVlc[103][2] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9},
    {0x24, 9}, {0x21, 10}, {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11},
    {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10}, {0x21, 11}, {0x50, 12},
    {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10},
    {0x53, 12}, {0x13, 6}, {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10},
    {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10}, {0x16, 7}, {0x55, 12},
    {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9},
    {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6}, {0xd, 6}, {0xc, 6},
    {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8},
    {0x18, 9}, {0x17, 9}, {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9},
    {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10}, {0x5, 10}, {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7},
};
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6},
    {0x13, 6}, {0x12, 6}, {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8},
    {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9}, {0x21, 10}, {0x20, 10},
    {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7},
    {0x1c, 8}, {0x20, 9}, {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9}, {0xc, 10}, {0x56, 12},
    {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9},
    {0x54, 12}, {0x14, 7}, {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10},
    {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9}, {0x18, 9}, {0x7, 10},
    {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10},
    {0xe, 6}, {0x4, 10}, {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11},
    {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12}, {0x14, 8}, {0x13, 8},
    {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7},
};
// (last, run) groups: the runs and how many levels each holds, in table
// order; the levels of a group run 1, 2, ...
struct RunGroup { int8_t run, levels; };
const RunGroup kInterRuns[] = {
    {0, 12}, {1, 6}, {2, 4}, {3, 3}, {4, 3}, {5, 3}, {6, 3}, {7, 2}, {8, 2},
    {9, 2}, {10, 2}, {11, 1}, {12, 1}, {13, 1}, {14, 1}, {15, 1}, {16, 1},
    {17, 1}, {18, 1}, {19, 1}, {20, 1}, {21, 1}, {22, 1}, {23, 1}, {24, 1},
    {25, 1}, {26, 1},
    // last
    {0, 3}, {1, 2}, {2, 1}, {3, 1}, {4, 1}, {5, 1}, {6, 1}, {7, 1}, {8, 1},
    {9, 1}, {10, 1}, {11, 1}, {12, 1}, {13, 1}, {14, 1}, {15, 1}, {16, 1},
    {17, 1}, {18, 1}, {19, 1}, {20, 1}, {21, 1}, {22, 1}, {23, 1}, {24, 1},
    {25, 1}, {26, 1}, {27, 1}, {28, 1}, {29, 1}, {30, 1}, {31, 1}, {32, 1},
    {33, 1}, {34, 1}, {35, 1}, {36, 1}, {37, 1}, {38, 1}, {39, 1}, {40, 1},
};
const int kInterLast = 58;  // first entry with last = 1
const RunGroup kIntraRuns[] = {
    {0, 27}, {1, 10}, {2, 5}, {3, 4}, {4, 3}, {5, 3}, {6, 3}, {7, 3},
    {8, 2}, {9, 2}, {10, 1}, {11, 1}, {12, 1}, {13, 1}, {14, 1},
    // last
    {0, 8}, {1, 3}, {2, 2}, {3, 2}, {4, 2}, {5, 2}, {6, 2}, {7, 1}, {8, 1},
    {9, 1}, {10, 1}, {11, 1}, {12, 1}, {13, 1}, {14, 1}, {15, 1}, {16, 1},
    {17, 1}, {18, 1}, {19, 1}, {20, 1},
};
const int kIntraLast = 67;

// MCBPC, CBPY, MVD and DC size VLCs: (code, length) by symbol
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// symbol = type * 4 + cbpc: 0 inter, 1 intra, 2 inter+q, 3 intra+q,
// 4 inter4v, 5 stuffing (20), 6 inter4v+q
const uint8_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9},
    {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}, {0, 0}, {0, 0}, {0, 0},
    {2, 11}, {12, 13}, {14, 13}, {15, 13}};
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                              {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4},
                              {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint8_t kMv[33][2] = {
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
    {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10},
    {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10},
    {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11}, {3, 11},
    {2, 11}, {3, 12}, {2, 12}};
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                               {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                               {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                                 {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                                 {1, 10}, {1, 11}, {1, 12}};

const uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

const uint8_t kYDcScale[32] = {0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19,
                               20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                               31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12,
                               12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17,
                               18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kQuantStep[4] = {-1, -2, 1, 2};

// ---------------------------------------------------------------------------
// Bits and VLCs
// ---------------------------------------------------------------------------

struct Bits {
  const uint8_t* p = nullptr;
  int64_t size = 0;  // in bits
  int64_t pos = 0;

  // the next n (<= 32) bits; zeros past the end
  uint32_t show(int n) const {
    if (n == 0) return 0;
    int64_t byte = pos >> 3;
    uint64_t v = 0;
    int64_t bytes = size >> 3;
    for (int i = 0; i < 5; ++i)
      v = (v << 8) | (byte + i < bytes ? p[byte + i] : 0);
    v <<= 24 + (pos & 7);  // the first wanted bit at bit 63
    return uint32_t(v >> (64 - n));
  }
  void skip(int n) { pos += n; }
  uint32_t get(int n) {
    uint32_t v = show(n);
    pos += n;
    return v;
  }
  int get1() { return int(get(1)); }
  int64_t left() const { return size - pos; }
  void align() { pos = (pos + 7) & ~int64_t(7); }
  // get_xbits: n bits, a leading 0 making the value negative
  int xbits(int n) {
    uint32_t v = get(n);
    if (v >> (n - 1)) return int(v);
    return int(v) - int((1u << n) - 1);
  }
  int sbits(int n) {
    uint32_t v = get(n);
    return int32_t(v << (32 - n)) >> (32 - n);
  }
};

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;  // by the next `bits` bits; -1: no code
  std::vector<uint8_t> len;
};

template <typename T>
void build_vlc(Vlc& v, const T (*codes)[2], int n, int bits) {
  v.bits = bits;
  v.sym.assign(size_t(1) << bits, -1);
  v.len.assign(size_t(1) << bits, 0);
  for (int s = 0; s < n; ++s) {
    int len = codes[s][1];
    if (len == 0) continue;
    uint32_t first = uint32_t(codes[s][0]) << (bits - len);
    uint32_t count = 1u << (bits - len);
    for (uint32_t k = 0; k < count; ++k) {
      v.sym[first + k] = int16_t(s);
      v.len[first + k] = uint8_t(len);
    }
  }
}

// av_log2: the index of the highest set bit, 0 for 0
inline int log2_floor(unsigned v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

inline int read_vlc(Bits& b, const Vlc& v) {
  uint32_t k = b.show(v.bits);
  int s = v.sym[k];
  if (s >= 0) b.skip(v.len[k]);
  return s;
}

struct RunLevel {
  Vlc vlc;
  int n = 102, last = 0;
  int8_t run[102], level[102];
  int8_t max_level[2][64];
  int8_t max_run[2][65];
};

void build_rl(RunLevel& rl, const uint16_t (*codes)[2], const RunGroup* groups,
              int ngroups, int last) {
  build_vlc(rl.vlc, codes, 103, 12);
  rl.last = last;
  int i = 0;
  for (int g = 0; g < ngroups; ++g)
    for (int l = 1; l <= groups[g].levels; ++l) {
      rl.run[i] = groups[g].run;
      rl.level[i] = int8_t(l);
      ++i;
    }
  std::memset(rl.max_level, 0, sizeof(rl.max_level));
  std::memset(rl.max_run, 0, sizeof(rl.max_run));
  for (int k = 0; k < 102; ++k) {
    int t = k >= last;
    int r = rl.run[k], l = rl.level[k];
    if (l > rl.max_level[t][r]) rl.max_level[t][r] = int8_t(l);
    if (r > rl.max_run[t][l]) rl.max_run[t][l] = int8_t(r);
  }
}

struct Tables {
  RunLevel inter, intra;
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Tables() {
    build_rl(inter, kInterVlc, kInterRuns,
             int(sizeof(kInterRuns) / sizeof(kInterRuns[0])), kInterLast);
    build_rl(intra, kIntraVlc, kIntraRuns,
             int(sizeof(kIntraRuns) / sizeof(kIntraRuns[0])), kIntraLast);
    build_vlc(intra_mcbpc, kIntraMcbpc, 9, 9);
    build_vlc(inter_mcbpc, kInterMcbpc, 28, 13);
    build_vlc(cbpy, kCbpy, 16, 6);
    build_vlc(mv, kMv, 33, 12);
    build_vlc(dc_lum, kDcLum, 13, 11);
    build_vlc(dc_chrom, kDcChrom, 13, 12);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---------------------------------------------------------------------------
// The simple IDCT (libavcodec simple_idct_template.c, 8 bits)
// ---------------------------------------------------------------------------

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

inline void idct_row(int16_t* row) {
  uint64_t r0, r1;
  std::memcpy(&r0, row, 8);
  std::memcpy(&r1, row + 4, 8);
  if (((r0 & ~uint64_t(0xffff)) | r1) == 0) {
    uint16_t t = uint16_t(row[0] * (1 << DC_SHIFT));
    for (int i = 0; i < 8; ++i) row[i] = int16_t(t);
    return;
  }
  unsigned a0 = unsigned(W4) * row[0] + (1u << (ROW_SHIFT - 1));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += unsigned(W2) * row[2];
  a1 += unsigned(W6) * row[2];
  a2 -= unsigned(W6) * row[2];
  a3 -= unsigned(W2) * row[2];
  unsigned b0 = unsigned(W1) * row[1] + unsigned(W3) * row[3];
  unsigned b1 = unsigned(W3) * row[1] - unsigned(W7) * row[3];
  unsigned b2 = unsigned(W5) * row[1] - unsigned(W1) * row[3];
  unsigned b3 = unsigned(W7) * row[1] - unsigned(W5) * row[3];
  if (r1) {
    a0 += unsigned(W4) * row[4] + unsigned(W6) * row[6];
    a1 += -unsigned(W4) * row[4] - unsigned(W2) * row[6];
    a2 += -unsigned(W4) * row[4] + unsigned(W2) * row[6];
    a3 += unsigned(W4) * row[4] - unsigned(W6) * row[6];
    b0 += unsigned(W5) * row[5] + unsigned(W7) * row[7];
    b1 += -unsigned(W1) * row[5] - unsigned(W5) * row[7];
    b2 += unsigned(W7) * row[5] + unsigned(W3) * row[7];
    b3 += unsigned(W3) * row[5] - unsigned(W1) * row[7];
  }
  row[0] = int16_t(int(a0 + b0) >> ROW_SHIFT);
  row[7] = int16_t(int(a0 - b0) >> ROW_SHIFT);
  row[1] = int16_t(int(a1 + b1) >> ROW_SHIFT);
  row[6] = int16_t(int(a1 - b1) >> ROW_SHIFT);
  row[2] = int16_t(int(a2 + b2) >> ROW_SHIFT);
  row[5] = int16_t(int(a2 - b2) >> ROW_SHIFT);
  row[3] = int16_t(int(a3 + b3) >> ROW_SHIFT);
  row[4] = int16_t(int(a3 - b3) >> ROW_SHIFT);
}

inline void idct_col(const int16_t* col, int out[8]) {
  unsigned a0 = unsigned(W4) * unsigned(col[0] + ((1 << (COL_SHIFT - 1)) / W4));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += unsigned(W2) * col[16];
  a1 += unsigned(W6) * col[16];
  a2 += unsigned(-W6) * col[16];
  a3 += unsigned(-W2) * col[16];
  unsigned b0 = unsigned(W1) * col[8] + unsigned(W3) * col[24];
  unsigned b1 = unsigned(W3) * col[8] + unsigned(-W7) * col[24];
  unsigned b2 = unsigned(W5) * col[8] + unsigned(-W1) * col[24];
  unsigned b3 = unsigned(W7) * col[8] + unsigned(-W5) * col[24];
  if (col[32]) {
    a0 += unsigned(W4) * col[32];
    a1 += -unsigned(W4) * col[32];
    a2 += -unsigned(W4) * col[32];
    a3 += unsigned(W4) * col[32];
  }
  if (col[40]) {
    b0 += unsigned(W5) * col[40];
    b1 += unsigned(-W1) * col[40];
    b2 += unsigned(W7) * col[40];
    b3 += unsigned(W3) * col[40];
  }
  if (col[48]) {
    a0 += unsigned(W6) * col[48];
    a1 += -unsigned(W2) * col[48];
    a2 += unsigned(W2) * col[48];
    a3 += -unsigned(W6) * col[48];
  }
  if (col[56]) {
    b0 += unsigned(W7) * col[56];
    b1 += unsigned(-W5) * col[56];
    b2 += unsigned(W3) * col[56];
    b3 += unsigned(-W1) * col[56];
  }
  out[0] = int(a0 + b0) >> COL_SHIFT;
  out[1] = int(a1 + b1) >> COL_SHIFT;
  out[2] = int(a2 + b2) >> COL_SHIFT;
  out[3] = int(a3 + b3) >> COL_SHIFT;
  out[4] = int(a3 - b3) >> COL_SHIFT;
  out[5] = int(a2 - b2) >> COL_SHIFT;
  out[6] = int(a1 - b1) >> COL_SHIFT;
  out[7] = int(a0 - b0) >> COL_SHIFT;
}

inline uint8_t clip_u8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// block (natural order) -> dest, put (add = false) or add to dest
void idct(int16_t* block, uint8_t* dest, int64_t stride, bool add) {
  for (int i = 0; i < 8; ++i) idct_row(block + 8 * i);
  int out[8];
  for (int i = 0; i < 8; ++i) {
    idct_col(block + i, out);
    for (int k = 0; k < 8; ++k) {
      uint8_t* d = dest + k * stride + i;
      *d = clip_u8(add ? *d + out[k] : out[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// Half-pel motion compensation (libavcodec hpeldsp as x86 runs it)
// ---------------------------------------------------------------------------

// src: (w + 1) x (h + 1) samples, `sstride` apart; dxy: bit 0 x, bit 1 y.
// The averages are exact, rounding up or (no_rounding) down.
void hpel_put(uint8_t* dst, int64_t dstride, const uint8_t* src,
              int64_t sstride, int w, int h, int dxy, bool no_rounding) {
  const int r2 = no_rounding ? 0 : 1, r4 = no_rounding ? 1 : 2;
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + y * sstride;
    const uint8_t* t = s + sstride;
    uint8_t* d = dst + y * dstride;
    switch (dxy) {
      case 0:
        std::memcpy(d, s, size_t(w));
        break;
      case 1:
        for (int x = 0; x < w; ++x) d[x] = uint8_t((s[x] + s[x + 1] + r2) >> 1);
        break;
      case 2:
        for (int x = 0; x < w; ++x) d[x] = uint8_t((s[x] + t[x] + r2) >> 1);
        break;
      default:
        for (int x = 0; x < w; ++x)
          d[x] = uint8_t((s[x] + s[x + 1] + t[x] + t[x + 1] + r4) >> 2);
    }
  }
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Plane {
  std::vector<uint8_t> px;
  int w = 0, h = 0;  // macroblock-aligned
  int64_t stride = 0;
  void alloc(int w_, int h_) {
    w = w_;
    h = h_;
    stride = w_;
    px.assign(size_t(w_) * h_, 0);
  }
  uint8_t at(int x, int y) const {
    x = x < 0 ? 0 : x >= w ? w - 1 : x;
    y = y < 0 ? 0 : y >= h ? h - 1 : y;
    return px[size_t(y) * stride + x];
  }
};

struct Picture {
  Plane p[3];
};

enum { kOk = 0, kEnd = 1 };
enum {
  kErrBits = -1,       // a code no table holds, or data that ran out
  kErrHeader = -2,     // a broken header
  kErrUnsupported = -3,  // a feature the decoder does not decode (a Why)
  kErrNoRef = -4,      // a P-VOP with no picture before it
  kErrPacket = -5,     // a video packet header out of place
  kErrSize = -6,       // a picture of another size than the caller's
};
// what a header names that the decoder does not decode
// (io/video_decode.py's _M4V_REFUSED names each)
enum {
  kWhyChroma = 1, kWhyShape, kWhyTimeResolution, kWhyInterlaced, kWhyObmc,
  kWhySprites, kWhyDepth, kWhyMpegQuant, kWhyQuarterPel, kWhyComplexity,
  kWhyPartitioned, kWhyNewpred, kWhyReducedResolution, kWhyScalability,
  kWhyBVop, kWhySVop, kWhyNotCoded, kWhyNoVol, kWhyShortHeader,
  kWhySignalType,
};

struct Decoder {
  // a probe reads headers only and holds no picture
  bool probe = false;
  // stream
  bool have_vol = false;
  int vo_type = 0, vol_control = 0, why = 0;
  int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0;
  int time_increment_bits = 1, quant_precision = 5;
  // pictures
  Picture cur, ref;
  bool have_ref = false;
  // prediction state, laid out as libavcodec lays it out (a border row
  // and column in front, chroma after luma), so that the buffer cleaning
  // at a video packet covers the same entries
  int b8_stride = 0, mb_stride = 0;
  int64_t y_size = 0, c_size = 0;
  std::vector<int16_t> dc_val, ac_val;
  std::vector<int8_t> qscale_table;
  std::vector<int16_t> mv;  // 2 * mb_h rows of b8_stride (x, y) pairs
  // VOP
  int pict_type = 0, no_rounding = 0, intra_dc_threshold = 99;
  int qscale = 1, f_code = 1;
  // MB
  int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0;
  bool first_slice_line = true;
  bool mb_intra = false, ac_pred = false, use_intra_dc_vlc = false;
  int mv_type = 0;  // 0: 16x16, 1: 8x8
  int mvs[4][2];
  int16_t block[6][64];
  int block_last_index[6];

  void set_size(int w, int h) {
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    mb_num = mb_w * mb_h;
    b8_stride = mb_w * 2 + 1;
    mb_stride = mb_w + 1;
    y_size = int64_t(b8_stride) * (2 * mb_h + 1);
    c_size = int64_t(mb_stride) * (mb_h + 1);
    int64_t yc = y_size + 2 * c_size;
    dc_val.assign(size_t(yc), 1024);
    ac_val.assign(size_t(yc) * 16, 0);
    qscale_table.assign(size_t(mb_stride) * mb_h, 0);
    mv.assign(size_t(2 * mb_h + 1) * b8_stride * 2 + 8, 0);
    for (Picture* p : {&cur, &ref}) {
      p->p[0].alloc(mb_w * 16, mb_h * 16);
      p->p[1].alloc(mb_w * 8, mb_h * 8);
      p->p[2].alloc(mb_w * 8, mb_h * 8);
    }
    have_ref = false;
  }

  // index of block n of the current MB into dc_val (ac_val x 16)
  int64_t block_index(int n) const {
    if (n < 4)
      return b8_stride + 1 + int64_t(b8_stride) * (2 * mb_y + (n >> 1)) +
             2 * mb_x + (n & 1);
    int64_t base = y_size + mb_stride + 1 + (n == 5 ? c_size : 0);
    return base + int64_t(mb_y) * mb_stride + mb_x;
  }
  int block_wrap(int n) const { return n < 4 ? b8_stride : mb_stride; }
  // motion vector table entry of luma block n of the current MB
  int16_t* mv_at(int n) {
    int64_t i = 4 + int64_t(b8_stride) * (2 * mb_y + (n >> 1)) + 2 * mb_x +
                (n & 1);
    return &mv[size_t(i) * 2];
  }

  // -- headers ------------------------------------------------------------

  // the feature a header names that the decoder does not decode: the
  // reason (a Why) is kept in `why`
  int unsupported(int reason) {
    why = reason;
    return kErrUnsupported;
  }

  int vol_header(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = int(b.get(8));
    int verid = 1;
    if (b.get1()) {  // is_object_layer_identifier
      verid = int(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // extended pixel aspect ratio
    vol_control = b.get1();
    if (vol_control) {
      if (b.get(2) != 1) return unsupported(kWhyChroma);
      b.skip(1);  // low_delay
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
    }
    if (b.get(2) != 0) return unsupported(kWhyShape);
    b.skip(1);
    int res = int(b.get(16));
    if (res == 0) return unsupported(kWhyTimeResolution);
    time_increment_bits = log2_floor(res - 1) + 1;
    b.skip(1);
    if (b.get1()) b.skip(time_increment_bits);  // fixed_vop_rate
    b.skip(1);
    int w = int(b.get(13));
    b.skip(1);
    int h = int(b.get(13));
    b.skip(1);
    if (b.get1()) return unsupported(kWhyInterlaced);
    if (!b.get1()) return unsupported(kWhyObmc);
    if (b.get(verid == 1 ? 1 : 2)) return unsupported(kWhySprites);
    if (b.get1()) return unsupported(kWhyDepth);
    quant_precision = 5;
    if (b.get1()) return unsupported(kWhyMpegQuant);
    if (verid != 1 && b.get1()) return unsupported(kWhyQuarterPel);
    if (!b.get1()) return unsupported(kWhyComplexity);
    b.skip(1);  // resync_marker_disable: the slices find the markers
    if (b.get1()) return unsupported(kWhyPartitioned);
    if (verid != 1) {
      if (b.get1()) return unsupported(kWhyNewpred);
      if (b.get1()) return unsupported(kWhyReducedResolution);
    }
    if (b.get1()) return unsupported(kWhyScalability);
    if (w <= 0 || h <= 0) return kErrHeader;
    if (probe) {
      width = w;
      height = h;
    } else if (!have_vol || w != width || h != height) {
      set_size(w, h);
    }
    have_vol = true;
    return kOk;
  }

  // scan start codes up to the VOP's, parsing the VO and VOL headers on
  // the way (the Python side reads the user data), then the VOP header
  // unless `stop_at_vop`; kEnd where the data ends first
  int headers(Bits& b, bool stop_at_vop) {
    if (b.show(22) == 0x20) return unsupported(kWhyShortHeader);
    for (;;) {
      b.align();
      uint32_t code = 0xff;
      for (;;) {
        if (b.left() < 8) return kEnd;
        code = ((code << 8) | b.get(8)) & 0xffffffffu;
        if ((code & 0xffffff00u) == 0x100) break;
      }
      if (code >= 0x120 && code <= 0x12f) {
        int r = vol_header(b);
        if (r) return r;
      } else if (code == 0x1b5) {  // visual object
        if (b.get1()) b.skip(4 + 3);  // verid, priority
        // a video ID's video_signal_type (range, colour description)
        if (b.get(4) == 1 && b.get1()) return unsupported(kWhySignalType);
      } else if (code == 0x1b6) {
        return stop_at_vop ? int(kOk) : vop_header(b);
      }
    }
  }

  int vop_header(Bits& b) {
    if (!have_vol) return unsupported(kWhyNoVol);
    pict_type = int(b.get(2));  // 0 I, 1 P, 2 B, 3 S
    if (pict_type == 2) return unsupported(kWhyBVop);
    if (pict_type == 3) return unsupported(kWhySVop);
    while (b.get1()) {
    }  // modulo_time_base
    b.skip(1);
    b.skip(time_increment_bits);
    b.skip(1);
    if (!b.get1()) return unsupported(kWhyNotCoded);  // vop_coded 0
    if (probe) return kOk;
    no_rounding = pict_type == 1 ? b.get1() : 0;
    if (b.left() < 3) return kErrBits;
    intra_dc_threshold = kDcThreshold[b.get(3)];
    qscale = int(b.get(quant_precision));
    if (qscale == 0) return kErrHeader;
    f_code = 1;
    if (pict_type == 1) {
      f_code = int(b.get(3));
      if (f_code == 0) return kErrHeader;
    }
    return kOk;
  }

  // -- prediction ------------------------------------------------------------

  // the DC block n is predicted from (in quantised units) and the
  // direction, as pred_dc reads them
  int dc_pred(int n, int* dir) const {
    int scale = n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
    int wrap = block_wrap(n);
    const int16_t* dc = &dc_val[size_t(block_index(n))];
    int a = dc[-1], bb = dc[-1 - wrap], c = dc[-wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) bb = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) bb = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
      if (n == 0 || n == 4 || n == 5) bb = 1024;
    }
    int pred;
    if (std::abs(a - bb) < std::abs(bb - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    return (pred + (scale >> 1)) / scale;
  }

  // keep block n's DC `level` (quantised) for the predictions after it
  void dc_store(int n, int level) {
    level *= n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    dc_val[size_t(block_index(n))] = int16_t(level);
  }

  int pred_dc(int n, int level, int* dir) {
    level += dc_pred(n, dir);
    dc_store(n, level);
    return level;
  }

  void pred_ac(int16_t* blk, int n, int dir) {
    int16_t* ac = &ac_val[size_t(block_index(n)) * 16];
    int16_t* ac1 = ac;
    if (ac_pred) {
      if (dir == 0) {
        int xy = mb_x - 1 + mb_y * mb_stride;
        ac -= 16;
        if (mb_x == 0 || qscale == qscale_table[size_t(xy)] || n == 1 ||
            n == 3) {
          for (int i = 1; i < 8; ++i) blk[i << 3] += ac[i];
        } else {
          int q = qscale_table[size_t(xy)];
          for (int i = 1; i < 8; ++i) blk[i << 3] += rounded_div(ac[i] * q, qscale);
        }
      } else {
        int xy = mb_x + mb_y * mb_stride - mb_stride;
        ac -= 16 * block_wrap(n);
        if (mb_y == 0 || qscale == qscale_table[size_t(xy)] || n == 2 ||
            n == 3) {
          for (int i = 1; i < 8; ++i) blk[i] += ac[i + 8];
        } else {
          int q = qscale_table[size_t(xy)];
          for (int i = 1; i < 8; ++i) blk[i] += rounded_div(ac[i + 8] * q, qscale);
        }
      }
    }
    for (int i = 1; i < 8; ++i) ac1[i] = blk[i << 3];
    for (int i = 1; i < 8; ++i) ac1[8 + i] = blk[i];
  }

  static int rounded_div(int a, int b) {
    return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b;
  }

  void clean_intra_entries() {
    int64_t xy = block_index(0);
    int w = b8_stride;
    dc_val[size_t(xy)] = dc_val[size_t(xy + 1)] = dc_val[size_t(xy + w)] =
        dc_val[size_t(xy + 1 + w)] = 1024;
    std::memset(&ac_val[size_t(xy) * 16], 0, 32 * sizeof(int16_t));
    std::memset(&ac_val[size_t(xy + w) * 16], 0, 32 * sizeof(int16_t));
    for (int n = 4; n < 6; ++n) {
      int64_t c = block_index(n);
      dc_val[size_t(c)] = 1024;
      std::memset(&ac_val[size_t(c) * 16], 0, 16 * sizeof(int16_t));
    }
  }

  // ff_mpeg4_clean_buffers at the start of a video packet
  void clean_buffers() {
    int64_t l_xy = b8_stride + 1 + int64_t(2 * mb_y - 1) * b8_stride +
                   mb_x * 2 - 1;
    int64_t c_xy = int64_t(mb_y - 1) * mb_stride + mb_x - 1;
    int64_t n = int64_t(b8_stride) * 2 + 1;
    std::fill_n(&ac_val[size_t(l_xy) * 16], size_t(n) * 16, int16_t(0));
    for (int p = 0; p < 2; ++p) {
      int64_t base = y_size + mb_stride + 1 + (p ? c_size : 0) + c_xy;
      std::fill_n(&ac_val[size_t(base) * 16], size_t(mb_stride + 1) * 16,
                  int16_t(0));
    }
  }

  void pred_motion(int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int wrap = b8_stride;
    int16_t* m = mv_at(blk);
    int16_t* A = m - 2;
    if (first_slice_line && blk < 3) {
      if (blk == 0) {
        if (mb_x == resync_mb_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_mb_x) {
          int16_t* C = m + 2 * (off[blk] - wrap);
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid(A[0], 0, C[0]);
            *py = mid(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (blk == 1) {
        if (mb_x + 1 == resync_mb_x) {
          int16_t* C = m + 2 * (off[blk] - wrap);
          *px = mid(A[0], 0, C[0]);
          *py = mid(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        int16_t* B = m - 2 * wrap;
        int16_t* C = m + 2 * (off[blk] - wrap);
        if (mb_x == resync_mb_x) A[0] = A[1] = 0;
        *px = mid(A[0], B[0], C[0]);
        *py = mid(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = m - 2 * wrap;
      int16_t* C = m + 2 * (off[blk] - wrap);
      *px = mid(A[0], B[0], C[0]);
      *py = mid(A[1], B[1], C[1]);
    }
  }

  static int mid(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
  }

  int decode_motion(Bits& b, int pred, bool* ok) {
    int code = read_vlc(b, tables().mv);
    if (code < 0) {
      *ok = false;
      return 0;
    }
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = f_code - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b.get(shift));
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f_code;  // sign_extend(val, 5 + f_code)
    return int32_t(uint32_t(val) << (32 - bits)) >> (32 - bits);
  }

  // -- blocks ------------------------------------------------------------

  int decode_block(Bits& b, int16_t* blk, int n, bool coded, bool intra) {
    const Tables& t = tables();
    const RunLevel* rl;
    const uint8_t* scan;
    int qmul, qadd, i, dc_dir = 0;
    if (intra) {
      if (use_intra_dc_vlc) {
        int size = read_vlc(b, n < 4 ? t.dc_lum : t.dc_chrom);
        if (size < 0) return kErrBits;
        int level = 0;
        if (size) {
          level = b.xbits(size);
          if (size > 8) b.skip(1);  // marker
        }
        blk[0] = int16_t(pred_dc(n, level, &dc_dir));
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dc_dir);
      }
      rl = &t.intra;
      scan = !ac_pred ? kZigzag : dc_dir == 0 ? kAltVertical : kAltHorizontal;
      qmul = 1;
      qadd = 0;
      if (!coded) goto not_coded;
    } else {
      i = -1;
      if (!coded) {
        block_last_index[n] = i;
        return kOk;
      }
      rl = &t.inter;
      scan = kZigzag;
      qmul = qscale << 1;
      qadd = (qscale - 1) | 1;
    }
    for (;;) {
      int sym = read_vlc(b, rl->vlc);
      if (sym < 0) return kErrBits;
      int run, level, last;
      if (sym == 102) {  // escape
        uint32_t c = b.show(2);
        if (c & 2) {
          if (c & 1) {  // third escape: fixed length
            b.skip(2);
            last = b.get1();
            run = int(b.get(6));
            b.skip(1);  // marker
            level = b.sbits(12);
            b.skip(1);  // marker
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (unsigned(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            i += run + 1;
            if (last) i += 192;
          } else {  // second escape: run offset
            b.skip(2);
            int s2 = read_vlc(b, rl->vlc);
            if (s2 < 0 || s2 == 102) return kErrBits;
            last = s2 >= rl->last;
            run = rl->run[s2];
            int mag = rl->level[s2];
            run += rl->max_run[last][mag] + 1;
            level = mag * qmul + qadd;
            if (b.get1()) level = -level;
            i += run + 1;
            if (last) i += 192;
          }
        } else {  // first escape: level offset
          b.skip(1);
          int s2 = read_vlc(b, rl->vlc);
          if (s2 < 0 || s2 == 102) return kErrBits;
          last = s2 >= rl->last;
          run = rl->run[s2];
          int mag = rl->level[s2] + rl->max_level[last][run];
          level = mag * qmul + qadd;
          if (b.get1()) level = -level;
          i += run + 1;
          if (last) i += 192;
        }
      } else {
        last = sym >= rl->last;
        run = rl->run[sym];
        level = rl->level[sym] * qmul + qadd;
        if (b.get1()) level = -level;
        i += run + 1;
        if (last) i += 192;
      }
      if (i > 62) {
        i -= 192;
        if (i & ~63) return kErrBits;
        blk[scan[i]] = int16_t(level);
        break;
      }
      blk[scan[i]] = int16_t(level);
    }
  not_coded:
    if (intra) {
      if (!use_intra_dc_vlc) {
        blk[0] = int16_t(pred_dc(n, blk[0], &dc_dir));
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, dc_dir);
      if (ac_pred) i = 63;
    }
    block_last_index[n] = i;
    return kOk;
  }

  // -- macroblocks ----------------------------------------------------------

  void set_qscale(int q) { qscale = q < 1 ? 1 : q > 31 ? 31 : q; }

  int decode_mb(Bits& b) {
    const Tables& t = tables();
    int cbpc, cbpy, cbp;
    bool dquant;
    std::memset(block, 0, sizeof(block));
    mv_type = 0;
    if (pict_type == 1) {
      do {
        if (b.get1()) {  // not coded
          mb_intra = false;
          for (int i = 0; i < 6; ++i) block_last_index[i] = -1;
          mv_type = 0;
          mvs[0][0] = mvs[0][1] = 0;
          return kOk;
        }
        cbpc = read_vlc(b, t.inter_mcbpc);
        if (cbpc < 0) return kErrBits;
      } while (cbpc == 20);
      dquant = cbpc & 8;
      mb_intra = cbpc & 4;
      if (!mb_intra) {
        cbpy = read_vlc(b, t.cbpy);
        if (cbpy < 0) return kErrBits;
        cbpy ^= 0xf;
        cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) set_qscale(qscale + kQuantStep[b.get(2)]);
        bool ok = true;
        if (!(cbpc & 16)) {
          mv_type = 0;
          int px, py;
          pred_motion(0, &px, &py);
          int mx = decode_motion(b, px, &ok);
          int my = decode_motion(b, py, &ok);
          if (!ok) return kErrBits;
          mvs[0][0] = mx;
          mvs[0][1] = my;
        } else {
          mv_type = 1;
          for (int i = 0; i < 4; ++i) {
            int px, py;
            pred_motion(i, &px, &py);
            int mx = decode_motion(b, px, &ok);
            int my = decode_motion(b, py, &ok);
            if (!ok) return kErrBits;
            mvs[i][0] = mx;
            mvs[i][1] = my;
            int16_t* m = mv_at(i);
            m[0] = int16_t(mx);
            m[1] = int16_t(my);
          }
        }
        for (int i = 0; i < 6; ++i) {
          int r = decode_block(b, block[i], i, cbp & 32, false);
          if (r) return r;
          cbp += cbp;
        }
        return kOk;
      }
    } else {
      do {
        cbpc = read_vlc(b, t.intra_mcbpc);
        if (cbpc < 0) return kErrBits;
      } while (cbpc == 8);
      dquant = cbpc & 4;
      mb_intra = true;
    }
    ac_pred = b.get1();
    cbpy = read_vlc(b, t.cbpy);
    if (cbpy < 0) return kErrBits;
    cbp = (cbpc & 3) | (cbpy << 2);
    use_intra_dc_vlc = qscale < intra_dc_threshold;
    if (dquant) set_qscale(qscale + kQuantStep[b.get(2)]);
    for (int i = 0; i < 6; ++i) {
      int r = decode_block(b, block[i], i, cbp & 32, true);
      if (r) return r;
      cbp += cbp;
    }
    return kOk;
  }

  // ff_h263_update_motion_val and the intra tables of an inter MB
  void update_tables() {
    if (mv_type == 0) {
      int mx = mb_intra ? 0 : mvs[0][0], my = mb_intra ? 0 : mvs[0][1];
      for (int n = 0; n < 4; ++n) {
        int16_t* m = mv_at(n);
        m[0] = int16_t(mx);
        m[1] = int16_t(my);
      }
    }
    if (!mb_intra) clean_intra_entries();
    qscale_table[size_t(mb_y * mb_stride + mb_x)] = int8_t(qscale);
  }

  // -- reconstruction ------------------------------------------------------

  // a (w + 1) x (h + 1) window of `pl` at (x, y), edges replicated
  static const uint8_t* window(const Plane& pl, int x, int y, int w, int h,
                               uint8_t* tmp, int64_t* stride) {
    if (x >= 0 && y >= 0 && x + w + 1 <= pl.w && y + h + 1 <= pl.h) {
      *stride = pl.stride;
      return &pl.px[size_t(y) * pl.stride + x];
    }
    for (int j = 0; j <= h; ++j)
      for (int i = 0; i <= w; ++i) tmp[j * (w + 1) + i] = pl.at(x + i, y + j);
    *stride = w + 1;
    return tmp;
  }

  void mc_block(Plane& dst, const Plane& src, int dx, int dy, int sx, int sy,
                int w, int h, int dxy) {
    uint8_t tmp[17 * 17];
    int64_t ss;
    const uint8_t* s = window(src, sx, sy, w, h, tmp, &ss);
    hpel_put(&dst.px[size_t(dy) * dst.stride + dx], dst.stride, s, ss, w, h,
             dxy, no_rounding);
  }

  void motion() {
    const Picture& r = ref;
    if (mv_type == 0) {
      int mx = mvs[0][0], my = mvs[0][1];
      int dxy = ((my & 1) << 1) | (mx & 1);
      mc_block(cur.p[0], r.p[0], mb_x * 16, mb_y * 16, mb_x * 16 + (mx >> 1),
               mb_y * 16 + (my >> 1), 16, 16, dxy);
      int cx = (mx >> 1) | (mx & 1), cy = (my >> 1) | (my & 1);
      int cdxy = ((cy & 1) << 1) | (cx & 1);
      for (int p = 1; p < 3; ++p)
        mc_block(cur.p[p], r.p[p], mb_x * 8, mb_y * 8, mb_x * 8 + (cx >> 1),
                 mb_y * 8 + (cy >> 1), 8, 8, cdxy);
      return;
    }
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; ++i) {
      int mx = mvs[i][0], my = mvs[i][1];
      int sx = mb_x * 16 + (i & 1) * 8 + (mx >> 1);
      int sy = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
      int dxy = 0;
      sx = std::clamp(sx, -16, width);
      if (sx != width) dxy |= mx & 1;
      sy = std::clamp(sy, -16, height);
      if (sy != height) dxy |= (my & 1) << 1;
      mc_block(cur.p[0], r.p[0], mb_x * 16 + (i & 1) * 8,
               mb_y * 16 + (i >> 1) * 8, sx, sy, 8, 8, dxy);
      sumx += mx;
      sumy += my;
    }
    int cx = round_chroma(sumx), cy = round_chroma(sumy);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    cx >>= 1;
    cy >>= 1;
    int sx = mb_x * 8 + cx, sy = mb_y * 8 + cy;
    sx = std::clamp(sx, -8, width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::clamp(sy, -8, height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    for (int p = 1; p < 3; ++p)
      mc_block(cur.p[p], r.p[p], mb_x * 8, mb_y * 8, sx, sy, 8, 8, dxy);
  }

  static int round_chroma(int x) {
    static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 2, 2};
    return tab[x & 0xf] + ((x >> 3) & ~1);
  }

  void reconstruct() {
    for (int n = 0; n < 6; ++n) {
      Plane& pl = cur.p[n < 4 ? 0 : n - 3];
      int x = n < 4 ? mb_x * 16 + (n & 1) * 8 : mb_x * 8;
      int y = n < 4 ? mb_y * 16 + (n >> 1) * 8 : mb_y * 8;
      uint8_t* d = &pl.px[size_t(y) * pl.stride + x];
      if (mb_intra) {
        // dct_unquantize_h263_intra
        int16_t* blk = block[n];
        int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        blk[0] = int16_t(blk[0] * (n < 4 ? kYDcScale[qscale]
                                         : kCDcScale[qscale]));
        for (int i = 1; i < 64; ++i) {
          int l = blk[i];
          if (l) blk[i] = int16_t(l < 0 ? l * qmul - qadd : l * qmul + qadd);
        }
        idct(blk, d, pl.stride, false);
      } else if (block_last_index[n] >= 0) {
        idct(block[n], d, pl.stride, true);
      }
    }
  }

  // ff_mpeg4 is_resync: the macroblock number of the packet that starts
  // after the current macroblock, mb_num at the end of the data, else 0
  int is_resync(Bits& b) {
    int64_t bits_count = b.pos;
    uint32_t v = b.show(16);
    while (v <= 0xff) {
      if ((v >> (8 - (pict_type + 1))) != 1) break;
      b.skip(8 + pict_type + 1);
      bits_count += 8 + pict_type + 1;
      v = b.show(16);
    }
    if (bits_count + 8 >= b.size) {
      v >>= 8;
      v |= 0x7f >> (7 - (bits_count & 7));
      if (v == 0x7f) return mb_num;
    } else {
      static const uint16_t prefix[8] = {0x7f00, 0x7e00, 0x7c00, 0x7800,
                                         0x7000, 0x6000, 0x4000, 0x0000};
      if (v == prefix[bits_count & 7]) {
        Bits g = b;
        g.skip(1);
        g.align();
        int len = 0;
        for (; len < 32; ++len)
          if (g.get1()) break;
        int num = int(g.get(mb_num_bits()));
        if (!num || num > mb_num || g.pos + 6 > g.size) num = -1;
        if (len >= prefix_length()) return num;
      }
    }
    return 0;
  }

  int mb_num_bits() const { return log2_floor(mb_num - 1) + 1; }
  int prefix_length() const { return pict_type == 0 ? 16 : f_code + 15; }

  int packet_header(Bits& b) {
    b.skip(1);
    b.align();
    if (b.show(16) != 0) return kErrPacket;
    int len = 0;
    for (; len < 32; ++len)
      if (b.get1()) break;
    if (len != prefix_length()) return kErrPacket;
    int num = int(b.get(mb_num_bits()));
    if (num >= mb_num || !num) return kErrPacket;
    mb_x = num % mb_w;
    mb_y = num / mb_w;
    int q = int(b.get(quant_precision));
    if (q) qscale = q;
    if (b.get1()) {  // header_extension_code
      while (b.get1()) {
      }
      b.skip(1);
      b.skip(time_increment_bits);
      b.skip(1);
      b.skip(2);
      b.skip(3);
      if (pict_type != 0) b.skip(3);
    }
    return kOk;
  }

  int start_vop() {
    if (pict_type == 1 && !have_ref) return kErrNoRef;
    std::fill(mv.begin(), mv.end(), int16_t(0));
    mb_x = mb_y = 0;
    return kOk;
  }

  // the macroblock at (mb_x, mb_y), decoded and reconstructed into cur
  int macroblock(Bits& b) {
    int r = decode_mb(b);
    if (r) return r;
    update_tables();
    if (!mb_intra) motion();
    reconstruct();
    return kOk;
  }

  void end_vop() {
    std::swap(cur, ref);
    have_ref = true;
  }

  int decode_vop(Bits& b) {
    if (int r = start_vop()) return r;
    for (;;) {
      // a slice (video packet) from mb_x, mb_y
      first_slice_line = true;
      resync_mb_x = mb_x;
      resync_mb_y = mb_y;
      bool slice_end = false;
      for (; mb_y < mb_h && !slice_end; ++mb_y) {
        for (; mb_x < mb_w; ++mb_x) {
          if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y)
            first_slice_line = false;
          if (int r = macroblock(b)) return r;
          int next = is_resync(b);
          if (next && mb_x + mb_y * mb_w + 1 >= next) {
            slice_end = true;
            ++mb_x;
            if (mb_x == mb_w) {
              mb_x = 0;
              ++mb_y;
            }
            break;
          }
        }
        if (slice_end) break;
        mb_x = 0;
      }
      if (mb_y >= mb_h) break;
      if (!slice_end) break;
      int r = packet_header(b);
      if (r) return r;
      clean_buffers();
    }
    end_vop();
    return kOk;
  }

  int decode(const uint8_t* data, int64_t len) {
    Bits b;
    b.p = data;
    b.size = len * 8;
    int r = headers(b, false);
    if (r) return r == kEnd ? int(kErrHeader) : r;
    return decode_vop(b);
  }
};

// ---------------------------------------------------------------------------
// The encoder: MPEG-4 Part 2 Simple Profile as the decoder above decodes
// it (what cv2's VideoWriter writes under `mp4v`, without its user data):
// one rectangular progressive VOL with H.263 quantisation, an I-VOP every
// kGop frames and P-VOPs between, intra DC prediction without AC
// prediction, one half-pel motion vector a macroblock, not-coded
// macroblocks, no video packets. Every macroblock is decoded from its
// bits by an embedded Decoder as soon as it is written: the reference
// pictures are the decoder's own, so the encoder's reconstruction is what
// a decoder returns, and a macroblock the decoder would read otherwise is
// an error (kErrEncoder), never a silent drift.
// ---------------------------------------------------------------------------

constexpr int kErrEncoder = -7;

// kDct[u][x] = round(2^13 C(u) / 2 cos((2x + 1) u pi / 16)), C(0) = 1/sqrt(2)
const int16_t kDct[8][8] = {
    {2896, 2896, 2896, 2896, 2896, 2896, 2896, 2896},
    {4017, 3406, 2276, 799, -799, -2276, -3406, -4017},
    {3784, 1567, -1567, -3784, -3784, -1567, 1567, 3784},
    {3406, -799, -4017, -2276, 2276, 4017, 799, -3406},
    {2896, -2896, -2896, 2896, 2896, -2896, -2896, 2896},
    {2276, -4017, 799, 3406, -3406, -799, 4017, -2276},
    {1567, -3784, 3784, -1567, -1567, 3784, -3784, 1567},
    {799, -2276, 3406, -4017, 4017, -3406, 2276, -799},
};
// kDctT[x][u] = kDct[u][x]
const int16_t kDctT[8][8] = {
    {2896, 4017, 3784, 3406, 2896, 2276, 1567, 799},
    {2896, 3406, 1567, -799, -2896, -4017, -3784, -2276},
    {2896, 2276, -1567, -4017, -2896, 799, 3784, 3406},
    {2896, 799, -3784, -2276, 2896, 3406, -1567, -4017},
    {2896, -799, -3784, 2276, 2896, -3406, -1567, 4017},
    {2896, -2276, -1567, 4017, -2896, -799, 3784, -3406},
    {2896, -3406, 1567, 799, -2896, 4017, -3784, 2276},
    {2896, -4017, 3784, -3406, 2896, -2276, 1567, -799},
};

// The forward DCT of an 8x8 block of samples or differences (|v| <= 255,
// natural order) into out (natural order, orthonormal scale: a flat block
// of v gives 8 v at 0). Integer arithmetic: the same bits on every host.
void fdct(const int16_t* in, int* out) {
  bool flat = true;
  for (int i = 1; i < 64; ++i) flat &= in[i] == in[0];
  if (flat) {
    // what the passes below give a flat block: every row and column sum
    // of kDct but the first is 0
    std::memset(out, 0, 64 * sizeof(int));
    int t = (kDct[0][0] * 8 * in[0] + (1 << 9)) >> 10;
    out[0] = (kDct[0][0] * 8 * t + (1 << 15)) >> 16;
    return;
  }
  int tmp[64];  // tmp[y * 8 + u]: coefficient u of row y, times 8
  for (int y = 0; y < 8; ++y) {
    int s[8] = {};
    for (int x = 0; x < 8; ++x)
      for (int u = 0; u < 8; ++u) s[u] += kDctT[x][u] * in[y * 8 + x];
    for (int u = 0; u < 8; ++u) tmp[y * 8 + u] = (s[u] + (1 << 9)) >> 10;
  }
  for (int v = 0; v < 8; ++v) {
    int s[8] = {};
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) s[u] += kDct[v][y] * tmp[y * 8 + u];
    for (int u = 0; u < 8; ++u) out[v * 8 + u] = (s[u] + (1 << 15)) >> 16;
  }
}

// BT.601 limited range, times 2^15: Y from B, G and R (the sum 219/255),
// U and V (each row summing to 0, so that grey gives 128)
constexpr int kYb = 3208, kYg = 16520, kYr = 8414;
constexpr int kUb = 14392, kUg = -9535, kUr = -4857;
constexpr int kVb = -2340, kVg = -12052, kVr = 14392;

struct PutBits {
  std::vector<uint8_t> buf;  // zeros from pos on
  int64_t pos = 0;           // in bits

  // the next n (<= 32) bits, v < 2^n
  void put(int n, uint32_t v) {
    if (n == 0) return;
    size_t byte = size_t(pos >> 3);
    uint64_t w = uint64_t(v) << (64 - n - int(pos & 7));
    for (int i = 0; i < 5; ++i) buf[byte + i] |= uint8_t(w >> (56 - 8 * i));
    pos += n;
  }
  template <typename T>
  void code(const T* c) { put(c[1], c[0]); }
  void start_code(int code) {
    put(24, 1);
    put(8, uint32_t(code));
  }
  // next_start_code: a 0, then 1s to the byte boundary
  void stuffing() {
    put(1, 0);
    int k = int(-pos & 7);
    if (k) put(k, (1u << k) - 1);
  }
  int64_t bytes() const { return (pos + 7) >> 3; }
  void clear() {
    std::fill_n(buf.begin(), size_t(bytes()) + 8, uint8_t(0));
    pos = 0;
  }
};

// the TCOEF symbol of (last, run, level) in each table, -1 where none
struct CoefIndex {
  int16_t sym[2][2][64][28];  // [intra][last][run][level]
  CoefIndex() {
    std::memset(sym, -1, sizeof(sym));
    const RunLevel* rls[2] = {&tables().inter, &tables().intra};
    for (int t = 0; t < 2; ++t)
      for (int k = 0; k < 102; ++k)
        sym[t][k >= rls[t]->last][rls[t]->run[k]][rls[t]->level[k]] =
            int16_t(k);
  }
  int at(int intra, int last, int run, int level) const {
    if (run < 0 || run > 63 || level < 1 || level > 27) return -1;
    return sym[intra][last][run][level];
  }
};

const CoefIndex& coef_index() {
  static const CoefIndex c;
  return c;
}

// The SAD of two 16x16 blocks, summed 4 rows at a time: past `limit`,
// the sum so far (some value past it).
inline int sad16(const uint8_t* a, int64_t as, const uint8_t* b, int64_t bs,
                 int limit) {
  int s = 0;
  for (int j = 0; j < 16; j += 4) {
    for (int r = j; r < j + 4; ++r)
      for (int i = 0; i < 16; ++i)
        s += std::abs(int(a[r * as + i]) - int(b[r * bs + i]));
    if (s > limit) break;
  }
  return s;
}

// bits of a motion vector difference's code (f_code 1 ... 7), as put_mvd
inline int mvd_bits(int d, int f) {
  if (d == 0) return 1;
  int a = std::abs(d) - 1;
  int code = std::min((a >> (f - 1)) + 1, 32);
  return kMv[code][1] + 1 + (f - 1);
}

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

struct Encoder {
  Decoder dec;  // reads every macroblock back: the reference pictures
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  static constexpr int kGop = 12;  // frames from one I-VOP to the next
  int res = 1, inc = 1, fixed_q = 0;
  int time_bits = 1;
  int64_t frame = 0, last_time_base = 0;
  Picture src;  // the frame, macroblock-aligned, edges replicated
  PutBits pb;
  std::vector<uint8_t> hdr;  // VOS, VO and VOL
  // the quantiser of the next VOP and the bits written so far
  int q = 3;
  int64_t spent = 0;
  // pass 1 of a P-VOP: each macroblock's vector (half-pel) and intra flag;
  // the last P-VOP's vectors seed the next search
  std::vector<int16_t> mvf, last_mvf;
  std::vector<uint8_t> intra;
  int f_code = 1;

  int init(int w, int h, int res_, int inc_, int q_) {
    if (w < 1 || h < 1 || w > 8191 || h > 8191 || res_ < 1 ||
        res_ > 65535 || inc_ < 1 || q_ < 0 || q_ > 31 || q_ == 1)
      return kErrHeader;
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    res = res_;
    inc = inc_;
    fixed_q = q_;
    q = q_ ? q_ : 3;
    time_bits = log2_floor(unsigned(res - 1)) + 1;
    src.p[0].alloc(mb_w * 16, mb_h * 16);
    src.p[1].alloc(mb_w * 8, mb_h * 8);
    src.p[2].alloc(mb_w * 8, mb_h * 8);
    mvf.assign(size_t(mb_w) * mb_h * 2, 0);
    last_mvf = mvf;
    intra.assign(size_t(mb_w) * mb_h, 0);
    // a macroblock: its header and six blocks of a DC and 63 third
    // escapes at most
    pb.buf.assign(size_t(mb_w) * mb_h * 1500 + 256, 0);
    write_headers();
    Bits b;
    b.p = hdr.data();
    b.size = int64_t(hdr.size()) * 8;
    int r = dec.headers(b, false);
    return r == kEnd && dec.have_vol ? int(kOk) : int(kErrEncoder);
  }

  void write_headers() {
    PutBits h;
    h.buf.assign(64, 0);
    h.start_code(0xB0);  // visual object sequence
    h.put(8, 0x01);      // simple profile, level 1
    h.start_code(0xB5);  // visual object
    h.put(1, 1);         // is_visual_object_identifier
    h.put(4, 1);         // verid
    h.put(3, 1);         // priority
    h.put(4, 1);         // video ID
    h.put(1, 0);         // no video_signal_type
    h.stuffing();
    h.start_code(0x00);  // video object 0
    h.start_code(0x20);  // video object layer 0
    h.put(1, 0);         // random_accessible_vol
    h.put(8, 1);         // simple object type
    h.put(1, 1);         // is_object_layer_identifier
    h.put(4, 1);         // verid
    h.put(3, 1);         // priority
    h.put(4, 1);         // aspect ratio: square pixels
    h.put(1, 1);         // vol_control_parameters
    h.put(2, 1);         // 4:2:0
    h.put(1, 1);         // low_delay
    h.put(1, 0);         // no vbv_parameters
    h.put(2, 0);         // rectangular
    h.put(1, 1);
    h.put(16, uint32_t(res));  // vop_time_increment_resolution
    h.put(1, 1);
    h.put(1, 0);  // no fixed_vop_rate
    h.put(1, 1);
    h.put(13, uint32_t(width));
    h.put(1, 1);
    h.put(13, uint32_t(height));
    h.put(1, 1);
    h.put(1, 0);  // progressive
    h.put(1, 1);  // obmc_disable
    h.put(1, 0);  // no sprites
    h.put(1, 0);  // 8 bits
    h.put(1, 0);  // H.263 quantisation
    h.put(1, 1);  // complexity_estimation_disable
    h.put(1, 1);  // resync_marker_disable
    h.put(1, 0);  // not data-partitioned
    h.put(1, 0);  // no scalability
    h.stuffing();
    hdr.assign(h.buf.begin(), h.buf.begin() + h.bytes());
  }

  // -- the input ------------------------------------------------------------

  // BGR (channels 3) or grey (1) rows into src: Y, U and V, the chroma of
  // each 2x2 block averaged, then the macroblock padding replicated
  void load(const uint8_t* img, int64_t stride, int channels) {
    Plane& Y = src.p[0];
    Plane& U = src.p[1];
    Plane& V = src.p[2];
    int cw = (width + 1) / 2, ch = (height + 1) / 2;
    if (channels == 1) {
      uint8_t lut[256];
      for (int g = 0; g < 256; ++g)
        lut[g] = uint8_t(((g * (kYb + kYg + kYr) + (1 << 14)) >> 15) + 16);
      for (int j = 0; j < height; ++j) {
        const uint8_t* s = img + j * stride;
        uint8_t* d = &Y.px[size_t(j) * Y.stride];
        for (int i = 0; i < width; ++i) d[i] = lut[s[i]];
      }
      for (int j = 0; j < ch; ++j) {
        std::memset(&U.px[size_t(j) * U.stride], 128, size_t(cw));
        std::memset(&V.px[size_t(j) * V.stride], 128, size_t(cw));
      }
    } else {
      for (int j = 0; j < height; ++j) {
        const uint8_t* s = img + j * stride;
        uint8_t* d = &Y.px[size_t(j) * Y.stride];
        for (int i = 0; i < width; ++i, s += 3)
          d[i] = uint8_t(((s[0] * kYb + s[1] * kYg + s[2] * kYr + (1 << 14)) >>
                          15) + 16);
      }
      for (int j = 0; j < ch; ++j) {
        const uint8_t* r0 = img + int64_t(2 * j) * stride;
        const uint8_t* r1 =
            img + int64_t(std::min(2 * j + 1, height - 1)) * stride;
        uint8_t* du = &U.px[size_t(j) * U.stride];
        uint8_t* dv = &V.px[size_t(j) * V.stride];
        for (int i = 0; i < cw; ++i) {
          int x0 = 6 * i, x1 = 3 * std::min(2 * i + 1, width - 1);
          int b = r0[x0] + r0[x1] + r1[x0] + r1[x1];
          int g = r0[x0 + 1] + r0[x1 + 1] + r1[x0 + 1] + r1[x1 + 1];
          int r = r0[x0 + 2] + r0[x1 + 2] + r1[x0 + 2] + r1[x1 + 2];
          du[i] = uint8_t(((b * kUb + g * kUg + r * kUr + (1 << 16)) >> 17) +
                          128);
          dv[i] = uint8_t(((b * kVb + g * kVg + r * kVr + (1 << 16)) >> 17) +
                          128);
        }
      }
    }
    pad(Y, width, height);
    pad(U, cw, ch);
    pad(V, cw, ch);
  }

  static void pad(Plane& p, int w, int h) {
    for (int j = 0; j < h; ++j) {
      uint8_t* row = &p.px[size_t(j) * p.stride];
      std::memset(row + w, row[w - 1], size_t(p.w - w));
    }
    for (int j = h; j < p.h; ++j)
      std::memcpy(&p.px[size_t(j) * p.stride],
                  &p.px[size_t(h - 1) * p.stride], size_t(p.w));
  }

  // -- motion search (pass 1 of a P-VOP) ----------------------------------

  // SAD of the source macroblock at (x, y) against the reference luma at
  // the half-pel vector (vx, vy), as the decoder's motion() predicts it;
  // once past `limit`, some value past it
  int sad_at(int x, int y, int vx, int vy, int limit = 1 << 30) {
    const Plane& r = dec.ref.p[0];
    const Plane& s = src.p[0];
    uint8_t tmp[17 * 17], pred[256];
    int64_t ss;
    const uint8_t* w = Decoder::window(r, x + (vx >> 1), y + (vy >> 1), 16,
                                       16, tmp, &ss);
    int dxy = ((vy & 1) << 1) | (vx & 1);
    if (dxy) {
      hpel_put(pred, 16, w, ss, 16, 16, dxy, dec.no_rounding);
      w = pred;
      ss = 16;
    }
    return sad16(&s.px[size_t(y) * s.stride + x], s.stride, w, ss, limit);
  }

  // each macroblock's vector and intra decision; the smallest f_code
  // that holds every vector
  void motion_search() {
    const int lim = 126;  // |vector| in half-pels: f_code 3 at most
    int maxv = 0;
    for (int my = 0; my < mb_h; ++my)
      for (int mx = 0; mx < mb_w; ++mx) {
        size_t k = size_t(my) * mb_w + mx;
        int x = mx * 16, y = my * 16;
        // the median of the vectors left, above and above right (0 for
        // one outside or intra), the cost's predictor
        auto at = [&](int cx, int cy, int c) {
          if (cx < 0 || cy < 0 || cx >= mb_w) return 0;
          return int(mvf[(size_t(cy) * mb_w + cx) * 2 + c]);
        };
        int px = median3(at(mx - 1, my, 0), at(mx, my - 1, 0),
                         at(mx + 1, my - 1, 0));
        int py = median3(at(mx - 1, my, 1), at(mx, my - 1, 1),
                         at(mx + 1, my - 1, 1));
        int sad0 = sad_at(x, y, 0, 0);
        int best = sad0 + q * (mvd_bits(px, 2) + mvd_bits(py, 2));
        // past the best so far, some cost past it
        auto cost = [&](int vx, int vy) {
          int bits = q * (mvd_bits(vx - px, 2) + mvd_bits(vy - py, 2));
          return sad_at(x, y, vx, vy, best - bits) + bits;
        };
        int bx = 0, by = 0;
        if (sad0 > 256) {
          auto consider = [&](int vx, int vy) {
            vx = std::clamp(vx, -lim, lim) & ~1;
            vy = std::clamp(vy, -lim, lim) & ~1;
            if (vx == bx && vy == by) return false;
            int c = cost(vx, vy);
            if (c >= best) return false;
            best = c;
            bx = vx;
            by = vy;
            return true;
          };
          consider(px, py);
          consider(at(mx - 1, my, 0), at(mx - 1, my, 1));
          consider(at(mx, my - 1, 0), at(mx, my - 1, 1));
          consider(at(mx + 1, my - 1, 0), at(mx + 1, my - 1, 1));
          consider(last_mvf[k * 2], last_mvf[k * 2 + 1]);
          // a full-pel diamond from the best, then its diagonals
          static const int dirs[8][2] = {{2, 0},  {-2, 0}, {0, 2},  {0, -2},
                                         {2, 2},  {-2, 2}, {2, -2}, {-2, -2}};
          for (int it = 0; it < 64; ++it) {
            int cx = bx, cy = by;
            bool moved = false;
            for (int d = 0; d < 4; ++d)
              moved |= consider(cx + dirs[d][0], cy + dirs[d][1]);
            if (!moved) break;
          }
          int cx = bx, cy = by;
          for (int d = 4; d < 8; ++d) consider(cx + dirs[d][0], cy + dirs[d][1]);
          // half-pels around it
          cx = bx;
          cy = by;
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              if (!dx && !dy) continue;
              int vx = cx + dx, vy = cy + dy;
              if (std::abs(vx) > lim || std::abs(vy) > lim) continue;
              int c = cost(vx, vy);
              if (c < best) {
                best = c;
                bx = vx;
                by = vy;
              }
            }
          // intra where the macroblock's own spread is well below the
          // best prediction's error
          const Plane& s = src.p[0];
          const uint8_t* a = &s.px[size_t(y) * s.stride + x];
          int sum = 0;
          for (int j = 0; j < 16; ++j)
            for (int i = 0; i < 16; ++i) sum += a[j * s.stride + i];
          int mean = (sum + 128) >> 8, dev = 0;
          for (int j = 0; j < 16; ++j)
            for (int i = 0; i < 16; ++i)
              dev += std::abs(int(a[j * s.stride + i]) - mean);
          if (dev + 500 < best - q * (mvd_bits(bx - px, 2) +
                                      mvd_bits(by - py, 2))) {
            intra[k] = 1;
            bx = by = 0;
          }
        }
        mvf[k * 2] = int16_t(bx);
        mvf[k * 2 + 1] = int16_t(by);
        maxv = std::max({maxv, std::abs(bx), std::abs(by)});
      }
    // vectors in [-2^(4+f), 2^(4+f) - 1]
    f_code = 1;
    while ((16 << f_code) <= maxv) ++f_code;
  }

  // -- bits -------------------------------------------------------------------

  void put_dc(int n, int diff) {
    int a = std::abs(diff), size = 0;
    while (a >> size) ++size;
    pb.code(n < 4 ? kDcLum[size] : kDcChrom[size]);
    if (size) {
      pb.put(size, uint32_t(diff > 0 ? diff : diff + (1 << size) - 1));
      if (size > 8) pb.put(1, 1);  // marker
    }
  }

  void put_coef(int is_intra, int last, int run, int level) {
    const RunLevel& rl = is_intra ? tables().intra : tables().inter;
    const uint16_t (*vlc)[2] = is_intra ? kIntraVlc : kInterVlc;
    const CoefIndex& ci = coef_index();
    int a = std::abs(level);
    uint32_t sign = level < 0;
    int s = ci.at(is_intra, last, run, a);
    if (s >= 0) {
      pb.code(vlc[s]);
      pb.put(1, sign);
      return;
    }
    pb.code(vlc[102]);
    // first escape: the level less the largest of its run
    s = ci.at(is_intra, last, run, a - rl.max_level[last][run]);
    if (s >= 0) {
      pb.put(1, 0);
      pb.code(vlc[s]);
      pb.put(1, sign);
      return;
    }
    // second escape: the run less the longest of its level, less 1
    if (a <= 64) {
      s = ci.at(is_intra, last, run - rl.max_run[last][a] - 1, a);
      if (s >= 0) {
        pb.put(2, 2);
        pb.code(vlc[s]);
        pb.put(1, sign);
        return;
      }
    }
    // third escape: fixed length
    pb.put(2, 3);
    pb.put(1, uint32_t(last));
    pb.put(6, uint32_t(run));
    pb.put(1, 1);
    pb.put(12, uint32_t(level) & 0xfff);
    pb.put(1, 1);
  }

  // the coefficients of `lv` (natural order) from zigzag index `start`
  void put_block(const int16_t* lv, int start, int is_intra) {
    int end = -1;
    for (int i = start; i < 64; ++i)
      if (lv[kZigzag[i]]) end = i;
    int run = 0;
    for (int i = start; i <= end; ++i) {
      int l = lv[kZigzag[i]];
      if (!l) {
        ++run;
        continue;
      }
      put_coef(is_intra, i == end, run, l);
      run = 0;
    }
  }

  void put_mvd(int d) {
    int m = 16 << f_code;
    d = ((d + m) & (2 * m - 1)) - m;
    if (d == 0) {
      pb.code(kMv[0]);
      return;
    }
    int shift = f_code - 1, a = std::abs(d) - 1;
    pb.code(kMv[(a >> shift) + 1]);
    pb.put(1, d < 0);
    if (shift) pb.put(shift, uint32_t(a & ((1 << shift) - 1)));
  }

  // -- macroblocks ----------------------------------------------------------

  // block n of the current macroblock: its plane and position
  uint8_t* block_at(Picture& p, int n, int64_t* stride) const {
    Plane& pl = p.p[n < 4 ? 0 : n - 3];
    int x = n < 4 ? dec.mb_x * 16 + (n & 1) * 8 : dec.mb_x * 8;
    int y = n < 4 ? dec.mb_y * 16 + (n >> 1) * 8 : dec.mb_y * 8;
    *stride = pl.stride;
    return &pl.px[size_t(y) * pl.stride + x];
  }

  void intra_mb(bool in_p) {
    int16_t lv[6][64], in[64];
    int coef[64], dc[6], cbp = 0;
    for (int n = 0; n < 6; ++n) {
      int64_t ss;
      const uint8_t* s = block_at(src, n, &ss);
      for (int j = 0; j < 8; ++j)
        for (int i = 0; i < 8; ++i) in[j * 8 + i] = s[j * ss + i];
      fdct(in, coef);
      int scale = n < 4 ? kYDcScale[q] : kCDcScale[q];
      dc[n] = (coef[0] + (scale >> 1)) / scale;
      bool coded = false;
      lv[n][0] = 0;
      for (int i = 1; i < 64; ++i) {
        int l = std::min(std::abs(coef[i]) / (2 * q), 2047);
        lv[n][i] = int16_t(coef[i] < 0 ? -l : l);
        coded |= l != 0;
      }
      cbp |= int(coded) << (5 - n);
    }
    if (in_p) {
      pb.put(1, 0);  // coded
      pb.code(kInterMcbpc[4 + (cbp & 3)]);
    } else {
      pb.code(kIntraMcbpc[cbp & 3]);
    }
    pb.put(1, 0);  // no AC prediction
    pb.code(kCbpy[cbp >> 2]);
    for (int n = 0; n < 6; ++n) {
      int dir;
      put_dc(n, dc[n] - dec.dc_pred(n, &dir));
      dec.dc_store(n, dc[n]);
      if (cbp & (32 >> n)) put_block(lv[n], 1, 1);
    }
  }

  void inter_mb(int vx, int vy) {
    dec.mb_intra = false;
    dec.mv_type = 0;
    dec.mvs[0][0] = vx;
    dec.mvs[0][1] = vy;
    // the prediction: the reference itself under a zero vector, else
    // motion()'s, into dec.cur
    Picture* pred = &dec.ref;
    if (vx || vy) {
      dec.motion();
      pred = &dec.cur;
    }
    int16_t lv[6][64], in[64];
    int coef[64], cbp = 0;
    for (int n = 0; n < 6; ++n) {
      int64_t ss, ps;
      const uint8_t* s = block_at(src, n, &ss);
      const uint8_t* p = block_at(*pred, n, &ps);
      bool same = true;
      for (int j = 0; j < 8 && same; ++j)
        same = std::memcmp(s + j * ss, p + j * ps, 8) == 0;
      if (same) continue;
      int sad = 0;
      for (int j = 0; j < 8; ++j)
        for (int i = 0; i < 8; ++i) {
          in[j * 8 + i] = int16_t(s[j * ss + i] - p[j * ps + i]);
          sad += std::abs(in[j * 8 + i]);
        }
      // |coefficient| <= sad / 4 (+ 1 for rounding) < 2.5 q: all zero
      if (sad < 8 * q) continue;
      fdct(in, coef);
      bool coded = false;
      for (int i = 0; i < 64; ++i) {
        int a2 = 2 * std::abs(coef[i]);
        int l = a2 > q ? std::min((a2 - q) / (4 * q), 2047) : 0;
        lv[n][i] = int16_t(coef[i] < 0 ? -l : l);
        coded |= l != 0;
      }
      cbp |= int(coded) << (5 - n);
    }
    if (vx == 0 && vy == 0 && cbp == 0) {
      pb.put(1, 1);  // not coded
      return;
    }
    pb.put(1, 0);
    pb.code(kInterMcbpc[cbp & 3]);
    pb.code(kCbpy[(cbp >> 2) ^ 15]);
    int px, py;
    dec.pred_motion(0, &px, &py);
    put_mvd(vx - px);
    put_mvd(vy - py);
    for (int n = 0; n < 6; ++n)
      if (cbp & (32 >> n)) put_block(lv[n], 0, 0);
  }

  // -- VOPs -----------------------------------------------------------------

  // one frame into pb; returns 0 or a negative error
  int encode(const uint8_t* img, int64_t stride, int channels) {
    load(img, stride, channels);
    bool key = frame % kGop == 0;
    if (!fixed_q && frame) rate_control();
    pb.clear();
    if (!key) {
      dec.no_rounding ^= 1;  // alternated over the P-VOPs against drift
      motion_search();
    }
    pb.start_code(0xB6);
    pb.put(2, key ? 0 : 1);
    int64_t t = frame * inc, base = t / res;
    for (int64_t k = base - last_time_base; k > 0; --k) pb.put(1, 1);
    pb.put(1, 0);  // modulo_time_base
    last_time_base = base;
    pb.put(1, 1);
    pb.put(time_bits, uint32_t(t % res));
    pb.put(1, 1);
    pb.put(1, 1);  // vop_coded
    int rounding = key ? 0 : dec.no_rounding;
    if (!key) pb.put(1, uint32_t(rounding));
    pb.put(3, 0);  // intra_dc_vlc_thr: always the DC VLC
    pb.put(5, uint32_t(q));
    if (!key) pb.put(3, uint32_t(f_code));
    // the decoder reads the header back: its VOP state is the encoder's
    Bits b;
    b.p = pb.buf.data();
    b.size = pb.bytes() * 8;
    if (dec.headers(b, false) != kOk || b.pos != pb.pos ||
        dec.pict_type != (key ? 0 : 1) || dec.qscale != q)
      return kErrEncoder;
    if (int r = dec.start_vop()) return r;
    dec.first_slice_line = true;
    dec.resync_mb_x = dec.resync_mb_y = 0;
    for (int my = 0; my < mb_h; ++my)
      for (int mx = 0; mx < mb_w; ++mx) {
        dec.mb_x = mx;
        dec.mb_y = my;
        if (my == 1 && mx == 0) dec.first_slice_line = false;
        int64_t at = pb.pos;
        size_t k = size_t(my) * mb_w + mx;
        if (key || intra[k])
          intra_mb(!key);
        else
          inter_mb(mvf[k * 2], mvf[k * 2 + 1]);
        b.size = pb.bytes() * 8;
        b.pos = at;
        if (dec.macroblock(b) != kOk || b.pos != pb.pos) return kErrEncoder;
      }
    pb.stuffing();
    dec.end_vop();
    if (!key) last_mvf = mvf;
    std::fill(intra.begin(), intra.end(), uint8_t(0));
    spent += pb.pos;
    ++frame;
    return kOk;
  }

  // The quantiser of the next VOP, toward cv2's budget of w * h bits a
  // frame: 3 + 28 * excess / (30 s of budget), rounded, where excess is
  // the bits written less the budget of the frames written, kept within
  // the range that maps to [2, 31] (a stream long under its budget does
  // not bank what it did not spend).
  void rate_control() {
    const double budget = double(width) * height;
    const double window = 30.0 * res / inc * budget;
    double excess = double(spent) - budget * double(frame);
    double lo = -window / 28, hi = window;
    if (excess < lo || excess > hi) {
      excess = std::clamp(excess, lo, hi);
      spent = int64_t(excess + budget * double(frame));
    }
    q = std::clamp(int(std::lround(3.0 + 28.0 * excess / window)), 2, 31);
  }
};

// ---------------------------------------------------------------------------
// libswscale's yuv2rgb coefficients (ff_yuv2rgb_c_init_tables) and its
// x86 SIMD conversion
// ---------------------------------------------------------------------------

int16_t round_int16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return int16_t(r < -0x7fff ? -0x8000 : r > 0x7fff ? 0x7fff : r);
}

inline int16_t sat16(int v) {
  return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}
inline int16_t mulhw(int16_t a, int16_t b) {
  return int16_t((int32_t(a) * int32_t(b)) >> 16);
}

}  // namespace

extern "C" {

// A decoder; with `probe`, one that reads headers only
// (trex_m4v_headers) and allocates no picture.
void* trex_m4v_new(int32_t probe) {
  auto* d = new Decoder();
  d->probe = probe != 0;
  return d;
}

void trex_m4v_free(void* h) { delete static_cast<Decoder*>(h); }

// Forget the reference picture (a seek to a key frame).
void trex_m4v_flush(void* h) { static_cast<Decoder*>(h)->have_ref = false; }

// state: the VOL's width and height, whether a VOL was read, its
// video_object_type_indication and vol_control_parameters flag, and the
// Why of the last kErrUnsupported
static void m4v_state(const Decoder* d, int32_t* info) {
  info[0] = d->width;
  info[1] = d->height;
  info[2] = d->have_vol;
  info[3] = d->vo_type;
  info[4] = d->vol_control;
  info[5] = d->why;
}

// Read the headers of `data` (an MP4's extradata, or the head of a
// packet): VOS, VO and VOL, and for a probe the VOP header up to its
// vop_coded flag. Returns 0 or a negative error; kErrUnsupported (-3)
// with info[5] naming the feature. info: as m4v_state.
int32_t trex_m4v_headers(void* h, const uint8_t* data, int64_t len,
                         int32_t* info) {
  auto* d = static_cast<Decoder*>(h);
  Bits b;
  b.p = data;
  b.size = len * 8;
  int r = d->headers(b, !d->probe);
  m4v_state(d, info);
  return r == kEnd ? 0 : r;
}

// Decode one packet into y, u, v (the given strides) of `w` x `h` (chroma
// (w + 1) / 2 x (h + 1) / 2): the picture, cropped to the VOL's size.
// Returns 0 or a negative error; kErrSize, writing nothing, where the
// VOL's size is not w x h. info: as m4v_state.
int32_t trex_m4v_decode(void* h, const uint8_t* data, int64_t len,
                        uint8_t* y, int64_t ys, uint8_t* u, uint8_t* v,
                        int64_t cs, int32_t w, int32_t hh, int32_t* info) {
  auto* d = static_cast<Decoder*>(h);
  if (d->probe) return kErrHeader;
  int r = d->decode(data, len);
  m4v_state(d, info);
  if (r != 0) return r;
  if (d->width != w || d->height != hh) return kErrSize;
  const Picture& p = d->ref;
  for (int j = 0; j < hh; ++j)
    std::memcpy(y + j * ys, &p.p[0].px[size_t(j) * p.p[0].stride], size_t(w));
  int cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + j * cs, &p.p[1].px[size_t(j) * p.p[1].stride], size_t(cw));
    std::memcpy(v + j * cs, &p.p[2].px[size_t(j) * p.p[2].stride], size_t(cw));
  }
  return 0;
}

// FFmpeg's mjpeg decoder on one component: `coef` holds bw x bh blocks
// (a row of `stride` blocks) of quantised coefficients in natural order,
// the DC already summed over its differences (as the JPEG scan decoder
// leaves them), with restart intervals of `restart_blocks` blocks in
// decoding order (0: none) resetting the predictor; `q` the quantisation
// table in natural order. The DC is rebuilt as FFmpeg predicts it (from
// 1024, in dequantised units), the AC products kept to 16 bits, then the
// simple IDCT writes the plane (bh * 8 rows of `out_stride`).
void trex_mjpeg_idct(const int16_t* coef, int32_t bw, int32_t bh,
                     int32_t stride, const uint16_t* q, uint8_t* out,
                     int64_t out_stride) {
  int16_t blk[64];
  for (int by = 0; by < bh; ++by)
    for (int bx = 0; bx < bw; ++bx) {
      const int16_t* c = coef + (int64_t(by) * stride + bx) * 64;
      int dc = 1024 + int(c[0]) * int(q[0]);
      blk[0] = sat16(dc);
      for (int i = 1; i < 64; ++i) blk[i] = int16_t(int(c[i]) * int(q[i]));
      idct(blk, out + int64_t(by) * 8 * out_stride + bx * 8, out_stride,
           false);
    }
}

// libswscale's unscaled yuv420p (full_range 0) or yuvj420p (1) -> bgr24,
// as its x86 SIMD computes it: out is h x w x 3 BGR, or with `grey` h x w
// of cvtColor(COLOR_BGR2GRAY) of that BGR, (3735 b + 19235 g + 9798 r +
// 2^14) >> 15.
void trex_yuv420_bgr(const uint8_t* y, int64_t ys, const uint8_t* u,
                     int64_t us, const uint8_t* v, int64_t vs, int32_t w,
                     int32_t h, int32_t full_range, int32_t grey,
                     uint8_t* out) {
  // ff_yuv2rgb_coeffs[SWS_CS_DEFAULT] (ITU-R BT.601)
  int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = int64_t(16) << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  const int64_t contrast = 1 << 16, saturation = 1 << 16;
  cy = (cy * contrast) >> 16;
  crv = (crv * contrast * saturation) >> 32;
  cbu = (cbu * contrast * saturation) >> 32;
  cgu = (cgu * contrast * saturation) >> 32;
  cgv = (cgv * contrast * saturation) >> 32;
  const int16_t yc = round_int16(cy * (1 << 13));
  const int16_t vr = round_int16(crv * (1 << 13));
  const int16_t ub = round_int16(cbu * (1 << 13));
  const int16_t vg = round_int16(cgv * (1 << 13));
  const int16_t ug = round_int16(cgu * (1 << 13));
  const int16_t yo = round_int16(oy * 8);
  // Y' = pmulhw((y << 3) - yOffset, yCoeff) by value; the chroma terms a
  // pair of rows shares. |Y'| + |chroma term| stays far inside 16 bits,
  // so the lanes' saturating adds are plain adds here.
  int ylut[256];
  for (int k = 0; k < 256; ++k) ylut[k] = mulhw(int16_t((k << 3) - yo), yc);
  std::vector<int> cb(size_t(w) + 2), cg(size_t(w) + 2), cr(size_t(w) + 2);
  for (int j = 0; j < h; ++j) {
    const uint8_t* py = y + j * ys;
    if ((j & 1) == 0) {
      const uint8_t* pu = u + (j >> 1) * us;
      const uint8_t* pv = v + (j >> 1) * vs;
      for (int i = 0; i < (w + 1) / 2; ++i) {
        int16_t U = sat16((pu[i] << 3) - 1024);
        int16_t V = sat16((pv[i] << 3) - 1024);
        // each pixel's own copy of its pair's terms
        cb[2 * i] = cb[2 * i + 1] = mulhw(U, ub);
        cr[2 * i] = cr[2 * i + 1] = mulhw(V, vr);
        cg[2 * i] = cg[2 * i + 1] = sat16(mulhw(U, ug) + mulhw(V, vg));
      }
    }
    if (grey) {
      uint8_t* o = out + int64_t(j) * w;
      for (int i = 0; i < w; ++i) {
        int Y = ylut[py[i]];
        int b = std::clamp(Y + cb[i], 0, 255);
        int g = std::clamp(Y + cg[i], 0, 255);
        int r = std::clamp(Y + cr[i], 0, 255);
        // cvtColor's BGR2GRAY, the twin of track/tag_image.py's
        // _GRAY_BGR (bgr_to_gray), fused here to skip the BGR frame
        o[i] = uint8_t((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15);
      }
    } else {
      uint8_t* o = out + int64_t(j) * w * 3;
      for (int i = 0; i < w; ++i) {
        int Y = ylut[py[i]];
        o[3 * i + 0] = uint8_t(std::clamp(Y + cb[i], 0, 255));
        o[3 * i + 1] = uint8_t(std::clamp(Y + cg[i], 0, 255));
        o[3 * i + 2] = uint8_t(std::clamp(Y + cr[i], 0, 255));
      }
    }
  }
}

// An MPEG-4 Part 2 encoder of w x h frames at res / inc frames a second
// (vop_time_increment_resolution res, each frame inc later), an I-VOP
// every 12 frames; quantiser `q` 0: the rate control, 2-31: that
// quantiser on every VOP. Null where a value is out of range.
void* trex_m4v_enc_new(int32_t w, int32_t h, int32_t res, int32_t inc,
                       int32_t q) {
  auto* e = new Encoder();
  if (e->init(w, h, res, inc, q) != kOk) {
    delete e;
    return nullptr;
  }
  return e;
}

void trex_m4v_enc_free(void* h) { delete static_cast<Encoder*>(h); }

// The VOS, VO and VOL headers (an MP4's DecoderSpecificInfo) into out;
// returns their bytes, or the bytes needed where `cap` is smaller.
int64_t trex_m4v_enc_headers(void* h, uint8_t* out, int64_t cap) {
  const auto* e = static_cast<Encoder*>(h);
  int64_t n = int64_t(e->hdr.size());
  if (n <= cap) std::memcpy(out, e->hdr.data(), size_t(n));
  return n;
}

// The bytes a packet may need at most.
int64_t trex_m4v_enc_capacity(void* h) {
  return int64_t(static_cast<Encoder*>(h)->pb.buf.size());
}

// Encode one frame of h rows `stride` bytes apart, BGR (channels 3) or
// grey (1), into out (trex_m4v_enc_capacity bytes); returns the packet's
// bytes or a negative error. info: whether the VOP is an I-VOP, and its
// quantiser.
int64_t trex_m4v_enc_frame(void* h, const uint8_t* img, int64_t stride,
                           int32_t channels, uint8_t* out, int32_t* info) {
  auto* e = static_cast<Encoder*>(h);
  if (channels != 1 && channels != 3) return kErrHeader;
  int r = e->encode(img, stride, channels);
  if (r != kOk) return r;
  std::memcpy(out, e->pb.buf.data(), size_t(e->pb.bytes()));
  info[0] = e->dec.pict_type == 0;
  info[1] = e->dec.qscale;
  return e->pb.bytes();
}

// The last frame's reconstruction, the decoder's picture, cropped: y
// (w x h) and u, v ((w + 1) / 2 x (h + 1) / 2), the given strides.
void trex_m4v_enc_recon(void* h, uint8_t* y, int64_t ys, uint8_t* u,
                        uint8_t* v, int64_t cs) {
  const auto* e = static_cast<Encoder*>(h);
  const Picture& p = e->dec.ref;
  int w = e->width, hh = e->height;
  for (int j = 0; j < hh; ++j)
    std::memcpy(y + j * ys, &p.p[0].px[size_t(j) * p.p[0].stride], size_t(w));
  int cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + j * cs, &p.p[1].px[size_t(j) * p.p[1].stride], size_t(cw));
    std::memcpy(v + j * cs, &p.p[2].px[size_t(j) * p.p[2].stride], size_t(cw));
  }
}

}  // extern "C"
