// 8-connected component labelling of a batch of binary masks, for Hopper
// (sm_90a). Bound with ctypes through the plain C entry point at the end.
//
// Replaces trex_tpu/ops/cc_device.py::_stripe_kernel (the Pallas stripe
// relaxation launched by label_components_vmem). Output is bit-identical:
// each foreground pixel gets the linear index y*W+x of its component's
// first pixel in scan order, background gets -1.
//
// Bound: memory. The function must read 1 byte of mask and write 4 bytes
// of labels per pixel: 5 bytes/pixel, 168 MB for 32 x 1024^2, about 50 us
// at the H100's 3.35 TB/s. Detection masks are about 2 % foreground, so
// the label store is the work. What costs beyond it: passes that read
// the whole mask again, global atomics and dependent loads for every
// foreground pixel, and per-pixel loops that a warp runs as long as its
// busiest lane.
//
// Design: union-find in three launches, the bulk of it in shared memory,
// on a grid of kTileH x kTileW tiles.
//   1. ccl_tile: a block labels one tile, one warp per kRowsPerWarp rows,
//      one lane per pixel of each 32-column word of a row: a warp ballot
//      gives the word's foreground bits. An all-background word is stored
//      as -1 at once. The words with foreground are listed and dealt out
//      evenly to the block's warps: each foreground pixel points at the
//      first pixel of its horizontal run inside the tile, then unites
//      with the runs above it inside the tile (shared-memory atomicMin
//      links from the larger root to the smaller), and is resolved in
//      shared memory and stored as the frame index of its tile root. Each
//      store is one full 128-byte line per warp. Inside a tile its
//      row-major order and the frame's agree, so a tile root is its
//      piece's first pixel in the frame and parent[i] <= i holds in the
//      frame's indices too.
//   2. ccl_border: unites across tile borders only, in device memory:
//      the first row of every tile but the top ones against the row
//      above (only the words the tile pass found foreground in), and the
//      first column of every tile but the left ones against the column
//      to its left, both diagonals included, so the link through a tile
//      corner is made. It reads labels, not the mask: a label >= 0 is
//      foreground and is already the pixel's tile root. It flags the
//      tile of every root it links.
//   3. ccl_compress: in the flagged tiles only, visits the listed words
//      and points each foreground pixel at its global root; a pixel
//      whose tile root is still a root needs no store.
// The tile pass leaves each tile's list and flag in a scratch array, so
// the later passes never read the mask and touch only those words. The
// final root is the component's minimum index, i.e. its first pixel in
// scan order. Outside the tile pass the label array is the union-find
// parent array.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;               // 32-column words per tile row
constexpr int kTileW = 32 * kWords;     // 256 columns
constexpr int kTileH = 32;              // rows
constexpr int kWarps = 8;               // warps per tile block
constexpr int kRowsPerWarp = kTileH / kWarps;
// per tile, in the scratch array between the passes: [0] set when
// ccl_border linked one of the tile's roots, [1] the number of words
// with foreground, [2] bit j set when word j of the tile's first row has
// foreground, [3 ..] the positions ty * kWords + j of the words with
// foreground, one byte each
constexpr int kInfo = 3 + kTileH * kWords / 4;
constexpr unsigned kFullWarp = 0xffffffffu;

// Root of index `a` in the parent array `lab`, halving the path on the
// way: each visited entry is lowered to its grandparent. Entries only
// ever decrease and always name a pixel of the same component, so a stale
// read costs an extra step and atomicMin keeps whichever of a concurrent
// link and the grandparent is smaller: no union is lost.
__device__ __forceinline__ int32_t find_root(int32_t* lab, int32_t a) {
  const volatile int32_t* v = lab;
  int32_t p = v[a];
  while (p != a) {
    const int32_t g = v[p];
    if (g == p) return p;
    atomicMin(&lab[a], g);
    a = g;
    p = v[a];
  }
  return a;
}

// Union of the sets of `a` and `b` in the parent array `lab` (shared or
// device memory): the larger root is linked to the smaller with
// atomicMin, so parent[i] <= i always holds. The two chains are walked
// side by side, so that the loads of each step are in flight together.
// Returns the root it linked, or -1 when both were in one set already.
__device__ __forceinline__ int32_t unite(int32_t* lab, int32_t a,
                                          int32_t b) {
  const volatile int32_t* v = lab;
  while (true) {
    int32_t pa = v[a], pb = v[b];
    while (pa != a || pb != b) {
      a = pa;
      b = pb;
      pa = v[a];
      pb = v[b];
    }
    if (a == b) return -1;
    const int32_t hi = max(a, b), lo = min(a, b);
    const int32_t old = atomicMin(&lab[hi], lo);
    if (old == hi) return hi;
    // hi was linked meanwhile: unite its new parent with lo
    if (a == hi) a = old; else b = old;
  }
}

// Bits lane - 1 .. lane + 32 of a tile row held as kWords words in
// shared memory, around word j: bit 0 of the result is column 32 j - 1,
// bit 33 column 32 j + 32 (0 past the tile's edges).
__device__ __forceinline__ uint64_t window(const unsigned* row, int j) {
  const uint64_t left = j > 0 ? row[j - 1] >> 31 : 0u;
  const uint64_t right = j + 1 < kWords ? row[j + 1] & 1u : 0u;
  return left | (uint64_t)row[j] << 1 | right << 33;
}

__device__ __forceinline__ int tile_of_block() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

__global__ void __launch_bounds__(32 * kWarps)
    ccl_tile(const uint8_t* __restrict__ mask, int32_t* __restrict__ label,
             int32_t* __restrict__ info, int H, int W) {
  // parent array of the tile in tile-local indices ty * kTileW + tx,
  // written and read at foreground pixels only
  __shared__ int32_t par[kTileH * kTileW];
  __shared__ unsigned fg[kTileH][kWords];  // foreground bits of each row
  __shared__ int32_t n_busy;                // words with foreground, and
  __shared__ uint32_t busy_at[kInfo - 3];   // their positions, bytes
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t base = (size_t)blockIdx.z * H * W;
  int32_t* tile_info = info + (size_t)tile_of_block() * kInfo;
  if (lane == 0 && threadIdx.y == 0) {
    n_busy = 0;
    tile_info[0] = 0;  // no root of this tile linked yet
  }
  // bit j of busy[r]: word j of the warp's row r has foreground (the same
  // in every lane), so that the later phases visit those words only
  unsigned busy[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int ty = threadIdx.y * kRowsPerWarp + r;
    const int y = y0 + ty;
    const uint8_t* row = mask + base + (size_t)min(y, H - 1) * W;
    uint8_t m[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int x = x0 + 32 * j + lane;
      m[j] = y < H && x < W ? row[x] : 0;
    }
    busy[r] = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const unsigned w = __ballot_sync(kFullWarp, m[j] != 0);
      fg[ty][j] = w;
      busy[r] |= (w != 0) << j;
      // an all-background word needs no union: store it now
      const int x = x0 + 32 * j + lane;
      if (!w && y < H && x < W) label[base + (size_t)y * W + x] = -1;
    }
  }
  __syncwarp();
  // run-start labels: each foreground pixel points at the first pixel of
  // its horizontal run inside the tile
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int ty = threadIdx.y * kRowsPerWarp + r;
    for (unsigned b = busy[r]; b; b &= b - 1) {
      const int j = __ffs(b) - 1;
      const unsigned w = fg[ty][j];
      if (!(w >> lane & 1)) continue;
      // the run starts after the last background pixel to the left
      const unsigned gaps = ~w & ((1u << lane) - 1u);
      int start = 0;
      if (gaps) {
        start = 32 * j + 32 - __clz(gaps);
      } else {
        for (int k = j - 1; k >= 0; --k) {
          const unsigned bg = ~fg[ty][k];
          if (bg) {
            start = 32 * k + 32 - __clz(bg);
            break;
          }
        }
      }
      par[ty * kTileW + 32 * j + lane] = ty * kTileW + start;
    }
  }
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) any |= busy[r] != 0;
  const int flat = threadIdx.y * 32 + lane;
  if (flat == 0) tile_info[2] = busy[0];  // warp 0 holds the first row
  if (!__syncthreads_or(any)) {  // an all-background tile is done
    if (flat == 0) tile_info[1] = 0;
    return;
  }
  // list the words with foreground, for ccl_compress and to share the
  // unions and the resolution of the tile evenly among its warps
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int ty = threadIdx.y * kRowsPerWarp + r;
      for (unsigned b = busy[r]; b; b &= b - 1)
        reinterpret_cast<uint8_t*>(busy_at)[atomicAdd(&n_busy, 1)] =
            (uint8_t)(ty * kWords + __ffs(b) - 1);
    }
  }
  __syncthreads();
  const int words = n_busy;
  const uint8_t* at = reinterpret_cast<const uint8_t*>(busy_at);
  // unite each run with the runs above it inside the tile; the tile's
  // top row and its side columns are linked by ccl_border
  for (int k = threadIdx.y; k < words; k += kWarps) {
    const int ty = at[k] / kWords, j = at[k] % kWords;
    if (ty == 0 || !(fg[ty][j] >> lane & 1)) continue;
    const int p = ty * kTileW + 32 * j + lane;
    const uint64_t above = window(fg[ty - 1], j) >> lane;
    const bool nw = above & 1, n = above >> 1 & 1, ne = above >> 2 & 1;
    if (window(fg[ty], j) >> lane & 1) {
      // the west neighbour, in this pixel's run, has joined its own NW,
      // N and NE, which are this pixel's NW and N; NE is new only when N
      // is background (else it lies in N's run)
      if (ne && !n) unite(par, p, p - kTileW + 1);
    } else if (n) {
      unite(par, p, p - kTileW);  // NW and NE, when set, lie in N's run
    } else {
      if (nw) unite(par, p, p - kTileW - 1);
      if (ne) unite(par, p, p - kTileW + 1);
    }
  }
  __syncthreads();
  if (flat == 0) tile_info[1] = words;
  if (flat < (words + 3) / 4) tile_info[3 + flat] = busy_at[flat];
  // resolve in shared memory and store the words with foreground
  for (int k = threadIdx.y; k < words; k += kWarps) {
    const int ty = at[k] / kWords, j = at[k] % kWords;
    const int x = x0 + 32 * j + lane;
    if (x >= W) continue;
    int32_t v = -1;
    if (fg[ty][j] >> lane & 1) {
      int32_t t = ty * kTileW + 32 * j + lane;
      while (par[t] != t) t = par[t];
      v = (y0 + t / kTileW) * W + x0 + t % kTileW;
    }
    label[base + (size_t)(y0 + ty) * W + x] = v;
  }
}

// One block of kWords + 1 warps per tile, on the same grid as ccl_tile.
// Warp j < kWords links word j of the tile's first row to the row above,
// when the tile pass found foreground there; warp kWords links the
// tile's first column to the column left of it, one lane per row. Labels
// are read, not the mask: a label >= 0 is foreground, and it is the
// pixel's tile root already. Each lane makes at most two links, so the
// pass costs a few dependent round trips to memory.
__global__ void __launch_bounds__(32 * (kWords + 1))
    ccl_border(int32_t* label, int32_t* info, int H, int W) {
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  int32_t* lab = label + (size_t)blockIdx.z * H * W;
  int32_t* frame_info =
      info + (size_t)blockIdx.z * gridDim.y * gridDim.x * kInfo;
  // link two sets and flag the tile of the root linked, for ccl_compress
  auto link = [&](int32_t a, int32_t b) {
    const int32_t hi = unite(lab, a, b);
    if (hi >= 0)
      frame_info[(hi / W / kTileH * gridDim.x + hi % W / kTileW) * kInfo] =
          1;
  };
  const int j = threadIdx.y;
  if (j < kWords) {
    const int x = x0 + 32 * j + lane;
    if (y0 == 0 || x >= W) return;
    const unsigned top = frame_info[(blockIdx.y * gridDim.x + blockIdx.x) *
                                        kInfo + 2];
    if (!(top >> j & 1)) return;  // the whole warp
    const int32_t p = y0 * W + x;
    const int32_t up = p - W;
    // labels of the pixel, its west and its three neighbours above, all
    // loaded together; -1 is background
    const int32_t lp = lab[p];
    const int32_t lw = x > 0 ? lab[p - 1] : -1;
    const int32_t lnw = x > 0 ? lab[up - 1] : -1;
    const int32_t ln = lab[up];
    const int32_t lne = x + 1 < W ? lab[up + 1] : -1;
    if (lp < 0) return;
    // the same links as inside a tile: every foreground pixel of this
    // row is visited, and its west link is made by a tile or below
    if (lw >= 0) {
      if (lne >= 0 && ln < 0) link(lp, lne);
    } else if (ln >= 0) {
      link(lp, ln);
    } else {
      if (lnw >= 0) link(lp, lnw);
      if (lne >= 0 && lne != lnw) link(lp, lne);
    }
  } else {
    const int y = y0 + lane;
    if (x0 == 0 || y >= H) return;
    const int32_t p = y * W + x0;  // the first column of the tile
    const int32_t w = p - 1;       // the last column of the tile to its left
    const int32_t lp = lab[p], lw = lab[w];
    const int32_t lnw = y > 0 ? lab[w - W] : -1;  // p's north-west
    const int32_t lne = y > 0 ? lab[p - W] : -1;  // w's north-east
    // equal labels name one set: skip the links that repeat one made
    const bool pw = lp >= 0 && lw >= 0;
    if (pw) link(lp, lw);
    if (lp >= 0 && lnw >= 0 && !(pw && lnw == lw)) link(lp, lnw);
    if (lw >= 0 && lne >= 0 && !(pw && lne == lp)) link(lw, lne);
  }
}

// One block per tile, as in ccl_tile: a tile none of whose roots
// ccl_border linked is final already; in the others, each warp takes
// words of the tile's list. A label >= 0 is foreground.
__global__ void __launch_bounds__(32 * kWarps)
    ccl_compress(int32_t* label, const int32_t* __restrict__ info, int H,
                 int W) {
  const int32_t* tile_info = info + (size_t)tile_of_block() * kInfo;
  if (!tile_info[0]) return;
  const int n = tile_info[1];
  const uint8_t* at = reinterpret_cast<const uint8_t*>(tile_info + 3);
  int32_t* lab = label + (size_t)blockIdx.z * H * W;
  for (int k = threadIdx.y; k < n; k += kWarps) {
    const int ty = at[k] / kWords, j = at[k] % kWords;
    const int x = blockIdx.x * kTileW + 32 * j + threadIdx.x;
    if (x >= W) continue;
    const int32_t p = (blockIdx.y * kTileH + ty) * W + x;
    // the tile pass left each label at its tile root: only a tile root
    // that ccl_border linked needs a longer walk
    const int32_t up = lab[p];
    if (up < 0) continue;
    const int32_t up2 = lab[up];
    if (up2 != up) lab[p] = find_root(lab, up2);
  }
}

}  // namespace

// mask: (B, H, W) uint8 (0 / non-zero), labels: (B, H, W) int32,
// scratch: B * ceil(H / kTileH) * ceil(W / kTileW) * kInfo int32 (see
// trex_ccl_scratch_ints), all contiguous on the device. Launches on
// `stream`; returns the CUDA error code of the launches (0 on success).
// B and ceil(H / kTileH) must fit the grid's z and y limits (65535);
// H * W must fit an int32.
extern "C" int trex_ccl_label(const void* mask, void* labels, void* scratch,
                              int B, int H, int W, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  if (tiles_y > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  int32_t* lab = (int32_t*)labels;
  int32_t* info = (int32_t*)scratch;
  const dim3 tiles(tiles_x, tiles_y, B), block(32, kWarps);
  ccl_tile<<<tiles, block, 0, s>>>(m, lab, info, H, W);
  cudaError_t err = cudaGetLastError();
  // a frame of one tile is final after the tile pass
  if (err != cudaSuccess || tiles_x * tiles_y == 1) return (int)err;
  ccl_border<<<tiles, dim3(32, kWords + 1), 0, s>>>(lab, info, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_compress<<<tiles, block, 0, s>>>(lab, info, H, W);
  return (int)cudaGetLastError();
}

// Number of int32 of scratch that trex_ccl_label needs for (B, H, W).
extern "C" long long trex_ccl_scratch_ints(int B, int H, int W) {
  return (long long)B * ((H + kTileH - 1) / kTileH) *
         ((W + kTileW - 1) / kTileW) * kInfo;
}
