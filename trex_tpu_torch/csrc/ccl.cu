// 8-connected component labelling of a batch of binary masks, for Hopper
// (sm_90a). Bound with ctypes through the plain C entry point at the end.
//
// Replaces trex_tpu/ops/cc_device.py::_stripe_kernel (the Pallas stripe
// relaxation launched by label_components_vmem). Output is bit-identical:
// each foreground pixel gets the linear index y*W+x of its component's
// first pixel in scan order, background gets -1.
//
// Design: union-find label equivalence in three launches over the
// (B, H, W) mask, with no host round trip and no convergence loop.
//   1. init:     each foreground pixel points at the first pixel of its
//                horizontal run (one warp ballot per 32 columns, so the
//                W-neighbour links cost no union), background gets -1;
//   2. merge:    each foreground pixel unions with the foreground runs
//                above it that its west neighbour has not already joined.
//                A union links the larger root to the smaller with
//                atomicMin, so parent[i] <= i always holds and the final
//                root is the component's minimum index, i.e. its first
//                pixel in scan order;
//   3. compress: each pixel follows its chain to the root.
// The label array itself is the union-find parent array (frame-local
// indices), so no scratch memory is needed.
//
// Bound: memory. The function must read 1 byte of mask and write 4 bytes
// of labels per pixel: 5 bytes/pixel, 168 MB for 32 x 1024^2, about 50 us
// at the H100's 3.35 TB/s. Staying near it: every pass is a coalesced
// one-thread-per-pixel sweep over a (column, row, frame) grid with no
// integer division; init writes every label once; merge and compress
// read the mask and touch labels only on foreground pixels. What costs
// beyond the bytes is the latency of find's dependent loads, so chains
// are kept short: run-start labels make a chain at most one link per
// row of the blob, and find halves the path it walks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // columns: one warp reads 32 adjacent pixels
constexpr int kBlockY = 8;   // rows
constexpr unsigned kFullWarp = 0xffffffffu;

struct Pixel {
  int x, y, p;        // column, row, frame-local index y*W+x
  size_t base;        // offset of the frame
};

// The pixel of this thread, or false past the frame's edge.
__device__ __forceinline__ bool pixel_of_thread(int H, int W, Pixel* px) {
  px->x = blockIdx.x * kBlockX + threadIdx.x;
  px->y = blockIdx.y * kBlockY + threadIdx.y;
  if (px->x >= W || px->y >= H) return false;
  px->p = px->y * W + px->x;
  px->base = (size_t)blockIdx.z * H * W;
  return true;
}

__global__ void ccl_init(const uint8_t* __restrict__ mask,
                         int32_t* __restrict__ label, int H, int W) {
  // a warp is 32 adjacent columns of one row (blockDim.x == 32)
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * kBlockX;
  const int x = x0 + lane;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (y >= H) return;  // the whole warp
  const size_t base = (size_t)blockIdx.z * H * W;
  const uint8_t* row = mask + base + (size_t)y * W;
  const bool fg = x < W && row[x];
  const unsigned bits = __ballot_sync(kFullWarp, fg);
  // column where the run through lane 0 begins, walking left a warp's
  // width at a time while the columns to the left are all foreground
  int edge_start = x0;
  if (bits & 1u) {
    for (int xs = x0 - kBlockX; xs >= 0; xs -= kBlockX) {
      const unsigned prev = __ballot_sync(kFullWarp, row[xs + lane] != 0);
      if (prev != kFullWarp) {
        edge_start = xs + 32 - __clz(~prev);
        break;
      }
      edge_start = xs;
    }
  }
  if (x >= W) return;
  // background lanes at or left of this one; the run starts after the
  // rightmost of them, or at edge_start when there is none
  const unsigned gaps = ~bits & ((2u << lane) - 1u);
  const int start = gaps ? x0 + 32 - __clz(gaps) : edge_start;
  label[base + (size_t)y * W + x] = fg ? y * W + start : -1;
}

// Root of frame-local index `a` in the frame whose labels start at `lab`,
// halving the path on the way: each visited entry is lowered to its
// grandparent. Entries only ever decrease and always name a pixel of the
// same component, so a stale read costs an extra step and atomicMin keeps
// whichever of a concurrent link and the grandparent is smaller: no union
// is lost.
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

__device__ void unite(int32_t* lab, int32_t a, int32_t b) {
  bool done;
  do {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a < b) {
      int32_t old = atomicMin(&lab[b], a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      int32_t old = atomicMin(&lab[a], b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void ccl_merge(const uint8_t* __restrict__ mask,
                          int32_t* label, int H, int W) {
  Pixel px;
  if (!pixel_of_thread(H, W, &px)) return;
  const uint8_t* m = mask + px.base;
  const int32_t p = px.p;
  if (px.y == 0 || !m[p]) return;
  int32_t* lab = label + px.base;
  const int32_t up = p - W;
  const bool n = m[up];
  const bool ne = px.x + 1 < W && m[up + 1];
  if (px.x > 0 && m[p - 1]) {
    // the west neighbour, in this pixel's run, has joined its own NW, N
    // and NE, which are this pixel's NW and N; NE is new only when N is
    // background (else it lies in N's run)
    if (ne && !n) unite(lab, p, up + 1);
  } else if (n) {
    unite(lab, p, up);  // NW and NE, when foreground, lie in N's run
  } else {
    if (px.x > 0 && m[up - 1]) unite(lab, p, up - 1);
    if (ne) unite(lab, p, up + 1);
  }
}

__global__ void ccl_compress(const uint8_t* __restrict__ mask,
                             int32_t* label, int H, int W) {
  Pixel px;
  if (!pixel_of_thread(H, W, &px)) return;
  if (!mask[px.base + px.p]) return;
  int32_t* lab = label + px.base;
  const int32_t r = find_root(lab, px.p);
  if (r != px.p) lab[px.p] = r;
}

}  // namespace

// mask: (B, H, W) uint8 (0 / non-zero), labels: (B, H, W) int32, both
// contiguous on the device. Launches on `stream`; returns the CUDA error
// code of the launches (0 on success). B and ceil(H / 8) must fit the
// grid's y and z limits (65535); H * W must fit an int32.
extern "C" int trex_ccl_label(const void* mask, void* labels, int B, int H,
                              int W, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY,
                  B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  int32_t* lab = (int32_t*)labels;
  ccl_init<<<grid, block, 0, s>>>(m, lab, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_merge<<<grid, block, 0, s>>>(m, lab, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_compress<<<grid, block, 0, s>>>(m, lab, H, W);
  return (int)cudaGetLastError();
}
