// 3x3 minimum stencil over a batch of int32 label tiles, for Hopper
// (sm_90a). Bound with ctypes through the plain C entry point at the end.
//
// Replaces trex_tpu/ops/cc_device.py::_neighbor_min_kernel (the Pallas
// kernel that label_components(use_pallas=True) launches once per
// propagation step). Output is bit-identical to it over the whole tile:
// each element becomes the minimum of the 3x3 window around it, centre
// included, with row and column indices taken modulo the tile's own
// height and width. That is what jnp.roll does in the TPU kernel, so the
// border wraps around inside its frame and never into another frame of
// the batch. The caller pads each frame with INACTIVE and keeps only the
// interior, where no index wraps.
//
// Bound: memory. The function must read 4 bytes and write 4 bytes per
// element: 8.42 MB for one 1026 x 1026 tile, 2.5 us at the H100's
// 3.35 TB/s; its 9 compares per element are about 0.14 us at 67 TOP/s.
// Design: one thread per output element on a (column, row, frame) grid,
// a warp along 32 adjacent columns, so the three row loads of a warp and
// its store are coalesced; the neighbouring rows come back through L1/L2
// rather than device memory. No integer division, no shared memory: at
// one frame of 1024^2 the launch itself is most of the time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // columns: one warp reads 32 adjacent elements
constexpr int kBlockY = 8;   // rows

__device__ __forceinline__ int32_t min3(const int32_t* __restrict__ row,
                                        int xm, int x, int xp) {
  return min(min(__ldg(row + xm), __ldg(row + x)), __ldg(row + xp));
}

__global__ void neighbor_min(const int32_t* __restrict__ in,
                             int32_t* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int xm = x == 0 ? W - 1 : x - 1;
  const int xp = x == W - 1 ? 0 : x + 1;
  const int ym = y == 0 ? H - 1 : y - 1;
  const int yp = y == H - 1 ? 0 : y + 1;
  const int32_t* f = in + base;
  int32_t m = min3(f + (size_t)ym * W, xm, x, xp);
  m = min(m, min3(f + (size_t)y * W, xm, x, xp));
  m = min(m, min3(f + (size_t)yp * W, xm, x, xp));
  out[base + (size_t)y * W + x] = m;
}

}  // namespace

// in, out: (N, H, W) int32, contiguous on the device, distinct buffers.
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success). N and ceil(H / 8) must fit the grid's z and y limits (65535).
extern "C" int trex_neighbor_min(const void* in, void* out, int N, int H,
                                 int W, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY,
                  N);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  neighbor_min<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, H, W);
  return (int)cudaGetLastError();
}
