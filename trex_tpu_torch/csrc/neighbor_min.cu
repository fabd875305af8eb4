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
// element: 269.5 MB for the labelling path's 32 x 1026^2 batch, 80 us at
// the H100's 3.35 TB/s; its 8 minimums per element take 32 us at
// 67 TOP/s. The batch is larger than the 50 MB L2, so every byte comes
// from device memory.
//
// Design: a strip sweep with a register window. Each thread owns V adjacent
// columns (V = 2 when the row width is even and the buffers are 8-byte
// aligned, as rows of 1026 elements are, else V = 1; rows of 1026 are 8 mod
// 16 bytes long, so no wider vector stays aligned down a column) and walks
// down a strip of kStripRows rows. Per row it makes one vector load; the
// columns left and right of its vector come from the neighbouring lanes by
// warp shuffle, and only a warp's edge lanes load one halo element each. It
// keeps the horizontal 3-minimums of the rows above and at the output row in
// registers, so each output row costs one new row's minimums, two more
// minimums and one vector store, and each input element is read from device
// memory once, plus 2 / kStripRows for the strip's halo rows. Each warp
// loads its rows kRowsInFlight at a time, one group ahead of their use, so
// that its loads stay in flight while it computes and stores the group
// before. The wrap stays exact: the halo column of x = 0 and of x = W - 1 is
// taken modulo W, and the strips at the top and the bottom read row H - 1
// and row 0 as their halo rows.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kStripRows = 8;     // output rows per warp
constexpr int kRowsInFlight = 4;  // rows loaded ahead of their use
constexpr int kWarps = 4;         // warps per block, one strip each
constexpr unsigned kFullWarp = 0xffffffffu;

template <int V>
struct Vec {
  int32_t v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const int32_t* p) {
  Vec<V> r;
  if constexpr (V == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_vec(int32_t* p, const Vec<V>& r) {
  if constexpr (V == 2) {
    __stcs(reinterpret_cast<int2*>(p), make_int2(r.v[0], r.v[1]));
  } else {
    __stcs(p, r.v[0]);
  }
}

// One row of a thread's columns as loaded: its vector and, on the lanes
// that need them, the halo elements no neighbouring lane holds.
template <int V>
struct Row {
  Vec<V> v;
  int32_t left, right;
};

// Where a thread's columns and their halo lie in every row.
struct Columns {
  int x;       // first column of the thread's vector
  int xl, xr;  // halo columns left and right of it, modulo W
  bool active, need_l, need_r;
};

template <int V>
__device__ __forceinline__ Row<V> load_row(const int32_t* row,
                                           const Columns& c) {
  Row<V> r;
  if (c.active) {
    r.v = load_vec<V>(row + c.x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.v.v[j] = INT_MAX;
  }
  r.left = c.need_l ? __ldg(row + c.xl) : INT_MAX;
  r.right = c.need_r ? __ldg(row + c.xr) : INT_MAX;
  return r;
}

// The rows below output rows y .. y + kRowsInFlight - 1 that lie before
// y1, row H wrapping to row 0.
template <int V>
__device__ __forceinline__ void load_group(const int32_t* f, int y, int y1,
                                           int H, int W, const Columns& c,
                                           Row<V> (&rows)[kRowsInFlight]) {
#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const int yn = y + u + 1;
    if (y + u < y1)
      rows[u] = load_row<V>(f + (size_t)(yn == H ? 0 : yn) * W, c);
  }
}

// Horizontal 3-minimums of a row; the whole warp calls it (shuffles).
template <int V>
__device__ __forceinline__ Vec<V> row_min3(const Row<V>& r,
                                           const Columns& c) {
  int32_t left = __shfl_up_sync(kFullWarp, r.v.v[V - 1], 1);
  int32_t right = __shfl_down_sync(kFullWarp, r.v.v[0], 1);
  if (c.need_l) left = r.left;
  if (c.need_r) right = r.right;
  Vec<V> m;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int32_t a = j > 0 ? r.v.v[j - 1] : left;
    const int32_t b = j + 1 < V ? r.v.v[j + 1] : right;
    m.v[j] = min(min(a, r.v.v[j]), b);
  }
  return m;
}

template <int V>
__global__ void __launch_bounds__(32 * kWarps)
    neighbor_min_strips(const int32_t* __restrict__ in,
                        int32_t* __restrict__ out, int H, int W) {
  const int lane = threadIdx.x;
  const int y0 = (blockIdx.y * kWarps + threadIdx.y) * kStripRows;
  if (y0 >= H) return;  // the whole warp
  const int y1 = min(y0 + kStripRows, H);
  Columns c;
  c.x = (blockIdx.x * 32 + lane) * V;
  c.active = c.x < W;
  c.need_l = c.active && lane == 0;
  c.need_r = c.active && (lane == 31 || c.x + V == W);
  c.xl = c.x == 0 ? W - 1 : c.x - 1;
  c.xr = c.x + V == W ? 0 : c.x + V;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int32_t* f = in + base;
  int32_t* g = out + base;
  // horizontal minimums of the rows above (a) and at (b) the output row
  Vec<V> a = row_min3<V>(
      load_row<V>(f + (size_t)(y0 == 0 ? H - 1 : y0 - 1) * W, c), c);
  Vec<V> b = row_min3<V>(load_row<V>(f + (size_t)y0 * W, c), c);
  // the rows below output rows y .. y + kRowsInFlight - 1, loaded one
  // group ahead of their use so that loads stay in flight while a group
  // is computed and stored
  Row<V> below[kRowsInFlight], ahead[kRowsInFlight];
  load_group<V>(f, y0, y1, H, W, c, below);
  for (int y = y0; y < y1; y += kRowsInFlight) {
    load_group<V>(f, y + kRowsInFlight, y1, H, W, c, ahead);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (y + u < y1) {  // the whole warp alike
        const Vec<V> n = row_min3<V>(below[u], c);
        if (c.active) {
          Vec<V> m;
#pragma unroll
          for (int j = 0; j < V; ++j)
            m.v[j] = min(min(a.v[j], b.v[j]), n.v[j]);
          store_vec<V>(g + (size_t)(y + u) * W + c.x, m);
        }
        a = b;
        b = n;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) below[u] = ahead[u];
  }
}

template <int V>
int launch(const int32_t* in, int32_t* out, int N, int H, int W,
           cudaStream_t s) {
  const int strips = (H + kStripRows - 1) / kStripRows;
  const dim3 block(32, kWarps);
  const dim3 grid((W + 32 * V - 1) / (32 * V), (strips + kWarps - 1) / kWarps,
                  N);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  neighbor_min_strips<V><<<grid, block, 0, s>>>(in, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: (N, H, W) int32, contiguous on the device, distinct buffers.
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success). The vector width follows W and the buffers' alignment: 2
// when W is even and both are 8-byte aligned, else 1. N and
// ceil(H / (kStripRows * kWarps)) must fit the grid's z and y limits
// (65535).
extern "C" int trex_neighbor_min(const void* in, void* out, int N, int H,
                                 int W, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const uintptr_t both = (uintptr_t)in | (uintptr_t)out;
  const int32_t* src = (const int32_t*)in;
  int32_t* dst = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (W % 2 == 0 && both % 8 == 0) return launch<2>(src, dst, N, H, W, s);
  return launch<1>(src, dst, N, H, W, s);
}
