// Segment sum over rows sorted by segment id (CSR layout).
//
// Replaces src/repro/kernels/segsum/kernel.py::segsum_blocks (the Pallas TPU
// kernel).  For every segment s < n and column j < d:
//
//     out[s, j] = sum over r in [row_ptr[s], row_ptr[s + 1]) of vals[r, j]
//
// with the rows of vals sorted by segment id (stable, so each segment's
// rows keep their input order).  f32 and f64.
//
// The TPU has no scatter unit, so its kernel multiplied a one-hot matrix of
// each edge block's ids into the block's values on the MXU and accumulated
// windows of block_n segments in VMEM.  Hopper has no such constraint: here
// one warp owns one segment and a tile of up to kTileD columns, walks the
// segment's rows in sorted order with the tile's partial sums in registers
// (lane l holds columns l, l + 32, l + 64, l + 96 of the tile), and writes
// its output row once.  So no atomics, no zero-fill pass: an empty segment
// writes zeros, and every launch adds in the same order and gives the same
// bits.
//
// Bound: memory traffic.  One launch reads each row of vals once (E * d
// elements), row_ptr (n + 1 int32), and writes n * d elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block, one segment each
constexpr int kChunks = 4;     // 32-column chunks per lane
constexpr int kTileD = 32 * kChunks;

template <typename T>
__global__ void segsum_csr_kernel(const T* __restrict__ vals,
                                  const int32_t* __restrict__ row_ptr,
                                  T* __restrict__ out, int n, int d) {
  const int warps = blockDim.x >> 5;
  const int s = blockIdx.x * warps + (threadIdx.x >> 5);
  if (s >= n) return;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kTileD + lane;
  T acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = T(0);
  const int lo = row_ptr[s];
  const int hi = row_ptr[s + 1];
  for (int r = lo; r < hi; ++r) {
    const T* row = vals + static_cast<size_t>(r) * d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = col0 + 32 * c;
      if (col < d) acc[c] += row[col];
    }
  }
  T* o = out + static_cast<size_t>(s) * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = col0 + 32 * c;
    if (col < d) o[col] = acc[c];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `out`
// holds n * d elements of the same type as `vals` (f64 when `is_double`,
// else f32); every one of them is written.
extern "C" int segsum_csr_launch(const void* vals, const void* row_ptr,
                                 void* out, int n, int d, int is_double,
                                 void* stream) {
  if (n > 0 && d > 0) {
    const int warps = kThreads / 32;
    const dim3 grid((n + warps - 1) / warps, (d + kTileD - 1) / kTileD);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double) {
      segsum_csr_kernel<double><<<grid, kThreads, 0, st>>>(
          static_cast<const double*>(vals),
          static_cast<const int32_t*>(row_ptr), static_cast<double*>(out), n,
          d);
    } else {
      segsum_csr_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(vals),
          static_cast<const int32_t*>(row_ptr), static_cast<float*>(out), n,
          d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
