// Segmented OR over the blocked destination layout, fused with the gather
// of the source-frontier bits.
//
// Replaces src/repro/kernels/segsum/kernel.py::segor_blocks (the Pallas TPU
// kernel) together with the _edge_bits gather that feeds it in
// src/repro/core/dualsim.py::solve_sparse.  For every edge block g and
// every edge (src, dst) of it with dst < n inside window win[g]:
//
//     out[v, dst >> 5] |= 1 << (dst & 31)   if bit (src & 31) of
//                                           frontier[v, src >> 5] is set
//
// for each of the V variables.  Pad rows carry the sentinel n_pad >= n and
// set nothing.  The frontier has its own axis of n_src bits in rows of
// nw_src words: the edge engines pass the node axis (n_src = n), the
// segmented-OR op (ops.segor) the edge axis, one bit per edge.  Words are int32 tensors on the host side and are read here
// as the uint32 bit patterns they hold.
//
// Bound: memory traffic, not arithmetic.  One launch reads G*BE*8 bytes of
// edge ids (src and dst, int32), G*4 bytes of windows, gathers frontier
// words (V*nw*4 bytes at least) and writes V*nw*4 bytes of output.  The
// TPU kernel materialised the gathered bits as a [G, BE, V] plane first;
// here the gather happens inside the kernel, so that plane never exists.
//
// Why atomics: the TPU walked its grid in order on one core, so blocks that
// share a window (a window with more than BE edges, or the trailing pad
// blocks) revisited the same output tile in VMEM one after another.  On
// Hopper the blocks run in parallel and in no order, so several blocks may
// own one window at once.  Each block ORs its window into shared memory
// with shared atomics, then merges its nonzero words into device memory
// with atomicOr onto an output the wrapper zeroes.  OR is idempotent and
// commutative, so the result does not depend on the order.
//
// Design: one thread block per edge block; each thread strides over the
// block's edges.  Dynamic shared memory holds the [V, block_n / 32] window
// accumulator, V * block_n / 8 bytes; the wrapper refuses a V past the
// 227 KB a block may use.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void segor_blocks_kernel(const uint32_t* __restrict__ frontier,
                                    const int32_t* __restrict__ src_b,
                                    const int32_t* __restrict__ dst_b,
                                    const int32_t* __restrict__ win,
                                    uint32_t* __restrict__ out,
                                    int n_vars, int nw, int block_e, int n,
                                    int block_n, int n_src, int nw_src) {
  extern __shared__ uint32_t acc[];  // [n_vars, block_n / 32]
  const int bw = block_n >> 5;
  const int g = blockIdx.x;
  const int base = win[g] * block_n;
  for (int i = threadIdx.x; i < n_vars * bw; i += blockDim.x) acc[i] = 0u;
  __syncthreads();

  const int32_t* src_g = src_b + static_cast<size_t>(g) * block_e;
  const int32_t* dst_g = dst_b + static_cast<size_t>(g) * block_e;
  for (int e = threadIdx.x; e < block_e; e += blockDim.x) {
    const int dst = dst_g[e];
    const int src = src_g[e];
    const int local = dst - base;
    // pad rows (sentinel n_pad), ids outside the block's window, and
    // sources past the frontier's axis set nothing
    if (dst < 0 || dst >= n || local < 0 || local >= block_n || src < 0 ||
        src >= n_src) {
      continue;
    }
    const uint32_t* f = frontier + (src >> 5);
    const uint32_t shift = static_cast<uint32_t>(src & 31);
    const uint32_t bit = 1u << (dst & 31);
    uint32_t* a = acc + (local >> 5);
    for (int v = 0; v < n_vars; ++v) {
      if ((f[static_cast<size_t>(v) * nw_src] >> shift) & 1u) {
        atomicOr(a + v * bw, bit);
      }
    }
  }
  __syncthreads();

  const int word0 = base >> 5;
  for (int i = threadIdx.x; i < n_vars * bw; i += blockDim.x) {
    const uint32_t w = acc[i];
    if (w == 0u) continue;
    const int v = i / bw;
    const int gw = word0 + (i - v * bw);
    if (gw < nw) atomicOr(out + static_cast<size_t>(v) * nw + gw, w);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `out`
// must hold n_vars * nw zeroed words; `frontier` holds n_vars rows of
// nw_src words.
extern "C" int segor_blocks_launch(const void* frontier, const void* src_b,
                                   const void* dst_b, const void* win,
                                   void* out, int n_vars, int nw, int n_blocks,
                                   int block_e, int n, int block_n, int n_src,
                                   int nw_src, void* stream) {
  const size_t smem =
      static_cast<size_t>(n_vars) * (block_n / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segor_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_blocks > 0) {
    segor_blocks_kernel<<<n_blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(frontier),
        static_cast<const int32_t*>(src_b), static_cast<const int32_t*>(dst_b),
        static_cast<const int32_t*>(win), static_cast<uint32_t*>(out), n_vars,
        nw, block_e, n, block_n, n_src, nw_src);
  }
  return static_cast<int>(cudaGetLastError());
}
