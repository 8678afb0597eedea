// Segmented OR over the blocked destination layout, fed by a source-major
// copy of the packed source frontier.
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
// segmented-OR op (ops.segor) the edge axis, one bit per edge.  Words are
// int32 tensors on the host side and are read here as the uint32 bit
// patterns they hold.
//
// One call (segor_blocks_launch) zeroes the output and launches two
// kernels, one after the other on the caller's stream:
//
// 1. transpose_kernel turns the frontier [V, nw_src] into its source-major
//    copy t [nw_src * 32, Vw], Vw = ceil(V / 32): bit (v & 31) of
//    t[s, v >> 5] is bit (s & 31) of frontier[v, s >> 5], and every bit of
//    a variable past V or a source past n_src is zero.  A warp stages 32
//    rows x 32 words of the frontier in shared memory (4 KB a warp, a fixed
//    16.5 KB a block), each row read by one coalesced load, and turns each
//    32 x 32 bit block around in registers (transpose32: five
//    __shfl_xor_sync steps, where one __ballot_sync a bit took 4x the
//    instructions and, measured on the H100, 0.029 ms a call at the main
//    path's shape).
// 2. segor_blocks_kernel, one thread block per edge block, one edge slot a
//    thread.  Each live edge loads its source's Vw contiguous words of t
//    (one 32-byte sector while Vw <= 8); dead slots (pads, ids outside the
//    block's window, dst >= n, src >= n_src) carry zero words.  Edges are
//    sorted by destination, so the lanes of a warp hold runs of equal dst:
//    a segmented inclusive OR over each run (five __shfl_up_sync steps a
//    word) leaves the run's OR in its last lane, which ORs it into the
//    source-major accumulator acc [block_n, Vw] in shared memory.  At the
//    end each warp turns 32 x 32 bit blocks of acc around in place
//    (transpose32 again), so that acc holds the block's [V, block_n / 32]
//    destination words, and the block ORs every nonzero word into the
//    zeroed output.
//
// Bound: memory traffic.  One call reads G*BE*8 bytes of edge ids (src and
// dst, int32), G*4 bytes of windows and the V*nw_src*4 bytes of the
// frontier, and writes V*nw*4 bytes of output; t (as many bytes as the
// frontier, rounded up to whole words of variables) is written and read
// back while it sits in L2.  Each live edge gathers one row of t, where a
// destination-major frontier would cost one scattered load per variable.
//
// Why atomics remain: blocks run in parallel and in no order, and several
// blocks may own one window (a window with more than BE edges, or the
// trailing pad blocks), so the merge into device memory is an atomicOr
// onto the zeroed output.  Inside a block a run of one destination can
// span two warps, and the layout's order is not assumed, so the
// accumulator takes atomicOr in shared memory too; sorted runs make those
// atomics hit distinct addresses.  OR is idempotent and commutative, so the
// result does not depend on the order.
//
// Shared memory: acc is block_n * Vw * 4 bytes (V * block_n / 8 when V is
// a multiple of 32); the wrapper refuses a V past the 227 KB a block may
// use (Vw <= 227, V <= 7,264 at block_n = 256).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;        // segor_blocks_kernel: threads a block
constexpr int kTransposeWarps = 4;   // transpose_kernel: warps a block

// 32 x 32 bit block across a warp: lane l passes row l and gets column l
// back (bit r of the result is bit l of lane r's row).  Five butterfly
// steps swap the off-diagonal halves of ever smaller sub-blocks between
// lanes j apart; an all-zero block costs one ballot.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  if (__ballot_sync(kFull, x != 0u) == 0u) return 0u;
  uint32_t m = 0x0000FFFFu;  // bits of the left half of each 2j-bit group
#pragma unroll
  for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
  }
  return x;
}

// One warp per (tile of 32 source words, group of 32 variables).
__global__ void transpose_kernel(const uint32_t* __restrict__ frontier,
                                 uint32_t* __restrict__ t, int n_vars,
                                 int n_src, int nw_src, int vw) {
  __shared__ uint32_t tile[kTransposeWarps][32][33];  // +1: no bank conflicts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long job =
      static_cast<long long>(blockIdx.x) * kTransposeWarps + warp;
  const int k = static_cast<int>(job % vw);
  const long long w0 = job / vw * 32;
  if (w0 >= nw_src) return;  // the whole warp: past the last tile
  uint32_t(*s)[33] = tile[warp];
  for (int r = 0; r < 32; ++r) {
    const int v = 32 * k + r;
    const long long w = w0 + lane;
    s[r][lane] = (v < n_vars && w < nw_src)
                     ? frontier[static_cast<size_t>(v) * nw_src + w]
                     : 0u;
  }
  __syncwarp();
  for (int j = 0; j < 32 && w0 + j < nw_src; ++j) {
    const uint32_t col = transpose32(s[lane][j], lane);
    const long long src = (w0 + j) * 32 + lane;
    t[src * vw + k] = src < n_src ? col : 0u;
  }
}

__global__ void segor_blocks_kernel(const uint32_t* __restrict__ t,
                                    const int32_t* __restrict__ src_b,
                                    const int32_t* __restrict__ dst_b,
                                    const int32_t* __restrict__ win,
                                    uint32_t* __restrict__ out, int n_vars,
                                    int nw, int block_e, int n, int block_n,
                                    int n_src, int vw) {
  extern __shared__ uint32_t acc[];  // [block_n, vw], source-major
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const int base = win[g] * block_n;
  for (int i = threadIdx.x; i < block_n * vw; i += blockDim.x) acc[i] = 0u;
  __syncthreads();

  const int32_t* src_g = src_b + static_cast<size_t>(g) * block_e;
  const int32_t* dst_g = dst_b + static_cast<size_t>(g) * block_e;
  const uint32_t upto = kFull >> (31 - lane);  // lanes 0 .. lane
  for (int e0 = warp * 32; e0 < block_e; e0 += blockDim.x) {
    const int e = e0 + lane;
    const int dst = e < block_e ? dst_g[e] : -1;
    const int src = e < block_e ? src_g[e] : -1;
    const int local = dst - base;
    const bool live = dst >= 0 && dst < n && local >= 0 && local < block_n &&
                      src >= 0 && src < n_src;
    // runs of equal dst over consecutive lanes: the first lane of this
    // lane's run, and whether this lane ends it.  A run's OR is nonzero
    // only if a live lane is in it, so its dst then lies in the window.
    const int prev = __shfl_up_sync(kFull, dst, 1);
    const uint32_t heads = __ballot_sync(kFull, lane == 0 || prev != dst);
    const int start = 31 - __clz(heads & upto);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    const uint32_t* row = t + static_cast<size_t>(live ? src : 0) * vw;
    for (int k = 0; k < vw; ++k) {
      uint32_t w = live ? __ldg(row + k) : 0u;
      if (__ballot_sync(kFull, w != 0u) == 0u) continue;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(kFull, w, d);
        if (lane - d >= start) w |= up;
      }
      if (tail && w != 0u) {
        atomicOr(acc + static_cast<size_t>(local) * vw + k, w);
      }
    }
  }
  __syncthreads();

  // block (i, k) of acc: destinations 32i .. 32i+31 x variables 32k ..
  // 32k+31; turned around, lane b's word is destination word (32k + b, i),
  // stored back into the slot lane b read
  const int bw = block_n >> 5;
  for (int blk = warp; blk < bw * vw; blk += blockDim.x >> 5) {
    const int i = blk / vw;
    uint32_t* a = acc + static_cast<size_t>(32 * i + lane) * vw + (blk - i * vw);
    *a = transpose32(*a, lane);
  }
  __syncthreads();

  const int word0 = base >> 5;
  for (int idx = threadIdx.x; idx < n_vars * bw; idx += blockDim.x) {
    const int v = idx / bw;
    const int i = idx - v * bw;
    const int gw = word0 + i;
    const uint32_t w =
        acc[static_cast<size_t>(32 * i + (v & 31)) * vw + (v >> 5)];
    if (w != 0u && gw < nw) atomicOr(out + static_cast<size_t>(v) * nw + gw, w);
  }
}


cudaError_t launch_transpose(const void* frontier, void* t, int n_vars,
                             int n_src, int nw_src, cudaStream_t stream) {
  const int vw = (n_vars + 31) / 32;
  const long long jobs = static_cast<long long>((nw_src + 31) / 32) * vw;
  const long long blocks = (jobs + kTransposeWarps - 1) / kTransposeWarps;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    transpose_kernel<<<static_cast<unsigned>(blocks), kTransposeWarps * 32, 0,
                       stream>>>(static_cast<const uint32_t*>(frontier),
                                 static_cast<uint32_t*>(t), n_vars, n_src,
                                 nw_src, vw);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch transpose_kernel alone on `stream`; returns cudaGetLastError() (0
// on success).  `frontier` holds n_vars rows of nw_src words; `t` must
// hold nw_src * 32 rows of ceil(n_vars / 32) words.
extern "C" int segor_transpose_launch(const void* frontier, void* t,
                                      int n_vars, int n_src, int nw_src,
                                      void* stream) {
  return static_cast<int>(launch_transpose(
      frontier, t, n_vars, n_src, nw_src, static_cast<cudaStream_t>(stream)));
}

// One segmented-OR call on `stream`: zero `out` (n_vars * nw words), write
// the source-major copy of `frontier` (n_vars rows of nw_src words) into
// the scratch `t` (nw_src * 32 rows of ceil(n_vars / 32) words), then run
// segor_blocks_kernel.  Returns the first CUDA error (0 on success).
extern "C" int segor_blocks_launch(const void* frontier, const void* src_b,
                                   const void* dst_b, const void* win,
                                   void* t, void* out, int n_vars, int nw,
                                   int n_blocks, int block_e, int n,
                                   int block_n, int n_src, int nw_src,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vw = (n_vars + 31) / 32;
  const size_t smem = static_cast<size_t>(block_n) * vw * sizeof(uint32_t);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(segor_blocks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_vars) * nw * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_transpose(frontier, t, n_vars, n_src, nw_src, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    segor_blocks_kernel<<<n_blocks, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(t), static_cast<const int32_t*>(src_b),
        static_cast<const int32_t*>(dst_b), static_cast<const int32_t*>(win),
        static_cast<uint32_t*>(out), n_vars, nw, block_e, n, block_n, n_src,
        vw);
  }
  return static_cast<int>(cudaGetLastError());
}
