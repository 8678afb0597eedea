// Packed boolean products over bit-packed adjacency rows: the product of
// the `packed` engine and the fused sweep step of the `packed_fused` engine.
//
// bitmm_packed replaces src/repro/kernels/bitmm/kernel.py::bitmm_packed
// (Pallas body _bitmm_kernel):
//
//     out[v, jw] = OR_{i < n : x[v, i] != 0} A[i, jw]
//
// with the frontier x given as 0/1 bytes (a bool tensor's storage).
//
// bitmm_apply_packed replaces src/repro/kernels/bitmm/kernel.py::
// bitmm_apply_packed (Pallas body _bitmm_apply_kernel): the same product
// with the frontier bits read from packed chi (bit i & 31 of word i >> 5),
// then, for every variable l,
//
//     chi'[l, jw] = chi[l, jw] & ~OR_{r : F[l, r] != 0} ~y[r, jw]
//
// and one word, `changed`, that receives the OR of chi' ^ chi over every
// word (nonzero iff any word moved).  ~y sets the pad bits of the last
// word, but chi's pad bits are zero and chi & ~bad keeps them zero.  Words
// are int32 tensors on the host side and are read here as the uint32 bit
// patterns they hold.
//
// Bound on this card.  Per launch the product must read the rows of A
// that some variable selects (at most n * nw * 4 bytes), chi or the flags
// once, F (V * V words, bitmm_apply_packed only), and write V * nw words;
// it does one word OR for each (v, i) with x[v, i] set and each of the nw
// columns: at most V * n * nw word operations.  At the dense tier's largest
// graphs (n = 46,200, nw = 1,444) A alone is 267 MB, so a launch that reads
// all of A takes at least 0.080 ms at 3.35 TB/s, and V = 48 variables with
// every bit set would be 3.2e9 word operations: the operations bound it.
//
// Design.  The TPU walked the contraction as the sequential inner axis of
// its grid and revisited one output tile in VMEM.  Here one thread block
// owns a tile of 32 column words for all V variables and walks the whole
// contraction itself, so no sum crosses blocks, and the fused step can
// combine the finished y rows of its tile in shared memory in the same
// launch.  Lane j of every warp owns column word tile0 + j, so each row of
// A is read as one coalesced 128-byte line.  The warps of a block split the
// contraction words; for each word iw (rows 32*iw .. 32*iw + 31) a warp
// gathers the V frontier words into shared memory, skips the word when no
// variable has a bit in it (rows no variable selects are never read), loads
// the selected rows of A into registers, and ORs them into its own y
// accumulator in shared memory ([V, 32] words per warp).  The warps' y
// accumulators are then ORed together.  Rows past n do not exist: A is not
// padded, the last word's bits past n are masked off.
//
// What holds it back: one block per 32-word column tile gives ceil(nw / 32)
// blocks, 46 at nw = 1,444, on 132 SMs, and every selected bit costs a
// select and an OR in each of the 32 lanes.  Splitting the contraction
// across blocks is later work.  Shared memory per block is warps * V * 33
// words; the wrapper picks the warp count and refuses a V past the 227 KB a
// block may use.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // column words per block: one per lane
constexpr unsigned kFull = 0xffffffffu;

// Frontier words of bitmm_apply_packed: packed chi [V, nw].
struct PackedFrontier {
  const uint32_t* chi;
  int nw;

  // Writes cs[v] = the frontier word iw of variable v (bits past n masked
  // by `valid`) and returns the OR of all of them, the same in every lane.
  __device__ uint32_t load(uint32_t* cs, int iw, uint32_t valid, int lane,
                           int n_vars) const {
    uint32_t any = 0u;
    for (int v = lane; v < n_vars; v += 32) {
      const uint32_t c = chi[static_cast<size_t>(v) * nw + iw] & valid;
      cs[v] = c;
      any |= c;
    }
    __syncwarp();
    return __reduce_or_sync(kFull, any);
  }
};

// Frontier words of bitmm_packed: 0/1 bytes [V, n], packed by a ballot.
struct FlagFrontier {
  const uint8_t* x;
  int n;

  __device__ uint32_t load(uint32_t* cs, int iw, uint32_t, int lane,
                           int n_vars) const {
    const int row = iw * 32 + lane;
    const bool live = row < n;
    uint32_t any = 0u;
#pragma unroll 8
    for (int v = 0; v < n_vars; ++v) {
      const bool bit = live && x[static_cast<size_t>(v) * n + row] != 0;
      const uint32_t c = __ballot_sync(kFull, bit);
      if (lane == 0) cs[v] = c;
      any |= c;
    }
    __syncwarp();
    return any;
  }
};

// y[v, tile] over the whole contraction, left in the first warp's slice
// of `smem` ([V, 32] words).  Every warp's slice is warps * (V * 33) words:
// y accumulator [V, 32], then frontier words [V].
template <typename Frontier>
__device__ uint32_t* product_tile(const Frontier& frontier,
                                  const uint32_t* __restrict__ a, int n,
                                  int nw, int n_vars, uint32_t* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int stride = n_vars * (kTile + 1);
  for (int i = threadIdx.x; i < n_warps * stride; i += blockDim.x) smem[i] = 0u;
  __syncthreads();

  uint32_t* ys = smem + warp * stride;
  uint32_t* cs = ys + n_vars * kTile;
  const int jw = blockIdx.x * kTile + lane;
  const bool live_col = jw < nw;
  const int niw = (n + 31) >> 5;
  for (int iw = warp; iw < niw; iw += n_warps) {
    const int rows = min(32, n - iw * 32);
    const uint32_t valid = rows == 32 ? kFull : ((1u << rows) - 1u);
    const uint32_t any = frontier.load(cs, iw, valid, lane, n_vars);
    if (any == 0u) continue;
    uint32_t arow[32];
    const uint32_t* a_iw = a + static_cast<size_t>(iw) * 32 * nw + jw;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      arow[s] = (live_col && ((any >> s) & 1u))
                    ? a_iw[static_cast<size_t>(s) * nw]
                    : 0u;
    }
    for (int v = 0; v < n_vars; ++v) {
      const uint32_t c = cs[v];
      if (c == 0u) continue;
      uint32_t acc = 0u;
#pragma unroll
      for (int s = 0; s < 32; ++s) acc |= ((c >> s) & 1u) ? arow[s] : 0u;
      ys[v * kTile + lane] |= acc;
    }
    __syncwarp();  // the next word rewrites cs
  }
  __syncthreads();

  // OR the warps' accumulators into the first one: thread t alone reads
  // and writes index i of every slice
  for (int i = threadIdx.x; i < n_vars * kTile; i += blockDim.x) {
    uint32_t acc = 0u;
    for (int w = 0; w < n_warps; ++w) acc |= smem[w * stride + i];
    smem[i] = acc;
  }
  __syncthreads();
  return smem;
}

__global__ void bitmm_packed_kernel(const uint8_t* __restrict__ x,
                                    const uint32_t* __restrict__ a,
                                    uint32_t* __restrict__ out, int n_vars,
                                    int n, int nw) {
  extern __shared__ uint32_t smem[];
  const uint32_t* y =
      product_tile(FlagFrontier{x, n}, a, n, nw, n_vars, smem);
  for (int i = threadIdx.x; i < n_vars * kTile; i += blockDim.x) {
    const int jw = blockIdx.x * kTile + (i & 31);
    if (jw < nw) out[static_cast<size_t>(i >> 5) * nw + jw] = y[i];
  }
}

__global__ void bitmm_apply_kernel(const uint32_t* __restrict__ chi,
                                   const uint32_t* __restrict__ a,
                                   const int32_t* __restrict__ flags,
                                   uint32_t* __restrict__ out,
                                   uint32_t* __restrict__ changed, int n_vars,
                                   int n, int nw) {
  extern __shared__ uint32_t smem[];
  const uint32_t* y =
      product_tile(PackedFrontier{chi, nw}, a, n, nw, n_vars, smem);
  // every lane of a warp runs the same number of iterations (V * 32 and
  // blockDim.x are multiples of 32), and the lhs variable l is the same
  // across a warp, so its flags are broadcast reads
  uint32_t delta = 0u;
  for (int i = threadIdx.x; i < n_vars * kTile; i += blockDim.x) {
    const int l = i >> 5;
    const int lane = i & 31;
    const int jw = blockIdx.x * kTile + lane;
    const int32_t* f = flags + static_cast<size_t>(l) * n_vars;
    uint32_t bad = 0u;
    for (int r = 0; r < n_vars; ++r) {
      if (f[r] != 0) bad |= ~y[r * kTile + lane];
    }
    if (jw < nw) {
      const size_t at = static_cast<size_t>(l) * nw + jw;
      const uint32_t old = chi[at];
      const uint32_t nu = old & ~bad;
      out[at] = nu;
      delta |= nu ^ old;
    }
  }
  delta = __reduce_or_sync(kFull, delta);
  if ((threadIdx.x & 31) == 0 && delta != 0u) atomicOr(changed, delta);
}

size_t smem_bytes(int n_vars, int warps) {
  return static_cast<size_t>(warps) * n_vars * (kTile + 1) * sizeof(uint32_t);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Launch on `stream` with `warps` warps per block; returns
// cudaGetLastError() (0 on success).  `out` holds n_vars * nw words.
extern "C" int bitmm_packed_launch(const void* x, const void* a, void* out,
                                   int n_vars, int n, int nw, int warps,
                                   void* stream) {
  const size_t smem = smem_bytes(n_vars, warps);
  int err = prepare(bitmm_packed_kernel, smem);
  if (err != 0) return err;
  const int blocks = (nw + kTile - 1) / kTile;
  if (blocks > 0 && n_vars > 0) {
    bitmm_packed_kernel<<<blocks, warps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(a),
        static_cast<uint32_t*>(out), n_vars, n, nw);
  }
  return static_cast<int>(cudaGetLastError());
}

// As above; `changed` is one word the caller zeroes.
extern "C" int bitmm_apply_launch(const void* chi, const void* a,
                                  const void* flags, void* out, void* changed,
                                  int n_vars, int n, int nw, int warps,
                                  void* stream) {
  const size_t smem = smem_bytes(n_vars, warps);
  int err = prepare(bitmm_apply_kernel, smem);
  if (err != 0) return err;
  const int blocks = (nw + kTile - 1) / kTile;
  if (blocks > 0 && n_vars > 0) {
    bitmm_apply_kernel<<<blocks, warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(chi), static_cast<const uint32_t*>(a),
        static_cast<const int32_t*>(flags), static_cast<uint32_t*>(out),
        static_cast<uint32_t*>(changed), n_vars, n, nw);
  }
  return static_cast<int>(cudaGetLastError());
}
