// Packed boolean products over bit-packed adjacency rows: the product of
// the `packed` engine and the fused sweep step of the `packed_fused` engine.
//
// bitmm_packed_launch replaces src/repro/kernels/bitmm/kernel.py::
// bitmm_packed (Pallas body _bitmm_kernel):
//
//     out[v, jw] = OR_{i < n : x[v, i] != 0} A[i, jw]
//
// with the frontier x given as 0/1 bytes (a bool tensor's storage).
//
// bitmm_apply_launch replaces src/repro/kernels/bitmm/kernel.py::
// bitmm_apply_packed (Pallas body _bitmm_apply_kernel): the same product
// y with the frontier bits read from packed chi (bit i & 31 of word
// i >> 5), then, for every variable l,
//
//     chi'[l, jw] = chi[l, jw] & ~OR_{r : F[l, r] != 0} ~y[r, jw]
//
// and one word, `changed`, that receives the OR of chi' ^ chi over every
// word (nonzero iff any word moved).  ~y sets the pad bits of the last
// word, but chi's pad bits are zero and chi & ~bad keeps them zero.  Words
// are int32 tensors on the host side and are read here as the uint32 bit
// patterns they hold.
//
// Bound on this card.  A launch must read the rows of A that some
// variable selects, the frontier once (V * n bytes for bitmm_packed, V *
// nw words of chi for bitmm_apply_packed, plus F's V * V words), and
// write V * nw words.  It does one word OR for each set frontier bit and
// each of the nw columns.  At the dense tier's largest graph (n = 46,200,
// nw = 1,444) and the serving microbatch's init chi (V = 48, 23,800
// selected rows, 380,800 set bits), that is 0.041 ms of bytes at
// 3.35 TB/s and 0.033 ms of int32 operations: the bytes bound it.
//
// What the product costs besides bytes: each set bit ORs one staged row
// tile out of shared memory, 380,800 bits x 1,444 words x 4 bytes = 2.2 GB
// of shared-memory reads at that shape, 0.066 ms at 128 bytes per clock
// on 132 SMs.  That, not device memory, is where the time goes.
//
// Design.
// 1. The contraction is split across blocks (split-K).  Block (x, y, z)
//    owns a tile of kTile = 128 column words (lane j holds words 4j ..
//    4j + 3, read from shared memory as one vector), a slice of
//    `slice_words` contraction words (32 rows each), and a group of up to
//    kGroup = 64 variables.  The wrapper picks the slice count
//    (kernel.py::geometry) for two blocks per SM, 264 blocks at the shape
//    above.  This tiling was chosen on the card (PERF.md §6): narrower
//    lanes, fewer warps, other ring depths and other block counts per SM
//    were slower.  Each block ORs its partial y into a zeroed [V, nw] word
//    buffer with atomicOr: OR is order-free, so every launch gives the
//    same bits.
// 2. Work follows the set bits.  A block first copies its variables'
//    frontier words of its slice into shared memory, the OR of them per
//    contraction word (`any`), and the list of words some variable
//    touches: other words are skipped, and rows no variable selects are
//    never read.  One producer warp stages the selected rows of each live
//    word into a ring of kStages shared buffers, with one bulk copy (TMA)
//    per row tile where rows are 16-byte aligned (nw a multiple of 4) and
//    with a 4-byte cp.async per word otherwise; a full and an empty
//    mbarrier per buffer hand it to the consumer warps and back, so copies
//    overlap the ORs.  A 16-byte cp.async per lane and row in place of
//    the bulk copies measured 14% slower on the card (PERF.md §6), likely
//    because such copies share the load/store pipe with the consumers'
//    shared-memory reads.  Consumer warp w holds the accumulators of
//    variables w, w + kWarps, ... in registers.
//    For each of its variables it writes the row offsets of the set bits
//    of the frontier word into a list (lane i: bit i and its rank), then
//    ORs those rows four at a time: no select runs for a clear bit, and
//    no load waits on the bit before it.
// 3. bitmm_packed packs its byte frontier into [V, nw] words once per
//    launch (pack_kernel: one ballot per word) and then runs the same
//    product into `out`.  bitmm_apply_packed runs the product into a
//    scratch y, then update_kernel applies the AND-combine: a block per
//    32 columns (times groups of lhs variables) stages ~y of every
//    variable in shared memory ([V, 32] words; the only shared memory
//    that grows with V, so the wrapper refuses a V past the 227 KB a
//    block may use), and the warp of lhs l ballots F[l, :] and ORs ~y
//    only for the set flags.
//
// Tensor cores do not fit this semiring.  A b1 mma.sync (AND + POPC)
// computes a count, needs A packed along the contraction (a transposed
// copy of every operator), and reads every row of A, while this product
// skips the rows no variable selects; at the main-path shape half of A is
// never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// The product's tiling, as kernel.py's WORDS_PER_LANE, WARPS and
// VARS_PER_WARP: column words per lane, consumer warps per block (and one
// producer warp), accumulators per consumer warp; and the ring of staged
// contraction words.
constexpr int kWordsPerLane = 4;
constexpr int kWarps = 8;
constexpr int kVarsPerWarp = 8;
constexpr int kStages = 3;
constexpr int kTile = 32 * kWordsPerLane;  // column words of a block
constexpr int kGroup = kWarps * kVarsPerWarp;  // variables of a block
constexpr int kStage = 32 * kTile;  // words of one staged contraction word
constexpr int kThreads = (kWarps + 1) * 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of one word from global to shared memory.
__device__ __forceinline__ void cp_async_word(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Makes the mbarrier at `bar` receive one arrival once every cp.async this
// thread has issued so far has landed (the arrival counts toward the
// barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory with the Tensor Memory Accelerator; the copy
// counts its bytes against the transaction count of the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One arrival on the mbarrier at `bar` that also expects `bytes` more
// bytes of bulk copies before its phase completes.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits until the phase of the mbarrier at `bar` with parity `parity` has
// completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The kWordsPerLane words at `row` (one vector load from shared memory),
// or zeros when `live` is false (no load issued).
__device__ __forceinline__ void load_row(uint32_t (&r)[kWordsPerLane],
                                         const uint32_t* row, bool live) {
  const uint4 u = live ? *reinterpret_cast<const uint4*>(row)
                       : make_uint4(0u, 0u, 0u, 0u);
  r[0] = u.x;
  r[1] = u.y;
  r[2] = u.z;
  r[3] = u.w;
}

// acc |= the staged rows of the set bits of c (c the same in every lane
// of the warp).  The lanes first write the offsets of the set bits' rows
// into the warp's list `lst` in order (lane i holds bit i and its rank
// among the set bits), so the ORs that follow read independent offsets
// instead of popping bits one after another; four rows a step, the
// missing ones of the last step skipped.  `lst` is 16-byte aligned.
__device__ __forceinline__ void or_set_rows(uint32_t (&acc)[kWordsPerLane],
                                            uint32_t c, const uint32_t* staged,
                                            uint32_t* lst, int lane) {
  if (c == 0u) return;
  if ((c >> lane) & 1u) lst[__popc(c & ((1u << lane) - 1u))] = lane * kTile;
  __syncwarp();
  const int count = __popc(c);
  for (int i = 0; i < count; i += 4) {
    const uint4 at = *reinterpret_cast<const uint4*>(lst + i);
    uint32_t r0[kWordsPerLane], r1[kWordsPerLane], r2[kWordsPerLane],
        r3[kWordsPerLane];
    load_row(r0, staged + at.x, true);
    load_row(r1, staged + at.y, i + 1 < count);
    load_row(r2, staged + at.z, i + 2 < count);
    load_row(r3, staged + at.w, i + 3 < count);
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      acc[q] |= r0[q] | r1[q] | r2[q] | r3[q];
    }
  }
  __syncwarp();  // the list is rewritten for the next word
}

// Partial y of one (column tile, contraction slice, variable group),
// ORed into y [V, nw] with atomicOr.  xw is the packed frontier [V, nw].
// The block is kWarps consumer warps and one producer warp (the last).
// Shared memory (product_smem): kStages row buffers [32][kTile], a full
// and an empty mbarrier per buffer, one list of 32 row offsets per
// consumer warp, the frontier words [min(V, kGroup)][slice_words], `any`
// [slice_words] and the live contraction words [slice_words].  `bulk`:
// A's row tiles are 16-byte aligned (nw a multiple of 4), and one
// producer thread stages each with one bulk copy; otherwise every
// producer lane copies its four words one at a time with cp.async.
__global__ void __launch_bounds__(kThreads, 2)
    product_kernel(const uint32_t* __restrict__ xw,
                   const uint32_t* __restrict__ a, uint32_t* __restrict__ y,
                   int n_vars, int n, int nw, int slice_words, int bulk) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int n_live;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v0 = blockIdx.z * kGroup;
  const int nv = min(kGroup, n_vars - v0);
  const int iw0 = blockIdx.y * slice_words;
  const int nk = min(slice_words, nw - iw0);  // >= 1: no slice is empty
  const int col = blockIdx.x * kTile + lane * kWordsPerLane;

  uint32_t* rows = smem;  // [kStages][32][kTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint32_t* lst = reinterpret_cast<uint32_t*>(empty + kStages) + warp * 32;
  uint32_t* fr = reinterpret_cast<uint32_t*>(empty + kStages) + kWarps * 32;
  uint32_t* any = fr + min(n_vars, kGroup) * slice_words;
  int* live = reinterpret_cast<int*>(any + slice_words);

  if (threadIdx.x == 0) {
    for (int b = 0; b < kStages; ++b) {
      // the producer thread's arrival and the bytes of its bulk copies, or
      // every producer lane once its copies land
      mbar_init(&full[b], bulk ? 1 : 32);
      mbar_init(&empty[b], kWarps);  // every consumer warp, once it has ORed
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this group's frontier words of the slice, bits past n masked off
  // (unrolled so that several loads are in flight)
  const uint32_t last = (n & 31) ? ((1u << (n & 31)) - 1u) : kFull;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv * nk; i += blockDim.x) {
    const int vl = i / nk;
    const int k = i - vl * nk;
    uint32_t w = xw[static_cast<size_t>(v0 + vl) * nw + iw0 + k];
    if (iw0 + k == nw - 1) w &= last;
    fr[vl * slice_words + k] = w;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
    uint32_t u = 0u;
    for (int vl = 0; vl < nv; ++vl) u |= fr[vl * slice_words + k];
    any[k] = u;
  }
  __syncthreads();
  if (warp == 0) {  // the contraction words some variable touches, in order
    int count = 0;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const int k = k0 + lane;
      const bool on = k < nk && any[k] != 0u;
      const uint32_t mask = __ballot_sync(kFull, on);
      if (on) live[count + __popc(mask & ((1u << lane) - 1u))] = k;
      count += __popc(mask);
    }
    if (lane == 0) n_live = count;
  }
  __syncthreads();
  const int nl = n_live;

  // A ring of kStages buffers: live word t goes to buffer t % kStages.
  // The producer refills a buffer once every consumer warp has released
  // it (empty), the consumers OR a buffer once all its copies landed
  // (full); use u of a buffer completes phase u of both barriers.
  if (warp == kWarps) {  // the producer: stage the rows some variable selects
    for (int t = 0; t < nl; ++t) {
      const int b = t % kStages;
      if (t >= kStages) mbar_wait(&empty[b], ((t / kStages) - 1) & 1);
      const int k = live[t];
      uint32_t sel = any[k];
      const uint32_t* row0 = a + static_cast<size_t>(iw0 + k) * 32 * nw;
      uint32_t* buf = rows + b * kStage;
      if (bulk) {
        if (lane == 0) {
          const int c0 = blockIdx.x * kTile;
          const unsigned bytes = 4u * min(kTile, nw - c0);
          mbar_arrive_expect(&full[b], bytes * __popc(sel));
          while (sel != 0u) {
            const int s = __ffs(sel) - 1;
            sel &= sel - 1u;
            bulk_copy(buf + s * kTile, row0 + static_cast<size_t>(s) * nw + c0,
                      bytes, &full[b]);
          }
        }
        continue;
      }
      while (sel != 0u) {
        const int s = __ffs(sel) - 1;
        sel &= sel - 1u;
        const uint32_t* src = row0 + static_cast<size_t>(s) * nw + col;
        uint32_t* dst = buf + s * kTile + lane * kWordsPerLane;
#pragma unroll
        for (int j = 0; j < kWordsPerLane; ++j) {
          if (col + j < nw) cp_async_word(dst + j, src + j);
        }
      }
      cp_async_arrive(&full[b]);
    }
    return;
  }

  uint32_t acc[kVarsPerWarp][kWordsPerLane];
#pragma unroll
  for (int j = 0; j < kVarsPerWarp; ++j) {
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) acc[j][q] = 0u;
  }
  for (int t = 0; t < nl; ++t) {
    const int b = t % kStages;
    const int k = live[t];
    uint32_t cs[kVarsPerWarp];  // this warp's frontier words, all loads first
#pragma unroll
    for (int j = 0; j < kVarsPerWarp; ++j) {
      const int vl = warp + j * kWarps;  // the same in every lane of the warp
      cs[j] = vl < nv ? fr[vl * slice_words + k] : 0u;
    }
    mbar_wait(&full[b], (t / kStages) & 1);
    const uint32_t* staged = rows + b * kStage + lane * kWordsPerLane;
#pragma unroll
    for (int j = 0; j < kVarsPerWarp; ++j) {
      or_set_rows(acc[j], cs[j], staged, lst, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[b]);
  }

#pragma unroll
  for (int j = 0; j < kVarsPerWarp; ++j) {
    const int vl = warp + j * kWarps;
    if (vl >= nv) continue;
    uint32_t* dst = y + static_cast<size_t>(v0 + vl) * nw + col;
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      if (col + q < nw && acc[j][q] != 0u) atomicOr(dst + q, acc[j][q]);
    }
  }
}

// xw[v, iw] = the 32 bytes x[v, 32 * iw ..] as bits, one ballot per word.
__global__ void pack_kernel(const uint8_t* __restrict__ x,
                            uint32_t* __restrict__ xw, int n_vars, int n,
                            int nw) {
  const int lane = threadIdx.x & 31;
  const long long total = static_cast<long long>(n_vars) * nw;
  const long long step = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       w < total; w += step) {  // the same trip count in every lane
    const int v = static_cast<int>(w / nw);
    const int row = static_cast<int>(w - static_cast<long long>(v) * nw) * 32 +
                    lane;
    const bool bit = row < n && x[static_cast<size_t>(v) * n + row] != 0;
    const uint32_t word = __ballot_sync(kFull, bit);
    if (lane == 0) xw[w] = word;
  }
}

// chi' and `changed` from the finished y: block (x, y) owns columns
// [32 x, 32 x + 32) and every gridDim.y-th group of `warps` lhs variables.
// Shared memory: ~y of every variable over the block's columns, [V][32].
__global__ void update_kernel(const uint32_t* __restrict__ chi,
                              const uint32_t* __restrict__ y,
                              const int32_t* __restrict__ flags,
                              uint32_t* __restrict__ out,
                              uint32_t* __restrict__ changed, int n_vars,
                              int nw) {
  extern __shared__ uint32_t not_y[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int jw = blockIdx.x * 32 + lane;
  const bool live = jw < nw;
  for (int r = warp; r < n_vars; r += warps) {
    not_y[r * 32 + lane] = live ? ~y[static_cast<size_t>(r) * nw + jw] : 0u;
  }
  __syncthreads();
  uint32_t delta = 0u;
  for (int l = blockIdx.y * warps + warp; l < n_vars;
       l += gridDim.y * warps) {  // l is the same in every lane of a warp
    const int32_t* f = flags + static_cast<size_t>(l) * n_vars;
    uint32_t bad = 0u;
    for (int r0 = 0; r0 < n_vars; r0 += 32) {
      uint32_t set = __ballot_sync(kFull, r0 + lane < n_vars && f[r0 + lane] != 0);
      while (set != 0u) {
        const int s = __ffs(set) - 1;
        set &= set - 1u;
        bad |= not_y[(r0 + s) * 32 + lane];
      }
    }
    if (live) {
      const size_t at = static_cast<size_t>(l) * nw + jw;
      const uint32_t old = chi[at];
      const uint32_t nu = old & ~bad;
      out[at] = nu;
      delta |= nu ^ old;
    }
  }
  delta = __reduce_or_sync(kFull, delta);
  if (lane == 0 && delta != 0u) atomicOr(changed, delta);
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  }
  return 0;
}

int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }

// product_kernel's dynamic shared memory, bytes (kernel.py's MAX_SLICE_WORDS
// keeps it under 84 KB).
int product_smem(int n_vars, int slice_words) {
  return 4 * kStages * kStage + 2 * 8 * kStages + 4 * 32 * kWarps +
         4 * ((n_vars < kGroup ? n_vars : kGroup) + 2) * slice_words;
}

// The product into y (zeroed first): cdiv(nw, kTile) column tiles x
// cdiv(nw, slice_words) contraction slices x cdiv(V, kGroup) groups.
int launch_product(const uint32_t* xw, const uint32_t* a, uint32_t* y,
                   int n_vars, int n, int nw, int slice_words,
                   cudaStream_t stream) {
  const int bulk =
      (reinterpret_cast<uintptr_t>(a) % 16 == 0 && nw % 4 == 0) ? 1 : 0;
  const int smem = product_smem(n_vars, slice_words);
  const int err = prepare(product_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(cdiv(nw, kTile), cdiv(nw, slice_words), cdiv(n_vars, kGroup));
  product_kernel<<<grid, kThreads, smem, stream>>>(xw, a, y, n_vars, n, nw,
                                                   slice_words, bulk);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kUpdateWarps = 8;
constexpr int kPackThreads = 256;

}  // namespace

// Both entry points launch on `stream` without synchronising and return
// cudaGetLastError() (0 on success).  The contraction slice's words come
// from kernel.py::geometry and `sms` is the card's SM count; the caller
// skips the launch when V or nw is 0 and refuses a V whose [V, 32] words
// of ~y pass the shared memory of a block.

// out [V, nw], zeroed here; xw [V, nw] scratch for the packed frontier.
extern "C" int bitmm_packed_launch(const void* x, const void* a, void* xw,
                                   void* out, int n_vars, int n, int nw,
                                   int slice_words, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = static_cast<long long>(n_vars) * nw;
  int err = static_cast<int>(cudaMemsetAsync(out, 0, words * 4, s));
  if (err != 0) return err;
  const int want = cdiv(words, kPackThreads / 32);
  const int blocks = want < 16 * sms ? want : 16 * sms;
  pack_kernel<<<blocks, kPackThreads, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<uint32_t*>(xw), n_vars, n,
      nw);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_product(static_cast<const uint32_t*>(xw),
                        static_cast<const uint32_t*>(a),
                        static_cast<uint32_t*>(out), n_vars, n, nw,
                        slice_words, s);
}

// y [V, nw] scratch and `changed` (one word), both zeroed here; chi' into
// out.  The update runs on ceil(nw / 32) column blocks times enough groups
// of lhs variables to give two blocks per SM, each group reloading ~y.
extern "C" int bitmm_apply_launch(const void* chi, const void* a,
                                  const void* flags, void* y, void* out,
                                  void* changed, int n_vars, int n, int nw,
                                  int slice_words, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaMemsetAsync(
      y, 0, static_cast<size_t>(n_vars) * nw * 4, s));
  if (err == 0) err = static_cast<int>(cudaMemsetAsync(changed, 0, 4, s));
  if (err != 0) return err;
  err = launch_product(static_cast<const uint32_t*>(chi),
                       static_cast<const uint32_t*>(a),
                       static_cast<uint32_t*>(y), n_vars, n, nw, slice_words,
                       s);
  if (err != 0) return err;
  const int update_smem = n_vars * 32 * 4;
  err = prepare(update_kernel, update_smem);
  if (err != 0) return err;
  const int cols = cdiv(nw, 32);
  const int most = cdiv(n_vars, kUpdateWarps);
  const int want = cdiv(2LL * sms, cols);
  const dim3 grid(cols, want < most ? want : most);
  update_kernel<<<grid, kUpdateWarps * 32, update_smem, s>>>(
      static_cast<const uint32_t*>(chi), static_cast<const uint32_t*>(y),
      static_cast<const int32_t*>(flags), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(changed), n_vars, nw);
  return static_cast<int>(cudaGetLastError());
}
