// The Hopper (sm_90a) core shared by the port's kernels: written for the
// two prefill attention kernels, flash_prefill.cu (row 9) and
// paged_prefill.cu (row 7), and the single-pass prefill,
// prefill_single_pass.cu (row 8); its rings, copies and tensor
// maps also serve decode_attention.cu and quant_gemm.cu.
//
// They compute the same online-softmax tile loop over 64-key K/V tiles
// for a block of 128 query rows: S = Q K^T on the tensor cores, the
// softmax on the S accumulator in registers, then O += P V. They differ
// in how a K/V tile reaches shared memory (TMA of bf16 rows for row 9;
// bulk copies of paged codes, dequantized by a producer warpgroup, for
// row 7, converted to code tiles and corrected per key in registers for
// row 8), so the pieces below are the whole tensor-core side of them:
//
// - wgmma.mma_async m64n64k16, f32 accumulation, bf16 or f16 operands.
//   S = Q K^T reads Q and K from shared memory (K-major descriptors);
//   O += P V takes P from registers, re-packed from the S accumulator (the
//   accumulator fragment of two 8-key column blocks is the A fragment of
//   one 16-key step), and V from shared memory through the transposed-B
//   (MN-major) descriptor, so V is stored as it arrives, token-major.
// - Shared-memory tiles in the 128-byte-swizzled layout that TMA's
//   CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma's B128 descriptors read: a
//   [rows][128] 16-bit tile is two [rows][64] halves (128-byte rows), the
//   16-byte chunk c of row r stored at chunk c ^ (r % 8). Each half is
//   1024-byte aligned. A plain row-major 64 x 128 tile is not a valid
//   wgmma operand in any layout mode.
// - mbarrier helpers for a ring of stages (full: the producer's copies
//   landed; empty: every consumer warp is done with the stage), TMA and
//   bulk copies that complete on an mbarrier (and the host's encoding of
//   128-byte-swizzled tensor maps), setmaxnreg to move registers from the
//   producer warps to the two consumer warpgroups.
// - The online softmax on the accumulator fragments: a row's 64 scores of
//   a tile live in the 4 threads of one quad, so its max and sum reduce
//   with two shuffles.
//
// Head dim 64 (rows 7 and 9): a row is one 128-byte half, so the Q, K and
// V tiles have one half each, QK^T takes 4 k steps and O one m64n64
// accumulator. The helpers below take NH, the halves of a row (2 at head
// dim 128, 1 at 64); at NH = 1 the second accumulator o1 is never touched.
//
// Fragment layout of an m64nN f32 accumulator, for warp w (0-3) of the
// warpgroup, lane = 4 g + t: element 4 nb + e holds row 16 w + g + 8 (e /
// 2), column 8 nb + 2 t + e % 2.

#pragma once

#include <cuda.h>            // CUtensorMap (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int D = 128;          // head dim (rows 7 and 9 also take 64)
constexpr int BM = 128;         // query rows per block: two warpgroups
constexpr int BN = 64;          // keys per K/V tile
constexpr int HALF = BN * 64 * 2;        // bytes of one [64][64] half tile
constexpr int QHALF = BM * 64 * 2;       // bytes of one [128][64] half
constexpr int TILE = 2 * HALF;           // bytes of a [64][128] tile
constexpr int NO_POS = 0x7fffffff;       // a tile row that holds no token
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;          // launchers' per-device setup flags

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed. A pipeline that
// is stuck for ~2^35 cycles (~20 s) traps: the launch then fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// A ring position: stage index and the parity of its current round.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int N>
  __device__ __forceinline__ void advance() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// ---- asynchronous copies ---------------------------------------------------

// 2-D TMA load of one box into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1) : "memory");
}

// bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory; completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operands written with st.shared)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warp specialization -------------------------------------------------

// setmaxnreg acts on a whole warpgroup (a warpgroup of one warp never
// completes it), and .inc draws only on the registers this block's own
// warpgroups gave back with .dec (the block holds entry_regs per thread
// from its launch); an increase the released registers cannot cover waits
// forever. The launchers check the budget against the kernel's entry
// count.
constexpr bool reg_budget_ok(int entry_regs, int n_consumer_threads,
                             int consumer_regs, int n_released_threads_a,
                             int regs_a, int n_released_threads_b = 0,
                             int regs_b = 0) {
  return entry_regs <= consumer_regs && entry_regs >= regs_a &&
         (n_released_threads_b == 0 || entry_regs >= regs_b) &&
         n_consumer_threads * (consumer_regs - entry_regs) <=
             n_released_threads_a * (entry_regs - regs_a) +
                 n_released_threads_b * (entry_regs - regs_b);
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// B128-swizzled shared-memory matrix descriptor. K-major operands (Q, K):
// 8-row groups SBO = 1024 bytes apart, LBO unused; a 16-element k step
// inside the 128-byte row adds 32 bytes to the start address. MN-major
// (V under the transposed-B flag): SBO = 1024 bytes between 8-key groups,
// LBO between 64-column atoms (one atom per n64 operand).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the
// asynchronous wgmma region
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define SM90_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major)
template <bool F16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SM90_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SM90_ACC32(d) : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SM90_ACC32(d) : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d += A (64 x 16 in registers) * B (16 x 64, MN-major in shared memory)
template <bool F16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t a[4],
                                            uint64_t db) {
  if constexpr (F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SM90_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SM90_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SM90_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef SM90_D32
#undef SM90_ACC32

// ---- tensor maps (host) ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map over a row-major [rows, cols] matrix of `type` (rows row_bytes
// apart), boxes of box_rows x box_cols elements (128 bytes a box row) in
// the 128-byte swizzle; reads past the edges give 0. Returns 0 or a
// cudaError_t value.
inline int encode_swizzled(CUtensorMap* map, CUtensorMapDataType type,
                           const void* base, uint64_t cols, uint64_t rows,
                           uint64_t row_bytes, uint32_t box_cols,
                           uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// byte offset of the 16-byte chunk `c` (0-7) of row `r` inside a swizzled
// [rows][64] half tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// The order in which thread (r, dh) of a 128-thread warpgroup writes the
// 8 chunks of its half row (step s -> chunk chunk_order(r, dh) ^ s): each
// quarter-warp (4 rows x 2 halves) reads and writes 8 distinct banks.
__device__ __forceinline__ int chunk_order(int r, int dh) {
  const int u = (r & 3) + 4 * dh;
  return ((u & 1) ? 2 : 0) ^ ((u & 2) ? 3 : 0) ^ ((u & 4) ? 4 : 0);
}

// S = Q K^T for one warpgroup: q_half0/1 point at this warpgroup's 64 rows
// of the two Q halves, k_half0/1 at the K tile's halves (64 keys); NH = 1:
// the first halves only.
template <bool F16, int NH = 2>
__device__ __forceinline__ void qk_tile(float (&s)[32], uint32_t q0,
                                        uint32_t q1, uint32_t k0,
                                        uint32_t k1) {
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NH; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint32_t qa = (kk < 4 ? q0 : q1) + off;
    const uint32_t kb = (kk < 4 ? k0 : k1) + off;
    wgmma_ss<F16>(s, desc_b128(qa, 16, 1024), desc_b128(kb, 16, 1024),
                  kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, bool f16) {
  if (f16) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// O += P V with P packed: a[kk] is the register A operand of keys 16 kk ..
// 16 kk + 15 (a[kk][w] holds accumulator elements 8 kk + 2 w, + 1); v0/v1
// are the V tile's halves (columns 0-63 and 64-127), 64 keys each,
// token-major; NH = 1: v0 and o0 only.
template <bool F16, int NH = 2>
__device__ __forceinline__ void pv_tile_a(float (&o0)[32], float (&o1)[32],
                                          const uint32_t (&a)[4][4],
                                          uint32_t v0, uint32_t v1) {
  fence_regs(o0);
  if constexpr (NH == 2) fence_regs(o1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // keys 16 kk .. 16 kk + 15: rows 16 kk of the token-major halves
    wgmma_rs_tb<F16>(o0, a[kk], desc_b128(v0 + kk * 2048, HALF, 1024));
    if constexpr (NH == 2)
      wgmma_rs_tb<F16>(o1, a[kk], desc_b128(v1 + kk * 2048, HALF, 1024));
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(o0);
  if constexpr (NH == 2) fence_regs(o1);
}

// O += P V: p holds the tile's probabilities in the S accumulator layout
// (rounded here to f16 or bf16).
template <bool F16, int NH = 2>
__device__ __forceinline__ void pv_tile(float (&o0)[32], float (&o1)[32],
                                        const float (&p)[32], uint32_t v0,
                                        uint32_t v1) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2(p[8 * kk + 0], p[8 * kk + 1], F16);
    a[kk][1] = pack2(p[8 * kk + 2], p[8 * kk + 3], F16);
    a[kk][2] = pack2(p[8 * kk + 4], p[8 * kk + 5], F16);
    a[kk][3] = pack2(p[8 * kk + 6], p[8 * kk + 7], F16);
  }
  pv_tile_a<F16, NH>(o0, o1, a, v0, v1);
}

// Online softmax of one tile for this thread's two rows (the scores in s
// already scaled by sm_scale * log2(e), masked entries -inf): updates the
// running max m (log2 domain) and sum l, rescales O, and leaves the
// probabilities exp2(s - m) in s (exactly 0 where masked; all 0 for a row
// with nothing visible yet). NH = 1: o1 is left alone.
template <int NH = 2>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&o0)[32],
                                             float (&o1)[32]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
    const float mn = fmaxf(m[hi], mx[hi]);
    alpha[hi] = mn == -INFINITY ? 1.0f : exp2f(m[hi] - mn);
    m[hi] = mn;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hi = (i >> 1) & 1;
    const float p = m[hi] == -INFINITY ? 0.0f : exp2f(s[i] - m[hi]);
    s[i] = p;
    ps[hi] += p;
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    ps[hi] += __shfl_xor_sync(0xffffffffu, ps[hi], 1);
    ps[hi] += __shfl_xor_sync(0xffffffffu, ps[hi], 2);
    l[hi] = l[hi] * alpha[hi] + ps[hi];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float al = alpha[(i >> 1) & 1];
    o0[i] *= al;
    if constexpr (NH == 2) o1[i] *= al;
  }
}

__device__ __forceinline__ uint32_t sel4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// One output row (hi = 0: row g, 1: row g + 8) as bf16: O / l, or 0 where
// `zero` (padding, or no visible key); stored where `write`. The 4 threads
// of a quad hold 2 of every 8 columns; 4 shuffle rounds hand each thread
// whole 8-column blocks, so the row goes out in 16-byte stores. Every
// lane of the warp calls it (the shuffles span the warp). NH = 1: a
// 64-column row from o0.
template <int NH = 2>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&o0)[32],
                                          const float (&o1)[32], int hi,
                                          float l, bool zero, bool write,
                                          int lane) {
  const int t4 = lane & 3, quad = lane & ~3;
  const float inv = (zero || !(l > 0.0f)) ? 0.0f : 1.0f / l;
  uint32_t pk[8 * NH];   // block b (columns 8 b .. + 7): columns 2 t4, +1
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    pk[nb] = pack2(o0[4 * nb + 2 * hi] * inv, o0[4 * nb + 2 * hi + 1] * inv,
                   false);
    if constexpr (NH == 2)
      pk[8 + nb] = pack2(o1[4 * nb + 2 * hi] * inv,
                         o1[4 * nb + 2 * hi + 1] * inv, false);
  }
#pragma unroll
  for (int grp = 0; grp < 2 * NH; ++grp) {
    // this thread takes block 4 grp + t4: in round k it receives the piece
    // of quad thread (t4 + k) % 4 and sends its own piece of block
    // 4 grp + (t4 - k) % 4 to the thread that takes that block
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t send = sel4(pk[4 * grp], pk[4 * grp + 1],
                                 pk[4 * grp + 2], pk[4 * grp + 3],
                                 (t4 - k) & 3);
      w[k] = __shfl_sync(0xffffffffu, send, quad | ((t4 + k) & 3));
    }
    // the piece of thread s sits in w[(s - t4) % 4]
    const uint4 v = make_uint4(sel4(w[0], w[1], w[2], w[3], (0 - t4) & 3),
                               sel4(w[0], w[1], w[2], w[3], (1 - t4) & 3),
                               sel4(w[0], w[1], w[2], w[3], (2 - t4) & 3),
                               sel4(w[0], w[1], w[2], w[3], (3 - t4) & 3));
    if (write)
      *reinterpret_cast<uint4*>(row + (4 * grp + t4) * 8) = v;
  }
}

}  // namespace sm90
