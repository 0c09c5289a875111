// W4A8 per-channel, W4A8 per-group and W8A8 GEMMs for Hopper (sm_90a),
// int8 tensor cores.
//
// Replaces the TPU kernels omniserve_tpu/ops/pallas/quant_matmul.py:
//   w4a8_matmul_per_channel (:151, kernel _per_chn_kernel :106),
//   w4a8_matmul_per_group   (:281, kernel _per_group_kernel :233) and
//   w8a8_matmul             (:406, kernel _w8a8_kernel :379).
//
// Contract (omniserve_tpu_torch/ops/matmul.py *_ref):
//   W4: qweight [K/2, N] uint8, half-split packed: byte[k, n] holds
//       w[k, n] in its low nibble and w[k + K/2, n] in its high nibble.
//       per channel: psum = a[:, :K/2] @ lo + a[:, K/2:] @ hi     (int32)
//                    out  = psum * s1[n] * a_scale[m] - s1_szero[n] * a_sum[m]
//       per group g of G input channels (s2, s2_zero [K/G, N] int8):
//                    w_i8 = wrap_int8(w_u4 * s2[g, n] + s2_zero[g, n])
//                    out  = (a @ w_i8) * s1[n] * a_scale[m]
//       where the low half's k sits in group k / G and the high half's
//       k + K/2 in group K/2/G + k / G.
//   W8: qweight [K, N] int8;  out = psum * w_scale[n] * a_scale[m]
//
// What bounds them: at decode M (a handful of rows) the weight bytes (bytes
// bound: 4 or 8 bits per weight); at prefill M (thousands of rows) the int8
// tensor-core rate.
//
// One body serves all three (int8_wgmma_kernel, template MODE: kW4Channel,
// kW8, kW4Group): a producer warp keeps a ring of mbarrier-guarded TMA
// copies in flight (the reference layout as it is: a 128-row x 128-byte box
// of weight rows per consumer warpgroup, and the activation rows as K-major
// boxes, both K halves for W4, all in the 128-byte swizzle), and consumer
// warpgroups run int8 wgmma (m64nNk32 .s32.s8.s8) with the operands
// swapped: out^T = W^T a^T, the weights the register A operand (64 output
// channels a wgmma), the activations the shared-memory B operand (N = the
// block's M tile). Each consumer thread loads the weight bytes it needs once
// (32-bit words, 4 k rows of 4 channels) and transposes them 4 x 4 in
// registers so each word holds 4 k of one channel:
//   - W8: the words are the A fragment as they are; a 32-deep k step issues
//     two wgmma, one per m64 tile of channels;
//   - W4 per channel: each word is split once into the low-half and
//     high-half nibbles: one loaded byte feeds one wgmma against the low K
//     half's activations and one against the high half's (four a step);
//   - W4 per group: as per channel, then each split word is dequantized
//     progressively: its four bytes are four u4 codes of one channel in one
//     group (G % 32 == 0, so a 32-deep k step never straddles groups), so
//     one 32-bit multiply by s2 scales all four (each product <= 15 * 17 =
//     255: no carry crosses a byte; the derived quantizer never gives s2 >
//     17) and __vadd4 adds the zero bytewise, wrapping mod 256 exactly as
//     the int8 cast of the reference. The producer copies each stage's s2
//     and zero rows (the groups its 128 rows touch, both K halves) into the
//     stage with four small TMA boxes, so no consumer waits on device
//     memory in the inner loop; a thread's 4 channels are adjacent, so one
//     32-bit shared load gives their four s2 (or zero) bytes. Its step runs
//     as two half steps (the low K half's two wgmma, then the high half's),
//     each on 8 A registers: a thread of 288 gets at most 168 registers,
//     and one 16-register buffer a step spilled 108 bytes at two
//     warpgroups (the half steps: 60; quarter steps on 4 registers: 88,
//     and slower on an H100).
// A thread's 4 channels are rows g and g + 8 of two m64 tiles, so its
// epilogue writes 4 adjacent channels. Two bodies of that kernel, chosen by
// M in ops/cuda/quant_matmul.gemm_plan (from the mode, M, N, K and the SM
// count only, so a captured launch keeps its grid):
//   - decode (M <= 128): one consumer warpgroup, 128 channels x an M tile of
//     32, 64 or 128 rows; K (its stages of 128 weight rows) is split over the
//     blocks of a cluster (at most 8) so that about one wave of resident
//     blocks covers the SMs (at an M tile of 128 whose channel tiles alone
//     fill that wave, the prefill body's two warpgroups instead: each
//     activation tile then serves 256 channels). The split stays exact:
//     each block keeps its int32 partial, the cluster sums them through
//     distributed shared memory (integer sums: any order gives the same
//     bits) and only then applies the one f32 epilogue, so the output
//     equals the plain version's, and a replayed graph the eager call;
//   - prefill (M > 128): two consumer warpgroups sharing each activation
//     tile, a 256-channel x 128-row block tile, no split; blocks walk the M
//     tiles of one channel tile first (its weights stay in L2).
// The TMA boxes need rows of a multiple of 16 bytes (N % 16 == 0). W8 and
// per group at N % 16 != 0 (no shape of a supported model: Llama-3-8B's N
// are 6,144, 4,096, 28,672 and 128,256, Llama-2's and Mistral's vocab
// 32,000, Qwen2's 152,064) take quant_gemm_kernel instead, picked by that
// shape alone: one block computes a BM x BN output tile with mma.sync
// m16n8k32 (s8 x s8 -> s32), weight tiles read with synchronous loads,
// transposed 4x4 bytes in registers into a k-contiguous shared-memory tile,
// the W4 nibbles split and dequantized as above right before each mma; two
// tile shapes, 16 x 32 for M <= 16, 128 x 128 for larger M.
//
// Built with --fmad=false so the f32 epilogues round exactly as the plain
// PyTorch versions do.

#include <cooperative_groups.h>

#include "attn_sm90.cuh"   // mbarriers, TMA, wgmma descriptors

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// in[r] holds bytes (row r, col 0..3); out[c] gets bytes (row 0..3, col c).
__device__ __forceinline__ void transpose4x4(const uint32_t (&in)[4],
                                             uint32_t (&out)[4]) {
  uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
  uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
  uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

enum Mode { kW8 = 0, kW4Channel = 1, kW4Group = 2 };

// A [M, K] int8 row-major; W: W4 -> [K/2, N] packed, W8 -> [K, N] int8.
// KW = rows of W (K/2 or K) must be a multiple of BK; N a multiple of 4;
// per group, G % 32 == 0 and (K/2) % G == 0.
template <int BM, int BN, int BK, int WM, int WN, int MODE, typename OutT>
__global__ void __launch_bounds__(WM * WN * 32)
    quant_gemm_kernel(const int8_t* __restrict__ A,
                      const uint8_t* __restrict__ W,
                      const float* __restrict__ w_scale,
                      const int8_t* __restrict__ s2,
                      const int8_t* __restrict__ s2_zero,
                      const float* __restrict__ a_scale,
                      OutT* __restrict__ out, int M, int N, int K, int G) {
  constexpr bool W4 = MODE != kW8;
  constexpr bool GROUP = MODE == kW4Group;
  constexpr int NTHREADS = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int NA = W4 ? 2 : 1;   // A tiles per step: K halves for W4
  constexpr int AS = BK + 16;      // A row stride in bytes (bank spread)
  constexpr int BS = BK / 4 + 4;   // B row stride in 32-bit words
  constexpr int KC = BK / 32;      // 32-deep k chunks per tile
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 32 == 0, "tile");

  __shared__ __align__(16) int8_t As[NA][BM][AS];
  __shared__ uint32_t Bs[BN][BS];
  // per group: s2 (0..255) and the zero byte replicated 4x, per K half,
  // k chunk and column of the tile
  constexpr int GS = GROUP ? 1 : 0;
  __shared__ uint32_t S2s[1 + GS][GROUP ? KC : 1][GROUP ? BN : 1];
  __shared__ uint32_t Zs[1 + GS][GROUP ? KC : 1][GROUP ? BN : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KW = W4 ? K / 2 : K;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < KW; k0 += BK) {
    // activations: BM rows x BK bytes per K half, 16 bytes per load
    constexpr int ACH = BM * (BK / 16);
    for (int i = tid; i < NA * ACH; i += NTHREADS) {
      const int half = i / ACH, r = (i % ACH) / (BK / 16);
      const int c = (i % (BK / 16)) * 16;
      const int m = m0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M)
        v = *reinterpret_cast<const int4*>(A + (size_t)m * K + half * KW +
                                           k0 + c);
      *reinterpret_cast<int4*>(&As[half][r][c]) = v;
    }
    // weights: 4x4-byte blocks, transposed so each word holds 4 k of one n
    constexpr int BU = (BK / 4) * (BN / 4);
    for (int u = tid; u < BU; u += NTHREADS) {
      const int kq = u / (BN / 4), nq = u % (BN / 4);
      const int n = n0 + nq * 4;
      uint32_t in[4], o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        in[r] = n < N ? *reinterpret_cast<const uint32_t*>(
                            W + (size_t)(k0 + kq * 4 + r) * N + n)
                      : 0u;
      transpose4x4(in, o);
#pragma unroll
      for (int c = 0; c < 4; ++c) Bs[nq * 4 + c][kq] = o[c];
    }
    if constexpr (GROUP) {
      const int groups_per_half = KW / G;
      for (int i = tid; i < 2 * KC * BN; i += NTHREADS) {
        const int half = i / (KC * BN), c = (i / BN) % KC, nn = i % BN;
        const int n = n0 + nn;
        uint32_t sc = 0u, zr = 0u;
        if (n < N) {
          const size_t gi =
              (size_t)(half * groups_per_half + (k0 + c * 32) / G);
          sc = (uint8_t)s2[gi * N + n];
          zr = (uint8_t)s2_zero[gi * N + n] * 0x01010101u;
        }
        S2s[half][c][nn] = sc;
        Zs[half][c][nn] = zr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t bw[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * WTN + nt * 8 + g;
        bw[nt][0] = Bs[n][kk / 4 + tig];
        bw[nt][1] = Bs[n][kk / 4 + 4 + tig];
      }
#pragma unroll
      for (int half = 0; half < NA; ++half) {
        // this half's B words: nibbles split (W4) and dequantized (group)
        uint32_t bh[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b0 = bw[nt][0], b1 = bw[nt][1];
          if (W4) {
            b0 = (half ? b0 >> 4 : b0) & 0x0F0F0F0Fu;
            b1 = (half ? b1 >> 4 : b1) & 0x0F0F0F0Fu;
          }
          if constexpr (GROUP) {
            const int nl = wn * WTN + nt * 8 + g;
            const uint32_t sc = S2s[half][kk / 32][nl];
            const uint32_t zr = Zs[half][kk / 32][nl];
            b0 = __vadd4(b0 * sc, zr);
            b1 = __vadd4(b1 * sc, zr);
          }
          bh[nt][0] = b0;
          bh[nt][1] = b1;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wm * WTM + mt * 16 + g;
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(&As[half][r][kk + tig * 4]);
          af[1] = *reinterpret_cast<const uint32_t*>(&As[half][r + 8][kk + tig * 4]);
          af[2] = *reinterpret_cast<const uint32_t*>(&As[half][r][kk + 16 + tig * 4]);
          af[3] = *reinterpret_cast<const uint32_t*>(&As[half][r + 8][kk + 16 + tig * 4]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_s8(acc[mt][nt], af, bh[nt][0], bh[nt][1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * WTM + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * WTN + nt * 8 + tig * 2 + (e & 1);
        if (m < M && n < N) {
          const float p = (float)acc[mt][nt][e];
          store_out(out + (size_t)m * N + n, p * w_scale[n] * a_scale[m]);
        }
      }
}

template <int MODE, typename OutT>
int launch(const void* a, const void* w, const void* ws, const void* s2,
           const void* s2z, const void* as, void* out, int M, int N, int K,
           int G, cudaStream_t stream) {
  const int8_t* A = static_cast<const int8_t*>(a);
  const uint8_t* Wt = static_cast<const uint8_t*>(w);
  const float* fs = static_cast<const float*>(ws);
  const int8_t* g2 = static_cast<const int8_t*>(s2);
  const int8_t* g2z = static_cast<const int8_t*>(s2z);
  const float* fa = static_cast<const float*>(as);
  OutT* o = static_cast<OutT*>(out);
  if (M <= 16) {
    constexpr int BM = 16, BN = 32, BK = 128;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    quant_gemm_kernel<BM, BN, BK, 1, 4, MODE, OutT><<<grid, 128, 0, stream>>>(
        A, Wt, fs, g2, g2z, fa, o, M, N, K, G);
  } else {
    constexpr int BM = 128, BN = 128, BK = 64;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    quant_gemm_kernel<BM, BN, BK, 2, 4, MODE, OutT><<<grid, 256, 0, stream>>>(
        A, Wt, fs, g2, g2z, fa, o, M, N, K, G);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The int8 wgmma body: int8_wgmma_kernel (see the header for the design).
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int CH_RK = 128;              // weight rows a stage holds
constexpr int CH_NW = 128;              // output channels of a warpgroup
constexpr int CH_WTILE = CH_RK * CH_NW;  // bytes of a warpgroup's weight box
constexpr int CH_MAX_SPLIT = 8;         // blocks of a cluster (portable)
constexpr int GS_ROWS = CH_RK / 32;     // per group: s2 / zero rows a box

// A stage: NWG weight boxes, then the activation boxes (both K halves for
// W4), then per group four boxes of GS_ROWS x NWG * 128 bytes (s2 of the
// low half, s2 of the high half, zeros of the low half, of the high half)
template <int MODE, int MT, int NWG>
__host__ __device__ constexpr int stage_bytes() {
  return NWG * CH_WTILE + (MODE == kW8 ? 1 : 2) * MT * 128 +
         (MODE == kW4Group ? 4 * GS_ROWS * NWG * CH_NW : 0);
}
// ring depth by mode and tile, each the fastest of 2-6 stages in turns on
// an H100 at the main path's shapes (M = 8, 128, 8192; the M tile of 64,
// off that path, untimed): per channel 4 stages at an M tile of 128 and 32
// beat 2 and 3; W8 and per group run best on shallower rings (2 at M=8,
// two warpgroups at 3 and 2 stages)
template <int MODE, int MT, int NWG>
__host__ __device__ constexpr int ring_depth() {
  if (MODE == kW4Channel) return NWG == 2 ? 3 : MT == 64 ? 3 : 4;
  if (MODE == kW8) return NWG == 2 ? 3 : MT == 32 ? 2 : MT == 64 ? 3 : 4;
  return NWG == 2 ? 2 : MT == 32 ? 2 : 3;    // per group
}
template <int MODE, int MT, int NWG>
__host__ __device__ constexpr int smem_bytes() {
  return ring_depth<MODE, MT, NWG>() * stage_bytes<MODE, MT, NWG>() +
         1024;   // + alignment slack
}
// the int32 partial of a split block: [MT][NWG * CH_NW + 4] (padded rows)
template <int NWG>
__host__ __device__ constexpr int ch_partial_stride() {
  return NWG * CH_NW + 4;
}

template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};
// keep the compiler from moving register accesses across the asynchronous
// wgmma region (accumulators), or reusing A registers a wgmma in flight
// still reads
template <int N>
__device__ __forceinline__ void keep_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// byte offset of word q (bytes 4q..4q+3) of row k in a 128-byte-swizzled
// box of 128-byte rows
__device__ __forceinline__ uint32_t swz_word(int k, int q) {
  return static_cast<uint32_t>(k * 128 + ((((q >> 2) ^ (k & 7))) << 4) +
                               ((q & 3) << 2));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// out[m, n .. n+3] from their int32 sums, in the plain version's op order
// (s1 is w_scale for W8; s1_szero and a_sum are read per channel only)
template <int MODE, typename OutT>
__device__ __forceinline__ void gemm_epilogue(
    OutT* __restrict__ out, const int (&p)[4], const float* __restrict__ s1,
    const float* __restrict__ s1_szero, const float* __restrict__ a_scale,
    const float* __restrict__ a_sum, int m, int n, int N) {
  const float4 sc = *reinterpret_cast<const float4*>(s1 + n);
  const float scs[4] = {sc.x, sc.y, sc.z, sc.w};
  const float as = a_scale[m];
  float v[4];
  if constexpr (MODE == kW4Channel) {
    const float4 sz = *reinterpret_cast<const float4*>(s1_szero + n);
    const float szs[4] = {sz.x, sz.y, sz.z, sz.w};
    const float am = a_sum[m];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (float)p[i] * scs[i] * as - szs[i] * am;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)p[i] * scs[i] * as;
  }
  store4(out + (size_t)m * N + n, v);
}

// Block (M tile x, channel tile y, split z): channels [y * NWG * 128, +NWG *
// 128), rows [x * MT, +MT), weight rows [z * per_split * 128, ...) (of each
// K half for W4). Threads: NWG consumer warpgroups, then the producer warp.
// A [M, K] int8 (amap: boxes 128 k x MT rows), W [KW, N] with KW = K/2 (W4)
// or K (W8) (wmap: boxes 128 channels x 128 rows), per group s2 / s2_zero
// [K/G, N] int8 (s2map / zmap: boxes NWG * 128 channels x min(4, K/G)
// rows; the other modes get amap there, unused); s1 is w_scale for W8, and
// s1_szero / a_sum are read per channel only. KW % 128 == 0, N % 16 == 0,
// per group G % 32 == 0 and (K/2) % G == 0 (checked by the launcher).
template <int MODE, int MT, int NWG, int NSTAGE, typename OutT>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) int8_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap s2map,
    const __grid_constant__ CUtensorMap zmap,
    const float* __restrict__ s1, const float* __restrict__ s1_szero,
    const float* __restrict__ a_scale, const float* __restrict__ a_sum,
    OutT* __restrict__ out, int M, int N, int K, int G, int per_split) {
  constexpr bool W4 = MODE != kW8;
  constexpr bool GROUP = MODE == kW4Group;
  constexpr bool ZERO = MODE == kW4Channel;          // the a_sum term
  constexpr int NA = W4 ? 2 : 1;                     // activation boxes
  constexpr int NC = NWG * 128;                      // consumer threads
  constexpr int CW = NWG * CH_NW;                    // channels of a block
  constexpr int SB = stage_bytes<MODE, MT, NWG>();
  constexpr int A_OFF = NWG * CH_WTILE;              // activation boxes
  constexpr int S_OFF = A_OFF + NA * MT * 128;       // per group: scales
  constexpr int SBOX = GS_ROWS * CW;                 // bytes of a scale box
  constexpr int PS = ch_partial_stride<NWG>();
  constexpr int NACC = MT / 2;                       // accumulators a tile
  static_assert(SB % 1024 == 0, "stages keep the 1024-byte swizzle atom");
  static_assert(MT * PS * 4 <= NSTAGE * SB, "partial fits the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[NSTAGE], empty[NSTAGE];
  // split: the epilogue's scales, staged while the main loop runs
  __shared__ __align__(16) float ep_s1[CW], ep_sz[CW];
  __shared__ float ep_as[MT], ep_am[MT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * CW;
  const int kw = W4 ? K / 2 : K;                     // weight rows
  const int it0 = blockIdx.z * per_split;
  const int n_it = min(kw / CH_RK, it0 + per_split) - it0;
  const int S = gridDim.z;
  // per group: groups of a K half, and the rows each scale box lands
  const int g_half = GROUP ? kw / G : 0;
  const int g_rows = GROUP ? min(GS_ROWS, K / G) : 0;
  const uint32_t tx = A_OFF + NA * MT * 128 + (GROUP ? 4 * g_rows * CW : 0);
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      sm90::mbar_init(&full[st], 1);      // the producer (+ bytes)
      sm90::mbar_init(&empty[st], NC);    // every consumer thread
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == NC / 32) {
    // producer: one lane keeps the ring full, the others stage a split's
    // epilogue scales; the warp stays for the cluster's barriers below
    if (lane > 0 && S > 1) {
      for (int i = lane - 1; i < CW; i += 31) {
        const bool ok = n0 + i < N;
        ep_s1[i] = ok ? s1[n0 + i] : 0.0f;
        ep_sz[i] = ok && ZERO ? s1_szero[n0 + i] : 0.0f;
      }
      for (int i = lane - 1; i < MT; i += 31) {
        const bool ok = m0 + i < M;
        ep_as[i] = ok ? a_scale[m0 + i] : 0.0f;
        ep_am[i] = ok && ZERO ? a_sum[m0 + i] : 0.0f;
      }
    }
    if (lane == 0) {
      sm90::Ring rg;
      for (int it = 0; it < n_it; ++it) {
        const int st = rg.stage;
        sm90::mbar_wait(&empty[st], rg.phase ^ 1u);
        unsigned char* sb = smem + st * SB;
        sm90::mbar_arrive_tx(&full[st], tx);
        const int kp = (it0 + it) * CH_RK;
#pragma unroll
        for (int c = 0; c < NWG; ++c)
          sm90::tma_load_2d(sb + c * CH_WTILE, &wmap, &full[st],
                            n0 + c * CH_NW, kp);
        sm90::tma_load_2d(sb + A_OFF, &amap, &full[st], kp, m0);
        if constexpr (W4)
          sm90::tma_load_2d(sb + A_OFF + MT * 128, &amap, &full[st], kw + kp,
                            m0);
        if constexpr (GROUP) {
          const int g0 = kp / G;    // the first group the stage touches
          sm90::tma_load_2d(sb + S_OFF, &s2map, &full[st], n0, g0);
          sm90::tma_load_2d(sb + S_OFF + SBOX, &s2map, &full[st], n0,
                            g_half + g0);
          sm90::tma_load_2d(sb + S_OFF + 2 * SBOX, &zmap, &full[st], n0, g0);
          sm90::tma_load_2d(sb + S_OFF + 3 * SBOX, &zmap, &full[st], n0,
                            g_half + g0);
        }
        rg.advance<NSTAGE>();
      }
    }
  }

  // consumer thread (warpgroup c, warp w, lane 4 g + t): the weight words
  // of column q = 8 w + g (channels 4q .. 4q+3 of the warpgroup's 128) at
  // k rows 4t.., 16+4t.. of each 32-row step; they are rows g, g + 8 of the
  // two m64 tiles: channel 4q + 2 tile + (row >= 8)
  const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int q = 8 * w + g;
  int acc0[NACC], acc1[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc0[i] = acc1[i] = 0;
  if (warp < NC / 32) {
    sm90::Ring rg;
    uint32_t afr[2][GROUP ? 8 : 8 * NA];   // per group: a half step's
    for (int it = 0; it < n_it; ++it) {
      const int st = rg.stage;
      sm90::mbar_wait(&full[st], rg.phase);
      const unsigned char* sb = smem + st * SB;
      const unsigned char* wt = sb + c * CH_WTILE;
      const uint32_t a_lo = sm90::smem_u32(sb + A_OFF);
      const uint32_t a_hi = a_lo + MT * 128;
      // per group: the scale-box row of each 32-deep step's group
      int grow[CH_RK / 32];
      if constexpr (GROUP) {
        const int j0 = (it0 + it) * (CH_RK / 32), gs = G / 32;
#pragma unroll
        for (int kk = 0; kk < CH_RK / 32; ++kk)
          grow[kk] = (j0 + kk) / gs - j0 / gs;
      }
#pragma unroll
      for (int kk = 0; kk < CH_RK / 32; ++kk) {
        uint32_t in0[4], in1[4], t0[4], t1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          in0[j] = *reinterpret_cast<const uint32_t*>(
              wt + swz_word(32 * kk + 4 * t + j, q));
          in1[j] = *reinterpret_cast<const uint32_t*>(
              wt + swz_word(32 * kk + 16 + 4 * t + j, q));
        }
        transpose4x4(in0, t0);    // t0[i]: k 4t.. of channel 4q + i
        transpose4x4(in1, t1);    // t1[i]: k 16+4t..
        if constexpr (GROUP) {
          // half steps (low K half, then high), each on its own 8 A
          // registers: half the A registers of one buffer a step, which
          // the dequant's words need (168 registers a thread at most with
          // two warpgroups). s2 and the zero of channel 4q + i are bytes i
          // of the stage's words for the step's group.
          const unsigned char* sc =
              sb + S_OFF + grow[kk] * CW + c * CH_NW + 4 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t(&a)[8] = afr[h];
            const uint32_t s2w =
                *reinterpret_cast<const uint32_t*>(sc + h * SBOX);
            const uint32_t zw =
                *reinterpret_cast<const uint32_t*>(sc + (2 + h) * SBOX);
#pragma unroll
            for (int tile = 0; tile < 2; ++tile) {
              const uint32_t x[4] = {t0[2 * tile], t0[2 * tile + 1],
                                     t1[2 * tile], t1[2 * tile + 1]};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int ch = 2 * tile + (r & 1);
                const uint32_t u = (h ? x[r] >> 4 : x[r]) & 0x0F0F0F0Fu;
                a[4 * tile + r] =
                    __vadd4(u * __byte_perm(s2w, 0u, 0x4440 + ch),
                            __byte_perm(zw, 0u, 0x1111 * ch));
              }
            }
            keep_regs(a);
            keep_regs(acc0);
            keep_regs(acc1);
            sm90::wg_fence();
            const uint64_t d =
                sm90::desc_b128((h ? a_hi : a_lo) + 32 * kk, 16, 1024);
            WgmmaS8<MT>::mma(acc0, a, d);
            WgmmaS8<MT>::mma(acc1, a + 4, d);
            sm90::wg_commit();
            // the other half's group has finished: its registers are free
            sm90::wg_wait<1>();
            keep_regs(afr[h ^ 1]);
          }
        } else {
          uint32_t(&a)[8 * NA] = afr[kk & 1];
          // a[8 half + 4 tile + r]: the A fragment of (K half, m64 tile)
#pragma unroll
          for (int tile = 0; tile < 2; ++tile) {
            const uint32_t x[4] = {t0[2 * tile], t0[2 * tile + 1],
                                   t1[2 * tile], t1[2 * tile + 1]};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if constexpr (!W4) {
                a[4 * tile + r] = x[r];
              } else {
                a[4 * tile + r] = x[r] & 0x0F0F0F0Fu;
                a[8 + 4 * tile + r] = (x[r] >> 4) & 0x0F0F0F0Fu;
              }
            }
          }
          keep_regs(a);
          keep_regs(acc0);
          keep_regs(acc1);
          sm90::wg_fence();
          const uint64_t d_lo = sm90::desc_b128(a_lo + 32 * kk, 16, 1024);
          WgmmaS8<MT>::mma(acc0, a, d_lo);
          WgmmaS8<MT>::mma(acc1, a + 4, d_lo);
          if constexpr (W4) {
            const uint64_t d_hi = sm90::desc_b128(a_hi + 32 * kk, 16, 1024);
            WgmmaS8<MT>::mma(acc0, a + 8, d_hi);
            WgmmaS8<MT>::mma(acc1, a + 12, d_hi);
          }
          sm90::wg_commit();
          // the previous step's group has finished: its A registers are free
          sm90::wg_wait<1>();
          keep_regs(afr[(kk + 1) & 1]);
        }
      }
      sm90::wg_wait<0>();
      keep_regs(afr[0]);
      keep_regs(afr[1]);
      keep_regs(acc0);
      keep_regs(acc1);
      sm90::mbar_arrive(&empty[st]);
      rg.advance<NSTAGE>();
    }
  }

  const int nq = n0 + c * CH_NW + 4 * q;   // this thread's first channel
  if (S == 1) {
    if (warp < NC / 32 && nq < N) {
#pragma unroll
      for (int nb = 0; nb < MT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * nb + 2 * t + e;
          if (m >= M) continue;
          const int p[4] = {acc0[4 * nb + e], acc0[4 * nb + 2 + e],
                            acc1[4 * nb + e], acc1[4 * nb + 2 + e]};
          gemm_epilogue<MODE>(out, p, s1, s1_szero, a_scale, a_sum, m, nq,
                              N);
        }
    }
    return;
  }

  // split over K: the partials meet in distributed shared memory, written
  // over the ring once every warpgroup is done reading it
  cg::cluster_group cluster = cg::this_cluster();
  int* part = reinterpret_cast<int*>(smem);
  __syncthreads();
  if (warp < NC / 32) {
#pragma unroll
    for (int nb = 0; nb < MT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ml = 8 * nb + 2 * t + e;
        *reinterpret_cast<int4*>(part + ml * PS + c * CH_NW + 4 * q) =
            make_int4(acc0[4 * nb + e], acc0[4 * nb + 2 + e],
                      acc1[4 * nb + e], acc1[4 * nb + 2 + e]);
      }
  }
  cluster.sync();
  // block r of the cluster finishes the rows r, r + S, ... of the tile:
  // thread (row lane lr, chunk col) reads the S partials of 4 channels at
  // once (one latency a row), scales from shared memory
  const int rank = (int)cluster.block_rank();
  const int rows = min(MT, M - m0);
  constexpr int CHUNKS = CW / 4;                     // 4 channels each
  constexpr int LANES = (NC + 32) / CHUNKS;          // rows in flight
  const int col = 4 * (tid % CHUNKS), lr = tid / CHUNKS;
  if (lr < LANES && n0 + col < N) {
    const float4 sc4 = *reinterpret_cast<const float4*>(ep_s1 + col);
    const float4 sz4 = *reinterpret_cast<const float4*>(ep_sz + col);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const float sz[4] = {sz4.x, sz4.y, sz4.z, sz4.w};
#pragma unroll 2
    for (int ml = rank + S * lr; ml < rows; ml += S * LANES) {
      int4 v[CH_MAX_SPLIT];
#pragma unroll
      for (int s = 0; s < CH_MAX_SPLIT; ++s)
        if (s < S)
          v[s] = *reinterpret_cast<const int4*>(
              cluster.map_shared_rank(part + ml * PS + col, s));
      int p[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < CH_MAX_SPLIT; ++s)
        if (s < S) {
          p[0] += v[s].x;
          p[1] += v[s].y;
          p[2] += v[s].z;
          p[3] += v[s].w;
        }
      const float as = ep_as[ml], am = ep_am[ml];
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = ZERO ? (float)p[i] * sc[i] * as - sz[i] * am
                    : (float)p[i] * sc[i] * as;
      store4(out + (size_t)(m0 + ml) * N + n0 + col, o);
    }
  }
  cluster.sync();   // no block leaves while another reads its partial
}

struct GemmArgs {
  const void* a;         // [M, K] int8
  const void* w;         // [K/2, N] packed u4 or [K, N] int8
  const void* s1;        // [N] f32: s1 (W4) or w_scale (W8)
  const void* s1_szero;  // [N] f32, per channel
  const void* s2;        // [K/G, N] int8, per group
  const void* s2_zero;   // [K/G, N] int8, per group
  const void* a_scale;   // [M] f32
  const void* a_sum;     // [M] f32, per channel
  void* out;             // [M, N] f32 or bf16
  int M, N, K, G, splits, per_split;
};

// a map over the per-group [K/G, N] int8 rows, boxes of NWG * 128 channels
// x min(4, K/G) rows, unswizzled
inline int encode_group_rows(CUtensorMap* map, const void* base, int N,
                             int rows, int box_cols) {
  sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols,
                             (cuuint32_t)(rows < GS_ROWS ? rows : GS_ROWS)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int MODE, int MT, int NWG, typename OutT>
int launch_wgmma(const GemmArgs& g, cudaStream_t stream) {
  constexpr int NSTAGE = ring_depth<MODE, MT, NWG>();
  constexpr int SMEM = smem_bytes<MODE, MT, NWG>();
  constexpr int CW = NWG * CH_NW;
  auto kernel = int8_wgmma_kernel<MODE, MT, NWG, NSTAGE, OutT>;
  const int kw = MODE == kW8 ? g.K : g.K / 2;
  CUtensorMap amap, wmap, s2map, zmap;
  // byte matrices, boxes of 128 bytes x MT activation rows / CH_RK rows
  int err = sm90::encode_swizzled(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, g.a,
                                  (uint64_t)g.K, (uint64_t)g.M,
                                  (uint64_t)g.K, 128, MT);
  if (err == 0)
    err = sm90::encode_swizzled(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, g.w,
                                (uint64_t)g.N, (uint64_t)kw, (uint64_t)g.N,
                                128, CH_RK);
  s2map = amap;
  zmap = amap;
  if (MODE == kW4Group && err == 0)
    err = encode_group_rows(&s2map, g.s2, g.N, g.K / g.G, CW);
  if (MODE == kW4Group && err == 0)
    err = encode_group_rows(&zmap, g.s2_zero, g.N, g.K / g.G, CW);
  if (err != 0) return err;
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return (int)cerr;
  static bool ready[sm90::MAX_DEVICES] = {};   // per instantiation
  if (dev >= sm90::MAX_DEVICES || !ready[dev]) {
    cerr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (cerr != cudaSuccess) return (int)cerr;
    if (dev < sm90::MAX_DEVICES) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.M + MT - 1) / MT, (g.N + CW - 1) / CW, g.splits);
  cfg.blockDim = dim3(NWG * 128 + 32);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.splits;
  cfg.attrs = attr;
  cfg.numAttrs = g.splits > 1 ? 1 : 0;
  cerr = cudaLaunchKernelEx(
      &cfg, kernel, amap, wmap, s2map, zmap, static_cast<const float*>(g.s1),
      static_cast<const float*>(g.s1_szero),
      static_cast<const float*>(g.a_scale),
      static_cast<const float*>(g.a_sum), static_cast<OutT*>(g.out), g.M,
      g.N, g.K, g.G, g.per_split);
  if (cerr != cudaSuccess) return (int)cerr;
  return (int)cudaGetLastError();
}

template <int MODE, typename OutT>
int launch_plan(const GemmArgs& g, int mt, int n_wg, cudaStream_t s) {
  if (n_wg == 2 && mt == 128)   // two warpgroups: prefill, and wide decode
    return launch_wgmma<MODE, 128, 2, OutT>(g, s);
  if (n_wg != 1) return (int)cudaErrorInvalidValue;
  switch (mt) {                 // the decode body
    case 32: return launch_wgmma<MODE, 32, 1, OutT>(g, s);
    case 64: return launch_wgmma<MODE, 64, 1, OutT>(g, s);
    case 128: return launch_wgmma<MODE, 128, 1, OutT>(g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Checks the plan and the pointers of the wgmma body, then launches it.
template <int MODE>
int launch_checked(const GemmArgs& g, int out_f32, int mt, int n_wg,
                   cudaStream_t s) {
  const int kw = MODE == kW8 ? g.K : g.K / 2;
  const int n_it = kw / CH_RK;
  uintptr_t ptrs = reinterpret_cast<uintptr_t>(g.a) |
                   reinterpret_cast<uintptr_t>(g.w) |
                   reinterpret_cast<uintptr_t>(g.s1);
  if (MODE == kW4Channel) ptrs |= reinterpret_cast<uintptr_t>(g.s1_szero);
  if (MODE == kW4Group)
    ptrs |= reinterpret_cast<uintptr_t>(g.s2) |
            reinterpret_cast<uintptr_t>(g.s2_zero);
  if (g.M <= 0 || g.N <= 0 || g.K <= 0 || kw % CH_RK || g.N % 16 ||
      g.splits < 1 || g.splits > CH_MAX_SPLIT || g.per_split < 1 ||
      (long long)g.splits * g.per_split < n_it ||
      (long long)(g.splits - 1) * g.per_split >= n_it || (ptrs & 15u))
    return (int)cudaErrorInvalidValue;
  return out_f32 ? launch_plan<MODE, float>(g, mt, n_wg, s)
                 : launch_plan<MODE, __nv_bfloat16>(g, mt, n_wg, s);
}
}  // namespace

extern "C" {

// The wgmma body (N % 16 == 0) runs on the plan of
// ops/cuda/quant_matmul.gemm_plan: M tiles of mt rows (32, 64 or 128)
// with n_wg consumer warpgroups (1: the decode body; 2 at mt = 128: the
// prefill body), the weight rows (K/2 for W4, K for W8) cut into runs of
// per_split 128-row stages, one block of a cluster of `splits` each. It
// needs those rows % 128 == 0 and a, qweight, s1 / w_scale, s1_szero, s2,
// s2_zero 16-byte aligned. Each returns cudaGetLastError() after the
// launch (0 = launched).
int launch_w4a8_per_channel(const void* a, const void* qweight,
                            const void* s1, const void* s1_szero,
                            const void* a_scale, const void* a_sum,
                            void* out, int out_f32, int M, int N, int K,
                            int mt, int n_wg, int splits, int per_split,
                            void* stream) {
  const GemmArgs g = {a, qweight, s1, s1_szero, nullptr, nullptr, a_scale,
                      a_sum, out, M, N, K, 0, splits, per_split};
  return launch_checked<kW4Channel>(g, out_f32, mt, n_wg,
                                    static_cast<cudaStream_t>(stream));
}

// G: input channels per group; needs G % 32 == 0 and (K/2) % G == 0. At
// N % 16 != 0 the mma.sync body (the plan's arguments unused).
int launch_w4a8_per_group(const void* a, const void* qweight, const void* s1,
                          const void* s2, const void* s2_zero,
                          const void* a_scale, void* out, int out_f32, int M,
                          int N, int K, int G, int mt, int n_wg, int splits,
                          int per_split, void* stream) {
  if (G <= 0 || G % 32 || (K / 2) % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 16)
    return out_f32
               ? launch<kW4Group, float>(a, qweight, s1, s2, s2_zero, a_scale,
                                         out, M, N, K, G, s)
               : launch<kW4Group, __nv_bfloat16>(a, qweight, s1, s2, s2_zero,
                                                 a_scale, out, M, N, K, G, s);
  const GemmArgs g = {a, qweight, s1, nullptr, s2, s2_zero, a_scale,
                      nullptr, out, M, N, K, G, splits, per_split};
  return launch_checked<kW4Group>(g, out_f32, mt, n_wg, s);
}

// At N % 16 != 0 the mma.sync body (the plan's arguments unused).
int launch_w8a8(const void* a, const void* qweight, const void* w_scale,
                const void* a_scale, void* out, int out_f32, int M, int N,
                int K, int mt, int n_wg, int splits, int per_split,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 16)
    return out_f32 ? launch<kW8, float>(a, qweight, w_scale, nullptr, nullptr,
                                        a_scale, out, M, N, K, 0, s)
                   : launch<kW8, __nv_bfloat16>(a, qweight, w_scale, nullptr,
                                                nullptr, a_scale, out, M, N,
                                                K, 0, s);
  const GemmArgs g = {a, qweight, w_scale, nullptr, nullptr, nullptr,
                      a_scale, nullptr, out, M, N, K, 0, splits, per_split};
  return launch_checked<kW8>(g, out_f32, mt, n_wg, s);
}

}  // extern "C"
