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
// What bounds it: at decode M (a handful of rows) the weight bytes (bytes
// bound: 4 bits per weight); at prefill M (thousands of rows) the int8
// tensor-core rate. Design: one block computes a BM x BN output tile with
// mma.sync m16n8k32 (s8 x s8 -> s32). Weight tiles are read from device
// memory as packed bytes (4 bits per weight for W4), transposed 4x4 bytes
// in registers into a k-contiguous shared-memory tile, and the nibbles are
// split in registers right before each mma (lo = w & 0x0F0F0F0F,
// hi = (w >> 4) & 0x0F0F0F0F): the W4 path issues one mma against the low
// half of K and one against the high half from the same loaded word.
// Per group, the progressive dequant runs on that split word too: its four
// bytes are four u4 codes of one column n in one group (G % 32 == 0, so a
// 32-deep k step never straddles groups), so one 32-bit multiply by s2
// scales all four (each product <= 15 * 17 = 255: no carry crosses a byte;
// the derived quantizer never gives s2 > 17) and __vadd4 adds the zero
// bytewise, wrapping mod 256 exactly as the int8 cast of the reference.
// The tile's s2 and zeros (one per 32-deep k chunk, column and K half) are
// staged in shared memory with the weight tile. Two tile shapes: 16 x 32
// for M <= 16 (many blocks stream the weights), 128 x 128 for larger M.
// No cp.async/TMA pipelining or wgmma yet (a later PR).
//
// Built with --fmad=false so the f32 epilogue rounds exactly as the plain
// PyTorch version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                      const float* __restrict__ w_szero,
                      const int8_t* __restrict__ s2,
                      const int8_t* __restrict__ s2_zero,
                      const float* __restrict__ a_scale,
                      const float* __restrict__ a_sum,
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
          float o = p * w_scale[n] * a_scale[m];
          if (MODE == kW4Channel) o = o - w_szero[n] * a_sum[m];
          store_out(out + (size_t)m * N + n, o);
        }
      }
}

template <int MODE, typename OutT>
int launch(const void* a, const void* w, const void* ws, const void* wz,
           const void* s2, const void* s2z, const void* as, const void* asum,
           void* out, int M, int N, int K, int G, cudaStream_t stream) {
  const int8_t* A = static_cast<const int8_t*>(a);
  const uint8_t* Wt = static_cast<const uint8_t*>(w);
  const float* fs = static_cast<const float*>(ws);
  const float* fz = static_cast<const float*>(wz);
  const int8_t* g2 = static_cast<const int8_t*>(s2);
  const int8_t* g2z = static_cast<const int8_t*>(s2z);
  const float* fa = static_cast<const float*>(as);
  const float* fsum = static_cast<const float*>(asum);
  OutT* o = static_cast<OutT*>(out);
  if (M <= 16) {
    constexpr int BM = 16, BN = 32, BK = 128;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    quant_gemm_kernel<BM, BN, BK, 1, 4, MODE, OutT><<<grid, 128, 0, stream>>>(
        A, Wt, fs, fz, g2, g2z, fa, fsum, o, M, N, K, G);
  } else {
    constexpr int BM = 128, BN = 128, BK = 64;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    quant_gemm_kernel<BM, BN, BK, 2, 4, MODE, OutT><<<grid, 256, 0, stream>>>(
        A, Wt, fs, fz, g2, g2z, fa, fsum, o, M, N, K, G);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int launch_w4a8_per_channel(const void* a, const void* qweight,
                            const void* s1, const void* s1_szero,
                            const void* a_scale, const void* a_sum,
                            void* out, int out_f32, int M, int N, int K,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32
             ? launch<kW4Channel, float>(a, qweight, s1, s1_szero, nullptr,
                                         nullptr, a_scale, a_sum, out, M, N,
                                         K, 0, s)
             : launch<kW4Channel, __nv_bfloat16>(
                   a, qweight, s1, s1_szero, nullptr, nullptr, a_scale,
                   a_sum, out, M, N, K, 0, s);
}

// G: input channels per group; needs G % 32 == 0 and (K/2) % G == 0.
int launch_w4a8_per_group(const void* a, const void* qweight, const void* s1,
                          const void* s2, const void* s2_zero,
                          const void* a_scale, void* out, int out_f32, int M,
                          int N, int K, int G, void* stream) {
  if (G <= 0 || G % 32 || (K / 2) % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32
             ? launch<kW4Group, float>(a, qweight, s1, nullptr, s2, s2_zero,
                                       a_scale, nullptr, out, M, N, K, G, s)
             : launch<kW4Group, __nv_bfloat16>(a, qweight, s1, nullptr, s2,
                                               s2_zero, a_scale, nullptr, out,
                                               M, N, K, G, s);
}

int launch_w8a8(const void* a, const void* qweight, const void* w_scale,
                const void* a_scale, void* out, int out_f32, int M, int N,
                int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<kW8, float>(a, qweight, w_scale, nullptr, nullptr,
                                      nullptr, a_scale, nullptr, out, M, N, K,
                                      0, s)
                 : launch<kW8, __nv_bfloat16>(a, qweight, w_scale, nullptr,
                                              nullptr, nullptr, a_scale,
                                              nullptr, out, M, N, K, 0, s);
}

}  // extern "C"
