// Decode-step KV append into the paged kv4, kv8 or kv16 pool, with the
// optional K min/max page statistics, for Hopper (sm_90a); one launch
// writes one pool, or LServe's two (retrieval and streaming) at once.
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/kv_append.py:
//   append_kv_decode (:156, kernel _append_kernel :58), in its kv4 and kv8
//   modes, fine-grained or per-tensor (_quant_rows :40-56), and its kv16
//   mode (:42, :108: the bf16 rows stored as they are).
//
// Contract (plain version: omniserve_tpu_torch/ops/cuda/kv_append.py
// append_kv_decode_plain = append_kv, then update_k_stats; the two-pool
// entry's is that, once per pool):
//   - one new token per sequence, each to a DISTINCT page of its pool (the
//     decode invariant), so no two warps touch one byte; page id < 0 marks
//     an inactive token, which is written to the trash page P-1;
//   - row h of a pool takes the token's K and V rows of head src[h] (the
//     pool's row -> kv head map; null: head h), read in place from k / v
//     [T, Hin, D] with `stride` elements between tokens;
//   - per pool row, K and V are quantized from their f32 values:
//     fine-grained over L = 15 (kv4) or 255 (kv8) levels (scale =
//     max(max-min, 1e-8)/L, zero = -L*min/range, code = rint(x/scale +
//     zero) in [0, L]), the four folded planes (k_scale,
//     k_scale*(k_zero+128), v_scale, v_zero+128) into lane `slot`; or
//     per-tensor (PT) with the pool's layer K / V scale pt, read on the
//     device (code = clip(rint(x/pt), -qmax-1, qmax) + qmax+1, qmax 7 or
//     127), no planes;
//   - kv4 codes go into the nibble of byte row slot % (page/2), the high
//     nibble iff slot >= page/2; kv8 codes into byte row `slot`;
//   - kv16 (KV_BITS 16): the token's K and V rows are rounded to bf16 (a
//     no-op for bf16 inputs) and stored at row `slot` of [P, H, page, D]
//     bf16; no planes;
//   - with stats, rows 2*sub and 2*sub+1 of the page's [H, 2*n_sub, D]
//     record take min(cur, k) and max(cur, k) of the UNQUANTIZED key, where
//     sub = slot / (page / n_sub).
//   - pool layout: kv4 k/v [P, H, page/2, D] uint8, kv8 [P, H, page, D]
//     uint8, planes [P, 4, H, page] f32 (fine-grained); kv16 k/v [P, H,
//     page, D] bf16; stats [P, H, 2*n_sub, D] f32 (one layer each).
//
// What bounds it: launch latency and a few KB of scattered traffic per
// token (D bytes of K and V read-modify-written and 16 bytes of planes
// under kv4, 2*D bytes written under kv8, 4*D under kv16, 2*D floats of
// stats). Design: one warp per (token, pool row), every row of both pools
// at once; a lane holds D / 32 of the D values (4 at head_dim 128, 2 at
// 64: one 8- or 16-byte load of K and of V, 4 or 8 at 64) and writes them
// as one word or half word of codes (kv4 / kv8), 8 or 4 bytes (kv16) and
// one float4 or float2 of each stats row; the head dim is a template
// parameter (64 or 128). The fine-grained quantizer's max and min
// reduce by warp shuffles alone: no shared memory, no block barrier. Max
// and min do not depend on the order of the reduction, and the rest of
// the quantizer is per value (kv_common.cuh), compiled with --fmad=false,
// so pool bytes, planes and stats equal the plain version's exactly.

#include <type_traits>

#include "kv_common.cuh"

namespace {

using namespace kv;

constexpr int WARPS = 4;          // (token, pool row) items per block

// One pool's side of an append.
struct Side {
  void* k_data;            // layer: [P, H, rows, D] u8 or [P, H, page, D] bf16
  void* v_data;
  float* planes;           // layer: [P, 4, H, page] f32, or null
  const float* kpt;        // PT: the layer's K scale
  const float* vpt;        // PT: the layer's V scale
  float* stats;            // layer: [P, H, 2*n_sub, D] f32, or null
  const int* page_ids;     // [T], < 0 = inactive
  const int* slots;        // [T]
  const long long* src;    // [H] kv head of each pool row, or null (= row)
  int H, P;
};

// A lane's N = D / 32 consecutive values (4 at D = 128, 2 at D = 64), as
// one load: 16 / 8 bytes of f32, 8 / 4 of bf16.
template <int N>
__device__ __forceinline__ void load_lane(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(p);
    x[0] = w.x;
    x[1] = w.y;
  }
}
template <int N>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p,
                                          float (&x)[N]) {
  uint32_t w[N / 2];
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// N bytes of codes (one word at N = 4, a half word at N = 2) at p
template <int N>
struct CodeWord {
  using T = typename std::conditional<N == 4, uint32_t, uint16_t>::type;
  static constexpr uint32_t LO = N == 4 ? 0x0F0F0F0Fu : 0x0F0Fu;
};

// The lane's N codes, one per byte (value e in byte e), of a row whose
// other values sit in the warp's other lanes; `q` gets the row's scale and
// zero (fine-grained) or pt and the bias (per tensor).
template <int KV_BITS, bool PT, int N>
__device__ __forceinline__ uint32_t quant_lane(const float (&x)[N], float pt,
                                               TokQuant& q) {
  constexpr int LEVELS = KV_BITS == 8 ? 255 : 15;
  constexpr int QMAX = KV_BITS == 8 ? 127 : 7;
  float mx = 0.0f, mn = 0.0f;
  if constexpr (!PT) {
    float lmx = x[0], lmn = x[0];
#pragma unroll
    for (int e = 1; e < N; ++e) {
      lmx = fmaxf(lmx, x[e]);
      lmn = fminf(lmn, x[e]);
    }
    mx = warp_max(lmx);
    mn = -warp_max(-lmn);
  }
  uint32_t codes = 0u;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    q = PT ? quant_pt<QMAX>(x[e], pt) : quant_kv_range<LEVELS>(x[e], mx, mn);
    codes |= static_cast<uint32_t>(q.code) << (8 * e);
  }
  return codes;
}

template <typename T, int KV_BITS, bool PT, int D>
__global__ void __launch_bounds__(32 * WARPS) kv_append_kernel(
    const T* __restrict__ k, const T* __restrict__ v, int k_stride,
    int v_stride, Side a, Side b, int n_tok, int page, int n_sub) {
  constexpr bool KV16 = KV_BITS == 16, KV8 = KV_BITS == 8;
  constexpr int N = D / 32;          // values a lane holds
  using W = typename CodeWord<N>::T;
  constexpr uint32_t LO = CodeWord<N>::LO;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_a = n_tok * a.H;
  if (item >= n_a + n_tok * b.H) return;
  const bool second = item >= n_a;
  const Side s = second ? b : a;
  const int i = second ? item - n_a : item;
  const int t = i / s.H, h = i - t * s.H;
  int pg = s.page_ids[t];
  const bool active = pg >= 0;
  if (!active) pg = s.P - 1;
  const int slot = active ? s.slots[t] : 0;
  const int src = s.src != nullptr ? static_cast<int>(s.src[h]) : h;
  const int d0 = N * lane;
  float kx[N], vx[N];
  load_lane<N>(k + (size_t)t * k_stride + (size_t)src * D + d0, kx);
  load_lane<N>(v + (size_t)t * v_stride + (size_t)src * D + d0, vx);
  const size_t head = (size_t)pg * s.H + h;
  if constexpr (KV16) {
    const size_t off = (head * page + slot) * D + d0;
    uint32_t kw[N / 2], vw[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const __nv_bfloat162 kb = __floats2bfloat162_rn(kx[2 * e], kx[2 * e + 1]);
      const __nv_bfloat162 vb = __floats2bfloat162_rn(vx[2 * e], vx[2 * e + 1]);
      kw[e] = *reinterpret_cast<const uint32_t*>(&kb);
      vw[e] = *reinterpret_cast<const uint32_t*>(&vb);
    }
    __nv_bfloat16* kd = static_cast<__nv_bfloat16*>(s.k_data) + off;
    __nv_bfloat16* vd = static_cast<__nv_bfloat16*>(s.v_data) + off;
    if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(kd) = make_uint2(kw[0], kw[1]);
      *reinterpret_cast<uint2*>(vd) = make_uint2(vw[0], vw[1]);
    } else {
      *reinterpret_cast<uint32_t*>(kd) = kw[0];
      *reinterpret_cast<uint32_t*>(vd) = vw[0];
    }
  } else {
    TokQuant kq, vq;
    const uint32_t kc = quant_lane<KV_BITS, PT, N>(kx, PT ? *s.kpt : 0.0f, kq);
    const uint32_t vc = quant_lane<KV_BITS, PT, N>(vx, PT ? *s.vpt : 0.0f, vq);
    const int half = page / 2;
    const int rows = KV8 ? page : half;   // byte rows per page and head
    const int row = KV8 ? slot : slot % half;
    const size_t off = (head * rows + row) * D + d0;
    W* kd = reinterpret_cast<W*>(static_cast<uint8_t*>(s.k_data) + off);
    W* vd = reinterpret_cast<W*>(static_cast<uint8_t*>(s.v_data) + off);
    if constexpr (KV8) {
      *kd = static_cast<W>(kc);
      *vd = static_cast<W>(vc);
    } else if (slot >= half) {      // the high nibbles
      *kd = static_cast<W>((*kd & LO) | (kc << 4));
      *vd = static_cast<W>((*vd & LO) | (vc << 4));
    } else {
      *kd = static_cast<W>((*kd & (LO << 4)) | kc);
      *vd = static_cast<W>((*vd & (LO << 4)) | vc);
    }
    if (!PT && lane < 4) {
      float val;
      if (lane == 0) val = kq.scale;
      else if (lane == 1) val = kq.scale * (kq.zero + 128.0f);
      else if (lane == 2) val = vq.scale;
      else val = vq.zero + 128.0f;
      s.planes[(((size_t)pg * 4 + lane) * s.H + h) * page + slot] = val;
    }
  }
  if (s.stats != nullptr) {
    const int sub = slot / (page / n_sub);
    float* lo = s.stats + (head * 2 * n_sub + 2 * sub) * D + d0;
    float* hi = lo + D;
    float cl[N], ch[N];
    load_lane<N>(lo, cl);
    load_lane<N>(hi, ch);
    if constexpr (N == 4) {
      *reinterpret_cast<float4*>(lo) =
          make_float4(fminf(cl[0], kx[0]), fminf(cl[1], kx[1]),
                      fminf(cl[2], kx[2]), fminf(cl[3], kx[3]));
      *reinterpret_cast<float4*>(hi) =
          make_float4(fmaxf(ch[0], kx[0]), fmaxf(ch[1], kx[1]),
                      fmaxf(ch[2], kx[2]), fmaxf(ch[3], kx[3]));
    } else {
      *reinterpret_cast<float2*>(lo) =
          make_float2(fminf(cl[0], kx[0]), fminf(cl[1], kx[1]));
      *reinterpret_cast<float2*>(hi) =
          make_float2(fmaxf(ch[0], kx[0]), fmaxf(ch[1], kx[1]));
    }
  }
}

Side side(void* k_data, void* v_data, void* planes, const void* k_pt,
          const void* v_pt, void* stats, const void* page_ids,
          const void* slots, const void* src, int H, int P) {
  return Side{k_data,
              v_data,
              static_cast<float*>(planes),
              static_cast<const float*>(k_pt),
              static_cast<const float*>(v_pt),
              static_cast<float*>(stats),
              static_cast<const int*>(page_ids),
              static_cast<const int*>(slots),
              static_cast<const long long*>(src),
              H,
              P};
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// kv_bits: 4 (nibble pages), 8 (byte pages) or 16 (bf16 pages), the same
// for both pools. kv4 / kv8 take folded planes (fine-grained) or, when
// k_pt / v_pt (device addresses of the layer's scales) are given,
// per-tensor codes and no planes; both pools in one mode. Pool b is left
// alone when b_H == 0 (the single-pool entry). src: int64 [H] row -> kv
// head maps, or null. k / v: bf16 (is_f32 0) or f32 rows, 8- / 16-byte
// aligned, with k_stride / v_stride elements (a multiple of 4) between
// tokens. head_dim: 64 or 128.
int launch_kv_append_decode(
    const void* k, const void* v, int is_f32, int k_stride, int v_stride,
    int T, int page, int n_sub, int kv_bits,
    void* a_k_data, void* a_v_data, void* a_planes, const void* a_k_pt,
    const void* a_v_pt, void* a_stats, const void* a_page_ids,
    const void* a_slots, const void* a_src, int a_H, int a_P,
    void* b_k_data, void* b_v_data, void* b_planes, const void* b_k_pt,
    const void* b_v_pt, void* b_stats, const void* b_page_ids,
    const void* b_slots, const void* b_src, int b_H, int b_P, int head_dim,
    void* stream) {
  const bool pt = a_k_pt != nullptr;
  const bool fine = kv_bits != 16 && !pt;
  if ((kv_bits != 4 && kv_bits != 8 && kv_bits != 16) || a_H <= 0 ||
      b_H < 0 || pt != (a_v_pt != nullptr) || (pt && kv_bits == 16) ||
      (fine && a_planes == nullptr) || k_stride % 4 || v_stride % 4 ||
      !head_dim_ok(head_dim) ||
      page <= 0 || page % 2 || n_sub <= 0 || page % n_sub ||
      (b_H > 0 && (pt != (b_k_pt != nullptr) || pt != (b_v_pt != nullptr) ||
                   (fine && b_planes == nullptr))))
    return (int)cudaErrorInvalidValue;
  const Side a = side(a_k_data, a_v_data, a_planes, a_k_pt, a_v_pt, a_stats,
                      a_page_ids, a_slots, a_src, a_H, a_P);
  const Side b = side(b_k_data, b_v_data, b_planes, b_k_pt, b_v_pt, b_stats,
                      b_page_ids, b_slots, b_src, b_H, b_P);
  const int items = T * (a_H + b_H);
  if (items == 0) return (int)cudaSuccess;
  const int blocks = (items + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TYPE, BITS, PT)                                              \
  do {                                                                      \
    if (head_dim == 64)                                                     \
      kv_append_kernel<TYPE, BITS, PT, 64><<<blocks, 32 * WARPS, 0, s>>>(   \
          static_cast<const TYPE*>(k), static_cast<const TYPE*>(v),         \
          k_stride, v_stride, a, b, T, page, n_sub);                        \
    else                                                                    \
      kv_append_kernel<TYPE, BITS, PT, 128><<<blocks, 32 * WARPS, 0, s>>>(  \
          static_cast<const TYPE*>(k), static_cast<const TYPE*>(v),         \
          k_stride, v_stride, a, b, T, page, n_sub);                        \
  } while (0)
#define LAUNCH_MODE(TYPE)                                     \
  if (kv_bits == 16) LAUNCH(TYPE, 16, false);                 \
  else if (kv_bits == 8) {                                    \
    if (pt) LAUNCH(TYPE, 8, true);                            \
    else LAUNCH(TYPE, 8, false);                              \
  } else {                                                    \
    if (pt) LAUNCH(TYPE, 4, true);                            \
    else LAUNCH(TYPE, 4, false);                              \
  }
  if (is_f32) { LAUNCH_MODE(float) }
  else { LAUNCH_MODE(__nv_bfloat16) }
#undef LAUNCH_MODE
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
