// Decode-step KV append into the paged kv4, kv8 or kv16 pool, with the
// optional K min/max page statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/kv_append.py:
//   append_kv_decode (:156, kernel _append_kernel :58), in its kv4 and kv8
//   modes, fine-grained or per-tensor (_quant_rows :40-56), and its kv16
//   mode (:42, :108: the bf16 rows stored as they are).
//
// Contract (plain version: omniserve_tpu_torch/ops/cuda/kv_append.py
// append_kv_decode_plain = append_kv, then update_k_stats):
//   - one new token per sequence, each to a DISTINCT page (the decode
//     invariant), so no two blocks touch one byte; page id < 0 marks an
//     inactive token, which is written to the trash page P-1;
//   - per head, K and V are quantized from their f32 values: fine-grained
//     over L = 15 (kv4) or 255 (kv8) levels (scale = max(max-min, 1e-8)/L,
//     zero = -L*min/range, code = rint(x/scale + zero) in [0, L]), the four
//     folded planes (k_scale, k_scale*(k_zero+128), v_scale, v_zero+128)
//     into lane `slot`; or per-tensor (PT) with the layer's K / V scale pt,
//     read on the device (code = clip(rint(x/pt), -qmax-1, qmax) + qmax+1,
//     qmax 7 or 127), no planes;
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
// stats). Design: one block per token, one thread per head-dim lane, a
// loop over the pool's heads; the quantizers are the ones the fused decode
// kernel uses (kv_common.cuh). Compiled with --fmad=false so pool bytes,
// planes and stats equal the plain version's exactly.

#include "kv_common.cuh"

namespace {

using namespace kv;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int KV_BITS, bool PT>
__global__ void __launch_bounds__(NT) kv_append_kernel(
    const T* __restrict__ k,              // [T, H, D]
    const T* __restrict__ v,              // [T, H, D]
    const int* __restrict__ page_ids,     // [T], < 0 = inactive
    const int* __restrict__ slots,        // [T]
    void* __restrict__ k_data,            // layer: [P, H, rows, D] u8 or
    void* __restrict__ v_data,            //        [P, H, page, D] bf16
    float* __restrict__ planes,           // layer: [P, 4, H, page] or null
    const float* __restrict__ kpt,        // PT: the layer's K scale
    const float* __restrict__ vpt,        // PT: the layer's V scale
    float* __restrict__ stats,            // layer: [P, H, 2*n_sub, D] or null
    int H, int P, int page, int n_sub) {
  constexpr bool KV16 = KV_BITS == 16, KV8 = KV_BITS == 8;
  constexpr int LEVELS = KV8 ? 255 : 15;
  constexpr int QMAX = KV8 ? 127 : 7;
  __shared__ float red[NWARP];
  const int t = blockIdx.x, tid = threadIdx.x;
  int pg = page_ids[t];
  const bool active = pg >= 0;
  if (!active) pg = P - 1;
  const int slot = active ? slots[t] : 0;
  const int half = page / 2;
  const int row = KV8 ? slot : slot % half;
  const int rows = KV8 ? page : half;   // byte rows per page and head
  const bool is_hi = !KV8 && slot >= half;
  const float k_pt = PT ? *kpt : 0.0f, v_pt = PT ? *vpt : 0.0f;
  for (int h = 0; h < H; ++h) {
    const size_t in_off = ((size_t)t * H + h) * D + tid;
    const float kx = to_f32(k[in_off]);
    if constexpr (KV16) {
      const size_t off = (((size_t)pg * H + h) * page + slot) * D + tid;
      static_cast<__nv_bfloat16*>(k_data)[off] = __float2bfloat16(kx);
      static_cast<__nv_bfloat16*>(v_data)[off] =
          __float2bfloat16(to_f32(v[in_off]));
    } else {
      uint8_t* kd = static_cast<uint8_t*>(k_data);
      uint8_t* vd = static_cast<uint8_t*>(v_data);
      const float vx = to_f32(v[in_off]);
      const TokQuant kq = PT ? quant_pt<QMAX>(kx, k_pt) : quant_kv<LEVELS>(kx, red);
      const TokQuant vq = PT ? quant_pt<QMAX>(vx, v_pt) : quant_kv<LEVELS>(vx, red);
      const size_t byte_off = (((size_t)pg * H + h) * rows + row) * D + tid;
      const uint32_t kc = (uint32_t)kq.code, vc = (uint32_t)vq.code;
      if constexpr (KV8) {
        kd[byte_off] = (uint8_t)kc;
        vd[byte_off] = (uint8_t)vc;
      } else {
        const uint32_t kb = kd[byte_off], vb = vd[byte_off];
        kd[byte_off] =
            (uint8_t)(is_hi ? ((kb & 0x0F) | (kc << 4)) : ((kb & 0xF0) | kc));
        vd[byte_off] =
            (uint8_t)(is_hi ? ((vb & 0x0F) | (vc << 4)) : ((vb & 0xF0) | vc));
      }
      if (!PT && tid < 4) {
        float val;
        if (tid == 0) val = kq.scale;
        else if (tid == 1) val = kq.scale * (kq.zero + 128.0f);
        else if (tid == 2) val = vq.scale;
        else val = vq.zero + 128.0f;
        planes[(((size_t)pg * 4 + tid) * H + h) * page + slot] = val;
      }
    }
    if (stats != nullptr) {
      const int sub = slot / (page / n_sub);
      float* st =
          stats + (((size_t)pg * H + h) * 2 * n_sub + 2 * sub) * D + tid;
      st[0] = fminf(st[0], kx);
      st[D] = fmaxf(st[D], kx);
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// kv_bits: 4 (nibble pages), 8 (byte pages) or 16 (bf16 pages). kv4 / kv8
// take folded planes (fine-grained) or, when k_pt / v_pt (device addresses
// of the layer's scales) are given, per-tensor codes and no planes.
int launch_kv_append_decode(const void* k, const void* v, int is_f32,
                            const void* page_ids, const void* slots,
                            void* k_data, void* v_data, void* planes,
                            const void* k_pt, const void* v_pt, void* stats,
                            int T, int H, int P, int page, int n_sub,
                            int kv_bits, void* stream) {
  const bool pt = k_pt != nullptr;
  if ((kv_bits != 4 && kv_bits != 8 && kv_bits != 16) ||
      pt != (v_pt != nullptr) || (pt && kv_bits == 16) ||
      (kv_bits != 16 && !pt && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TYPE, BITS, PT)                                              \
  kv_append_kernel<TYPE, BITS, PT><<<T, NT, 0, s>>>(                        \
      static_cast<const TYPE*>(k), static_cast<const TYPE*>(v),             \
      static_cast<const int*>(page_ids), static_cast<const int*>(slots),    \
      k_data, v_data, static_cast<float*>(planes),                          \
      static_cast<const float*>(k_pt), static_cast<const float*>(v_pt),     \
      static_cast<float*>(stats), H, P, page, n_sub)
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
