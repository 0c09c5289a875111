// Decode-step KV append into the paged kv4 or kv16 pool, with the optional
// K min/max page statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/kv_append.py:
//   append_kv_decode (:156, kernel _append_kernel :58), in its kv4
//   fine-grained mode and its kv16 mode (:42, :108: the bf16 rows stored
//   as they are).
//
// Contract (plain version: omniserve_tpu_torch/ops/cuda/kv_append.py
// append_kv_decode_plain = append_kv, then update_k_stats):
//   - one new token per sequence, each to a DISTINCT page (the decode
//     invariant), so no two blocks touch one byte; page id < 0 marks an
//     inactive token, which is written to the trash page P-1;
//   - per head, K and V are quantized from their f32 values (fine-grained
//     kv4: scale = max(max-min, 1e-8)/15, zero = -15*min/range,
//     code = rint(x/scale + zero) in [0, 15]); the code goes into the nibble
//     of byte row slot % (page/2), the high nibble iff slot >= page/2, and
//     the four folded planes (k_scale, k_scale*(k_zero+128), v_scale,
//     v_zero+128) into lane `slot`;
//   - kv16 (KV16): the token's K and V rows are rounded to bf16 (a no-op
//     for bf16 inputs) and stored at row `slot` of [P, H, page, D] bf16; no
//     planes;
//   - with stats, rows 2*sub and 2*sub+1 of the page's [H, 2*n_sub, D]
//     record take min(cur, k) and max(cur, k) of the UNQUANTIZED key, where
//     sub = slot / (page / n_sub).
//   - pool layout: kv4 k/v [P, H, page/2, D] uint8, planes [P, 4, H, page]
//     f32; kv16 k/v [P, H, page, D] bf16; stats [P, H, 2*n_sub, D] f32 (one
//     layer each).
//
// What bounds it: launch latency and a few KB of scattered traffic per
// token (D bytes of K and V read-modify-written and 16 bytes of planes
// under kv4, 4*D bytes written under kv16, 2*D floats of stats). Design: one block per token, one thread per head-dim
// lane, a loop over the pool's heads; the quantizer is the one the fused
// decode kernel uses (kv_common.cuh). Compiled with --fmad=false so pool
// bytes, planes and stats equal the plain version's exactly.

#include "kv_common.cuh"

namespace {

using namespace kv;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool KV16>
__global__ void __launch_bounds__(NT) kv_append_kernel(
    const T* __restrict__ k,              // [T, H, D]
    const T* __restrict__ v,              // [T, H, D]
    const int* __restrict__ page_ids,     // [T], < 0 = inactive
    const int* __restrict__ slots,        // [T]
    void* __restrict__ k_data,            // layer: [P, H, page/2, D] u8 or
    void* __restrict__ v_data,            //        [P, H, page, D] bf16
    float* __restrict__ planes,           // layer: [P, 4, H, page] (kv4)
    float* __restrict__ stats,            // layer: [P, H, 2*n_sub, D] or null
    int H, int P, int page, int n_sub) {
  __shared__ float red[NWARP];
  const int t = blockIdx.x, tid = threadIdx.x;
  int pg = page_ids[t];
  const bool active = pg >= 0;
  if (!active) pg = P - 1;
  const int slot = active ? slots[t] : 0;
  const int half = page / 2;
  const int row = slot % half;
  const bool is_hi = slot >= half;
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
      const TokQuant kq = quant_kv<15>(kx, red);
      const TokQuant vq = quant_kv<15>(to_f32(v[in_off]), red);
      const size_t byte_off = (((size_t)pg * H + h) * half + row) * D + tid;
      const uint32_t kc = (uint32_t)kq.code, vc = (uint32_t)vq.code;
      const uint32_t kb = kd[byte_off], vb = vd[byte_off];
      kd[byte_off] =
          (uint8_t)(is_hi ? ((kb & 0x0F) | (kc << 4)) : ((kb & 0xF0) | kc));
      vd[byte_off] =
          (uint8_t)(is_hi ? ((vb & 0x0F) | (vc << 4)) : ((vb & 0xF0) | vc));
      if (tid < 4) {
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
// kv_bits: 4 (fine-grained nibble pages with planes) or 16 (bf16 pages).
int launch_kv_append_decode(const void* k, const void* v, int is_f32,
                            const void* page_ids, const void* slots,
                            void* k_data, void* v_data, void* planes,
                            void* stats, int T, int H, int P, int page,
                            int n_sub, int kv_bits, void* stream) {
  if ((kv_bits != 4 && kv_bits != 16) || (kv_bits == 4 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TYPE, KV16)                                                  \
  kv_append_kernel<TYPE, KV16><<<T, NT, 0, s>>>(                            \
      static_cast<const TYPE*>(k), static_cast<const TYPE*>(v),             \
      static_cast<const int*>(page_ids), static_cast<const int*>(slots),    \
      k_data, v_data, static_cast<float*>(planes),                          \
      static_cast<float*>(stats), H, P, page, n_sub)
  if (kv_bits == 16) {
    if (is_f32) LAUNCH(float, true);
    else LAUNCH(__nv_bfloat16, true);
  } else {
    if (is_f32) LAUNCH(float, false);
    else LAUNCH(__nv_bfloat16, false);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
