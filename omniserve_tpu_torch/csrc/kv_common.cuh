// Device code shared by the paged-KV kernels (decode_attention.cu,
// kv_append.cu): warp reductions and reductions over the D threads of a
// head (one thread per head-dim lane, D = 64 or 128), the fine-grained
// quantizer of one [D] vector
// over 15 levels (kv4) or 255 (kv8), and the per-tensor quantizer of one
// value by a calibrated scale (codes biased by 8 or 128).
//
// The quantizers follow the plain versions' f32 op order
// (ops/quantization.kv_quantize_fine_grained, kv_quantize_per_tensor);
// sources that include this header are compiled with --fmad=false so
// codes, scales and zeros come out bit-identical to them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kv {

constexpr int MAX_PAGE = 256;  // tokens per page the kernels stage

// head dims the kernels are instantiated for: a head-dim template
// parameter HD of the decode and append kernels is one of these
__host__ __device__ constexpr bool head_dim_ok(int d) {
  return d == 64 || d == 128;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum / max / min over the NWARP warps of threads 0 .. 32 NWARP - 1 that
// meet at `sync` (all threads get the result): __syncthreads for a whole
// block, a named barrier for the consumer threads of a block whose other
// warps have left.
template <int NWARP, typename Sync>
__device__ inline float reduce_nt(float v, int op, float* red, Sync sync) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (op == 0) v = warp_sum(v);
  else if (op == 1) v = warp_max(v);
  else v = -warp_max(-v);
  sync();
  if (lane == 0) red[warp] = v;
  sync();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w)
    r = op == 0 ? r + red[w] : (op == 1 ? fmaxf(r, red[w]) : fminf(r, red[w]));
  return r;
}

struct TokQuant {
  float code, dq, scale, zero;
};

// Fine-grained quantization of one value x of a [D] vector whose max and
// min are mx and mn, over LEVELS = 15 (kv4) or 255 (kv8) levels, exactly
// the plain version's op order (ops/quantization.kv_quantize_fine_grained).
template <int LEVELS>
__device__ __forceinline__ TokQuant quant_kv_range(float x, float mx,
                                                   float mn) {
  constexpr float L = (float)LEVELS;
  const float rng = fmaxf(mx - mn, 1e-8f);
  TokQuant t;
  t.scale = rng / L;
  t.zero = (-L * mn) / rng;
  t.code = fminf(fmaxf(rintf(x / t.scale + t.zero), 0.0f), L);
  t.dq = (t.code - t.zero) * t.scale;
  return t;
}

// The same for one lane of the vector; `reduce(v, op)` is the max (op 1) /
// min (op 2) over the D lanes.
template <int LEVELS, typename Reduce>
__device__ inline TokQuant quant_kv_by(float x, Reduce reduce) {
  const float mx = reduce(x, 1);
  const float mn = reduce(x, 2);
  return quant_kv_range<LEVELS>(x, mx, mn);
}

// Per-tensor quantization of one value with the layer's calibrated scale
// pt (QMAX = 7 for kv4, 127 for kv8): code = clip(rint(x / pt), -QMAX-1,
// QMAX) + QMAX+1, an IEEE division and round-half-even as
// ops/quantization.kv_quantize_per_tensor; dq = (code - bias) * pt, the
// value the pool holds. scale / zero carry pt and the bias.
template <int QMAX>
__device__ __forceinline__ TokQuant quant_pt(float x, float pt) {
  constexpr float bias = (float)(QMAX + 1);
  const float q = fminf(fmaxf(rintf(x / pt), -bias), (float)QMAX);
  TokQuant t;
  t.code = q + bias;
  t.dq = q * pt;
  t.scale = pt;
  t.zero = bias;
  return t;
}

}  // namespace kv
