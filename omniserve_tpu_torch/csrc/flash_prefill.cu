// Packed-varlen causal flash attention for whole-prompt prefill, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/flash_attention.py:
//   flash_prefill (:150, kernel _flash_kernel :35), dense heads and the
//   LServe sink + local band of streaming heads.
//
// Contract (plain version: omniserve_tpu_torch/ops/attention_ref.py
// prefill_attention):
//   q [T, Hq, D], k/v [T, Hkv, D] bf16, segment_ids/positions [T] int32.
//   Query i attends key j iff seg[i] == seg[j] >= 0 and pos[i] >= pos[j];
//   q head h reads kv head hk = h / (Hq / Hkv). With flags [Hkv] int32
//   (null = every head dense), a head with flags[hk] == 0 streams: it also
//   needs pos[j] < sink_size or pos[i] - pos[j] < local_size. Rows with no
//   valid key give 0. Any T: the ragged tail tile is masked (the TPU
//   kernel's t % block == 0 requirement does not carry over).
//
// What bounds it: operations (4 * D flops per attended (query, key) pair
// against a few bytes per token). Design: one block per (64-query tile,
// q head); it walks the 64-key tiles and skips every tile that cannot
// hold a (same segment, causal) pair, so packed sequences cost their own
// causal triangles only. A streaming head also skips every key tile that
// holds no sink key and lies wholly below the q tile's local band (the TPU
// kernel's stream_dead skip, tested per key): at 32K tokens with an 8K
// band that is most tiles. Scores and P.V run on the f32 FMA pipes from
// shared-memory tiles (a thread owns a 4 x 4 score patch and a 4 x 8
// output patch); the softmax is online, one warp per 8 query rows. A
// tensor-core (mma/wgmma) version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64, BKV = 64;
constexpr int NT = 256;
constexpr int DS = D + 4;       // f32 row stride of the q/k/v tiles
constexpr int SS = BKV + 1;     // f32 row stride of the score tile

constexpr size_t SMEM_BYTES =
    sizeof(float) * (3 * BQ * DS + BQ * SS + 3 * BQ) + sizeof(int) * 4 * BQ;

__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src,
                                          int row0, int T, int stride_row) {
  // 64 rows x D bf16 -> f32 [64][DS]; 8 bf16 (16 bytes) per load
  for (int i = threadIdx.x; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    float* d = dst + r * DS + c;
    if (row < T) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          src + (size_t)row * stride_row + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        d[2 * e] = f.x;
        d[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(NT) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ pos, const int* __restrict__ flags,
    __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int sink_size,
    int local_size, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* qS = smem;                 // [BQ][DS]
  float* kS = qS + BQ * DS;         // [BKV][DS]
  float* vS = kS + BKV * DS;        // [BKV][DS]
  float* S = vS + BKV * DS;         // [BQ][SS]
  float* m_s = S + BQ * SS;         // [BQ]
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  int* qseg = reinterpret_cast<int*>(a_s + BQ);
  int* qpos = qseg + BQ;
  int* kseg = qpos + BQ;
  int* kpos = kseg + BKV;
  __shared__ int qsum[4];   // q tile: seg min, seg max, pos max, pos min

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / 16, tx = tid % 16;
  const int i0 = blockIdx.x * BQ, h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const bool dense = flags == nullptr || flags[hk] != 0;

  load_tile(qS, q + (size_t)h * D, i0, T, Hq * D);
  if (tid < BQ) {
    const int i = i0 + tid;
    qseg[tid] = i < T ? seg[i] : -1;
    qpos[tid] = i < T ? pos[i] : 0;
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    int smin = 0x7fffffff, smax = -1, pmax = -1, pmin = 0x7fffffff;
    for (int r = 0; r < BQ; ++r)
      if (qseg[r] >= 0) {
        smin = min(smin, qseg[r]);
        smax = max(smax, qseg[r]);
        pmax = max(pmax, qpos[r]);
        pmin = min(pmin, qpos[r]);
      }
    qsum[0] = smin;
    qsum[1] = smax;
    qsum[2] = pmax;
    qsum[3] = pmin;
  }
  __syncthreads();

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  const int n_kv = (T + BKV - 1) / BKV;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * BKV;
    bool live = false;
    if (tid < BKV) {
      const int j = j0 + tid;
      const int sj = j < T ? seg[j] : -1;
      const int pj = j < T ? pos[j] : 0;
      kseg[tid] = sj;
      kpos[tid] = pj;
      // a streaming head needs key j only as a sink or inside the band of
      // the tile's earliest query (conservative across packed segments)
      live = sj >= 0 && sj >= qsum[0] && sj <= qsum[1] && pj <= qsum[2] &&
             (dense || pj < sink_size || pj + local_size > qsum[3]);
    }
    // skip tiles with no (same segment, causal, in band) pair; uniform per
    // block
    if (!__syncthreads_or(live)) continue;

    load_tile(kS, k + (size_t)hk * D, j0, T, Hkv * D);
    load_tile(vS, v + (size_t)hk * D, j0, T, Hkv * D);
    __syncthreads();

    // scores: rows ty*4 + r, cols tx + 16*c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(qS + (ty * 4 + r) * DS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] = *reinterpret_cast<const float4*>(kS + (tx + 16 * c) * DS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] += qa[r].x * kb[c].x + qa[r].y * kb[c].y +
                     qa[r].z * kb[c].z + qa[r].w * kb[c].w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ir = ty * 4 + r;
      const int si = qseg[ir], pi = qpos[ir];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        const int pj = kpos[jc];
        const bool ok = si >= 0 && kseg[jc] == si && pj <= pi &&
                        (dense || pj < sink_size || pi - pj < local_size);
        S[ir * SS + jc] = ok ? s[r][c] * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns query rows 8w .. 8w+7
    for (int ir = warp * 8; ir < warp * 8 + 8; ++ir) {
      const float s0 = S[ir * SS + lane], s1 = S[ir * SS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[ir];
      const float m_new = fmaxf(m_old, mx);
      float p0 = 0.0f, p1 = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {
        alpha = expf(m_old - m_new);
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
      }
      S[ir * SS + lane] = p0;
      S[ir * SS + lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane == 0) {
        m_s[ir] = m_new;
        l_s[ir] = l_s[ir] * alpha + ps;
        a_s[ir] = alpha;
      }
    }
    __syncthreads();

    // O = alpha * O + P V: rows ty*4 + r, cols tx*8 .. tx*8 + 7
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float al = a_s[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= al;
    }
    for (int j = 0; j < BKV; ++j) {
      const float4 v0 = *reinterpret_cast<const float4*>(vS + j * DS + tx * 8);
      const float4 v1 =
          *reinterpret_cast<const float4*>(vS + j * DS + tx * 8 + 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = S[(ty * 4 + r) * SS + j];
        acc[r][0] += p * v0.x;
        acc[r][1] += p * v0.y;
        acc[r][2] += p * v0.z;
        acc[r][3] += p * v0.w;
        acc[r][4] += p * v1.x;
        acc[r][5] += p * v1.y;
        acc[r][6] += p * v1.z;
        acc[r][7] += p * v1.w;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ir = ty * 4 + r, i = i0 + ir;
    if (i >= T) continue;
    const float l = l_s[ir];
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    __nv_bfloat16* o = out + ((size_t)i * Hq + h) * D + tx * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[c] = __float2bfloat16(acc[r][c] * inv);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// flags: [Hkv] int32 (1 dense, 0 streaming) or null for all dense.
int launch_flash_prefill(const void* q, const void* k, const void* v,
                         const void* segment_ids, const void* positions,
                         const void* flags, void* out, int T, int Hq, int Hkv,
                         int sink_size, int local_size, float sm_scale,
                         void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq);
  flash_prefill_kernel<<<grid, NT, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(segment_ids), static_cast<const int*>(positions),
      static_cast<const int*>(flags), static_cast<__nv_bfloat16*>(out), T, Hq,
      Hkv, sink_size, local_size, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
