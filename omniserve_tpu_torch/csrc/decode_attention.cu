// Paged decode attention for Hopper (sm_90a): three entry points over one
// page walk.
//
// Replace the TPU kernels of omniserve_tpu/ops/pallas/decode_attention.py:
//   1. paged_mqa_attention_single_pass (:620, kernel _sp_kernel :112) in its
//      append= mode over a dense, contiguous page list, kv4 or kv8 pools
//      (launch_decode_attention_append);
//   2. paged_mqa_attention_single_pass_ph (:1119, kernel _sp_kernel_ph :850):
//      dynamic-sparse decode over per-(sequence, kv head) page lists
//      (launch_decode_attention_ph);
//   3. paged_mqa_attention_single_pass in its plain mode with the streaming
//      band over a ring pool: one page list per sequence, shared by the
//      heads (launch_decode_attention_band);
// entries 1-3 over kv4 or kv8 pools, fine-grained or per-tensor;
// and of omniserve_tpu/ops/pallas/paged_attention.py:
//   4. paged_mqa_attention (:255, kernel _mqa_kernel :58), the two-stage
//      decode, over a kv16 (bf16) pool: one page list per sequence, read in
//      place, with no gather stage (launch_decode_attention_kv16).
// Entries 2 and 3 are one kernel (decode_attn_list_kernel), see below;
// entry 4 is a kernel of its own (decode_attn_kv16_kernel) so the kv4
// instantiations keep their code.
//
// Contract of entry 1 (plain version: omniserve_tpu_torch/ops/cuda/decode_attention.py
// paged_decode_attention_fused_plain = append_kv, then
// attention_ref.paged_decode_attention on the updated pool):
//   - context_lens INCLUDE the new token; a row with length 0 is inactive:
//     it writes nothing and outputs zeros.
//   - the new token goes to logical page (len-1) // page, slot
//     (len-1) % page; it is quantized from its bf16 value (fine-grained
//     over L = 15 levels for kv4, 255 for kv8: scale = max(max-min,
//     1e-8)/L, zero = -L*min/range, code = rint(x/scale + zero) in [0, L]),
//     attended through its dequantized value, and written into the pool:
//     kv4 merges its nibble into the byte it shares with slot s +- page/2,
//     kv8 writes one byte per value at row s; its four folded plane lanes
//     are set (k_scale, k_scale*(k_zero+128), v_scale, v_zero+128) for both.
//   - pool layout: kv4 k/v [P, H, page/2, D] uint8 (half-split: token t at
//     row t % (page/2), high nibble iff t >= page/2); kv8 k/v [P, H, page,
//     D] uint8 (token t at row t, codes without bias: value = (code - zero)
//     * scale); planes [P, 4, H, page] f32.
//   - per-tensor mode (PT, kv_zeros=False): no planes; the layer's K and V
//     scales kpt, vpt are device scalars (read inside the kernel, so a
//     captured step never reads them on the host). The new token is coded
//     clip(rint(x / pt), -qmax-1, qmax) + qmax+1 (qmax 7 or 127) and every
//     code is read as (code - bias) * pt, bias = qmax+1: the per-token
//     staging below takes scale = pt and zero = bias, so the score and P.V
//     loops are the fine-grained ones.
//
// What bounds it: device-memory bytes (each cached token costs D bytes of
// K+V nibbles, 2*D bytes under kv8, and 16 bytes of planes; the math is a
// few FMAs per byte).
// Design: one block per (kv head, sequence) walks that sequence's pages;
// one thread per token computes the n_rep query dots straight from the
// packed nibbles (rank-1 zero-point term from the folded planes), one warp
// per query row runs the online softmax over the page, and one thread per
// head-dim lane accumulates P.V from the packed V rows. The new token is an
// extra exact lane; its write-back happens after every pool read of the
// block. Compiled with --fmad=false so the quantization codes and planes
// are bit-identical to the plain append.

#include "kv_common.cuh"

namespace {

using namespace kv;

// KV_BITS = 4 (half-split nibble pages) or 8 (one byte per value); PT =
// per-tensor codes (planes null, kpt / vpt the layer's scales).
template <int NREP, int KV_BITS, bool PT>
__global__ void __launch_bounds__(NT) decode_attn_append_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, H, n_rep, D]
    const __nv_bfloat16* __restrict__ k_new,  // [B, H, D]
    const __nv_bfloat16* __restrict__ v_new,  // [B, H, D]
    uint8_t* __restrict__ k_data,             // layer: [P, H, rows, D]
    uint8_t* __restrict__ v_data,
    float* __restrict__ planes,               // layer: [P, 4, H, page]
    const float* __restrict__ kpt,            // PT: the layer's K scale
    const float* __restrict__ vpt,            // PT: the layer's V scale
    const int* __restrict__ block_tables,     // [B, W]
    const int* __restrict__ context_lens,     // [B]
    __nv_bfloat16* __restrict__ out,          // [B, H, n_rep, D]
    int H, int page, int W, float sm_scale) {
  constexpr int n_rep = NREP;
  __shared__ float q_s[NREP][D];
  __shared__ float score[NREP][MAX_PAGE];
  __shared__ float ks[MAX_PAGE], kc[MAX_PAGE], vs[MAX_PAGE], vz[MAX_PAGE];
  __shared__ float qsum[NREP], m_s[NREP], l_s[NREP];
  __shared__ float alpha_s[NREP], c_s[NREP];
  __shared__ float red[NWARP];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = context_lens[b];
  const size_t row_base = ((size_t)b * H + h) * n_rep;
  if (len <= 0) {
    for (int r = 0; r < n_rep; ++r)
      out[(row_base + r) * D + tid] = __float2bfloat16(0.0f);
    return;
  }
  constexpr bool KV8 = KV_BITS == 8;
  constexpr int LEVELS = KV8 ? 255 : 15;
  constexpr int QMAX = KV8 ? 127 : 7;          // per-tensor code range
  constexpr float BIAS = (float)(QMAX + 1);
  const float k_pt = PT ? *kpt : 0.0f, v_pt = PT ? *vpt : 0.0f;
  const int half = page / 2;
  const int rows = KV8 ? page : half;   // byte rows per page and head

  for (int r = 0; r < n_rep; ++r)
    q_s[r][tid] = __bfloat162float(q[(row_base + r) * D + tid]);
  __syncthreads();
  for (int r = 0; r < n_rep; ++r) {
    const float s = block_reduce(q_s[r][tid], 0, red);
    if (tid == 0) qsum[r] = s;
  }

  // the new token: quantize, attend through its dequantized value
  const size_t kv_off = ((size_t)b * H + h) * D + tid;
  const float kx = __bfloat162float(k_new[kv_off]);
  const float vx = __bfloat162float(v_new[kv_off]);
  const TokQuant kq = PT ? quant_pt<QMAX>(kx, k_pt) : quant_kv<LEVELS>(kx, red);
  const TokQuant vq = PT ? quant_pt<QMAX>(vx, v_pt) : quant_kv<LEVELS>(vx, red);
  float acc[NREP];
  for (int r = 0; r < n_rep; ++r) {
    const float s = block_reduce(q_s[r][tid] * kq.dq, 0, red) * sm_scale;
    if (tid == 0) {
      m_s[r] = s;
      l_s[r] = 1.0f;
    }
    acc[r] = vq.dq;
  }
  __syncthreads();

  // existing tokens: positions [0, len - 1)
  const int n_old = len - 1;
  const int n_pages = (n_old + page - 1) / page;
  for (int p = 0; p < n_pages; ++p) {
    const int phys = block_tables[(size_t)b * W + p];
    const int ntok = min(page, n_old - p * page);
    const uint8_t* krows = k_data + ((size_t)phys * H + h) * rows * D;
    const uint8_t* vrows = v_data + ((size_t)phys * H + h) * rows * D;
    for (int t = tid; t < page; t += NT) {
      if constexpr (PT) {
        ks[t] = k_pt;
        kc[t] = BIAS * k_pt;
        vs[t] = v_pt;
        vz[t] = BIAS;
      } else {
        const float* pl =
            planes + (size_t)phys * 4 * H * page + (size_t)h * page;
        const float s0 = pl[t];
        ks[t] = s0;
        kc[t] = pl[(size_t)H * page + t] - 128.0f * s0;   // k_scale * k_zero
        vs[t] = pl[(size_t)2 * H * page + t];
        vz[t] = pl[(size_t)3 * H * page + t] - 128.0f;     // v_zero
      }
    }
    __syncthreads();
    // scores: one thread per token, dots over the K codes
    for (int t = tid; t < page; t += NT) {
      if (t < ntok) {
        const int shift = (!KV8 && t >= half) ? 4 : 0;
        const uint32_t mask = KV8 ? 0xFFu : 0xFu;
        const uint4* kr = reinterpret_cast<const uint4*>(
            krows + (size_t)(KV8 ? t : t % half) * D);
        float dot[NREP];
        for (int r = 0; r < n_rep; ++r) dot[r] = 0.0f;
#pragma unroll 2
        for (int c = 0; c < D / 16; ++c) {
          const uint4 w4 = kr[c];
          const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float code =
                  (float)((words[wi] >> (8 * e + shift)) & mask);
              const int d = c * 16 + wi * 4 + e;
              for (int r = 0; r < n_rep; ++r) dot[r] += q_s[r][d] * code;
            }
          }
        }
        for (int r = 0; r < n_rep; ++r)
          score[r][t] = sm_scale * (ks[t] * dot[r] - kc[t] * qsum[r]);
      }
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int r = warp; r < n_rep; r += NWARP) {
      float mx = -INFINITY;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, score[r][t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float lsum = 0.0f, csum = 0.0f;
      for (int t = lane; t < page; t += 32) {
        const float pr = t < ntok ? expf(score[r][t] - m_new) : 0.0f;
        const float w = pr * vs[t];
        score[r][t] = w;
        lsum += pr;
        csum += w * vz[t];
      }
      lsum = warp_sum(lsum);
      csum = warp_sum(csum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + lsum;
        alpha_s[r] = alpha;
        c_s[r] = csum;
      }
    }
    __syncthreads();
    // P.V: one thread per head-dim lane; kv4 rows t and t + page/2 share a
    // byte, kv8 rows hold one token each
    for (int r = 0; r < n_rep; ++r) acc[r] = acc[r] * alpha_s[r] - c_s[r];
    if constexpr (KV8) {
      for (int row = 0; row < ntok; ++row) {
        const float code = (float)vrows[(size_t)row * D + tid];
        for (int r = 0; r < n_rep; ++r) acc[r] += score[r][row] * code;
      }
    } else {
      const int nrow = min(half, ntok);
      for (int row = 0; row < nrow; ++row) {
        const uint32_t byte = vrows[(size_t)row * D + tid];
        const float lo = (float)(byte & 0xF);
        const float hi = (float)(byte >> 4);
        const bool has_hi = row + half < ntok;
        for (int r = 0; r < n_rep; ++r) {
          acc[r] += score[r][row] * lo;
          if (has_hi) acc[r] += score[r][row + half] * hi;
        }
      }
    }
    __syncthreads();
  }

  for (int r = 0; r < n_rep; ++r)
    out[(row_base + r) * D + tid] = __float2bfloat16(acc[r] / l_s[r]);

  // write-back of the new token (after every pool read of this block)
  const int pos = len - 1;
  const int phys = block_tables[(size_t)b * W + pos / page];
  const int slot = pos % page;
  const uint32_t kc_new = (uint32_t)kq.code, vc_new = (uint32_t)vq.code;
  if constexpr (KV8) {
    const size_t byte_off = (((size_t)phys * H + h) * page + slot) * D + tid;
    k_data[byte_off] = (uint8_t)kc_new;
    v_data[byte_off] = (uint8_t)vc_new;
  } else {
    const int row = slot % half;
    const bool is_hi = slot >= half;
    const size_t byte_off = (((size_t)phys * H + h) * half + row) * D + tid;
    const uint32_t kb = k_data[byte_off], vb = v_data[byte_off];
    k_data[byte_off] = (uint8_t)(is_hi ? ((kb & 0x0F) | (kc_new << 4))
                                       : ((kb & 0xF0) | kc_new));
    v_data[byte_off] = (uint8_t)(is_hi ? ((vb & 0x0F) | (vc_new << 4))
                                       : ((vb & 0xF0) | vc_new));
  }
  if (!PT && tid < 4) {
    float val;
    if (tid == 0) val = kq.scale;
    else if (tid == 1) val = kq.scale * (kq.zero + 128.0f);
    else if (tid == 2) val = vq.scale;
    else val = vq.zero + 128.0f;
    planes[(((size_t)phys * 4 + tid) * H + h) * page + slot] = val;
  }
}

// Decode attention over explicit page lists (entries 2 and 3).
//
// Contract (plain version: attention_ref.paged_decode_attention with
// page_idxes, and with a streaming pool; the wrappers in
// omniserve_tpu_torch/ops/cuda/decode_attention.py build the lists):
//   - pages as entry 1 reads them: kv4 half-split nibble rows or kv8 byte
//     rows, fine-grained (folded planes) or per-tensor (PT: no planes, the
//     layer's scales kpt / vpt read on the device, codes biased by 8 / 128);
//   - entry i of a list names a physical page sel_phys and the logical page
//     sel_logic it holds (-1 = dead entry, skipped); lists are in no order.
//     head_stride = entries per head for per-head lists, 0 for one list per
//     sequence shared by every head of the pool.
//   - the token in slot t of the page sits at position sel_logic*page + t.
//     BAND with band_sink >= 0 and ring_span > 0: the page being written (logical page
//     (len-1)/page) still holds, past its write head, tokens of one ring
//     wrap earlier: those slots are relabelled pos - ring_span*page and are
//     live only at or above ring_sink_tok.
//   - a token is attended iff pos < len (and, relabelled, pos >= the ring's
//     first position), and under BAND only if pos < band_sink or
//     pos >= max(0, len - band_local).
//   - a row with len <= 0, or no live token, outputs zeros.
// The pool is only read. Bounded by device-memory bytes, as entry 1: each
// listed page costs its K/V codes (D bytes a token under kv4, 2*D under
// kv8) and, fine-grained, four plane rows. Same design: one block per
// (pool head, sequence), one thread per token for the scores, one warp per
// query row for the online softmax, one thread per head-dim lane for P.V;
// garbage in dead slots (never-written planes, stale codes) is masked
// before it meets a product: a dead slot's P.V weight is 0 and a code is
// always finite. KV_BITS and PT are template axes, so the kv4 fine-grained
// instantiations keep the code they had.
template <int NREP, bool BAND, int KV_BITS, bool PT>
__global__ void __launch_bounds__(NT) decode_attn_list_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, H, n_rep, D]
    const uint8_t* __restrict__ k_data,       // layer: [P, H, rows, D]
    const uint8_t* __restrict__ v_data,
    const float* __restrict__ planes,         // layer: [P, 4, H, page]
    const float* __restrict__ kpt,            // PT: the layer's K scale
    const float* __restrict__ vpt,            // PT: the layer's V scale
    const int* __restrict__ sel_phys,         // [B, (H,) Tp]
    const int* __restrict__ sel_logic,        // [B, (H,) Tp]
    const int* __restrict__ lengths,          // [B]
    __nv_bfloat16* __restrict__ out,          // [B, H, n_rep, D]
    int H, int page, int Tp, int head_stride, float sm_scale, int band_sink,
    int band_local, int ring_span, int ring_sink_tok) {
  constexpr int n_rep = NREP;
  __shared__ float q_s[NREP][D];
  __shared__ float score[NREP][MAX_PAGE];
  __shared__ float ks[MAX_PAGE], kc[MAX_PAGE], vs[MAX_PAGE], vz[MAX_PAGE];
  __shared__ unsigned char live[MAX_PAGE];
  __shared__ float qsum[NREP], m_s[NREP], l_s[NREP];
  __shared__ float alpha_s[NREP], c_s[NREP];
  __shared__ float red[NWARP];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  const size_t row_base = ((size_t)b * H + h) * n_rep;
  if (len <= 0) {
    for (int r = 0; r < n_rep; ++r)
      out[(row_base + r) * D + tid] = __float2bfloat16(0.0f);
    return;
  }
  constexpr bool KV8 = KV_BITS == 8;
  constexpr float BIAS = KV8 ? 128.0f : 8.0f;   // per-tensor code bias
  const float k_pt = PT ? *kpt : 0.0f, v_pt = PT ? *vpt : 0.0f;
  const int half = page / 2;
  const int rows = KV8 ? page : half;   // byte rows per page and head
  const int cur_page = (len - 1) / page, cur_slot = (len - 1) % page;
  const int win_start = max(0, len - band_local);

  for (int r = 0; r < n_rep; ++r)
    q_s[r][tid] = __bfloat162float(q[(row_base + r) * D + tid]);
  __syncthreads();
  for (int r = 0; r < n_rep; ++r) {
    const float s = block_reduce(q_s[r][tid], 0, red);
    if (tid == 0) qsum[r] = s;
  }
  float acc[NREP];
  for (int r = 0; r < n_rep; ++r) acc[r] = 0.0f;
  if (tid < n_rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  const size_t list_off = (size_t)b * (head_stride ? (size_t)H * head_stride
                                                    : (size_t)Tp) +
                          (size_t)h * head_stride;
  for (int i = 0; i < Tp; ++i) {
    const int logic = sel_logic[list_off + i];
    if (logic < 0) continue;                       // block-uniform
    const int first = logic * page;
    const bool ring_cur =
        BAND && band_sink >= 0 && ring_span > 0 && logic == cur_page;
    if (first >= len && !ring_cur) continue;       // nothing live here
    const int phys = sel_phys[list_off + i];
    const uint8_t* krows = k_data + ((size_t)phys * H + h) * rows * D;
    const uint8_t* vrows = v_data + ((size_t)phys * H + h) * rows * D;
    const float* pl = planes + (size_t)phys * 4 * H * page + (size_t)h * page;
    for (int t = tid; t < page; t += NT) {
      int pos = first + t, floor_pos = 0;
      if (ring_cur && t > cur_slot) {
        pos -= ring_span * page;
        floor_pos = ring_sink_tok;
      }
      bool ok = pos < len && pos >= floor_pos;
      if (BAND && band_sink >= 0) ok = ok && (pos < band_sink || pos >= win_start);
      live[t] = ok;
      if constexpr (PT) {            // codes read as (code - bias) * pt
        ks[t] = k_pt;
        kc[t] = BIAS * k_pt;
        vs[t] = v_pt;
        vz[t] = BIAS;
      } else {
        const float s0 = pl[t];
        ks[t] = s0;
        kc[t] = pl[(size_t)H * page + t] - 128.0f * s0;   // k_scale * k_zero
        vs[t] = pl[(size_t)2 * H * page + t];
        vz[t] = pl[(size_t)3 * H * page + t] - 128.0f;     // v_zero
      }
    }
    __syncthreads();
    // scores: one thread per token, dots over the K codes
    for (int t = tid; t < page; t += NT) {
      if (live[t]) {
        const int shift = (!KV8 && t >= half) ? 4 : 0;
        const uint32_t mask = KV8 ? 0xFFu : 0xFu;
        const uint4* kr = reinterpret_cast<const uint4*>(
            krows + (size_t)(KV8 ? t : t % half) * D);
        float dot[NREP];
        for (int r = 0; r < n_rep; ++r) dot[r] = 0.0f;
#pragma unroll 2
        for (int c = 0; c < D / 16; ++c) {
          const uint4 w4 = kr[c];
          const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float code =
                  (float)((words[wi] >> (8 * e + shift)) & mask);
              const int d = c * 16 + wi * 4 + e;
              for (int r = 0; r < n_rep; ++r) dot[r] += q_s[r][d] * code;
            }
          }
        }
        for (int r = 0; r < n_rep; ++r)
          score[r][t] = sm_scale * (ks[t] * dot[r] - kc[t] * qsum[r]);
      }
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int r = warp; r < n_rep; r += NWARP) {
      float mx = -INFINITY;
      for (int t = lane; t < page; t += 32)
        if (live[t]) mx = fmaxf(mx, score[r][t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // m_new stays -inf only while no live token has been met
      const float alpha = m_new == -INFINITY ? 1.0f : expf(m_old - m_new);
      float lsum = 0.0f, csum = 0.0f;
      for (int t = lane; t < page; t += 32) {
        float pr = 0.0f, w = 0.0f;
        if (live[t]) {
          pr = expf(score[r][t] - m_new);
          w = pr * vs[t];
          csum += w * vz[t];
        }
        score[r][t] = w;
        lsum += pr;
      }
      lsum = warp_sum(lsum);
      csum = warp_sum(csum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + lsum;
        alpha_s[r] = alpha;
        c_s[r] = csum;
      }
    }
    __syncthreads();
    // P.V: one thread per head-dim lane; kv4 rows t and t + page/2 share a
    // byte, kv8 rows hold one token each (dead slots carry weight 0, and a
    // code is always finite)
    for (int r = 0; r < n_rep; ++r) acc[r] = acc[r] * alpha_s[r] - c_s[r];
    if constexpr (KV8) {
      for (int row = 0; row < page; ++row) {
        const float code = (float)vrows[(size_t)row * D + tid];
        for (int r = 0; r < n_rep; ++r) acc[r] += score[r][row] * code;
      }
    } else {
      for (int row = 0; row < half; ++row) {
        const uint32_t byte = vrows[(size_t)row * D + tid];
        const float lo = (float)(byte & 0xF);
        const float hi = (float)(byte >> 4);
        for (int r = 0; r < n_rep; ++r)
          acc[r] += score[r][row] * lo + score[r][row + half] * hi;
      }
    }
    __syncthreads();
  }

  for (int r = 0; r < n_rep; ++r) {
    const float l = l_s[r];
    out[(row_base + r) * D + tid] =
        __float2bfloat16(l > 0.0f ? acc[r] / l : 0.0f);
  }
}

// Decode attention over one page list per sequence of a kv16 pool
// (entry 4).
//
// Contract (plain version: attention_ref.paged_decode_attention over a
// kv16 pool; the wrapper passes the dense list of the block table):
//   - pool layer k/v [P, H, page, D] bf16, token t of a page at row t, the
//     values as they are;
//   - entry i of the list names a physical page sel_phys and the logical
//     page sel_logic it holds (-1 = dead, skipped); the token in slot t sits
//     at position sel_logic*page + t and is attended iff pos < len;
//   - out = softmax(q.k * sm_scale) . v over those tokens, in f32; a row
//     with len <= 0, or no live token, outputs zeros.
// What bounds it: device-memory bytes (4*D bytes of K+V per cached token
// and kv head, the n_rep dots are 2*n_rep*D flops against them).
// Design: one block per (kv head, sequence) walks the list. Scores: one
// warp per token, each lane reads 4 consecutive bf16 of the K row (a warp
// reads the 256-byte row in one coalesced sweep) and the n_rep dots are
// warp sums; one warp per query row runs the online softmax over the
// page; P.V: one thread per head-dim lane walks the page's V rows (each
// row one coalesced 256-byte read by the block).
template <int NREP>
__global__ void __launch_bounds__(NT) decode_attn_kv16_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, n_rep, D]
    const __nv_bfloat16* __restrict__ k_data,  // layer: [P, H, page, D]
    const __nv_bfloat16* __restrict__ v_data,
    const int* __restrict__ sel_phys,          // [B, Tp]
    const int* __restrict__ sel_logic,         // [B, Tp]
    const int* __restrict__ lengths,           // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, n_rep, D]
    int H, int page, int Tp, float sm_scale) {
  constexpr int n_rep = NREP;
  __shared__ float q_s[NREP][D];
  __shared__ float score[NREP][MAX_PAGE];
  __shared__ float m_s[NREP], l_s[NREP], alpha_s[NREP];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  const size_t row_base = ((size_t)b * H + h) * n_rep;
  if (len <= 0) {
    for (int r = 0; r < n_rep; ++r)
      out[(row_base + r) * D + tid] = __float2bfloat16(0.0f);
    return;
  }
  for (int r = 0; r < n_rep; ++r)
    q_s[r][tid] = __bfloat162float(q[(row_base + r) * D + tid]);
  if (tid < n_rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[NREP];
  for (int r = 0; r < n_rep; ++r) acc[r] = 0.0f;
  __syncthreads();

  const size_t list_off = (size_t)b * Tp;
  for (int i = 0; i < Tp; ++i) {
    const int logic = sel_logic[list_off + i];
    if (logic < 0) continue;                       // block-uniform
    const int first = logic * page;
    if (first >= len) continue;
    const int ntok = min(page, len - first);
    const int phys = sel_phys[list_off + i];
    const __nv_bfloat16* krows = k_data + ((size_t)phys * H + h) * page * D;
    const __nv_bfloat16* vrows = v_data + ((size_t)phys * H + h) * page * D;
    // scores: one warp per token, 4 lanes of the head dim per thread
    for (int t = warp; t < ntok; t += NWARP) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(krows + (size_t)t * D + lane * 4);
      const float2 k01 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 k23 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float* qr = &q_s[r][lane * 4];
        float dot = qr[0] * k01.x + qr[1] * k01.y + qr[2] * k23.x +
                    qr[3] * k23.y;
        dot = warp_sum(dot);
        if (lane == 0) score[r][t] = dot * sm_scale;
      }
    }
    __syncthreads();
    // online softmax, one warp per query row (ntok >= 1: m_new is finite)
    for (int r = warp; r < n_rep; r += NWARP) {
      float mx = -INFINITY;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, score[r][t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float lsum = 0.0f;
      for (int t = lane; t < ntok; t += 32) {
        const float pr = expf(score[r][t] - m_new);
        score[r][t] = pr;
        lsum += pr;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + lsum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    // P.V: one thread per head-dim lane
    for (int r = 0; r < n_rep; ++r) acc[r] *= alpha_s[r];
#pragma unroll 4
    for (int row = 0; row < ntok; ++row) {
      const float v = __bfloat162float(vrows[(size_t)row * D + tid]);
      for (int r = 0; r < n_rep; ++r) acc[r] += score[r][row] * v;
    }
    __syncthreads();
  }

  for (int r = 0; r < n_rep; ++r) {
    const float l = l_s[r];
    out[(row_base + r) * D + tid] =
        __float2bfloat16(l > 0.0f ? acc[r] / l : 0.0f);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// kv_bits: 4 (half-split nibble pages) or 8 (one byte per value).
// Per-tensor codes when k_pt / v_pt (device addresses of the layer's
// scales) are given; planes are then not read and may be null.
int launch_decode_attention_append(
    const void* q, const void* k_new, const void* v_new, void* k_data,
    void* v_data, void* planes, const void* block_tables,
    const void* context_lens, void* out, int B, int H, int n_rep, int page,
    int W, float sm_scale, int kv_bits, const void* k_pt, const void* v_pt,
    void* stream) {
  const bool pt = k_pt != nullptr;
  if ((kv_bits != 4 && kv_bits != 8) || pt != (v_pt != nullptr) ||
      (!pt && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_BITS(R, BITS, PT)                                           \
  decode_attn_append_kernel<R, BITS, PT><<<grid, NT, 0, s>>>(              \
      static_cast<const __nv_bfloat16*>(q),                                \
      static_cast<const __nv_bfloat16*>(k_new),                            \
      static_cast<const __nv_bfloat16*>(v_new),                            \
      static_cast<uint8_t*>(k_data), static_cast<uint8_t*>(v_data),        \
      static_cast<float*>(planes), static_cast<const float*>(k_pt),        \
      static_cast<const float*>(v_pt),                                     \
      static_cast<const int*>(block_tables),                               \
      static_cast<const int*>(context_lens),                               \
      static_cast<__nv_bfloat16*>(out), H, page, W, sm_scale)
#define LAUNCH(R)                                     \
  if (pt) {                                           \
    if (kv_bits == 8) LAUNCH_BITS(R, 8, true);        \
    else LAUNCH_BITS(R, 4, true);                     \
  } else {                                            \
    if (kv_bits == 8) LAUNCH_BITS(R, 8, false);       \
    else LAUNCH_BITS(R, 4, false);                    \
  }
  switch (n_rep) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 4: LAUNCH(4); break;
    case 8: LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
#undef LAUNCH_BITS
  return (int)cudaGetLastError();
}

static int launch_list(bool band, const void* q, const void* k_data,
                       const void* v_data, const void* planes,
                       const void* sel_phys, const void* sel_logic,
                       const void* lengths, void* out, int B, int H,
                       int n_rep, int page, int Tp, int head_stride,
                       float sm_scale, int band_sink, int band_local,
                       int ring_span, int ring_sink_tok, int kv_bits,
                       const void* k_pt, const void* v_pt, void* stream) {
  const bool pt = k_pt != nullptr;
  if ((kv_bits != 4 && kv_bits != 8) || pt != (v_pt != nullptr) ||
      (!pt && planes == nullptr) || page <= 0 || page > MAX_PAGE)
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_LIST(R, BAND, BITS, PT)                                     \
  decode_attn_list_kernel<R, BAND, BITS, PT><<<grid, NT, 0, s>>>(          \
      static_cast<const __nv_bfloat16*>(q),                                \
      static_cast<const uint8_t*>(k_data),                                 \
      static_cast<const uint8_t*>(v_data),                                 \
      static_cast<const float*>(planes), static_cast<const float*>(k_pt),  \
      static_cast<const float*>(v_pt),                                     \
      static_cast<const int*>(sel_phys), static_cast<const int*>(sel_logic), \
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),  \
      H, page, Tp, head_stride, sm_scale, band_sink, band_local,           \
      ring_span, ring_sink_tok)
#define LAUNCH_MODE(R, BAND)                                  \
  if (pt) {                                                   \
    if (kv_bits == 8) LAUNCH_LIST(R, BAND, 8, true);          \
    else LAUNCH_LIST(R, BAND, 4, true);                       \
  } else {                                                    \
    if (kv_bits == 8) LAUNCH_LIST(R, BAND, 8, false);         \
    else LAUNCH_LIST(R, BAND, 4, false);                      \
  }
#define LAUNCH_REP(R)                     \
  if (band) { LAUNCH_MODE(R, true) }      \
  else { LAUNCH_MODE(R, false) }
  switch (n_rep) {
    case 1: LAUNCH_REP(1); break;
    case 2: LAUNCH_REP(2); break;
    case 4: LAUNCH_REP(4); break;
    case 8: LAUNCH_REP(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_REP
#undef LAUNCH_MODE
#undef LAUNCH_LIST
  return (int)cudaGetLastError();
}

// Dynamic-sparse decode: per-(sequence, head) page lists [B, H, Tp].
// kv_bits 4 or 8; per-tensor codes when k_pt / v_pt (device addresses of
// the layer's scales) are given, and planes may then be null.
int launch_decode_attention_ph(
    const void* q, const void* k_data, const void* v_data,
    const void* planes, const void* sel_phys, const void* sel_logic,
    const void* lengths, void* out, int B, int H, int n_rep, int page,
    int Tp, float sm_scale, int kv_bits, const void* k_pt, const void* v_pt,
    void* stream) {
  return launch_list(false, q, k_data, v_data, planes, sel_phys, sel_logic,
                     lengths, out, B, H, n_rep, page, Tp, Tp, sm_scale, -1,
                     0, 0, 0, kv_bits, k_pt, v_pt, stream);
}

// Plain mode with the streaming band: one page list [B, Tp] per sequence
// (pools as launch_decode_attention_ph takes them).
int launch_decode_attention_band(
    const void* q, const void* k_data, const void* v_data,
    const void* planes, const void* sel_phys, const void* sel_logic,
    const void* lengths, void* out, int B, int H, int n_rep, int page,
    int Tp, float sm_scale, int band_sink, int band_local, int ring_span,
    int ring_sink_tok, int kv_bits, const void* k_pt, const void* v_pt,
    void* stream) {
  return launch_list(true, q, k_data, v_data, planes, sel_phys, sel_logic,
                     lengths, out, B, H, n_rep, page, Tp, 0, sm_scale,
                     band_sink, band_local, ring_span, ring_sink_tok,
                     kv_bits, k_pt, v_pt, stream);
}

// Two-stage decode's kv16 mode: one page list [B, Tp] per sequence over a
// bf16 pool, read in place.
int launch_decode_attention_kv16(
    const void* q, const void* k_data, const void* v_data,
    const void* sel_phys, const void* sel_logic, const void* lengths,
    void* out, int B, int H, int n_rep, int page, int Tp, float sm_scale,
    void* stream) {
  if (page <= 0 || page > MAX_PAGE) return (int)cudaErrorInvalidValue;
  dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_KV16(R)                                                     \
  decode_attn_kv16_kernel<R><<<grid, NT, 0, s>>>(                          \
      static_cast<const __nv_bfloat16*>(q),                                \
      static_cast<const __nv_bfloat16*>(k_data),                           \
      static_cast<const __nv_bfloat16*>(v_data),                           \
      static_cast<const int*>(sel_phys), static_cast<const int*>(sel_logic), \
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),  \
      H, page, Tp, sm_scale)
  switch (n_rep) {
    case 1: LAUNCH_KV16(1); break;
    case 2: LAUNCH_KV16(2); break;
    case 4: LAUNCH_KV16(4); break;
    case 8: LAUNCH_KV16(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_KV16
  return (int)cudaGetLastError();
}

}  // extern "C"
