// Chunked-prefill attention over the paged kv4 / kv8 / kv16 pool, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/paged_prefill.py:
//   paged_prefill_attention (:268, kernel _prefill_kernel :39, tile dequant
//   :150-240): dense heads over a block table (fine-grained kv4 or kv8
//   pages, per-tensor kv4 or kv8 pages, kv16 pages), and, over the same
//   kv4 / kv8 pages but kv16, the explicit page-list mode with the
//   streaming ring's relabel and the per-head sink + local band (LServe's
//   chunked prefill over the ring pool).
//
// Contract (plain version: omniserve_tpu_torch/ops/attention_ref.py
// paged_prefill_attention):
//   q [B, Tc, Hq, D] bf16; one layer of the pool: kv4 k/v [P, H, page/2, D]
//   uint8 in the half-split layout (slot s at row s % (page/2), high nibble
//   iff s >= page/2), or kv8 k/v [P, H, page, D] uint8 (slot s at row s,
//   one byte per value), and planes [P, 4, H, page] f32, folded (k_scale,
//   k_scale*(k_zero+128), v_scale, v_zero+128): either width dequantizes
//   as (code - zero) * scale; per-tensor kv4 / kv8 pages (PT) have no
//   planes and dequantize as (code - bias) * pt, bias 8 / 128, with the
//   layer's K and V scales read from device memory; kv16 k/v [P, H, page,
//   D] bf16 hold the values as they are; block_tables [B, W] int32;
//   q_positions [B, Tc] int32 (-1 = padding); context_lens [B] int32
//   (history + chunk: the caller appends the chunk first).
//   Row r of table slot s holds position kp = logic * page + r, where
//   logic = s (dense table) or sel_logic[b, s] (a page list, -1 dead).
//   With ring_span > 0 the newest page's rows past the write head (logic
//   == (ctx-1) / page, r > (ctx-1) % page) hold tokens one ring wrap
//   older: kp -= ring_span * page, and they live only at kp >=
//   ring_sink_tok. Query (b, i) of q head hq attends row kp of kv head
//   hk = hq / n_rep iff q_pos >= 0, 0 <= kp <= q_pos, kp < context_lens[b]
//   and, for a streaming head (flags[hk] == 0; flags null = all dense),
//   kp < sink_size or q_pos - kp < local_size. A row with no visible key
//   gives 0. Out [B, Tc, Hq, D] bf16.
//
// What bounds it: operations (4 * D flops per visible (query, key) pair
// and q head, against D + 16 bytes per cached token and kv head, 2 * D +
// 16 under kv8).
// Design: one block of 4 warps per (tile of 64 query rows, kv head,
// sequence). A row is a (token, GQA rep) pair, so the n_rep q heads of one
// kv head share every K/V tile. The block reads the pages IN PLACE through
// the block table (no gather copy) and walks 64-token K/V tiles: over a
// dense table only up to its causal frontier min(context_len, max q_pos +
// 1); over a page list (not in position order) every slot, skipping each
// tile whose positions all fall outside the q tile's causal band before
// it loads a byte of it (the LServe prefill gain: a streaming head of a
// 32K chunk reads the sink and ~8K band of its ring). Each tile is
// dequantized with the folded planes (or the per-tensor scales) into f16
// shared memory (K token-major, V transposed), and each warp runs its 16
// rows on the tensor cores with mma.sync m16n8k16 (f16 inputs, f32
// accumulation): S = Q K^T, an online softmax on the S fragments in
// registers, P (f16, re-packed from the S fragments) times V. f16 rather
// than bf16 keeps 11 bits of the dequantized values and of P. kv16 pages
// are bf16, whose range f16 does not hold: that mode copies them into a
// bf16 tile as they are, keeps q in bf16 and runs the bf16 mma.sync (P in
// bf16, as the TPU kernel rounds it). TMA, wgmma and a producer warp are
// later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64, BKV = 64;
constexpr int NT = 128;         // 4 warps x 16 query rows
constexpr int QS = D + 8;       // f16 row stride of the q and k tiles
constexpr int VS = BKV + 8;     // f16 row stride of the transposed v tile

constexpr size_t SMEM_BYTES =
    sizeof(__half) * (BQ * QS + BKV * QS + D * VS) +
    sizeof(float) * 4 * BKV + sizeof(int) * (BQ + 4 * BKV);
constexpr int NO_POS = 0x7fffffff;  // a tile row that holds no token

__device__ __forceinline__ uint32_t pack_h2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);   // lo in the low 16 bits
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_b2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <bool BF16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (BF16) return pack_b2(lo, hi);
  else return pack_h2(lo, hi);
}

__device__ __forceinline__ uint32_t ld32(const __half* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row-major) * b (16x8, column-major), f16 (or, BF16,
// bf16) in, f32 out
template <bool BF16 = false>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (BF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// SPARSE = a page list and/or per-head flags; the dense instantiation is
// the plain block-table walk, so the bench's chunked prefill pays nothing
// for the ring mode. KV_BITS = 4, 8 (one byte per value) or 16 (bf16
// values); PT = per-tensor codes. kv16 is dense only; the fine-grained
// kv4 instantiations compile the code they had without the other modes.
template <bool SPARSE, int KV_BITS, bool PT>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_data,
    const uint8_t* __restrict__ v_data, const float* __restrict__ planes,
    const float* __restrict__ kpt, const float* __restrict__ vpt,
    const int* __restrict__ block_tables, const int* __restrict__ q_positions,
    const int* __restrict__ context_lens, const int* __restrict__ sel_logic,
    const int* __restrict__ flags, __nv_bfloat16* __restrict__ out, int Tc,
    int H, int n_rep, int page, int W, int sink_size, int local_size,
    int ring_span, int ring_sink_tok, float sm_scale) {
  constexpr bool KV8 = KV_BITS == 8, KV16 = KV_BITS == 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 16-bit tiles: f16 values, or bf16 bits under KV16
  __half* Qs = reinterpret_cast<__half*>(smem_raw);   // [BQ][QS]
  __half* Ks = Qs + BQ * QS;                           // [BKV][QS]
  __half* Vt = Ks + BKV * QS;                          // [D][VS]
  float* t_ks = reinterpret_cast<float*>(Vt + D * VS); // per tile token:
  float* t_kc = t_ks + BKV;                            //   k_scale * k_zero
  float* t_vs = t_kc + BKV;                            //   v_scale
  float* t_vz = t_vs + BKV;                            //   v_zero
  int* qpos = reinterpret_cast<int*>(t_vz + BKV);      // [BQ]
  int* t_phys = qpos + BQ;      // [BKV] physical page, -1 = no token
  int* t_row = t_phys + BKV;    // [BKV] byte row within the page
  int* t_shift = t_row + BKV;   // [BKV] 0 (low nibble) or 4 (high)
  int* t_pos = t_shift + BKV;   // [BKV] position, NO_POS = no token
  __shared__ int frontier, q_lo, q_hi;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * (BQ / n_rep);   // first query token of the tile
  const int Hq = H * n_rep;
  const int half = page / 2;
  const int rows = KV_BITS == 4 ? half : page;   // rows per page and head
  const int ctx = context_lens[b];
  const bool dense = !SPARSE || flags == nullptr || flags[h] != 0;
  const bool listed = SPARSE && sel_logic != nullptr;
  // the ring's write head: rows of page cb past it are one wrap older
  const int cb = (ctx - 1) / page, last_row = (ctx - 1) % page;

  // query row r: token t0 + r / n_rep, q head h * n_rep + r % n_rep
  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int t = t0 + r / n_rep;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tc) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tc + t) * Hq + h * n_rep + r % n_rep) * D + c);
      if constexpr (KV16) {
        packed = v;                           // the bf16 tile takes q as is
      } else {
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&v);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          w[e] = pack_h2(f.x, f.y);
        }
        packed = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = packed;
  }
  if (tid < BQ) {
    const int t = t0 + tid / n_rep;
    qpos[tid] = t < Tc ? q_positions[(size_t)b * Tc + t] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int pmax = -1, pmin = NO_POS;
    for (int r = 0; r < BQ; ++r)
      if (qpos[r] >= 0) {
        pmax = max(pmax, qpos[r]);
        pmin = min(pmin, qpos[r]);
      }
    // over a dense table, keys at or past the frontier are visible to no
    // row of this tile; a page list is walked whole
    frontier = pmax < 0 ? 0
                        : (listed ? W * page : min(min(ctx, pmax + 1), W * page));
    q_lo = pmin;
    q_hi = pmax;
  }
  __syncthreads();
  const int kv_end = frontier, qlo = q_lo, qhi = q_hi;

  // this warp's 16 query rows as mma A fragments, kept in registers
  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __half* p = Qs + (r0 + g) * QS + kk * 16 + 2 * t4;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * QS);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * QS + 8);
  }
  const int qp0 = qpos[r0 + g], qp1 = qpos[r0 + g + 8];

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();   // every warp is done with the previous tile
    if constexpr (SPARSE) {
      // the position each row of this K/V tile holds, and whether any
      // query row of the tile can see it (conservative over its rows)
      bool need = false;
      if (tid < BKV) {
        const int j = j0 + tid;
        int phys = -1, kp = NO_POS;
        if (j < kv_end) {
          const int s = j / page, r = j % page;
          const int logic = listed ? sel_logic[(size_t)b * W + s] : s;
          int p = logic * page + r, lo = 0;
          if (ring_span > 0 && logic == cb && r > last_row) {
            p -= ring_span * page;
            lo = ring_sink_tok;
          }
          if (logic >= 0 && p < ctx && p >= lo) {
            kp = p;
            phys = block_tables[(size_t)b * W + s];
          }
        }
        need = kp <= qhi &&
               (dense || kp < sink_size || kp + local_size > qlo);
        t_phys[tid] = need ? phys : -1;
        t_pos[tid] = kp;
      }
      if (!__syncthreads_or(need)) continue;   // uniform per block
    } else if (tid < BKV) {
      const int j = j0 + tid;
      t_phys[tid] = j < kv_end ? block_tables[(size_t)b * W + j / page] : -1;
    }
    // where each needed token lives, and its folded planes (per-tensor:
    // scale pt and zero = the code bias; kv16: none)
    if (tid < BKV) {
      const int phys = t_phys[tid];
      int row = 0, shift = 0;
      float ks = 0.0f, kc = 0.0f, vs = 0.0f, vz = 0.0f;
      if (phys >= 0) {
        const int slot = (j0 + tid) % page;
        row = KV_BITS == 4 ? slot % half : slot;
        shift = (KV_BITS == 4 && slot >= half) ? 4 : 0;
        if constexpr (PT) {
          constexpr float bias = KV8 ? 128.0f : 8.0f;
          ks = *kpt;
          kc = bias * ks;
          vs = *vpt;
          vz = bias;
        } else if constexpr (!KV16) {
          const float* pl = planes + (size_t)phys * 4 * H * page +
                            (size_t)h * page + slot;
          ks = pl[0];
          kc = pl[(size_t)H * page] - 128.0f * ks;        // k_scale * k_zero
          vs = pl[(size_t)2 * H * page];
          vz = pl[(size_t)3 * H * page] - 128.0f;         // v_zero
        }
      }
      t_row[tid] = row;
      t_shift[tid] = shift;
      t_ks[tid] = ks;
      t_kc[tid] = kc;
      t_vs[tid] = vs;
      t_vz[tid] = vz;
    }
    __syncthreads();
    if constexpr (KV16) {
      // copy K token-major and V transposed, 8 bf16 values per 16-byte load
      const __nv_bfloat16* kp = reinterpret_cast<const __nv_bfloat16*>(k_data);
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(v_data);
      for (int i = tid; i < BKV * (D / 8); i += NT) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const int phys = t_phys[r];
        uint4 kw = make_uint4(0u, 0u, 0u, 0u);
        if (phys >= 0)
          kw = *reinterpret_cast<const uint4*>(
              kp + (((size_t)phys * H + h) * page + t_row[r]) * D + c);
        *reinterpret_cast<uint4*>(Ks + r * QS + c) = kw;
      }
      for (int i = tid; i < BKV * (D / 8); i += NT) {
        const int r = i % BKV, c = (i / BKV) * 8;
        const int phys = t_phys[r];
        uint4 vw = make_uint4(0u, 0u, 0u, 0u);
        if (phys >= 0)
          vw = *reinterpret_cast<const uint4*>(
              vp + (((size_t)phys * H + h) * page + t_row[r]) * D + c);
        const uint16_t* e16 = reinterpret_cast<const uint16_t*>(&vw);
        uint16_t* dv = reinterpret_cast<uint16_t*>(Vt + c * VS + r);
#pragma unroll
        for (int e = 0; e < 8; ++e) dv[e * VS] = e16[e];
      }
    } else {
      // dequantize K token-major: 16 bytes (16 lanes of one token) per load
      for (int i = tid; i < BKV * (D / 16); i += NT) {
        const int r = i / (D / 16), c = (i % (D / 16)) * 16;
        uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        const int phys = t_phys[r];
        if (phys >= 0) {
          const uint4 kw = *reinterpret_cast<const uint4*>(
              k_data + (((size_t)phys * H + h) * rows + t_row[r]) * D + c);
          const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
          const int sh = t_shift[r];
          const float ks = t_ks[r], kc = t_kc[r];
          constexpr uint32_t mask = KV8 ? 0xFFu : 0xFu;
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const float a = (float)((words[wi] >> (8 * e + sh)) & mask);
              const float a2 = (float)((words[wi] >> (8 * e + 8 + sh)) & mask);
              w[wi * 2 + e / 2] = pack_h2(a * ks - kc, a2 * ks - kc);
            }
          }
        }
        uint4* dk = reinterpret_cast<uint4*>(Ks + r * QS + c);
        dk[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dk[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      // dequantize V transposed ([d][token]); consecutive lanes take
      // consecutive tokens, so the 2-byte stores do not collide in banks
      for (int i = tid; i < BKV * (D / 16); i += NT) {
        const int r = i % BKV, c = (i / BKV) * 16;
        const int phys = t_phys[r];
        __half* dv = Vt + c * VS + r;
        if (phys >= 0) {
          const uint4 vw = *reinterpret_cast<const uint4*>(
              v_data + (((size_t)phys * H + h) * rows + t_row[r]) * D + c);
          const uint32_t words[4] = {vw.x, vw.y, vw.z, vw.w};
          const int sh = t_shift[r];
          const float vs = t_vs[r], vz = t_vz[r];
          constexpr uint32_t mask = KV8 ? 0xFFu : 0xFu;
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float vq = (float)((words[wi] >> (8 * e + sh)) & mask);
              dv[(wi * 4 + e) * VS] = __float2half_rn((vq - vz) * vs);
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) dv[e * VS] = __float2half_rn(0.0f);
        }
      }
    }
    __syncthreads();

    // S = Q K^T: rows r0 + g (s[.][0..1]) and r0 + g + 8 (s[.][2..3]),
    // keys j0 + nt * 8 + 2 * t4 + {0, 1}
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __half* kb = Ks + (nt * 8 + g) * QS + kk * 16 + 2 * t4;
        mma16816<KV16>(s[nt], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool ok0, ok1;
        if constexpr (SPARSE) {
          // NO_POS fails kp <= qp; the band test runs only on real keys
          const int kp = t_pos[nt * 8 + 2 * t4 + e];
          ok0 = qp0 >= 0 && kp <= qp0 &&
                (dense || kp < sink_size || qp0 - kp < local_size);
          ok1 = qp1 >= 0 && kp <= qp1 &&
                (dense || kp < sink_size || qp1 - kp < local_size);
        } else {
          const int j = j0 + nt * 8 + 2 * t4 + e;   // kv_end <= ctx
          ok0 = qp0 >= 0 && j <= qp0 && j < kv_end;
          ok1 = qp1 >= 0 && j <= qp1 && j < kv_end;
        }
        s[nt][e] = ok0 ? s[nt][e] * sm_scale : -INFINITY;
        s[nt][2 + e] = ok1 ? s[nt][2 + e] * sm_scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    // a row's 64 scores live in the 4 lanes of one quad
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = mn0 == -INFINITY ? 1.0f : expf(m0 - mn0);
    const float al1 = mn1 == -INFINITY ? 1.0f : expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = mn0 == -INFINITY ? 0.0f : expf(s[nt][e] - mn0);
        s[nt][2 + e] = mn1 == -INFINITY ? 0.0f : expf(s[nt][2 + e] - mn1);
        ps0 += s[nt][e];
        ps1 += s[nt][2 + e];
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o_);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o_);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= al0;
      o[nd][1] *= al0;
      o[nd][2] *= al1;
      o[nd][3] *= al1;
    }
    // O += P V: the S accumulator of key tiles 2kk, 2kk+1 is the A
    // fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack2<KV16>(s[2 * kk][0], s[2 * kk][1]),
          pack2<KV16>(s[2 * kk][2], s[2 * kk][3]),
          pack2<KV16>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<KV16>(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __half* vb = Vt + (nd * 8 + g) * VS + kk * 16 + 2 * t4;
        mma16816<KV16>(o[nd], pa, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int ir = r0 + g + 8 * hi;
    const int t = t0 + ir / n_rep;
    if (t >= Tc) continue;
    const float l = hi ? l1 : l0;
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    __nv_bfloat16* orow =
        out + (((size_t)b * Tc + t) * Hq + h * n_rep + ir % n_rep) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nd][2 * hi] * inv, o[nd][2 * hi + 1] * inv);
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// sel_logic: [B, W] int32 logical page per table slot (-1 dead), or null
// for a dense table; flags: [H] int32 (1 dense, 0 streaming) or null for
// all dense; ring_span > 0 (pages) relabels the ring's stale rows;
// kv_bits 4, 8 or 16; k_pt / v_pt: device addresses of the layer's
// per-tensor scales (kv4 / kv8 without planes), or null. kv4 and kv8,
// fine-grained or per-tensor, take a page list or flags; kv16 does not.
int launch_paged_prefill(const void* q, const void* k_data,
                         const void* v_data, const void* planes,
                         const void* k_pt, const void* v_pt,
                         const void* block_tables, const void* q_positions,
                         const void* context_lens, const void* sel_logic,
                         const void* flags, void* out, int B, int Tc, int H,
                         int n_rep, int page, int W, int sink_size,
                         int local_size, int ring_span, int ring_sink_tok,
                         float sm_scale, int kv_bits, void* stream) {
  const bool sparse = sel_logic != nullptr || flags != nullptr;
  const bool pt = k_pt != nullptr;
  if (n_rep <= 0 || BQ % n_rep || page <= 0 || page % 2 || W <= 0 ||
      (ring_span > 0 && sel_logic == nullptr) ||
      (kv_bits != 4 && kv_bits != 8 && kv_bits != 16) ||
      pt != (v_pt != nullptr) || (pt && kv_bits == 16) ||
      (sparse && kv_bits == 16) ||
      (!pt && kv_bits != 16 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_prefill_kernel<false, 4, false>;
  if (sparse) {
    if (kv_bits == 8)
      kernel = pt ? paged_prefill_kernel<true, 8, true>
                  : paged_prefill_kernel<true, 8, false>;
    else
      kernel = pt ? paged_prefill_kernel<true, 4, true>
                  : paged_prefill_kernel<true, 4, false>;
  } else if (kv_bits == 16) kernel = paged_prefill_kernel<false, 16, false>;
  else if (kv_bits == 8)
    kernel = pt ? paged_prefill_kernel<false, 8, true>
                : paged_prefill_kernel<false, 8, false>;
  else if (pt) kernel = paged_prefill_kernel<false, 4, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tok_per_tile = BQ / n_rep;
  dim3 grid((Tc + tok_per_tile - 1) / tok_per_tile, H, B);
  kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(k_data), static_cast<const uint8_t*>(v_data),
      static_cast<const float*>(planes), static_cast<const float*>(k_pt),
      static_cast<const float*>(v_pt), static_cast<const int*>(block_tables),
      static_cast<const int*>(q_positions),
      static_cast<const int*>(context_lens),
      static_cast<const int*>(sel_logic), static_cast<const int*>(flags),
      static_cast<__nv_bfloat16*>(out), Tc, H, n_rep, page, W, sink_size,
      local_size, ring_span, ring_sink_tok, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
