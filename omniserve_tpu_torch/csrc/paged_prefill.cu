// Chunked-prefill attention over the paged kv4 / kv8 / kv16 pool, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/paged_prefill.py:
//   paged_prefill_attention (:268, kernel _prefill_kernel :39, tile dequant
//   :150-240): dense heads over a block table (fine-grained kv4 or kv8
//   pages, per-tensor kv4 or kv8 pages, kv16 pages), and, over the same
//   pages, the explicit page-list mode with the streaming ring's relabel
//   (:104-111) and the per-head sink + local band (:126), LServe's chunked
//   prefill over the ring pool (kv16 pages: the unpack and scores of
//   :155, :189, :222).
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
// 16 under kv8): the tensor cores. The first port (PR 2) ran mma.sync
// from 4 warps that staged and dequantized each tile synchronously, 13x
// off that bound and 3.7-4.1x slower than SDPA over pre-dequantized K/V.
//
// Design (the shared core is attn_sm90.cuh): one block per (128 query
// rows, kv head, sequence), the chunk's last rows (the most keys)
// launched first; a row is a (token, GQA rep) pair, so the n_rep q heads
// of one kv head share every K/V tile (BM / n_rep whole tokens a block; at
// n_rep 3, 5, 6 or 7 the last rows are dead: no q load, no store). Four
// roles:
// - a copy warp (paged_copy.cuh, shared with row 8) walks the 64-key
//   tiles of the table IN PLACE, up to the causal frontier or over a page
//   list's live slots, and bulk-copies each live tile's codes (and
//   planes) into a ring of 3 raw stages (2 under kv16);
// - a dequant warpgroup turns each raw stage into f16 K and V tiles (bf16
//   values as they are under kv16) in the 128-byte-swizzled layout wgmma
//   reads, with the folded planes or the per-tensor scales, into a ring of
//   2 operand stages; a key that no row can see (dead slot, past the
//   context, NaN planes) is written as 0;
// - two consumer warpgroups of 64 rows run S = Q K^T and O += P V on
//   wgmma (f16, f32 accumulation; P in f16, bf16 under kv16, as the first
//   port), the online softmax in registers; only tiles that hold a causal
//   edge, a dead key or a band edge take an element mask.
// setmaxnreg moves registers from the copy warpgroup (its idle warps exit)
// and the dequant warpgroup to the consumers. What is left between it and
// the bound (H100 SXM, 700 W): ~18% of the bf16 peak on the bench's
// chunks, ~23% over kv16 pages, which skip the dequantization: the
// dequant warpgroup paces the kv4 / kv8 tiles, and each short block's
// prologue (Q staged by the consumers, the rings filling) is not hidden
// (a persistent version ran the bench's chunks 3-10% faster and the ring
// 7-19% slower, items of unequal weight taken in a fixed order).
// Head dim 64 or 128 (a template parameter): at 64 a pool row is 64 bytes
// (kv4 / kv8) or 128 (kv16), the operand tiles one swizzled half each,
// each dequant thread converts half a row into chunks 4 dh .. 4 dh + 3,
// QK^T takes 4 k steps and O one m64n64 accumulator.

#include <type_traits>

#include "paged_copy.cuh"

namespace {

using namespace sm90;

// 2 consumer warpgroups, a dequant warpgroup and a copy warpgroup of which
// one warp works (setmaxnreg acts on whole warpgroups: the idle warps give
// their registers to the consumers and exit)
constexpr int NT = 512;
constexpr int NK = 2;     // operand (f16 / bf16) ring
constexpr int REGS_COPY = 40, REGS_DEQUANT = 64, REGS_CONSUMER = 200;

// The shared-memory layout at head dim HD (64 or 128): a row of the Q, K
// and V operand tiles is NH = HD / 64 swizzled 128-byte halves
template <int KV_BITS, int HD>
struct Cfg {
  static_assert(HD == 64 || HD == 128, "head dim 64 or 128");
  static constexpr int NH = HD / 64;
  static constexpr int ROWB = pool_row_bytes(KV_BITS, HD);  // a pool row
  static constexpr int NR = KV_BITS == 16 ? 2 : 3;        // raw ring
  static constexpr int RAW = 2 * BN * ROWB;    // a tile's K and V rows
  static constexpr int KTILE = NH * HALF;      // a [64][HD] operand tile
  static constexpr int OFF_KV = NH * QHALF;
  static constexpr int OFF_RAW = OFF_KV + NK * 2 * KTILE;
  static constexpr int OFF_META = OFF_RAW + NR * RAW;
  // raw planes [NR][4][BN] f32, raw kp / shift [NR][BN], raw hdr [NR][4],
  // operand kp [NK][BN], operand hdr [NK][4], then the barriers
  static constexpr int META = NR * 4 * BN * 4 + 2 * NR * BN * 4 + NR * 16 +
                              NK * BN * 4 + NK * 16 + 2 * (NR + NK) * 8;
  static constexpr size_t SMEM = OFF_META + META + 1024;   // + alignment
};

// (float)code, exact for code < 2^23, without the int-to-float unit
__device__ __forceinline__ float code_f(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.0f;
}

__device__ __forceinline__ uint32_t h2(float lo, float hi) {
  const __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// SPARSE = a page list and/or per-head flags; the dense instantiation is
// the plain block-table walk, so the bench's chunked prefill pays nothing
// for the ring mode. KV_BITS = 4, 8 (one byte per value) or 16 (bf16
// values); PT = per-tensor codes (kv4 / kv8); HD = the head dim, 64 or
// 128.
template <bool SPARSE, int KV_BITS, bool PT, int HD>
__global__ void __launch_bounds__(NT, 1) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_data,
    const uint8_t* __restrict__ v_data, const float* __restrict__ planes,
    const float* __restrict__ kpt, const float* __restrict__ vpt,
    const int* __restrict__ block_tables, const int* __restrict__ q_positions,
    const int* __restrict__ context_lens, const int* __restrict__ sel_logic,
    const int* __restrict__ flags, __nv_bfloat16* __restrict__ out, int Tc,
    int H, int n_rep, int page, int W, int sink_size, int local_size,
    int ring_span, int ring_sink_tok, float scale_log2) {
  using C = Cfg<KV_BITS, HD>;
  constexpr bool KV8 = KV_BITS == 8, KV16 = KV_BITS == 16;
  constexpr bool FINE = !PT && !KV16;      // planes in the pool
  constexpr int NR = C::NR, ROWB = C::ROWB, NH = C::NH, KTILE = C::KTILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;                         // [NH][128][64] 16-bit
  unsigned char* kvs = base + C::OFF_KV;            // stage: K tile, V tile
  unsigned char* raws = base + C::OFF_RAW;          // stage: K rows, V rows
  float* raw_pl = reinterpret_cast<float*>(base + C::OFF_META);  // [NR][4][BN]
  int* raw_kp = reinterpret_cast<int*>(raw_pl + NR * 4 * BN);    // [NR][BN]
  int* raw_sh = raw_kp + NR * BN;                                // [NR][BN]
  int* raw_hdr = raw_sh + NR * BN;          // [NR][4]: j0 (-1 = end), whole
  int* kv_kp = raw_hdr + NR * 4;                                 // [NK][BN]
  int* kv_hdr = kv_kp + NK * BN;                                 // [NK][4]
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(kv_hdr + NK * 4);
  uint64_t* raw_empty = raw_full + NR;
  uint64_t* kv_full = raw_empty + NR;
  uint64_t* kv_empty = kv_full + NK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * (BM / n_rep);  // heaviest first
  const int Hq = H * n_rep;
  const bool dense = !SPARSE || flags == nullptr || flags[h] != 0;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NR; ++st) {
      mbar_init(&raw_full[st], 32);     // the copy warp's lanes (+ bytes)
      mbar_init(&raw_empty[st], 128);   // the dequant warpgroup
    }
#pragma unroll
    for (int st = 0; st < NK; ++st) {
      mbar_init(&kv_full[st], 128);     // the dequant warpgroup
      mbar_init(&kv_empty[st], 8);      // one arrive per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 12) {
    // ---- copy warp: walk the table, bring live tiles' rows in ----
    reg_dealloc<REGS_COPY>();
    if (warp != 12) return;
    const PagedWalk walk{k_data, v_data, planes, block_tables, q_positions,
                         context_lens, SPARSE ? sel_logic : nullptr, b, h, H,
                         Tc, t0, n_rep, page, W, sink_size, local_size,
                         ring_span, ring_sink_tok, dense};
    const RawRing ring{raws, raw_pl, raw_kp, raw_sh, raw_hdr, raw_full,
                       raw_empty};
    paged_copy_warp<SPARSE, KV_BITS, FINE, NR, HD>(walk, ring, lane);
  } else if (warp >= 8) {
    // ---- dequant warpgroup: raw rows -> swizzled f16 (bf16) tiles ----
    reg_dealloc<REGS_DEQUANT>();
    // key r, half dh of its HD values: at HD = 128 operand half dh; at 64
    // chunks 4 dh .. 4 dh + 3 of the one half
    const int td = tid - 256, r = td >> 1, dh = td & 1;
    const int oh = NH == 2 ? dh : 0, oc = NH == 2 ? 0 : 4 * dh;
    float ks_pt = 0.0f, vs_pt = 0.0f;
    if constexpr (PT) {
      ks_pt = *kpt;
      vs_pt = *vpt;
    }
    Ring rr, rk;
    while (true) {
      mbar_wait(&raw_full[rr.stage], rr.phase);
      const int j0 = raw_hdr[4 * rr.stage];
      mbar_wait(&kv_empty[rk.stage], rk.phase ^ 1u);
      if (td == 0) {
        kv_hdr[4 * rk.stage] = j0;
        kv_hdr[4 * rk.stage + 1] = raw_hdr[4 * rr.stage + 1];
      }
      if (j0 >= 0) {
        const int kp = raw_kp[rr.stage * BN + r];
        const bool dead = kp == NO_POS;
        if (dh == 0) kv_kp[rk.stage * BN + r] = kp;
        const unsigned char* sk = raws + rr.stage * C::RAW + r * ROWB;
        const unsigned char* sv = sk + BN * ROWB;
        unsigned char* dk = kvs + rk.stage * 2 * KTILE + oh * HALF;
        unsigned char* dv = dk + KTILE;
        if constexpr (KV16) {
          const int co = chunk_order(r, dh);
#pragma unroll
          for (int s = 0; s < HD / 16; ++s) {
            const int c = (co ^ s) & (HD / 16 - 1);
            uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
            if (!dead) {
              kx = *reinterpret_cast<const uint4*>(sk + dh * HD + c * 16);
              vx = *reinterpret_cast<const uint4*>(sv + dh * HD + c * 16);
            }
            *reinterpret_cast<uint4*>(dk + swz(r, oc + c)) = kx;
            *reinterpret_cast<uint4*>(dv + swz(r, oc + c)) = vx;
          }
        } else {
          float ks, kc, vs, vz;
          if constexpr (PT) {
            constexpr float bias = KV8 ? 128.0f : 8.0f;
            ks = ks_pt;
            kc = bias * ks_pt;
            vs = vs_pt;
            vz = bias;
          } else {
            const float* pl = raw_pl + rr.stage * 4 * BN;
            ks = dead ? 0.0f : pl[r];
            kc = dead ? 0.0f : pl[BN + r] - 128.0f * ks;    // k_scale * k_zero
            vs = dead ? 0.0f : pl[2 * BN + r];
            vz = dead ? 0.0f : pl[3 * BN + r] - 128.0f;     // v_zero
          }
          const int sh = raw_sh[rr.stage * BN + r];
          constexpr uint32_t mask = KV8 ? 0xFFu : 0xFu;
#pragma unroll
          for (int s = 0; s < HD / 32; ++s) {
            // 16 codes: values dh * HD/2 + 16 ci .. + 15, chunks oc + 2 ci,
            // + 1
            const int ci = (s + r + 2 * dh) & (HD / 32 - 1);
            uint32_t wk[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
            uint32_t wv[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
            if (!dead) {
              const uint4 kw = *reinterpret_cast<const uint4*>(
                  sk + dh * (HD / 2) + ci * 16);
              const uint4 vw = *reinterpret_cast<const uint4*>(
                  sv + dh * (HD / 2) + ci * 16);
              const uint32_t kws[4] = {kw.x, kw.y, kw.z, kw.w};
              const uint32_t vws[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
              for (int wi = 0; wi < 4; ++wi) {
                float a[4], bv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  a[e] = code_f((kws[wi] >> (8 * e + sh)) & mask) * ks - kc;
                  bv[e] = (code_f((vws[wi] >> (8 * e + sh)) & mask) - vz) * vs;
                }
                wk[2 * wi] = h2(a[0], a[1]);
                wk[2 * wi + 1] = h2(a[2], a[3]);
                wv[2 * wi] = h2(bv[0], bv[1]);
                wv[2 * wi + 1] = h2(bv[2], bv[3]);
              }
            }
            *reinterpret_cast<uint4*>(dk + swz(r, oc + 2 * ci)) =
                make_uint4(wk[0], wk[1], wk[2], wk[3]);
            *reinterpret_cast<uint4*>(dk + swz(r, oc + 2 * ci + 1)) =
                make_uint4(wk[4], wk[5], wk[6], wk[7]);
            *reinterpret_cast<uint4*>(dv + swz(r, oc + 2 * ci)) =
                make_uint4(wv[0], wv[1], wv[2], wv[3]);
            *reinterpret_cast<uint4*>(dv + swz(r, oc + 2 * ci + 1)) =
                make_uint4(wv[4], wv[5], wv[6], wv[7]);
          }
        }
        fence_proxy_async();
      }
      mbar_arrive(&kv_full[rk.stage]);
      mbar_arrive(&raw_empty[rr.stage]);
      rr.advance<NR>();
      rk.advance<NK>();
      if (j0 < 0) break;
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    reg_alloc<REGS_CONSUMER>();
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    {
      // this warpgroup's 64 rows of Q into the swizzled tile: f16, or
      // bf16 as it is under kv16; thread (rq, dh) writes half dh of the row
      // (HD = 64: chunks 4 dh .. 4 dh + 3 of the one half)
      const int tw = tid & 127, rq = 64 * wg + (tw >> 1), dh = tw & 1;
      const int t = row_token(t0, rq, n_rep);
      const __nv_bfloat16* src =
          q + (((size_t)b * Tc + t) * Hq + h * n_rep + rq % n_rep) * HD +
          dh * (HD / 2);
      unsigned char* dst = qs + (NH == 2 ? dh : 0) * QHALF;
      const int qc = NH == 2 ? 0 : 4 * dh;
      const int co = chunk_order(rq, dh);
#pragma unroll
      for (int s = 0; s < HD / 16; ++s) {
        const int c = (co ^ s) & (HD / 16 - 1);
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (t < Tc) {
          x = *reinterpret_cast<const uint4*>(src + c * 8);
          if constexpr (!KV16) {
            const __nv_bfloat162* p =
                reinterpret_cast<const __nv_bfloat162*>(&x);
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p[e]);
              w[e] = h2(f.x, f.y);
            }
            x = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        *reinterpret_cast<uint4*>(dst + swz(rq, qc + c)) = x;
      }
      fence_proxy_async();
      wg_sync(1 + wg);
    }
    const int r0 = 64 * wg + 16 * wl + g;    // this thread's rows r0, r0 + 8
    int qpos[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int t = row_token(t0, r0 + 8 * hi, n_rep);
      qpos[hi] = t < Tc ? q_positions[(size_t)b * Tc + t] : -1;
    }
    float o0[32], o1[32], s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] = o1[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    const uint32_t q0 = smem_u32(qs) + wg * 64 * 128, q1 = q0 + QHALF;
    Ring ring;
    while (true) {
      const int st = ring.stage;
      mbar_wait(&kv_full[st], ring.phase);
      if (kv_hdr[4 * st] < 0) break;
      const bool whole = kv_hdr[4 * st + 1] != 0;
      const uint32_t kb = smem_u32(kvs + st * 2 * KTILE);
      qk_tile<!KV16, NH>(s, q0, q1, kb, kb + HALF);
      if (whole) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
      } else {
        const int* kps = kv_kp + st * BN;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int2 p2 = *reinterpret_cast<const int2*>(kps + nb * 8 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hi = e >> 1, qp = qpos[hi];
            const int kp = (e & 1) ? p2.y : p2.x;   // NO_POS fails kp <= qp
            bool ok = qp >= 0 && kp <= qp;
            if constexpr (SPARSE)
              ok = ok && (dense || kp < sink_size || qp - kp < local_size);
            s[4 * nb + e] = ok ? s[4 * nb + e] * scale_log2 : -INFINITY;
          }
        }
      }
      softmax_tile<NH>(s, m, l, o0, o1);
      pv_tile<!KV16, NH>(o0, o1, s, kb + KTILE, kb + KTILE + HALF);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[st]);
      ring.advance<NK>();
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int rq = r0 + 8 * hi, t = row_token(t0, rq, n_rep);
      const size_t orow =
          ((size_t)b * Tc + min(t, Tc - 1)) * Hq + h * n_rep + rq % n_rep;
      store_row<NH>(out + orow * HD, o0, o1, hi, l[hi], qpos[hi] < 0,
                    t < Tc, lane);
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
// per-tensor scales (kv4 / kv8 without planes), or null. Every mode
// takes a page list or flags.
// n_rep 1 to 8 (a block holds BM / n_rep whole tokens, paged_copy.cuh);
// head_dim 64 or 128.
// k_data, v_data and planes 16-byte aligned.
int launch_paged_prefill(const void* q, const void* k_data,
                         const void* v_data, const void* planes,
                         const void* k_pt, const void* v_pt,
                         const void* block_tables, const void* q_positions,
                         const void* context_lens, const void* sel_logic,
                         const void* flags, void* out, int B, int Tc, int H,
                         int n_rep, int page, int W, int sink_size,
                         int local_size, int ring_span, int ring_sink_tok,
                         float sm_scale, int kv_bits, int head_dim,
                         void* stream) {
  const bool sparse = sel_logic != nullptr || flags != nullptr;
  const bool pt = k_pt != nullptr;
  if (n_rep <= 0 || n_rep > 8 || page <= 0 || page % 2 || W <= 0 ||
      (ring_span > 0 && sel_logic == nullptr) ||
      (kv_bits != 4 && kv_bits != 8 && kv_bits != 16) ||
      (head_dim != 64 && head_dim != 128) ||
      pt != (v_pt != nullptr) || (pt && kv_bits == 16) ||
      (!pt && kv_bits != 16 && planes == nullptr) ||
      (reinterpret_cast<uintptr_t>(k_data) |
       reinterpret_cast<uintptr_t>(v_data) |
       reinterpret_cast<uintptr_t>(planes)) % 16)
    return (int)cudaErrorInvalidValue;
  // the 10 instantiations a head dim: dense kv4, kv4 pt, kv8, kv8 pt,
  // kv16; page list / band kv4, kv4 pt, kv8, kv8 pt, kv16
  using Kernel = decltype(&paged_prefill_kernel<false, 4, false, 128>);
  Kernel kernel = nullptr;
  int which = 0;
  size_t smem = 0;
  auto pick = [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    kernel = paged_prefill_kernel<false, 4, false, HD>;
    smem = Cfg<4, HD>::SMEM;
    which = 0;
    if (sparse && kv_bits == 16) {
      kernel = paged_prefill_kernel<true, 16, false, HD>;
      smem = Cfg<16, HD>::SMEM;
      which = 9;
    } else if (sparse) {
      if (kv_bits == 8)
        kernel = pt ? paged_prefill_kernel<true, 8, true, HD>
                    : paged_prefill_kernel<true, 8, false, HD>;
      else
        kernel = pt ? paged_prefill_kernel<true, 4, true, HD>
                    : paged_prefill_kernel<true, 4, false, HD>;
      which = 5 + (kv_bits == 8 ? 2 : 0) + (pt ? 1 : 0);
    } else if (kv_bits == 16) {
      kernel = paged_prefill_kernel<false, 16, false, HD>;
      smem = Cfg<16, HD>::SMEM;
      which = 4;
    } else if (kv_bits == 8) {
      kernel = pt ? paged_prefill_kernel<false, 8, true, HD>
                  : paged_prefill_kernel<false, 8, false, HD>;
      which = pt ? 3 : 2;
    } else if (pt) {
      kernel = paged_prefill_kernel<false, 4, true, HD>;
      which = 1;
    }
    static_assert(Cfg<4, HD>::SMEM == Cfg<8, HD>::SMEM,
                  "kv4 and kv8 share a layout");
  };
  if (head_dim == 64) pick(std::integral_constant<int, 64>());
  else pick(std::integral_constant<int, 128>());
  if (head_dim == 64) which += 10;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // each instantiation's shared-memory size is set, and its register
  // budget checked, once per device
  static bool ready[20][MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES || !ready[which][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (!reg_budget_ok(attr.numRegs, 256, REGS_CONSUMER, 128, REGS_DEQUANT,
                       128, REGS_COPY))
      return (int)cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) ready[which][dev] = true;
  }
  const int tok_per_tile = BM / n_rep;
  dim3 grid(H, B, (Tc + tok_per_tile - 1) / tok_per_tile);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(k_data), static_cast<const uint8_t*>(v_data),
      static_cast<const float*>(planes), static_cast<const float*>(k_pt),
      static_cast<const float*>(v_pt), static_cast<const int*>(block_tables),
      static_cast<const int*>(q_positions),
      static_cast<const int*>(context_lens),
      static_cast<const int*>(sel_logic), static_cast<const int*>(flags),
      static_cast<__nv_bfloat16*>(out), Tc, H, n_rep, page, W, sink_size,
      local_size, ring_span, ring_sink_tok, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // extern "C"
