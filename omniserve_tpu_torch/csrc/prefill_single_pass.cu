// Single-pass chunked-prefill attention over kv4 / kv8 pages in the integer
// domain, for Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/prefill_single_pass.py:
//   paged_prefill_single_pass (:291, kernel _psp_kernel :50): the same
//   contract as paged_prefill.cu (row 7), computed as the TPU kernel computes
//   it. A tile is never dequantized: Q (bf16) multiplies the page's raw
//   codes, which bf16 holds exactly (0-15 under kv4, 0-255 under kv8), and
//   each key column is corrected afterwards (:219-234):
//     fine-grained planes  s = (qk_int * s0 - (s1 - 128 s0) * q_sum) * sm
//     per-tensor           s = (qk_int - bias * q_sum) * pt_k * sm
//   with q_sum the row sum of the bf16 q, and P.V runs on the raw V codes
//   (:247-277): p_h = half(p * v_scale[key]), o += p_h . v_code -
//   sum(p_h * (plane3 - 128)) (per tensor: p_h = half(p), o += p_h .
//   v_code - bias * sum(p_h), times pt_v at the end). P is rounded to f16
//   (11 bits) where the TPU kernel rounds it to bf16 (8 bits): with bf16 P
//   the largest (token, head) row error against the f32 plain version
//   comes near the 1e-2-of-the-row's-norm gate at the bench's chunk (~0.5M
//   rows; tests/test_torch_kernels_cuda.py::
//   test_prefill_single_pass_row_error_tail emulates both roundings), and
//   f16 holds the V codes (0-255) exactly as well.
//
// Contract (plain version: omniserve_tpu_torch/ops/attention_ref.py
// paged_prefill_attention, through ops/cuda/paged_prefill.kv_positions_of
// for a page list):
//   q [B, Tc, Hq, D] bf16; one layer of the pool: kv4 k/v [P, H, page/2, D]
//   uint8 in the half-split layout (slot s at row s % (page/2), high nibble
//   iff s >= page/2) or kv8 k/v [P, H, page, D] uint8, and either folded
//   planes [P, 4, H, page] f32 (k_scale, k_scale*(k_zero+128), v_scale,
//   v_zero+128) or per-tensor codes (no planes; bias 8 / 128; the layer's K
//   and V scales read from device memory); block_tables [B, W] int32;
//   q_positions [B, Tc] int32 (-1 = padding); context_lens [B] int32
//   (history + chunk, appended by the caller). Row r of table slot s holds
//   position kp = logic * page + r, logic = s (dense table) or sel_logic[b,
//   s] (a page list, -1 dead). With ring_span > 0 the newest page's rows
//   past the write head (logic == (ctx-1) / page, r > (ctx-1) % page) hold
//   tokens one ring wrap older: kp -= ring_span * page, alive only at kp >=
//   ring_sink_tok (:171-178). Query (b, i) of q head hq attends row kp of kv
//   head hk = hq / n_rep iff q_pos >= 0, 0 <= kp <= q_pos, kp <
//   context_lens[b] and, for a streaming head (flags[hk] == 0; flags null =
//   all dense), kp < sink_size or q_pos - kp < local_size. A row with no
//   visible key gives 0. Out [B, Tc, Hq, D] bf16. page % 128 == 0 and D =
//   128 (the TPU kernel's supports(), decode_attention.py:67-88); n_rep
//   1 to 8 (a block holds BM / n_rep whole tokens, paged_copy.cuh).
//
// What bounds it: operations (4 * D flops per visible (query, key) pair and
// q head, against page * D * kv_bits / 4 + 16 * page bytes per kv head and
// page read): the tensor cores. A first design ran mma.sync from 4 warps
// that unpacked each 128-token unit synchronously before any of them
// multiplied: 2.3-3.7x row 7's time on the wgmma core.
//
// Design: row 7's (paged_prefill.cu) on the same Hopper core
// (attn_sm90.cuh). One block per (128 query rows, kv head, sequence), the
// chunk's last rows (the most keys) launched first; a row is a (token, GQA
// rep) pair, so the n_rep q heads of one kv head share every tile. Four
// roles:
// - row 7's copy warp (paged_copy.cuh): bulk copies of each live 64-key
//   tile's raw K / V code rows and four plane rows into a ring of 3 raw
//   stages, the ballot that skips dead list slots, the causal frontier;
// - a convert warpgroup that only turns codes into 16-bit operand tiles in
//   the 128-byte swizzle wgmma reads, no scale and no zero: K codes into
//   bf16 (kv4: nibble | 0x4300 by a byte permute, bf16(128 + n), the 128
//   folded into the per-key correction, so plane 1 applies as it is; kv8:
//   byte | 0x4B000000 = f32(2^23 + n), minus 2^23, to bf16, exact), V codes
//   into f16 (n | 0x6400 = half(1024 + n), minus 1024); beside each
//   operand stage it leaves each key's corrections (s0, s1 for S; v_scale
//   and v_zero for P; per tensor pt_k, bias * pt_k, 1 and the bias), zero
//   for a key that no row can see (dead slot, past the context, NaN
//   planes), whose codes it writes as 0;
// - two consumer warpgroups of 64 rows: S on wgmma in bf16 against the
//   code tile, q_sum per row computed once when Q is staged, s = s0 * S -
//   s1 * q_sum per key column in registers, the online softmax, P rounded
//   to f16 as p * v_scale[key] into the register A operand of the P.V wgmma
//   over the f16 V-code tile, and the row correction - sum(p_h * v_zero)
//   from the same rounded values; only tiles that hold a causal edge, a
//   dead key or a band edge take an element mask.
// setmaxnreg moves registers from the copy warpgroup (its idle warps exit)
// and the convert warpgroup to the consumers.

#include "paged_copy.cuh"

namespace {

using namespace sm90;

constexpr int NT = 512;   // 2 consumer, 1 convert, 1 copy warpgroup
constexpr int NK = 2;     // operand (bf16 K / f16 V code) ring
constexpr int NR = 3;     // raw ring
constexpr int ROWB = 128;                    // bytes of a kv4 / kv8 pool row
constexpr int RAW = 2 * BN * ROWB;           // a tile's K and V rows
constexpr int REGS_COPY = 40, REGS_CONVERT = 64, REGS_CONSUMER = 200;
constexpr int OFF_KV = 2 * QHALF;
constexpr int OFF_RAW = OFF_KV + NK * 2 * TILE;
constexpr int OFF_META = OFF_RAW + NR * RAW;
// raw planes [NR][4][BN] f32, raw kp / shift [NR][BN], raw hdr [NR][4],
// operand kp [NK][BN], operand corrections [NK][4][BN] f32, operand hdr
// [NK][4], q_sum [BM] f32, then the barriers
constexpr int META = NR * 4 * BN * 4 + 2 * NR * BN * 4 + NR * 16 +
                     NK * BN * 4 + NK * 4 * BN * 4 + NK * 16 + BM * 4 +
                     2 * (NR + NK) * 8;
constexpr size_t SMEM = OFF_META + META + 1024;   // + alignment

__device__ __forceinline__ uint32_t u32(const __half2 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t u32(const __nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 4 codes (one per byte of m, 0-255) -> two f16x2 words of their values:
// f16 bits 0x6400 | n are 1024 + n, exact
__device__ __forceinline__ void codes_to_f16(uint32_t m, uint32_t& w0,
                                             uint32_t& w1) {
  const __half2 k1024 = __floats2half2_rn(1024.0f, 1024.0f);
  uint32_t a = __byte_perm(m, 0x64646464u, 0x5140);
  uint32_t c = __byte_perm(m, 0x64646464u, 0x5342);
  w0 = u32(__hsub2(*reinterpret_cast<__half2*>(&a), k1024));
  w1 = u32(__hsub2(*reinterpret_cast<__half2*>(&c), k1024));
}

// 4 K codes -> two bf16x2 words. kv4 (nibbles, one per byte): bf16 bits
// 0x4300 | n are 128 + n, exact, the 128 left in (the correction takes it
// out); kv8 (bytes): f32 bits 0x4B000000 | n are 2^23 + n, exact, and every
// value 0-255 is exact in bf16.
template <bool KV8>
__device__ __forceinline__ void codes_to_bf16(uint32_t m, uint32_t& w0,
                                              uint32_t& w1) {
  if constexpr (KV8) {
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __uint_as_float(__byte_perm(m, 0x4B000000u, 0x7640 + e)) -
             8388608.0f;
    w0 = u32(__floats2bfloat162_rn(f[0], f[1]));
    w1 = u32(__floats2bfloat162_rn(f[2], f[3]));
  } else {
    w0 = __byte_perm(m, 0x43434343u, 0x5140);
    w1 = __byte_perm(m, 0x43434343u, 0x5342);
  }
}

// SPARSE = a page list and/or per-head flags (the dense instantiation is
// the plain block-table walk); KV8 = one byte per value (else kv4 half-split
// nibbles); PT = per-tensor codes (else folded planes).
template <bool SPARSE, bool KV8, bool PT>
__global__ void __launch_bounds__(NT, 1) prefill_single_pass_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_data,
    const uint8_t* __restrict__ v_data, const float* __restrict__ planes,
    const float* __restrict__ kpt, const float* __restrict__ vpt,
    const int* __restrict__ block_tables, const int* __restrict__ q_positions,
    const int* __restrict__ context_lens, const int* __restrict__ sel_logic,
    const int* __restrict__ flags, __nv_bfloat16* __restrict__ out, int Tc,
    int H, int n_rep, int page, int W, int sink_size, int local_size,
    int ring_span, int ring_sink_tok, float scale_log2) {
  constexpr int KV_BITS = KV8 ? 8 : 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;                  // [2][128][64] bf16
  unsigned char* kvs = base + OFF_KV;        // stage: K codes, V codes
  unsigned char* raws = base + OFF_RAW;      // stage: K rows, V rows
  float* raw_pl = reinterpret_cast<float*>(base + OFF_META);   // [NR][4][BN]
  int* raw_kp = reinterpret_cast<int*>(raw_pl + NR * 4 * BN);  // [NR][BN]
  int* raw_sh = raw_kp + NR * BN;                              // [NR][BN]
  int* raw_hdr = raw_sh + NR * BN;        // [NR][4]: j0 (-1 = end), whole
  int* kv_kp = raw_hdr + NR * 4;                               // [NK][BN]
  // [NK][4][BN]: s0, s1 (S = s0 * qk - s1 * q_sum, both times the
  // softmax scale), v_scale, v_zero
  float* kv_corr = reinterpret_cast<float*>(kv_kp + NK * BN);
  int* kv_hdr = reinterpret_cast<int*>(kv_corr + NK * 4 * BN);  // [NK][4]
  float* q_sum = reinterpret_cast<float*>(kv_hdr + NK * 4);      // [BM]
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(q_sum + BM);
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
      mbar_init(&raw_empty[st], 128);   // the convert warpgroup
    }
#pragma unroll
    for (int st = 0; st < NK; ++st) {
      mbar_init(&kv_full[st], 128);     // the convert warpgroup
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
    paged_copy_warp<SPARSE, KV_BITS, !PT, NR>(walk, ring, lane);
  } else if (warp >= 8) {
    // ---- convert warpgroup: raw codes -> swizzled bf16 K / f16 V code
    // tiles, and each key's corrections ----
    reg_dealloc<REGS_CONVERT>();
    const int td = tid - 256, r = td >> 1, dh = td & 1;   // key r, half dh
    float pt_s0 = 0.0f, pt_s1 = 0.0f;
    if constexpr (PT) {
      // (code - bias) * pt_k, the kv4 codes read as 128 + code
      pt_s0 = *kpt;
      pt_s1 = (KV8 ? 128.0f : 136.0f) * pt_s0;
    }
    // S's corrections carry the softmax scale (log2 domain)
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
        if (dh == 0) {
          kv_kp[rk.stage * BN + r] = kp;
          float s0, s1, vs, vz;
          if constexpr (PT) {
            s0 = pt_s0;
            s1 = pt_s1;
            vs = 1.0f;
            vz = KV8 ? 128.0f : 8.0f;
          } else {
            const float* pl = raw_pl + rr.stage * 4 * BN;
            s0 = pl[r];
            // plane 1 is k_scale * (k_zero + 128): kv4 codes carry the 128
            s1 = KV8 ? pl[BN + r] - 128.0f * s0 : pl[BN + r];
            vs = pl[2 * BN + r];
            vz = pl[3 * BN + r] - 128.0f;
          }
          float* cr = kv_corr + rk.stage * 4 * BN;
          cr[r] = dead ? 0.0f : s0 * scale_log2;
          cr[BN + r] = dead ? 0.0f : s1 * scale_log2;
          cr[2 * BN + r] = dead ? 0.0f : vs;
          cr[3 * BN + r] = dead ? 0.0f : vz;
        }
        const unsigned char* sk = raws + rr.stage * RAW + r * ROWB;
        const unsigned char* sv = sk + BN * ROWB;
        unsigned char* dk = kvs + rk.stage * 2 * TILE + dh * HALF;
        unsigned char* dv = dk + TILE;
        const int sh = raw_sh[rr.stage * BN + r];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // 16 codes: values dh * 64 + 16 ci .. + 15, chunks 2 ci, 2 ci + 1
          const int ci = (s + r + 2 * dh) & 3;
          uint32_t wk[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
          uint32_t wv[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
          if (!dead) {
            const uint4 kw =
                *reinterpret_cast<const uint4*>(sk + dh * 64 + ci * 16);
            const uint4 vw =
                *reinterpret_cast<const uint4*>(sv + dh * 64 + ci * 16);
            const uint32_t kws[4] = {kw.x, kw.y, kw.z, kw.w};
            const uint32_t vws[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
            for (int wi = 0; wi < 4; ++wi) {
              const uint32_t km = KV8 ? kws[wi] : (kws[wi] >> sh) & 0x0F0F0F0Fu;
              const uint32_t vm = KV8 ? vws[wi] : (vws[wi] >> sh) & 0x0F0F0F0Fu;
              codes_to_bf16<KV8>(km, wk[2 * wi], wk[2 * wi + 1]);
              codes_to_f16(vm, wv[2 * wi], wv[2 * wi + 1]);
            }
          }
          *reinterpret_cast<uint4*>(dk + swz(r, 2 * ci)) =
              make_uint4(wk[0], wk[1], wk[2], wk[3]);
          *reinterpret_cast<uint4*>(dk + swz(r, 2 * ci + 1)) =
              make_uint4(wk[4], wk[5], wk[6], wk[7]);
          *reinterpret_cast<uint4*>(dv + swz(r, 2 * ci)) =
              make_uint4(wv[0], wv[1], wv[2], wv[3]);
          *reinterpret_cast<uint4*>(dv + swz(r, 2 * ci + 1)) =
              make_uint4(wv[4], wv[5], wv[6], wv[7]);
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
      // this warpgroup's 64 rows of Q into the swizzled tile as they are
      // (bf16), and each row's sum of those values
      const int tw = tid & 127, rq = 64 * wg + (tw >> 1), dh = tw & 1;
      const int t = row_token(t0, rq, n_rep);
      const __nv_bfloat16* src =
          q + (((size_t)b * Tc + t) * Hq + h * n_rep + rq % n_rep) * D +
          dh * 64;
      unsigned char* dst = qs + dh * QHALF;
      const int co = chunk_order(rq, dh);
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int c = co ^ s;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (t < Tc) {
          x = *reinterpret_cast<const uint4*>(src + c * 8);
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
            sum += f.x + f.y;
          }
        }
        *reinterpret_cast<uint4*>(dst + swz(rq, c)) = x;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);   // the row's other half
      if (dh == 0) q_sum[rq] = sum;
      fence_proxy_async();
      wg_sync(1 + wg);
    }
    const int r0 = 64 * wg + 16 * wl + g;    // this thread's rows r0, r0 + 8
    int qpos[2];
    float qsum[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int t = row_token(t0, r0 + 8 * hi, n_rep);
      qpos[hi] = t < Tc ? q_positions[(size_t)b * Tc + t] : -1;
      qsum[hi] = q_sum[r0 + 8 * hi];
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
      const uint32_t kb = smem_u32(kvs + st * 2 * TILE);
      const float* cr = kv_corr + st * 4 * BN;
      qk_tile<false>(s, q0, q1, kb, kb + HALF);
      // element 4 nb + e: row hi = e / 2, key 8 nb + 2 t4 + e % 2
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int j = nb * 8 + 2 * t4;
        const float2 s0 = *reinterpret_cast<const float2*>(cr + j);
        const float2 s1 = *reinterpret_cast<const float2*>(cr + BN + j);
        int2 p2 = make_int2(0, 0);
        if (!whole) p2 = *reinterpret_cast<const int2*>(kv_kp + st * BN + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1;
          const float a = (e & 1) ? s0.y : s0.x, c = (e & 1) ? s1.y : s1.x;
          const float x = s[4 * nb + e] * a - c * qsum[hi];
          bool ok = true;
          if (!whole) {
            const int qp = qpos[hi];
            const int kp = (e & 1) ? p2.y : p2.x;   // NO_POS fails kp <= qp
            ok = qp >= 0 && kp <= qp;
            if constexpr (SPARSE)
              ok = ok && (dense || kp < sink_size || qp - kp < local_size);
          }
          s[4 * nb + e] = ok ? x : -INFINITY;
        }
      }
      softmax_tile(s, m, l, o0, o1);
      // P as f16(p * v_scale[key]) in the A operand of each 16-key step;
      // the V zeros' row correction from the same rounded values
      uint32_t pa[4][4];
      float cz[2] = {0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 8 * kk + 2 * w, hi = w & 1;
          const int j = (2 * kk + (w >> 1)) * 8 + 2 * t4;
          const float2 vs = *reinterpret_cast<const float2*>(cr + 2 * BN + j);
          const float2 vz = *reinterpret_cast<const float2*>(cr + 3 * BN + j);
          const __half2 ph = __floats2half2_rn(s[i] * vs.x, s[i + 1] * vs.y);
          const float2 pf = __half22float2(ph);
          cz[hi] += pf.x * vz.x + pf.y * vz.y;
          pa[kk][w] = u32(ph);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        cz[hi] += __shfl_xor_sync(0xffffffffu, cz[hi], 1);
        cz[hi] += __shfl_xor_sync(0xffffffffu, cz[hi], 2);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o0[i] -= cz[(i >> 1) & 1];
        o1[i] -= cz[(i >> 1) & 1];
      }
      pv_tile_a<true>(o0, o1, pa, kb + TILE, kb + TILE + HALF);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[st]);
      ring.advance<NK>();
    }
    if constexpr (PT) {
      const float v_mul = *vpt;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o0[i] *= v_mul;
        o1[i] *= v_mul;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int rq = r0 + 8 * hi, t = row_token(t0, rq, n_rep);
      const size_t orow =
          ((size_t)b * Tc + min(t, Tc - 1)) * Hq + h * n_rep + rq % n_rep;
      store_row(out + orow * D, o0, o1, hi, l[hi], qpos[hi] < 0, t < Tc,
                lane);
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// sel_logic: [B, W] int32 logical page per table slot (-1 dead), or null for
// a dense table; flags: [H] int32 (1 dense, 0 streaming) or null for all
// dense; ring_span > 0 (pages) relabels the ring's stale rows; kv_bits 4 or
// 8; k_pt / v_pt: device addresses of the layer's per-tensor scales (no
// planes), or null (planes given). page % 128 == 0, n_rep 1 to 8,
// head_dim 128 (row 7's arguments: other head dims are refused); k_data,
// v_data and planes 16-byte aligned.
int launch_prefill_single_pass(
    const void* q, const void* k_data, const void* v_data, const void* planes,
    const void* k_pt, const void* v_pt, const void* block_tables,
    const void* q_positions, const void* context_lens, const void* sel_logic,
    const void* flags, void* out, int B, int Tc, int H, int n_rep, int page,
    int W, int sink_size, int local_size, int ring_span, int ring_sink_tok,
    float sm_scale, int kv_bits, int head_dim, void* stream) {
  const bool sparse = sel_logic != nullptr || flags != nullptr;
  const bool pt = k_pt != nullptr;
  if (n_rep <= 0 || n_rep > 8 || page <= 0 || page % 128 || head_dim != D ||
      W <= 0 || (ring_span > 0 && sel_logic == nullptr) ||
      (kv_bits != 4 && kv_bits != 8) || pt != (v_pt != nullptr) ||
      (!pt && planes == nullptr) ||
      (reinterpret_cast<uintptr_t>(k_data) |
       reinterpret_cast<uintptr_t>(v_data) |
       reinterpret_cast<uintptr_t>(planes)) % 16)
    return (int)cudaErrorInvalidValue;
  // the 8 instantiations: (dense table, page list / band) x (kv4, kv8) x
  // (planes, per tensor)
  const int which = (sparse ? 4 : 0) + (kv_bits == 8 ? 2 : 0) + (pt ? 1 : 0);
  auto kernel = prefill_single_pass_kernel<false, false, false>;
  switch (which) {
    case 1: kernel = prefill_single_pass_kernel<false, false, true>; break;
    case 2: kernel = prefill_single_pass_kernel<false, true, false>; break;
    case 3: kernel = prefill_single_pass_kernel<false, true, true>; break;
    case 4: kernel = prefill_single_pass_kernel<true, false, false>; break;
    case 5: kernel = prefill_single_pass_kernel<true, false, true>; break;
    case 6: kernel = prefill_single_pass_kernel<true, true, false>; break;
    case 7: kernel = prefill_single_pass_kernel<true, true, true>; break;
    default: break;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // each instantiation's shared-memory size is set, and its register
  // budget checked, once per device
  static bool ready[8][MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES || !ready[which][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (!reg_budget_ok(attr.numRegs, 256, REGS_CONSUMER, 128, REGS_CONVERT,
                       128, REGS_COPY))
      return (int)cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) ready[which][dev] = true;
  }
  const int tok_per_tile = BM / n_rep;
  dim3 grid(H, B, (Tc + tok_per_tile - 1) / tok_per_tile);
  kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
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
