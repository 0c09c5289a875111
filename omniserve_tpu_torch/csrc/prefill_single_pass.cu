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
//   128 (the TPU kernel's supports(), decode_attention.py:67-88).
//
// What bounds it: operations (4 * D flops per visible (query, key) pair and
// q head, against page * D * kv_bits / 4 + 16 * page bytes per kv head and
// page read).
// Design: one block of 4 warps per (tile of 64 query rows, kv head,
// sequence); a row is a (token, GQA rep) pair, so the n_rep q heads of one
// kv head share every page. The block walks the kv side in units of 128
// tokens (a whole 128-token page; a 128-token part of a larger page): over
// a dense table only up to its causal frontier min(ctx, max q_pos + 1), over
// a page list every slot, skipping units whose positions no row of the tile
// can see (never on a frontier: a ring carries relabelled positions).
// Units are double-buffered in shared memory with cp.async (K and V codes
// and the four scale planes: the TPU kernel's page DMAs, :130-140) while the
// tensor cores work on the other buffer. Each 64-key half of a unit is
// unpacked once into bf16 code tiles (kv4: nibble | 0x4300 = bf16(128 + n),
// minus 128; kv8: byte | 0x4B000000 = f32(2^23 + n), minus 2^23, exact),
// shared by the 4 warps (V codes into f16: n | 0x6400 = half(1024 + n),
// minus 1024); each warp runs its 16 rows with mma.sync m16n8k16 (f32
// accumulation): S = Q K^T in bf16, the per-key correction and mask and
// an online softmax on the S fragments in registers, then P V in f16 with
// the V fragments read by ldmatrix.trans. Heavy (late) q tiles launch
// first.
// TMA, wgmma and a producer warp are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;           // query rows per block
constexpr int UNIT = 128;        // kv tokens per staged unit
constexpr int SUB = 64;          // keys per mma sub-tile
constexpr int NT = 128;          // 4 warps x 16 query rows
constexpr int QS = D + 8;        // bf16 row stride of the Q / K / V tiles
constexpr int NO_POS = 0x7fffffff;   // a key that holds no token

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 (or, F16, f16)
// in, f32 out
template <bool F16 = false>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (F16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t pack_b2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_h2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);   // lo in the low 16 bits
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 4 values 0-255 (one per byte of m) -> two f16x2 words of them: f16 bits
// 0x6400 | n are 1024 + n, exact
__device__ __forceinline__ void byte4_to_f16(uint32_t m, uint32_t& w0,
                                             uint32_t& w1) {
  const __half2 k1024 = __floats2half2_rn(1024.0f, 1024.0f);
  uint32_t a = __byte_perm(m, 0x64646464u, 0x5140);
  uint32_t c = __byte_perm(m, 0x64646464u, 0x5342);
  __half2 x = __hsub2(*reinterpret_cast<__half2*>(&a), k1024);
  __half2 y = __hsub2(*reinterpret_cast<__half2*>(&c), k1024);
  w0 = *reinterpret_cast<uint32_t*>(&x);
  w1 = *reinterpret_cast<uint32_t*>(&y);
}

// 4 nibbles (one per byte of m, already shifted down and masked) -> two
// bf16x2 words of their values: bf16 bits 0x4300 | n are 128 + n, exact
__device__ __forceinline__ void nib4_to_bf16(uint32_t m, uint32_t& w0,
                                             uint32_t& w1) {
  const __nv_bfloat162 k128 = __floats2bfloat162_rn(128.0f, 128.0f);
  uint32_t a = __byte_perm(m, 0x43434343u, 0x5140);
  uint32_t c = __byte_perm(m, 0x43434343u, 0x5342);
  __nv_bfloat162 x = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), k128);
  __nv_bfloat162 y = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&c), k128);
  w0 = *reinterpret_cast<uint32_t*>(&x);
  w1 = *reinterpret_cast<uint32_t*>(&y);
}

// 4 bytes -> two bf16x2 words of their values: f32 bits 0x4B000000 | n are
// 2^23 + n, exact; every value 0-255 is exact in bf16
__device__ __forceinline__ void byte4_to_bf16(uint32_t m, uint32_t& w0,
                                              uint32_t& w1) {
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(m, 0x4B000000u, 0x7640 + e)) -
           8388608.0f;
  w0 = pack_b2(f[0], f[1]);
  w1 = pack_b2(f[2], f[3]);
}

// Unpack 64 keys of raw codes (row r of the sub-tile at raw + r * D, the
// nibble at bit `shift` under kv4) into a token-major 16-bit tile [SUB][QS]
// of bf16 values (or, F16, f16 values).
template <bool KV8, bool F16>
__device__ __forceinline__ void unpack_codes(const uint8_t* raw, int shift,
                                             __nv_bfloat16* tile, int tid) {
  for (int i = tid; i < SUB * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + r * D + c);
    const uint32_t m0 = KV8 ? w.x : (w.x >> shift) & 0x0F0F0F0Fu;
    const uint32_t m1 = KV8 ? w.y : (w.y >> shift) & 0x0F0F0F0Fu;
    uint32_t o[4];
    if constexpr (F16) {
      byte4_to_f16(m0, o[0], o[1]);
      byte4_to_f16(m1, o[2], o[3]);
    } else if constexpr (KV8) {
      byte4_to_bf16(m0, o[0], o[1]);
      byte4_to_bf16(m1, o[2], o[3]);
    } else {
      nib4_to_bf16(m0, o[0], o[1]);
      nib4_to_bf16(m1, o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(tile + r * QS + c) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Walk state shared by the helpers below: one (q tile, kv head, sequence).
struct Walk {
  const int* sel_logic;   // null: dense table
  int b, W, page, parts, ctx, cb, last_row, ring_span, ring_sink_tok;
  int sink_size, local_size, qlo, qhi;
  bool dense;

  __device__ int logic_of(int s) const {
    return sel_logic ? sel_logic[(size_t)b * W + s] : s;
  }
  // whether some key in [a, e] is visible to some row of the tile
  __device__ bool seen(int a, int e) const {
    return a <= e && a <= qhi &&
           (dense || a < sink_size || min(e, qhi) + local_size > qlo);
  }
  // whether unit u (slot u / parts, 128-token part u % parts) holds a key
  // that some row of the tile sees: its fresh rows, and under a ring the
  // relabelled stale rows of the newest page
  __device__ bool needed(int u) const {
    const int s = u / parts, c = u % parts;
    const int logic = logic_of(s);
    if (logic < 0) return false;
    const int base = logic * page + c * UNIT;
    int e = base + UNIT - 1;
    if (logic == cb) e = min(e, logic * page + last_row);
    if (seen(base, min(e, ctx - 1))) return true;
    if (ring_span > 0 && logic == cb) {
      const int a2 = max(max(base, logic * page + last_row + 1) -
                             ring_span * page, ring_sink_tok);
      return seen(a2, base + UNIT - 1 - ring_span * page);
    }
    return false;
  }
  __device__ int next(int u, int n_units) const {
    while (u < n_units && !needed(u)) ++u;
    return u;
  }
  // position of token i (0-127) of unit u, NO_POS if it holds none
  __device__ int pos(int u, int i) const {
    const int s = u / parts, c = u % parts;
    const int logic = logic_of(s);
    const int in_page = c * UNIT + i;
    int p = logic * page + in_page, lo = 0;
    if (ring_span > 0 && logic == cb && in_page > last_row) {
      p -= ring_span * page;
      lo = ring_sink_tok;
    }
    return (logic >= 0 && p < ctx && p >= lo) ? p : NO_POS;
  }
};

// KV8: one byte per value (else kv4 half-split nibbles); PT: per-tensor
// codes (else folded planes).
template <bool KV8, bool PT>
__global__ void __launch_bounds__(NT) prefill_single_pass_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_data,
    const uint8_t* __restrict__ v_data, const float* __restrict__ planes,
    const float* __restrict__ kpt, const float* __restrict__ vpt,
    const int* __restrict__ block_tables, const int* __restrict__ q_positions,
    const int* __restrict__ context_lens, const int* __restrict__ sel_logic,
    const int* __restrict__ flags, __nv_bfloat16* __restrict__ out, int Tc,
    int H, int n_rep, int page, int W, int sink_size, int local_size,
    int ring_span, int ring_sink_tok, float sm_scale) {
  // raw codes of one unit and head: kv8 128 rows, kv4 64 rows of a 128-token
  // page (both nibbles) or, over a larger page, two 64-row sub-tiles staged
  // apart (each in one nibble; see sub_row)
  const bool wide = KV8 || page > UNIT;
  const int raw_bytes = (wide ? UNIT : UNIT / 2) * D;
  const int rows_pp = KV8 ? page : page / 2;   // byte rows per page, head
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* raw_k = smem_raw;                               // [2][raw_bytes]
  uint8_t* raw_v = raw_k + 2 * raw_bytes;                  // [2][raw_bytes]
  float* raw_pl = reinterpret_cast<float*>(raw_v + 2 * raw_bytes);
  //                                                          [2][4][UNIT]
  __nv_bfloat16* Kb =
      reinterpret_cast<__nv_bfloat16*>(raw_pl + 2 * 4 * UNIT);  // [SUB][QS]
  __nv_bfloat16* Vb = Kb + SUB * QS;             // [SUB][QS], f16 bits
  float* t_s0 = reinterpret_cast<float*>(Vb + SUB * QS);   // per key: k_scale
  float* t_s1 = t_s0 + SUB;     // k_scale * k_zero
  float* t_vs = t_s1 + SUB;     // v_scale
  float* t_z3 = t_vs + SUB;     // v_zero
  int* t_pos = reinterpret_cast<int*>(t_z3 + SUB);         // [SUB]
  int* qpos = t_pos + SUB;                                 // [BQ]
  __nv_bfloat16* Qs = Kb;       // the Q tile, until the walk starts
  __shared__ int s_qlo, s_qhi;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const int tok_per_tile = BQ / n_rep;
  const int tile = gridDim.x - 1 - blockIdx.x;   // late (heavy) tiles first
  const int t0 = tile * tok_per_tile;
  const int Hq = H * n_rep;
  const int ctx = context_lens[b];

  // query row r: token t0 + r / n_rep, q head h * n_rep + r % n_rep
  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int t = t0 + r / n_rep;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tc)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tc + t) * Hq + h * n_rep + r % n_rep) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = v;
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
    s_qlo = pmin;
    s_qhi = pmax;
  }
  __syncthreads();
  if (s_qhi < 0) {   // a padded tile: zeros, and no page is read
    for (int i = tid; i < BQ * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int t = t0 + r / n_rep;
      if (t < Tc)
        *reinterpret_cast<uint4*>(
            out + (((size_t)b * Tc + t) * Hq + h * n_rep + r % n_rep) * D +
            c) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  Walk wk;
  wk.sel_logic = sel_logic;
  wk.b = b;
  wk.W = W;
  wk.page = page;
  wk.parts = page / UNIT;
  wk.ctx = ctx;
  wk.cb = (ctx - 1) / page;
  wk.last_row = (ctx - 1) % page;
  wk.ring_span = ring_span;
  wk.ring_sink_tok = ring_sink_tok;
  wk.sink_size = sink_size;
  wk.local_size = local_size;
  wk.qlo = s_qlo;
  wk.qhi = s_qhi;
  wk.dense = flags == nullptr || flags[h] != 0;
  // a dense table (slot = logical page) ends at the causal frontier; a page
  // list is walked whole
  const int n_units =
      sel_logic ? W * wk.parts
                : min(W * wk.parts, (min(ctx, wk.qhi + 1) + UNIT - 1) / UNIT);

  // this warp's 16 query rows as mma A fragments, and their bf16 row sums
  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
  float qsum0 = 0.0f, qsum1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Qs + (r0 + g) * QS + kk * 16 + 2 * t4;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * QS);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * QS + 8);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][0]));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][2]));
    const float2 a1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][1]));
    const float2 c1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][3]));
    qsum0 += (a.x + a.y) + (c.x + c.y);
    qsum1 += (a1.x + a1.y) + (c1.x + c1.y);
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    qsum0 += __shfl_xor_sync(0xffffffffu, qsum0, o_);
    qsum1 += __shfl_xor_sync(0xffffffffu, qsum1, o_);
  }
  const int qp0 = qpos[r0 + g], qp1 = qpos[r0 + g + 8];
  constexpr float bias = KV8 ? 128.0f : 8.0f;
  const float k_mul = PT ? *kpt * sm_scale : sm_scale;

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  // first byte row of 64-key sub-tile st of part c within the head's page
  // rows: kv8 row = slot; kv4 row = slot % (page/2), and page/2 is a
  // multiple of 64, so a sub-tile never straddles the two nibble halves
  // (a 128-token kv4 unit is 64 rows, both nibbles: sub-tile 0's rows)
  auto sub_row = [&](int c, int st) {
    return wide ? (c * UNIT + st * SUB) % rows_pp : 0;
  };
  auto issue = [&](int u, int bf) {
    const int s = u / wk.parts, c = u % wk.parts;
    const int phys = block_tables[(size_t)b * W + s];
    const size_t off = ((size_t)phys * H + h) * rows_pp * D;
    for (int i = tid * 16; i < raw_bytes; i += NT * 16) {
      const size_t src = off + (size_t)sub_row(c, i / (SUB * D)) * D +
                         i % (SUB * D);
      cp_async16(raw_k + bf * raw_bytes + i, k_data + src);
      cp_async16(raw_v + bf * raw_bytes + i, v_data + src);
    }
    if constexpr (!PT) {   // 4 planes x 32 chunks of 4 floats: one a thread
      const int pl = tid / 32, j = (tid % 32) * 4;
      cp_async16(raw_pl + (bf * 4 + pl) * UNIT + j,
                 planes + (((size_t)phys * 4 + pl) * H + h) * page +
                     c * UNIT + j);
    }
  };

  int u = wk.next(0, n_units);
  if (u < n_units) issue(u, 0);
  cp_async_commit();
  for (int bf = 0; u < n_units; bf ^= 1) {
    const int un = wk.next(u + 1, n_units);
    if (un < n_units) issue(un, bf ^ 1);   // overlaps this unit's math
    cp_async_commit();
    cp_async_wait_1();                     // this unit's copies landed
    __syncthreads();
    const int c = u % wk.parts;
    for (int st = 0; st < UNIT / SUB; ++st) {
      // per key of this half: position, folded planes (garbage past the
      // context: every use below is behind the visibility mask)
      bool any = false;
      if (tid < SUB) {
        const int i = st * SUB + tid;
        const int kp = wk.pos(u, i);
        t_pos[tid] = kp;
        any = kp <= wk.qhi &&
              (wk.dense || kp < sink_size || kp + local_size > wk.qlo);
        if constexpr (!PT) {
          const float* pl = raw_pl + bf * 4 * UNIT;
          const float s0 = pl[i];
          t_s0[tid] = s0;
          t_s1[tid] = pl[UNIT + i] - 128.0f * s0;
          t_vs[tid] = pl[2 * UNIT + i];
          t_z3[tid] = pl[3 * UNIT + i] - 128.0f;
        }
      }
      if (!__syncthreads_or(any)) continue;   // uniform per block
      // unpack this half's K and V codes to bf16 (the sub-tile's rows and
      // nibble within the staged unit: under kv4 the high nibble iff its
      // slots lie in the page's second half)
      const int row0 = wide ? st * SUB : 0;
      const int shift =
          KV8 ? 0
              : (page > UNIT ? ((c * UNIT + st * SUB >= page / 2) ? 4 : 0)
                             : st * 4);
      unpack_codes<KV8, false>(raw_k + bf * raw_bytes + row0 * D, shift, Kb,
                               tid);
      unpack_codes<KV8, true>(raw_v + bf * raw_bytes + row0 * D, shift, Vb,
                              tid);
      __syncthreads();

      // S = Q codes^T: rows r0 + g (s[.][0..1]) and r0 + g + 8 (s[.][2..3]),
      // keys nt * 8 + 2 * t4 + {0, 1}
      float s[SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* kb = Kb + (nt * 8 + g) * QS + kk * 16 + 2 * t4;
          mma16816(s[nt], qa[kk], ld32(kb), ld32(kb + 8));
        }
      }
      // per-key correction, mask (bit 2 * (nt * 2 + e) + row half)
      uint32_t vis = 0u;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * t4 + e;
          const int kp = t_pos[j];
          // NO_POS fails kp <= qp; the band test runs only on real keys
          const bool ok0 = qp0 >= 0 && kp <= qp0 &&
                           (wk.dense || kp < sink_size ||
                            qp0 - kp < local_size);
          const bool ok1 = qp1 >= 0 && kp <= qp1 &&
                           (wk.dense || kp < sink_size ||
                            qp1 - kp < local_size);
          float v0, v1;
          if constexpr (PT) {
            v0 = (s[nt][e] - bias * qsum0) * k_mul;
            v1 = (s[nt][2 + e] - bias * qsum1) * k_mul;
          } else {
            const float s0 = t_s0[j], s1 = t_s1[j];
            v0 = (s[nt][e] * s0 - s1 * qsum0) * k_mul;
            v1 = (s[nt][2 + e] * s0 - s1 * qsum1) * k_mul;
          }
          s[nt][e] = ok0 ? v0 : -INFINITY;
          s[nt][2 + e] = ok1 ? v1 : -INFINITY;
          vis |= (ok0 ? 1u : 0u) << (2 * (nt * 2 + e));
          vis |= (ok1 ? 1u : 0u) << (2 * (nt * 2 + e) + 1);
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
      // p in f32 for the row sums; P's A fragments as half(p * v_scale)
      // (per tensor half(p)); the zero correction from the f16 values
      float ps0 = 0.0f, ps1 = 0.0f, cr0 = 0.0f, cr1 = 0.0f;
      uint32_t pk[SUB / 8][2];
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
        float pb[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * t4 + e;
          const bool ok0 = (vis >> (2 * (nt * 2 + e))) & 1u;
          const bool ok1 = (vis >> (2 * (nt * 2 + e) + 1)) & 1u;
          const float p0 = ok0 ? expf(s[nt][e] - mn0) : 0.0f;
          const float p1 = ok1 ? expf(s[nt][2 + e] - mn1) : 0.0f;
          ps0 += p0;
          ps1 += p1;
          if constexpr (PT) {
            pb[e] = p0;
            pb[2 + e] = p1;
          } else {
            const float vs = t_vs[j];
            pb[e] = ok0 ? p0 * vs : 0.0f;
            pb[2 + e] = ok1 ? p1 * vs : 0.0f;
          }
        }
        pk[nt][0] = pack_h2(pb[0], pb[1]);
        pk[nt][1] = pack_h2(pb[2], pb[3]);
        const float2 r0v =
            __half22float2(*reinterpret_cast<const __half2*>(&pk[nt][0]));
        const float2 r1v =
            __half22float2(*reinterpret_cast<const __half2*>(&pk[nt][1]));
        if constexpr (PT) {
          cr0 += r0v.x + r0v.y;
          cr1 += r1v.x + r1v.y;
        } else {
          const int j = nt * 8 + 2 * t4;
          const bool a0 = (vis >> (2 * (nt * 2))) & 1u;
          const bool a1 = (vis >> (2 * (nt * 2 + 1))) & 1u;
          const bool b0 = (vis >> (2 * (nt * 2) + 1)) & 1u;
          const bool b1 = (vis >> (2 * (nt * 2 + 1) + 1)) & 1u;
          const float z0 = t_z3[j], z1 = t_z3[j + 1];
          cr0 += (a0 ? r0v.x * z0 : 0.0f) + (a1 ? r0v.y * z1 : 0.0f);
          cr1 += (b0 ? r1v.x * z0 : 0.0f) + (b1 ? r1v.y * z1 : 0.0f);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, o_);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, o_);
        cr0 += __shfl_xor_sync(0xffffffffu, cr0, o_);
        cr1 += __shfl_xor_sync(0xffffffffu, cr1, o_);
      }
      if constexpr (PT) {
        cr0 *= bias;
        cr1 *= bias;
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][0] = o[nd][0] * al0 - cr0;
        o[nd][1] = o[nd][1] * al0 - cr0;
        o[nd][2] = o[nd][2] * al1 - cr1;
        o[nd][3] = o[nd][3] * al1 - cr1;
      }
      // O += P V codes: the S accumulator of key tiles 2kk, 2kk+1 is the A
      // fragment of key step kk; ldmatrix.trans reads V's B fragments from
      // the token-major tile (matrices: keys +0 / +8, d columns nd / nd+1)
      const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        const uint32_t pa[4] = {pk[2 * kk][0], pk[2 * kk][1],
                                pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
#pragma unroll
        for (int nd = 0; nd < D / 8; nd += 2) {
          const uint32_t addr = smem_addr(
              Vb + (kk * 16 + (mi & 1) * 8 + mr) * QS + (nd + (mi >> 1)) * 8);
          uint32_t v0, v1, v2, v3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
              : "r"(addr));
          mma16816<true>(o[nd], pa, v0, v1);
          mma16816<true>(o[nd + 1], pa, v2, v3);
        }
      }
      __syncthreads();   // every warp is done with Kb, Vb and the key arrays
    }
    u = un;
  }

  const float v_mul = PT ? *vpt : 1.0f;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int ir = r0 + g + 8 * hi;
    const int t = t0 + ir / n_rep;
    if (t >= Tc) continue;
    const float inv = v_mul / fmaxf(hi ? l1 : l0, 1e-10f);
    __nv_bfloat16* orow =
        out + (((size_t)b * Tc + t) * Hq + h * n_rep + ir % n_rep) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nd][2 * hi] * inv, o[nd][2 * hi + 1] * inv);
    }
  }
}

size_t smem_bytes(int kv_bits, int page) {
  const int raw = ((kv_bits == 8 || page > UNIT) ? UNIT : UNIT / 2) * D;
  return 4 * (size_t)raw + sizeof(float) * 2 * 4 * UNIT +
         sizeof(__nv_bfloat16) * 2 * SUB * QS + sizeof(float) * 4 * SUB +
         sizeof(int) * (SUB + BQ);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// sel_logic: [B, W] int32 logical page per table slot (-1 dead), or null for
// a dense table; flags: [H] int32 (1 dense, 0 streaming) or null for all
// dense; ring_span > 0 (pages) relabels the ring's stale rows; kv_bits 4 or
// 8; k_pt / v_pt: device addresses of the layer's per-tensor scales (no
// planes), or null (planes given).
int launch_prefill_single_pass(
    const void* q, const void* k_data, const void* v_data, const void* planes,
    const void* k_pt, const void* v_pt, const void* block_tables,
    const void* q_positions, const void* context_lens, const void* sel_logic,
    const void* flags, void* out, int B, int Tc, int H, int n_rep, int page,
    int W, int sink_size, int local_size, int ring_span, int ring_sink_tok,
    float sm_scale, int kv_bits, void* stream) {
  const bool pt = k_pt != nullptr;
  if (n_rep <= 0 || BQ % n_rep || page <= 0 || page % UNIT || W <= 0 ||
      (ring_span > 0 && sel_logic == nullptr) ||
      (kv_bits != 4 && kv_bits != 8) || pt != (v_pt != nullptr) ||
      (!pt && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = prefill_single_pass_kernel<false, false>;
  if (kv_bits == 8)
    kernel = pt ? prefill_single_pass_kernel<true, true>
                : prefill_single_pass_kernel<true, false>;
  else if (pt)
    kernel = prefill_single_pass_kernel<false, true>;
  const size_t smem = smem_bytes(kv_bits, page);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tok_per_tile = BQ / n_rep;
  dim3 grid((Tc + tok_per_tile - 1) / tok_per_tile, H, B);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
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
