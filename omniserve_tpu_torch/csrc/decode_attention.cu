// Paged decode attention for Hopper (sm_90a): four entry points.
//
// Replace the TPU kernels of omniserve_tpu/ops/pallas/decode_attention.py:
//   1. paged_mqa_attention_single_pass (:620, kernel _sp_kernel :112) in its
//      append= mode over a dense, contiguous page list, kv4 or kv8 pools
//      (launch_decode_attention_append, decode_attn_list_kernel's APPEND
//      instantiations);
//   2. paged_mqa_attention_single_pass_ph (:1119, kernel _sp_kernel_ph :850,
//      pallas_call :1206): dynamic-sparse decode over per-(sequence, kv
//      head) page lists (launch_decode_attention_ph);
//   3. paged_mqa_attention_single_pass in its plain mode with the streaming
//      band over a ring pool: one page list per sequence, shared by the
//      heads (launch_decode_attention_band, decode_attn_list_kernel);
// entries 1-3 over kv4 or kv8 pools, fine-grained or per-tensor, at head
// dim 128 (the JAX package runs them only where decode_attention.supports
// holds: pages and head dim multiples of 128);
// and of omniserve_tpu/ops/pallas/paged_attention.py:
//   4. paged_mqa_attention (:255, kernel _mqa_kernel :58, pallas_call :421),
//      the two-stage decode the JAX package runs over every kv16 (bf16)
//      pool and over every kv4 / kv8 pool that supports refuses (head dim
//      64, pages not a multiple of 128), read in place, with no gather
//      stage (launch_paged_mqa_attention): a dense page list per sequence,
//      the selector's per-(sequence, kv head) lists (per_head_sel
//      :116-120) and the streaming band with the ring relabel over one
//      list per sequence (:125-140); kv16 pages on decode_attn_kv16_kernel,
//      kv4 / kv8 pages (fine-grained or per-tensor) on the list kernel of
//      entries 2 and 3, which computes _mqa_kernel's quantized-domain
//      product (:144-245: q.code * k_scale - (k_scale * k_zero) * sum q,
//      then p * v_scale against the V codes, less sum p * v_scale *
//      v_zero), at head dim 64 or 128.
//
// Head dims: every kernel takes D (64 or 128) as a template parameter; a
// block holds D consumer threads, one per head-dim lane (4 warps at 128,
// 2 at 64), and the copy warp.
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
//     written into the pool and attended as the pool then holds it:
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
// What bounds every entry: device-memory bytes. Each cached token costs D
// bytes of K+V nibbles (2*D under kv8, 4*D under kv16) and, fine-grained,
// 16 bytes of planes; the math is 2*n_rep flops a byte or less.
//
// Every entry is a split decode: one block of 4 consumer warps and a copy
// warp per (split, kv head, sequence). Two things kept their first bodies
// (one block per list, synchronous loads) far from the bytes bound, and
// the design answers each:
//   - too little parallelism (at batch 1, 4 lists of 32 pages on 132 SMs):
//     each list of Tp entries is cut into S contiguous runs of entries,
//     one block each. S comes from host-known shapes only (B, H, Tp and
//     the SM count, about two waves of blocks; see split_plan in
//     omniserve_tpu_torch/ops/cuda/decode_attention.py), never from lengths
//     or list contents, so a captured launch keeps its grid. With S = 1 a
//     block writes the bf16 output itself; with S > 1 it writes f32
//     partials (row max m, sum l, unnormalised acc[n_rep][D]; a split with
//     no live token writes m = -inf, l = 0, acc = 0) to a workspace the
//     wrapper allocates, and decode_split_combine_kernel merges the S
//     partials of each row in split order by the log-sum-exp rule of
//     omniserve_tpu/parallel/sp.py:sp_combine (no atomics: a replayed graph
//     gives the eager call's bits);
//   - loads not in flight: the copy warp brings each listed page's rows in
//     with cp.async.bulk into a ring of mbarrier-guarded stages while the
//     consumers score the previous one, and skips, before a byte moves,
//     dead entries and pages past the length. Entries 2 and 3 stage a kv8
//     page in runs of 64 token rows and a kv4 page whole (its rows hold
//     two tokens each), with the four plane runs of a fine-grained page;
//     entry 4 stages 32 tokens of a kv16 page, its K rows one bulk copy
//     each into rows padded to 272 bytes (so ldmatrix reads them without
//     bank conflicts) and its V rows as one copy.
// The consumers work from shared memory on the tensor cores with
// mma.sync m16n8k16 (f32 out): the scores S^T = K q^T take a stage's tokens
// as 16-row tiles and the n_rep q rows as the 8 columns; entry 4 reads its
// bf16 K rows with ldmatrix (on an H100 2.05x faster at B=128 than a warp
// per token summing FMAs from shared memory), entries 1-3 unpack their
// codes to f16 (1024 + code by a byte permute, minus 1024: exact) against
// q in f16, with the rank-1 zero-point term ks*(q.code) - kc*qsum. One warp
// per query row runs the online softmax over the stage in f32. P.V: f32
// FMAs for kv16 and kv4 pages (P is never rounded: consumer thread c owns
// head-dim lanes 2 (c % 64) and +1 for the tokens of parity c / 64); for
// kv8 pages mma.sync, the weights p * v_scale times 2^8 in f16 as the A
// operand (q rows), the V codes unpacked to f16 as B (a warp's 32 head
// dims, 16 slots a step), the zero-point term c = sum w * v_zero kept in
// f32 (on an H100 each choice beat the other, in turns, at B=8 and 128).
// The list kernel's ring holds 2 stages (entry 4's 3). A
// slot that is dead, past the length or outside the band is masked in S
// and gets weight 0 in P before it meets a product (never-written planes
// may hold NaN). Entry 1 walks the block table itself (entry i = logical
// page i; no list is built on the host) and the block whose run holds the
// row's newest page quantizes the new token: the fine-grained min / max
// reduce over the 128 consumer lanes (a named barrier, the copy warp has
// left) or the per-tensor scalars, then writes its codes into the staged
// page and into the pool as the stage lands (append_token), so the token
// is scored as any other slot and the pool gets append_kv's bytes. The
// band's short lists (entry 3: 1 sink + 2 ring pages) and the append
// (entry 1) took the split body after A/Bs against their first bodies on
// an H100 (PERF.md's kernel table, row 4).
// GQA: a block holds the n_rep q heads of its kv head as the query rows of
// an instantiation NREP = 1, 2, 4 or 8, the smallest that covers n_rep
// (row_capacity), so any n_rep up to 8 serves (Yi-34B's 7, Qwen2-1.5B's 6,
// Qwen2.5-14B's 5). Rows n_rep .. NREP - 1 are dead: zero q columns, no
// softmax, never stored; the partials hold the live rows only (rows = B *
// H * n_rep). The bytes, which bound decode, do not grow with them.
// The file is compiled with --fmad=false (entry 1's codes and planes are
// bit-identical to the plain append); the FMAs are written as __fmaf_rn.

#include "attn_sm90.cuh"   // mbarriers, bulk copies, the stage ring
#include "kv_common.cuh"

namespace {

using namespace kv;

// ---------------------------------------------------------------------------
// The split decode (every entry): see the header for the design.
// ---------------------------------------------------------------------------

constexpr int NSTAGE = 3;               // ring stages
constexpr int CONSUMERS = 1;            // named barrier of the consumer warps

// A block of the split decode at head dim D (64 or 128): D consumer
// threads, one per head-dim lane (4 warps at 128, 2 at 64), then the copy
// warp. Every kernel below takes D as a template parameter.
#define SPLIT_DIMS(D)                    \
  constexpr int NT = (D);                \
  constexpr int NWARP = (D) / 32;        \
  constexpr int COPY_WARP = NWARP;       \
  static_assert(head_dim_ok(D), "head dim 64 or 128")

// the named barrier of the NT consumer threads
template <int NT>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(CONSUMERS), "n"(NT) : "memory");
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

// Which slots of a listed page are attended (the list contract below;
// the kv16 lists take it with no band). Every test is block-uniform per
// entry, so the copy warp and the consumers walk the same stages.
struct ListMask {
  int len, page, band_sink, win_start, ring_span, ring_sink_tok, cur_page,
      cur_slot;
  bool band, ring;

  __device__ ListMask(int len_, int page_, int band_sink_, int band_local,
                      int ring_span_, int ring_sink_tok_)
      : len(len_), page(page_), band_sink(band_sink_),
        win_start(max(0, len_ - band_local)), ring_span(ring_span_),
        ring_sink_tok(ring_sink_tok_), cur_page((len_ - 1) / page_),
        cur_slot((len_ - 1) % page_), band(band_sink_ >= 0),
        ring(band_sink_ >= 0 && ring_span_ > 0) {}

  // the slots [0, n) of logical page `logic` that can hold a live token
  // (0: skip the entry): up to the length, the whole page being written on
  // a ring (its slots past the write head hold one wrap older tokens)
  __device__ int slots(int logic) const {
    if (logic < 0 || logic * page >= len) return 0;
    return ring && logic == cur_page ? page : min(page, len - logic * page);
  }

  __device__ bool live(int logic, int slot) const {
    int pos = logic * page + slot, floor_pos = 0;
    if (ring && logic == cur_page && slot > cur_slot) {
      pos -= ring_span * page;
      floor_pos = ring_sink_tok;
    }
    const bool ok = pos < len && pos >= floor_pos;
    return band ? ok && (pos < band_sink || pos >= win_start) : ok;
  }
};

// the N floats at src (16-byte aligned when N % 4 == 0, 8 when N == 2)
template <int N>
__device__ __forceinline__ void load_row(float (&p)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + j);
      p[j] = v.x;
      p[j + 1] = v.y;
      p[j + 2] = v.z;
      p[j + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    p[0] = v.x;
    p[1] = v.y;
  } else {
    p[0] = src[0];
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), f16 in, f32 out
__device__ __forceinline__ void mma16816_f16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two f16 of the form 1024 + c (c < 1024, exact) -> the codes c, exact
__device__ __forceinline__ uint32_t codes_f16(uint32_t biased) {
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&biased),
                            __floats2half2_rn(1024.0f, 1024.0f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the low nibbles of bytes 0 and 2 of x as two exact f16 codes
__device__ __forceinline__ uint32_t nibbles_f16(uint32_t x) {
  return codes_f16((x & 0x000F000Fu) | 0x64006400u);
}

// The end of a split (entry 4, and entries 1-3 over kv4 pages): consumer
// thread c holds acc for head-dim lanes
// 2 (c % (D/2)), +1 over the tokens of parity c / (D/2); the two halves
// are summed here. S = 1: out = acc / l (0 where no token was live) in bf16.
// S > 1: the f32 partial of split s, acc [S][rows][D] then (m, l)
// [S][rows][2], rows = B * H * n_rep. Only the n_rep live rows of the
// NREP the block holds are written.
template <int NREP, int D>
__device__ __forceinline__ void split_finish(
    float (&acc)[NREP][2], const float* m_s, const float* l_s, float* red,
    int ctid, size_t row_base, int n_rep, int s, int S, size_t rows,
    __nv_bfloat16* out, float* ws) {
  const int dp = ctid % (D / 2), th = ctid / (D / 2);
  if (th == 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      red[r * D + 2 * dp] = acc[r][0];
      red[r * D + 2 * dp + 1] = acc[r][1];
    }
  }
  consumers_sync<D>();
  if (th == 1) return;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (r >= n_rep) break;
    const float a0 = acc[r][0] + red[r * D + 2 * dp];
    const float a1 = acc[r][1] + red[r * D + 2 * dp + 1];
    const size_t row = row_base + r;
    if (S == 1) {
      const float l = l_s[r];
      *reinterpret_cast<__nv_bfloat162*>(out + row * D + 2 * dp) =
          __floats2bfloat162_rn(l > 0.0f ? a0 / l : 0.0f,
                                l > 0.0f ? a1 / l : 0.0f);
    } else {
      const size_t prow = (size_t)s * rows + row;
      *reinterpret_cast<float2*>(ws + prow * D + 2 * dp) = make_float2(a0, a1);
      if (dp == 0) {
        float* ml = ws + (size_t)S * rows * D + prow * 2;
        ml[0] = m_s[r];
        ml[1] = l_s[r];
      }
    }
  }
}

// Entry 4: decode over the page lists of a kv16 pool, in three modes
// (MODE): KV16_DENSE and KV16_BAND take one list per sequence [B, Tp],
// shared by the heads; KV16_PER_HEAD one per (sequence, kv head) [B, H, Tp].
//
// Contract (plain version: page_list_attention_plain in
// omniserve_tpu_torch/ops/cuda/decode_attention.py, the list contract of
// entries 2 and 3 below over bf16 pages):
//   - pool layer k/v [P, H, page, D] bf16, token t of a page at row t, the
//     values as they are;
//   - entry i of a list names a physical page sel_phys and the logical
//     page sel_logic it holds (-1 = dead, skipped); the token in slot t sits
//     at position sel_logic*page + t and is attended iff pos < len;
//   - KV16_BAND: the ring relabel and the sink + local band of entry 3
//     (band_sink >= 0; ring_span > 0 relabels the slots of the page being
//     written past its write head); a slot outside them gets score -inf
//     and weight 0, and its V row is read as 0 (a never-written row may
//     hold anything);
//   - out = softmax(q.k * sm_scale) . v over those tokens, in f32; a row
//     with len <= 0, or no live token, outputs zeros.
// The band's tests compile out of KV16_DENSE, whose code stays the dense
// body's, and of KV16_PER_HEAD, which differs from it in the list offset
// alone.
// Block (split s, kv head h, sequence b) takes list entries [s * per_split,
// (s + 1) * per_split). A stage holds 32 tokens of one page: K rows padded
// to KV16_KROW bytes (one bulk copy each), then the V rows (one copy). 32
// tokens in 3 stages (50 KB) let 3 blocks share an SM where 64 let 2; on an
// H100 that ran 0.91x the time of 64-token stages at B=128 and 0.83x at
// B=8 (16 tokens in 4 stages: 1.14x; 2 or 4 stages of 32: 1.02x / 0.95x).
constexpr int KV16_TS = 32;                  // tokens a stage holds
// a K row in shared memory: 2 D bytes padded by 16 (an odd number of
// 16-byte units, so ldmatrix's 8 rows fall in distinct banks)
__host__ __device__ constexpr int kv16_krow(int d) { return 2 * d + 16; }
__host__ __device__ constexpr int kv16_stage(int d) {
  return KV16_TS * (kv16_krow(d) + 2 * d);
}
__host__ __device__ constexpr int kv16_smem(int d) {
  return NSTAGE * kv16_stage(d) + 128;   // + alignment slack
}

enum Kv16Mode { KV16_DENSE = 0, KV16_PER_HEAD = 1, KV16_BAND = 2 };

template <int NREP, int MODE, int D>
__global__ void __launch_bounds__(D + 32) decode_attn_kv16_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, n_rep, D]
    const __nv_bfloat16* __restrict__ k_data,  // layer: [P, H, page, D]
    const __nv_bfloat16* __restrict__ v_data,
    const int* __restrict__ sel_phys,          // [B, Tp]; PER_HEAD [B, H, Tp]
    const int* __restrict__ sel_logic,         // [B, Tp]; PER_HEAD [B, H, Tp]
    const int* __restrict__ lengths,           // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, n_rep, D]
    float* __restrict__ ws,                    // S > 1: the partials
    int H, int n_rep, int page, int Tp, int per_split, float sm_scale,
    int band_sink, int band_local, int ring_span, int ring_sink_tok) {
  SPLIT_DIMS(D);
  constexpr bool BAND = MODE == KV16_BAND;
  constexpr int KV16_KROW = kv16_krow(D), KV16_STAGE = kv16_stage(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align128(smem_raw);
  __shared__ __align__(16) float sc[NREP][KV16_TS];   // scores
  __shared__ __align__(16) float pw[KV16_TS][NREP];   // probabilities
  __shared__ __align__(16) float red[NREP * D];
  __shared__ float m_s[NREP], l_s[NREP], alpha_s[NREP];
  __shared__ __align__(8) uint64_t full[NSTAGE], empty[NSTAGE];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const size_t list_off =
      MODE == KV16_PER_HEAD ? ((size_t)b * H + h) * Tp : (size_t)b * Tp;
  const int i0 = s * per_split, i1 = min(Tp, i0 + per_split);
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      sm90::mbar_init(&full[st], 1);      // the copy warp's lane 0 (+ bytes)
      sm90::mbar_init(&empty[st], NT);    // every consumer thread
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const ListMask mask(len, page, BAND ? band_sink : -1, band_local,
                      ring_span, ring_sink_tok);
  if (warp == COPY_WARP) {
    sm90::Ring rg;
    for (int i = i0; i < i1; ++i) {
      const int ntok = mask.slots(sel_logic[list_off + i]);
      if (ntok == 0) continue;
      const size_t row0 = ((size_t)sel_phys[list_off + i] * H + h) * page;
      for (int t0 = 0; t0 < ntok; t0 += KV16_TS) {
        const int ts = min(KV16_TS, ntok - t0);
        const int st = rg.stage;
        sm90::mbar_wait(&empty[st], rg.phase ^ 1u);
        unsigned char* ks = ring + st * KV16_STAGE;
        if (lane == 0) sm90::mbar_arrive_tx(&full[st], 4u * D * ts);
        __syncwarp();
        const __nv_bfloat16* krows = k_data + (row0 + t0) * D;
        for (int t = lane; t < ts; t += 32)
          sm90::bulk_load(ks + t * KV16_KROW, krows + (size_t)t * D, 2 * D,
                          &full[st]);
        if (lane == 0)
          sm90::bulk_load(ks + KV16_TS * KV16_KROW, v_data + (row0 + t0) * D,
                          2u * D * ts, &full[st]);
        rg.advance<NSTAGE>();
      }
    }
    return;
  }

  // q as the B operand of S^T = K q^T: column n is q row n (zero past
  // n_rep); k step kk covers head dims 16 kk .. 16 kk + 15
  const int g = lane >> 2, t4 = lane & 3;
  const size_t row_base = ((size_t)b * H + h) * n_rep;
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0u;
    if (g < n_rep) {
      const __nv_bfloat16* qr = q + (row_base + g) * D + 16 * kk + 2 * t4;
      qb[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
      qb[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  if (tid < NREP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[NREP][2];
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r][0] = acc[r][1] = 0.0f;
  const int dp = tid % (D / 2), th = tid / (D / 2);
  consumers_sync<NT>();

  sm90::Ring rg;
  for (int i = i0; i < i1; ++i) {
    const int logic = sel_logic[list_off + i];
    const int ntok = mask.slots(logic);
    if (ntok == 0) continue;
    for (int t0 = 0; t0 < ntok; t0 += KV16_TS) {
      const int ts = min(KV16_TS, ntok - t0);
      const int st = rg.stage;
      sm90::mbar_wait(&full[st], rg.phase);
      const unsigned char* ks = ring + st * KV16_STAGE;
      const __nv_bfloat16* vs =
          reinterpret_cast<const __nv_bfloat16*>(ks + KV16_TS * KV16_KROW);
      // scores: warp w's tokens 16 w .. 16 w + 15 are the A operand's rows
      // (rows past ts hold stale bytes and are never stored; the 2 warps
      // at D = 64 cover the stage's 32 tokens)
      if (16 * warp < ts) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const uint32_t a_addr = sm90::smem_u32(
            ks + (16 * warp + (lane & 15)) * KV16_KROW + (lane >> 4) * 16);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, a_addr + 32 * kk);
          mma16816(c, a, qb[kk][0], qb[kk][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * warp + g + 8 * (e >> 1), r = 2 * t4 + (e & 1);
          if (r < n_rep && t < ts)
            sc[r][t] = !BAND || mask.live(logic, t0 + t) ? c[e] * sm_scale
                                                         : -INFINITY;
        }
      }
      consumers_sync<NT>();
      // online softmax, one warp per query row (dense: ts >= 1 live slots,
      // so m_new is finite; the band's dead slots weigh 0, and a stage with
      // no live slot leaves the row as it was)
      for (int r = warp; r < n_rep; r += NWARP) {
        float mx = -INFINITY;
        for (int t = lane; t < ts; t += 32) mx = fmaxf(mx, sc[r][t]);
        mx = warp_max(mx);
        const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
        float lsum = 0.0f;
        for (int t = lane; t < ts; t += 32) {
          const float p = !BAND || mask.live(logic, t0 + t)
                              ? expf(sc[r][t] - m_new) : 0.0f;
          pw[t][r] = p;
          lsum += p;
        }
        lsum = warp_sum(lsum);
        if (lane == 0) {
          const float alpha =
              BAND && m_new == -INFINITY ? 1.0f : expf(m_old - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + lsum;
          alpha_s[r] = alpha;
        }
      }
      consumers_sync<NT>();
      // P.V in f32
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        acc[r][0] *= alpha_s[r];
        acc[r][1] *= alpha_s[r];
      }
      for (int t = th; t < ts; t += 2) {
        float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + t * D + 2 * dp));
        if (BAND && !mask.live(logic, t0 + t)) v = make_float2(0.0f, 0.0f);
        float p[NREP];
        load_row<NREP>(p, pw[t]);
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          acc[r][0] = __fmaf_rn(p[r], v.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(p[r], v.y, acc[r][1]);
        }
      }
      sm90::mbar_arrive(&empty[st]);
      rg.advance<NSTAGE>();
    }
  }
  split_finish<NREP, D>(acc, m_s, l_s, red, tid, row_base, n_rep, s,
                     gridDim.x, (size_t)gridDim.z * H * n_rep, out, ws);
}

// Entries 2 and 3: decode over explicit page lists of a kv4 or kv8 pool.
//
// Contract (plain version: attention_ref.paged_decode_attention with
// page_idxes, and with a streaming pool; the wrappers in
// omniserve_tpu_torch/ops/cuda/decode_attention.py build the lists):
//   - pages as entry 1 reads them: kv4 half-split nibble rows or kv8 byte
//     rows, fine-grained (folded planes) or per-tensor (PT: no planes, the
//     layer's scales kpt / vpt read on the device, codes biased by 8 / 128);
//   - entry i of a list names a physical page sel_phys and the logical page
//     sel_logic it holds (-1 = dead entry, skipped); lists are in no order,
//     one per (sequence, head) [B, H, Tp] for entry 2, one per sequence
//     shared by the heads [B, Tp] for entry 3 (BAND).
//   - the token in slot t of the page sits at position sel_logic*page + t.
//     With band_sink >= 0 and ring_span > 0: the page being written
//     (logical page (len-1)/page) still holds, past its write head, tokens
//     of one ring wrap earlier: those slots are relabelled pos -
//     ring_span*page and are live only at or above ring_sink_tok.
//   - a token is attended iff pos < len (and, relabelled, pos >= the ring's
//     first position), and with band_sink >= 0 only if pos < band_sink or
//     pos >= max(0, len - band_local).
//   - a row with len <= 0, or no live token, outputs zeros.
// The pool is only read. A kv8 stage holds a run of up to 64 token rows of
// a page, a kv4 stage the whole page (page/2 rows, token t in row t %
// (page/2), high nibble iff t >= page/2): the K rows, the V rows, then,
// fine-grained, the four plane runs of the slots it covers. Only rows that
// can hold a live token are copied (a kv8 run rounded up to 4 rows, so the
// plane runs stay multiples of 16 bytes).
// ring stages of the list kernel: on an H100, 2 ran faster than 3 at B=128
// (more resident blocks an SM) and as fast at B=8, and faster than 1 (PERF.md,
// row 4)
constexpr int LIST_NSTAGE = 2;
constexpr int LIST_KV8_ROWS = 64;     // token rows of a kv8 stage
constexpr int LIST_TS = MAX_PAGE;     // token slots of a stage, at most
// P.V's f16 weights are p * v_scale times 2^8 (an exact power of two, out
// of f16's subnormal range for weights down to ~2.4e-7, below 65504 for
// v_scale < 255), its f32 sums scaled back at the end
constexpr float P_SCALE = 256.0f;

__host__ __device__ constexpr int list_stage_rows(int kv_bits, int page) {
  return kv_bits == 8 ? (page < LIST_KV8_ROWS ? page : LIST_KV8_ROWS)
                      : page / 2;
}
__host__ __device__ constexpr int list_stage_slots(int kv_bits, int page) {
  return kv_bits == 8 ? list_stage_rows(8, page) : page;
}
__host__ __device__ constexpr int list_stage_bytes(int kv_bits, bool pt,
                                                   int page, int d) {
  return (2 * list_stage_rows(kv_bits, page) * d +
          (pt ? 0 : 16 * list_stage_slots(kv_bits, page)) + 127) / 128 * 128;
}

// The rows a stage copies and the plane slots it covers, from the slots
// [0, ntok) of the page that can hold a live token and the stage's first
// row r0.
template <bool KV8>
__device__ __forceinline__ void list_stage_extent(int ntok, int r0, int rs,
                                                  int half, int& nrow,
                                                  int& nslot) {
  if (KV8) {
    nrow = (min(rs, ntok - r0) + 3) & ~3;
    nslot = nrow;
  } else {
    nrow = min(half, ntok);
    nslot = (ntok + 3) & ~3;
  }
}

// APPEND: the new token into the staged page and into the pool, by the
// consumers (thread = head-dim lane) right after the stage that holds its
// slot landed: stage slot t of the stage at kst (rs rows of K codes, rs of
// V, then FINE the four plane runs of ts slots; a kv4 stage starts at slot
// 0), pool slot `slot` of page phys. The staged bytes are the pool's, so a
// kv4 byte merged here keeps its partner nibble (slot +- page/2) as the
// plain append does, and both copies get the same byte. The pool write
// comes after the block's only read of that page (the bulk copy has
// landed); no other block reads it. The consumers then meet, so the
// scoring reads the patched rows and planes.
template <bool KV8, bool FINE, int D>
__device__ __forceinline__ void append_token(
    unsigned char* kst, int rs, int ts, int t, int half, const TokQuant& kq,
    const TokQuant& vq, uint8_t* k_data, uint8_t* v_data, float* planes,
    int phys, int H, int h, int page, int slot) {
  constexpr int NT = D;
  const int tid = threadIdx.x;
  unsigned char* vst = kst + rs * D;
  const uint32_t kc = (uint32_t)kq.code, vc = (uint32_t)vq.code;
  const int row = KV8 ? t : t % half;
  uint32_t kb = kc, vb = vc;
  if (!KV8) {
    const uint32_t ko = kst[row * D + tid], vo = vst[row * D + tid];
    const bool hi = t >= half;
    kb = hi ? ((ko & 0x0Fu) | (kc << 4)) : ((ko & 0xF0u) | kc);
    vb = hi ? ((vo & 0x0Fu) | (vc << 4)) : ((vo & 0xF0u) | vc);
  }
  kst[row * D + tid] = (uint8_t)kb;
  vst[row * D + tid] = (uint8_t)vb;
  const size_t off = (((size_t)phys * H + h) * (KV8 ? page : half) +
                      (KV8 ? slot : slot % half)) * D + tid;
  k_data[off] = (uint8_t)kb;
  v_data[off] = (uint8_t)vb;
  if (FINE && tid < 4) {   // the folded plane lanes, as append_kv sets them
    const float val = tid == 0   ? kq.scale
                      : tid == 1 ? kq.scale * (kq.zero + 128.0f)
                      : tid == 2 ? vq.scale
                                 : vq.zero + 128.0f;
    reinterpret_cast<float*>(kst + 2 * rs * D)[tid * ts + t] = val;
    planes[(((size_t)phys * 4 + tid) * H + h) * page + slot] = val;
  }
  sm90::fence_proxy_async();   // before the ring's next copy into the stage
  consumers_sync<NT>();
}

template <int NREP, bool BAND, int KV_BITS, bool PT, bool APPEND, int D>
__global__ void __launch_bounds__(D + 32) decode_attn_list_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, H, n_rep, D]
    const uint8_t* __restrict__ k_data,       // layer: [P, H, rows, D]
    const uint8_t* __restrict__ v_data,
    const float* __restrict__ planes,         // layer: [P, 4, H, page]
    const float* __restrict__ kpt,            // PT: the layer's K scale
    const float* __restrict__ vpt,            // PT: the layer's V scale
    const int* __restrict__ sel_phys,         // [B, H, Tp]; BAND [B, Tp]
    const int* __restrict__ sel_logic,        // [B, H, Tp]; BAND [B, Tp]
    const int* __restrict__ lengths,          // [B]
    const __nv_bfloat16* __restrict__ k_new,  // APPEND: [B, H, D]
    const __nv_bfloat16* __restrict__ v_new,
    __nv_bfloat16* __restrict__ out,          // [B, H, n_rep, D]
    float* __restrict__ ws,                   // S > 1: the partials
    int H, int n_rep, int page, int Tp, int per_split, float sm_scale,
    int band_sink, int band_local, int ring_span, int ring_sink_tok) {
  SPLIT_DIMS(D);
  constexpr bool KV8 = KV_BITS == 8, FINE = !PT;
  constexpr float BIAS = KV8 ? 128.0f : 8.0f;   // per-tensor code bias
  static_assert(!APPEND || BAND, "the append walks a list shared by heads");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align128(smem_raw);
  __shared__ __align__(16) float q_s[NREP][D];
  __shared__ __align__(16) float sc[NREP][LIST_TS];    // scores
  __shared__ __align__(16) float pw[LIST_TS][NREP];    // p * v_scale
  __shared__ float red[NWARP];                          // APPEND's reduce
  __shared__ __align__(16) float red2[KV8 ? 4 : NREP * D];  // kv4's finish
  __shared__ float qsum[NREP], m_s[NREP], l_s[NREP], alpha_s[NREP], c_s[NREP];
  __shared__ __align__(8) uint64_t full[LIST_NSTAGE], empty[LIST_NSTAGE];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int half = page / 2, rows = KV8 ? page : half;
  const int rs = list_stage_rows(KV_BITS, page);
  const int ts = list_stage_slots(KV_BITS, page);
  const int stage_bytes = list_stage_bytes(KV_BITS, PT, page, D);
  const size_t list_off = BAND ? (size_t)b * Tp : ((size_t)b * H + h) * Tp;
  const ListMask mask(len, page, BAND ? band_sink : -1, band_local,
                      ring_span, ring_sink_tok);
  const int i0 = s * per_split, i1 = min(Tp, i0 + per_split);
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < LIST_NSTAGE; ++st) {
      sm90::mbar_init(&full[st], 1);      // the copy warp's lane 0 (+ bytes)
      sm90::mbar_init(&empty[st], NT);    // every consumer thread
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == COPY_WARP) {
    sm90::Ring rg;
    for (int i = i0; i < i1; ++i) {
      const int ntok = mask.slots(APPEND ? i : sel_logic[list_off + i]);
      if (ntok == 0) continue;
      const int phys = sel_phys[list_off + i];
      const size_t prow = ((size_t)phys * H + h) * rows;
      for (int r0 = 0; r0 < (KV8 ? ntok : 1); r0 += rs) {
        int nrow, nslot;
        list_stage_extent<KV8>(ntok, r0, rs, half, nrow, nslot);
        const int st = rg.stage;
        sm90::mbar_wait(&empty[st], rg.phase ^ 1u);
        unsigned char* kst = ring + st * stage_bytes;
        if (lane == 0)
          sm90::mbar_arrive_tx(&full[st],
                               2u * nrow * D + (FINE ? 16u * nslot : 0u));
        __syncwarp();
        if (lane == 0)
          sm90::bulk_load(kst, k_data + (prow + r0) * D, nrow * D, &full[st]);
        else if (lane == 1)
          sm90::bulk_load(kst + rs * D, v_data + (prow + r0) * D, nrow * D,
                          &full[st]);
        else if (FINE && lane < 6)
          sm90::bulk_load(
              reinterpret_cast<float*>(kst + 2 * rs * D) + (lane - 2) * ts,
              planes + (((size_t)phys * 4 + lane - 2) * H + h) * page + r0,
              4 * nslot, &full[st]);
        rg.advance<LIST_NSTAGE>();
      }
    }
    return;
  }

  const size_t row_base = ((size_t)b * H + h) * n_rep;
#pragma unroll
  for (int r = 0; r < NREP; ++r)
    if (r < n_rep) q_s[r][tid] = __bfloat162float(q[(row_base + r) * D + tid]);
  if (tid < NREP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  consumers_sync<NT>();
  for (int r = warp; r < n_rep; r += NWARP) {
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) part += q_s[r][lane * (D / 32) + j];
    const float sum = warp_sum(part);
    if (lane == 0) qsum[r] = sum;
  }
  const float k_pt = PT ? *kpt : 0.0f, v_pt = PT ? *vpt : 0.0f;
  // q as the f16 B operand of the scores: column n is q row n (zero past
  // n_rep); thread t4's k indices 2 t4, 2 t4 + 1 (b0) and 2 t4 + 8, + 9
  // (b1) of step kk are head dims (D/4) t4 + 4 kk + {0, 2} and {1, 3}, the
  // order in which the A operand's code words unpack
  constexpr int QB = D / 4;    // a quad thread's bytes of a K row
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0u;
    if (g < n_rep) {
      const float* qr = &q_s[g][QB * t4 + 4 * kk];
      qb[kk][0] = pack_f16(qr[0], qr[2]);
      qb[kk][1] = pack_f16(qr[1], qr[3]);
    }
  }
  // APPEND: the block whose run holds the row's newest page quantizes the
  // new token (thread = head-dim lane), as append_kv does
  const bool owner = APPEND && len > 0 && i0 <= mask.cur_page &&
                     mask.cur_page < i1;
  TokQuant kq = {}, vq = {};
  if (owner) {
    const size_t off = ((size_t)b * H + h) * D + tid;
    const float kx = __bfloat162float(k_new[off]);
    const float vx = __bfloat162float(v_new[off]);
    constexpr int LEVELS = KV8 ? 255 : 15, QMAX = KV8 ? 127 : 7;
    auto reduce = [&](float v, int op) {
      return reduce_nt<NWARP>(v, op, red, [] { consumers_sync<NT>(); });
    };
    kq = PT ? quant_pt<QMAX>(kx, k_pt) : quant_kv_by<LEVELS>(kx, reduce);
    vq = PT ? quant_pt<QMAX>(vx, v_pt) : quant_kv_by<LEVELS>(vx, reduce);
  }
  // P.V's accumulators: kv8, n-tile j's mma fragment (rows 8-15 unused);
  // kv4, row r's head-dim lanes 2 (tid % (D/2)), +1 (tokens of parity
  // tid / (D/2))
  constexpr int AR = KV8 ? 4 : NREP, AC = KV8 ? 4 : 2;
  float acc[AR][AC];
#pragma unroll
  for (int r = 0; r < AR; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[r][c] = 0.0f;
  const int dp = tid % (D / 2), th = tid / (D / 2);
  consumers_sync<NT>();

  sm90::Ring rg;
  for (int i = i0; i < i1; ++i) {
    const int logic = APPEND ? i : sel_logic[list_off + i];
    const int ntok = mask.slots(logic);
    if (ntok == 0) continue;
    for (int r0 = 0; r0 < (KV8 ? ntok : 1); r0 += rs) {
      int nrow, nslot;
      list_stage_extent<KV8>(ntok, r0, rs, half, nrow, nslot);
      const int n_pw = KV8 ? nrow : page;   // stage slots the softmax covers
      const int st = rg.stage;
      sm90::mbar_wait(&full[st], rg.phase);
      unsigned char* kst = ring + st * stage_bytes;
      const unsigned char* vst = kst + rs * D;
      const float* pst = reinterpret_cast<const float*>(kst + 2 * rs * D);
      if (owner && logic == mask.cur_page &&
          (!KV8 || (mask.cur_slot >= r0 && mask.cur_slot < r0 + rs)))
        append_token<KV8, FINE, D>(kst, rs, ts, mask.cur_slot - r0, half, kq, vq,
                                const_cast<uint8_t*>(k_data),
                                const_cast<uint8_t*>(v_data),
                                const_cast<float*>(planes),
                                sel_phys[list_off + i], H, h, page,
                                mask.cur_slot);
      // scores on the tensor cores, S^T = K q^T: warp w's pass takes the
      // stage's K rows rb .. rb + 15 as the A operand's rows (kv4: a tile of
      // their low nibbles, slots rb.., and one of their high nibbles, slots
      // rb + page/2 ..); only live slots' scores are stored or read
      for (int rb = 16 * warp; rb < nrow; rb += 16 * NWARP) {  // warp-uniform
        // rows rb + g, rb + g + 8: bytes [QB t4, + QB)
        uint4 kw[2][QB / 16];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = rb + g + 8 * hr;
#pragma unroll
          for (int i = 0; i < QB / 16; ++i)
            kw[hr][i] = row < nrow ? *reinterpret_cast<const uint4*>(
                                         kst + row * D + QB * t4 + 16 * i)
                                   : make_uint4(0u, 0u, 0u, 0u);
        }
        float clo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float chi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t x0 = word_of(kw[0][kk >> 2], kk & 3);
          const uint32_t x1 = word_of(kw[1][kk >> 2], kk & 3);
          uint32_t a[4];
          if constexpr (KV8) {
            a[0] = codes_f16(__byte_perm(x0, 0x64646464u, 0x4240));
            a[1] = codes_f16(__byte_perm(x1, 0x64646464u, 0x4240));
            a[2] = codes_f16(__byte_perm(x0, 0x64646464u, 0x4341));
            a[3] = codes_f16(__byte_perm(x1, 0x64646464u, 0x4341));
            mma16816_f16(clo, a, qb[kk][0], qb[kk][1]);
          } else {
#pragma unroll
            for (int nib = 0; nib < 2; ++nib) {
              a[0] = nibbles_f16(x0 >> (4 * nib));
              a[1] = nibbles_f16(x1 >> (4 * nib));
              a[2] = nibbles_f16(x0 >> (4 * nib + 8));
              a[3] = nibbles_f16(x1 >> (4 * nib + 8));
              mma16816_f16(nib ? chi : clo, a, qb[kk][0], qb[kk][1]);
            }
          }
        }
        // c[e]: K row rb + g + 8 (e / 2), q row 2 t4 + e % 2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rb + g + 8 * (e >> 1), r = 2 * t4 + (e & 1);
          if (r >= n_rep || row >= nrow) continue;
#pragma unroll
          for (int k = 0; k < (KV8 ? 1 : 2); ++k) {
            const int t = row + k * half;      // stage slot
            if (!mask.live(logic, r0 + t)) continue;
            const float ks = FINE ? pst[t] : k_pt;
            const float kc = FINE ? pst[ts + t] - 128.0f * ks : BIAS * k_pt;
            sc[r][t] = sm_scale * (ks * (k ? chi[e] : clo[e]) - kc * qsum[r]);
          }
        }
      }
      consumers_sync<NT>();
      // online softmax, one warp per query row; a dead slot's weight is 0
      for (int r = warp; r < n_rep; r += NWARP) {
        float mx = -INFINITY;
        for (int t = lane; t < n_pw; t += 32)
          if (mask.live(logic, r0 + t)) mx = fmaxf(mx, sc[r][t]);
        mx = warp_max(mx);
        const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
        float lsum = 0.0f, csum = 0.0f;
        for (int t = lane; t < n_pw; t += 32) {
          float p = 0.0f, w = 0.0f;
          if (mask.live(logic, r0 + t)) {
            p = expf(sc[r][t] - m_new);
            w = p * (FINE ? pst[2 * ts + t] : v_pt);
            csum += w * (FINE ? pst[3 * ts + t] - 128.0f : BIAS);   // v_zero
          }
          pw[t][r] = w;
          lsum += p;
        }
        lsum = warp_sum(lsum);
        csum = warp_sum(csum);
        if (lane == 0) {
          const float alpha = m_new == -INFINITY ? 1.0f : expf(m_old - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + lsum;
          alpha_s[r] = alpha;
          c_s[r] = csum;
        }
      }
      consumers_sync<NT>();
      if constexpr (!KV8) {
        // kv4: P.V in f32 FMAs (faster here than the tensor cores on an
        // H100; the weights never rounded): thread tid owns head-dim lanes
        // 2 (tid % (D/2)), +1 of the rows of parity tid / (D/2), whose
        // bytes hold slots row and row + page/2
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          acc[r][0] *= alpha_s[r];
          acc[r][1] *= alpha_s[r];
          if (th == 0) {
            acc[r][0] -= c_s[r];
            acc[r][1] -= c_s[r];
          }
        }
        for (int row = th; row < nrow; row += 2) {
          const uint32_t two =
              *reinterpret_cast<const uint16_t*>(vst + row * D + 2 * dp);
          float w[NREP], wh[NREP];
          load_row<NREP>(w, pw[row]);
          load_row<NREP>(wh, pw[row + half]);
          const float lo0 = (float)(two & 0xFu);
          const float hi0 = (float)((two >> 4) & 0xFu);
          const float lo1 = (float)((two >> 8) & 0xFu);
          const float hi1 = (float)(two >> 12);
#pragma unroll
          for (int r = 0; r < NREP; ++r) {
            acc[r][0] = __fmaf_rn(wh[r], hi0, __fmaf_rn(w[r], lo0, acc[r][0]));
            acc[r][1] = __fmaf_rn(wh[r], hi1, __fmaf_rn(w[r], lo1, acc[r][1]));
          }
        }
      } else {
        // kv8: P.V on the tensor cores (faster here than f32 FMAs on an
        // H100): O[r][d] += sum_t w[t][r] code[t][d], the weights w (p *
        // v_scale) times P_SCALE in f16 as the A operand (q row r = row g;
        // rows 8-15 zero), the stage's V codes as B (warp w's head dims
        // 32 w + 4 n + j as column n of n-tile j), 16 stage slots a step; a
        // slot past the stage gets weight 0 and code 0 (a dead slot's
        // weight is 0 and its codes finite)
        const float al = g < n_rep ? alpha_s[g] : 1.0f;
        const float cs = g < n_rep ? c_s[g] * P_SCALE : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = acc[j][0] * al - cs;
          acc[j][1] = acc[j][1] * al - cs;
        }
        for (int t0 = 0; t0 < n_pw; t0 += 16) {
          uint32_t a[4] = {0u, 0u, 0u, 0u};
          uint32_t v[4];   // dims 32 w + 4 g .. + 3 of slots t0 + 2 t4 + u
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = t0 + 2 * t4 + (u & 1) + 8 * (u >> 1);
            v[u] = t < n_pw ? *reinterpret_cast<const uint32_t*>(
                                  vst + t * D + 32 * warp + 4 * g)
                            : 0u;
          }
          if (g < n_rep) {
            float wt[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int t = t0 + 2 * t4 + (u & 1) + 8 * (u >> 1);
              wt[u] = t < n_pw ? pw[t][g] * P_SCALE : 0.0f;
            }
            a[0] = pack_f16(wt[0], wt[1]);
            a[2] = pack_f16(wt[2], wt[3]);
          }
          // (slot pair, dim) f16 pairs: byte j of the two slots' words
          const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
          const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
          const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
          const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t sel = (j & 1) ? 0x4342 : 0x4140;
            const uint32_t b0 = codes_f16(
                __byte_perm(j < 2 ? lo01 : hi01, 0x64646464u, sel));
            const uint32_t b1 = codes_f16(
                __byte_perm(j < 2 ? lo23 : hi23, 0x64646464u, sel));
            mma16816_f16(acc[j], a, b0, b1);
          }
        }
      }
      sm90::mbar_arrive(&empty[st]);
      rg.advance<LIST_NSTAGE>();
    }
  }
  if constexpr (!KV8) {
    split_finish<NREP, D>(acc, m_s, l_s, red2, tid, row_base, n_rep, s,
                       gridDim.x, (size_t)gridDim.z * H * n_rep, out, ws);
  } else {
    // the end of a split: thread (warp w, g < n_rep, t4) holds row g's
    // head dims 32 w + 8 t4 + i: acc[i % 4][i / 4] times P_SCALE
    if (g >= n_rep) return;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = acc[i & 3][i >> 2] * (1.0f / P_SCALE);
    const size_t row = row_base + g;
    const int d0 = 32 * warp + 8 * t4;
    if (gridDim.x == 1) {
      const float l = l_s[g];
      uint4 pk;
      uint32_t* p32 = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            l > 0.0f ? o[2 * i] / l : 0.0f,
            l > 0.0f ? o[2 * i + 1] / l : 0.0f);
        p32[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(out + row * D + d0) = pk;
    } else {
      const size_t rows = (size_t)gridDim.z * H * n_rep;
      const size_t prow = (size_t)s * rows + row;
      float4* dst = reinterpret_cast<float4*>(ws + prow * D + d0);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
      if (warp == 0 && t4 == 0) {
        float* ml = ws + (size_t)gridDim.x * rows * D + prow * 2;
        ml[0] = m_s[g];
        ml[1] = l_s[g];
      }
    }
  }
}

// Merges the S partials of each (sequence, head, rep) row in split order
// (omniserve_tpu/parallel/sp.py:sp_combine's rule): m* = max_s m_s, then
// out = sum_s acc_s e_s / sum_s l_s e_s, e_s = exp(m_s - m*) once per
// split, over the splits that met a live token (m_s > -inf); 0 where none
// did. One block per row, one thread per head-dim lane.
template <int D>
__global__ void __launch_bounds__(D) decode_split_combine_kernel(
    const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int rows,
    int S) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws + (size_t)S * rows * D;
  float m_star = -INFINITY;
  for (int s = 0; s < S; ++s)
    m_star = fmaxf(m_star, ml[((size_t)s * rows + row) * 2]);
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < S; ++s) {
    const size_t prow = (size_t)s * rows + row;
    const float m = ml[prow * 2];
    if (m == -INFINITY) continue;
    const float e = expf(m - m_star);
    den = __fmaf_rn(ml[prow * 2 + 1], e, den);
    num = __fmaf_rn(ws[prow * D + d], e, num);
  }
  out[row * D + d] = __float2bfloat16(den > 0.0f ? num / den : 0.0f);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Allow `kernel` `bytes` of dynamic shared memory, once per kernel and
// device (a launch that asks for more than 48 KB without it is refused).
int allow_smem(const void* kernel, int bytes) {
  constexpr int N = 64;
  static const void* fns[N];
  static int devs[N], n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i)
    if (fns[i] == kernel && devs[i] == dev) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  if (n < N) {
    fns[n] = kernel;
    devs[n] = dev;
    ++n;
  }
  return 0;
}

// The query rows a block holds for n_rep q heads a kv head: the smallest
// instantiation (1, 2, 4 or 8) that covers n_rep; 0 past 8. Rows n_rep ..
// NREP - 1 are dead: zero q columns, never scored into the softmax or
// stored (decode is bound by KV bytes, which a dead row does not add to).
int row_capacity(int n_rep) {
  return n_rep <= 0 ? 0 : n_rep <= 1 ? 1 : n_rep <= 2 ? 2 : n_rep <= 4 ? 4
                                      : n_rep <= 8 ? 8 : 0;
}

// S = the number of runs of per_split list entries (one block each)
int split_count(int Tp, int per_split) {
  return Tp <= 0 ? 1 : (Tp + per_split - 1) / per_split;
}

// After a split kernel: with S > 1 the combine over its partials.
int finish_split(int err, const void* ws, void* out, int rows, int S, int d,
                 cudaStream_t s) {
  if (err != 0 || S == 1) return err;
  if (d == 64)
    decode_split_combine_kernel<64><<<rows, 64, 0, s>>>(
        static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), rows,
        S);
  else
    decode_split_combine_kernel<128><<<rows, 128, 0, s>>>(
        static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), rows,
        S);
  return (int)cudaGetLastError();
}

using ListKernel = void (*)(const __nv_bfloat16*, const uint8_t*,
                            const uint8_t*, const float*, const float*,
                            const float*, const int*, const int*, const int*,
                            const __nv_bfloat16*, const __nv_bfloat16*,
                            __nv_bfloat16*, float*, int, int, int, int, int,
                            float, int, int, int, int);
using Kv16Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                            const __nv_bfloat16*, const int*, const int*,
                            const int*, __nv_bfloat16*, float*, int, int,
                            int, int, int, float, int, int, int, int);

template <int R, bool BAND, bool APPEND, int D>
ListKernel list_kernel(int kv_bits, bool pt) {
  if (pt)
    return kv_bits == 8
               ? decode_attn_list_kernel<R, BAND, 8, true, APPEND, D>
               : decode_attn_list_kernel<R, BAND, 4, true, APPEND, D>;
  return kv_bits == 8 ? decode_attn_list_kernel<R, BAND, 8, false, APPEND, D>
                      : decode_attn_list_kernel<R, BAND, 4, false, APPEND, D>;
}

// kPerHead: a list per (sequence, head); kBand: a list per sequence shared
// by the heads, with the band when band_sink >= 0 (a dense list without);
// kAppend: the block table as the dense list, with the new token
enum ListMode { kPerHead = 0, kBand = 1, kAppend = 2 };

// The list kernel for n_rep and a head dim: the append at head_dim 128
// only (the JAX package sends every head_dim-64 decode through the split
// path: the append kernel, then row 6's modes)
template <int R>
ListKernel pick_list(ListMode mode, int kv_bits, bool pt, int d) {
  if (d == 64)
    return mode == kAppend ? nullptr
           : mode == kBand ? list_kernel<R, true, false, 64>(kv_bits, pt)
                           : list_kernel<R, false, false, 64>(kv_bits, pt);
  return mode == kAppend ? list_kernel<R, true, true, 128>(kv_bits, pt)
         : mode == kBand ? list_kernel<R, true, false, 128>(kv_bits, pt)
                         : list_kernel<R, false, false, 128>(kv_bits, pt);
}

// Entries 1 (the dense list of block_tables with the append), 2 (per-head
// lists), 3 (the band) and row 6's kv4 / kv8 modes: grid (S, H, B), S =
// the runs of per_split list entries; with S > 1 the combine over the
// partials in ws.
int launch_list(ListMode mode, const void* q, const void* k_data,
                const void* v_data, const void* planes, const void* sel_phys,
                const void* sel_logic, const void* lengths,
                const void* k_new, const void* v_new, void* out, void* ws,
                int B, int H, int n_rep, int page, int Tp, int per_split,
                float sm_scale, int band_sink, int band_local, int ring_span,
                int ring_sink_tok, int kv_bits, const void* k_pt,
                const void* v_pt, int d, void* stream) {
  const bool pt = k_pt != nullptr;
  const int S = per_split > 0 ? split_count(Tp, per_split) : 0;
  if ((kv_bits != 4 && kv_bits != 8) || pt != (v_pt != nullptr) ||
      (!pt && planes == nullptr) || page <= 0 || page > MAX_PAGE ||
      page % 4 != 0 || S <= 0 || (S > 1 && ws == nullptr) ||
      !head_dim_ok(d) || !aligned16(k_data) || !aligned16(v_data) ||
      !aligned16(planes) ||
      (mode == kAppend && (k_new == nullptr || v_new == nullptr)))
    return (int)cudaErrorInvalidValue;
  ListKernel kernel = nullptr;
  switch (row_capacity(n_rep)) {
    case 1: kernel = pick_list<1>(mode, kv_bits, pt, d); break;
    case 2: kernel = pick_list<2>(mode, kv_bits, pt, d); break;
    case 4: kernel = pick_list<4>(mode, kv_bits, pt, d); break;
    case 8: kernel = pick_list<8>(mode, kv_bits, pt, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int err = allow_smem(reinterpret_cast<const void*>(kernel),
                       LIST_NSTAGE *
                               list_stage_bytes(kv_bits, pt, MAX_PAGE, d) +
                           128);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(S, H, B), d + 32,
           LIST_NSTAGE * list_stage_bytes(kv_bits, pt, page, d) + 128, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(k_data), static_cast<const uint8_t*>(v_data),
      static_cast<const float*>(planes), static_cast<const float*>(k_pt),
      static_cast<const float*>(v_pt), static_cast<const int*>(sel_phys),
      static_cast<const int*>(sel_logic), static_cast<const int*>(lengths),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), H, n_rep,
      page, Tp, per_split, sm_scale, band_sink, band_local, ring_span,
      ring_sink_tok);
  return finish_split((int)cudaGetLastError(), ws, out, B * H * n_rep, S, d,
                      s);
}

template <int R, int D>
Kv16Kernel kv16_kernel(Kv16Mode mode) {
  return mode == KV16_BAND ? decode_attn_kv16_kernel<R, KV16_BAND, D>
         : mode == KV16_PER_HEAD
             ? decode_attn_kv16_kernel<R, KV16_PER_HEAD, D>
             : decode_attn_kv16_kernel<R, KV16_DENSE, D>;
}

template <int R>
Kv16Kernel pick_kv16(Kv16Mode mode, int d) {
  return d == 64 ? kv16_kernel<R, 64>(mode) : kv16_kernel<R, 128>(mode);
}

// Entry 4 in each mode: grid (S, H, B), S = the runs of per_split list
// entries; with S > 1 the combine over the partials in ws.
int launch_kv16(Kv16Mode mode, const void* q, const void* k_data,
                const void* v_data, const void* sel_phys,
                const void* sel_logic, const void* lengths, void* out,
                void* ws, int B, int H, int n_rep, int page, int Tp,
                int per_split, float sm_scale, int band_sink, int band_local,
                int ring_span, int ring_sink_tok, int d, void* stream) {
  const int S = per_split > 0 ? split_count(Tp, per_split) : 0;
  if (page <= 0 || page > MAX_PAGE || S <= 0 || (S > 1 && ws == nullptr) ||
      !head_dim_ok(d) || !aligned16(k_data) || !aligned16(v_data) ||
      (mode == KV16_BAND && band_sink < 0))
    return (int)cudaErrorInvalidValue;
  Kv16Kernel kernel = nullptr;
  switch (row_capacity(n_rep)) {
    case 1: kernel = pick_kv16<1>(mode, d); break;
    case 2: kernel = pick_kv16<2>(mode, d); break;
    case 4: kernel = pick_kv16<4>(mode, d); break;
    case 8: kernel = pick_kv16<8>(mode, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  int err = allow_smem(reinterpret_cast<const void*>(kernel), kv16_smem(d));
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(S, H, B), d + 32, kv16_smem(d), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_data),
      static_cast<const __nv_bfloat16*>(v_data),
      static_cast<const int*>(sel_phys), static_cast<const int*>(sel_logic),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), H, n_rep, page, Tp, per_split, sm_scale,
      band_sink, band_local, ring_span, ring_sink_tok);
  return finish_split((int)cudaGetLastError(), ws, out, B * H * n_rep, S, d,
                      s);
}

}  // namespace

extern "C" {

// The fused decode: the new token's K/V (k_new, v_new [B, H, D] bf16)
// quantized into the pool and attended with the dense list of each row's
// block table [B, W] (entry i = logical page i, dead past the length), cut
// into runs of per_split entries (grid (S, H, B)); ws holds the f32
// partials when S > 1 (S * B*H*n_rep * (D + 2) floats; may be null at
// S = 1). kv_bits 4 or 8, pages of a multiple of 4 tokens up to 256, head
// dim 128; per-tensor codes when k_pt / v_pt (device addresses of the
// layer's scales) are given, and planes may then be null. Returns
// cudaGetLastError() after the launches (0 = launched).
int launch_decode_attention_append(
    const void* q, const void* k_new, const void* v_new, void* k_data,
    void* v_data, void* planes, const void* block_tables,
    const void* context_lens, void* out, void* ws, int B, int H, int n_rep,
    int page, int W, int per_split, float sm_scale, int kv_bits,
    const void* k_pt, const void* v_pt, void* stream) {
  return launch_list(kAppend, q, k_data, v_data, planes, block_tables,
                     nullptr, context_lens, k_new, v_new, out, ws, B, H,
                     n_rep, page, W, per_split, sm_scale, -1, 0, 0, 0,
                     kv_bits, k_pt, v_pt, 128, stream);
}

// Dynamic-sparse decode: per-(sequence, head) page lists [B, H, Tp], each
// cut into runs of per_split entries (grid (S, H, B)); ws holds the f32
// partials when S > 1 (S * B*H*n_rep * (D + 2) floats; may be null at
// S = 1). kv_bits 4 or 8 (pages of a multiple of 4 tokens: the plane runs
// are bulk copies of 16-byte multiples), head dim 128; per-tensor codes
// when k_pt / v_pt (device addresses of the layer's scales) are given,
// and planes may then be null. Returns cudaGetLastError() after the
// launches (0 = launched).
int launch_decode_attention_ph(
    const void* q, const void* k_data, const void* v_data,
    const void* planes, const void* sel_phys, const void* sel_logic,
    const void* lengths, void* out, void* ws, int B, int H, int n_rep,
    int page, int Tp, int per_split, float sm_scale, int kv_bits,
    const void* k_pt, const void* v_pt, void* stream) {
  return launch_list(kPerHead, q, k_data, v_data, planes, sel_phys,
                     sel_logic, lengths, nullptr, nullptr, out, ws, B, H,
                     n_rep, page, Tp, per_split, sm_scale, -1, 0, 0, 0,
                     kv_bits, k_pt, v_pt, 128, stream);
}

// Plain mode with the streaming band: one page list [B, Tp] per sequence,
// shared by the heads, split and pooled as launch_decode_attention_ph's.
int launch_decode_attention_band(
    const void* q, const void* k_data, const void* v_data,
    const void* planes, const void* sel_phys, const void* sel_logic,
    const void* lengths, void* out, void* ws, int B, int H, int n_rep,
    int page, int Tp, int per_split, float sm_scale, int band_sink,
    int band_local, int ring_span, int ring_sink_tok, int kv_bits,
    const void* k_pt, const void* v_pt, void* stream) {
  return launch_list(kBand, q, k_data, v_data, planes, sel_phys, sel_logic,
                     lengths, nullptr, nullptr, out, ws, B, H, n_rep, page,
                     Tp, per_split, sm_scale, band_sink, band_local,
                     ring_span, ring_sink_tok, kv_bits, k_pt, v_pt, 128,
                     stream);
}

// Row 6, the two-stage decode (paged_mqa_attention) in every mode the JAX
// package runs it: list_mode 0 one page list [B, Tp] per sequence shared
// by the heads (the dense history), 1 one per (sequence, head) [B, H, Tp]
// (the selector's), 2 one per sequence with the streaming band (band_sink
// >= 0) and, with ring_span > 0, the ring relabel; over a kv16 pool
// (kv_bits 16: decode_attn_kv16_kernel) or a kv4 / kv8 pool, fine-grained
// (planes) or per-tensor (k_pt / v_pt: device addresses of the layer's
// scales; planes may then be null), read in the quantized domain by the
// split list kernel; head_dim 64 or 128, pages of at most 256 tokens (a
// multiple of 4 for kv4 / kv8). Split and pooled as
// launch_decode_attention_ph's. Returns cudaGetLastError() after the
// launches (0 = launched).
int launch_paged_mqa_attention(
    int list_mode, int kv_bits, const void* q, const void* k_data,
    const void* v_data, const void* planes, const void* k_pt,
    const void* v_pt, const void* sel_phys, const void* sel_logic,
    const void* lengths, void* out, void* ws, int B, int H, int n_rep,
    int page, int Tp, int per_split, float sm_scale, int band_sink,
    int band_local, int ring_span, int ring_sink_tok, int head_dim,
    void* stream) {
  if (list_mode < 0 || list_mode > 2 || (list_mode == 2 && band_sink < 0))
    return (int)cudaErrorInvalidValue;
  if (list_mode != 2) band_sink = -1;
  if (kv_bits == 16)
    return launch_kv16(list_mode == 0   ? KV16_DENSE
                       : list_mode == 1 ? KV16_PER_HEAD
                                        : KV16_BAND,
                       q, k_data, v_data, sel_phys, sel_logic, lengths, out,
                       ws, B, H, n_rep, page, Tp, per_split, sm_scale,
                       band_sink, band_local, ring_span, ring_sink_tok,
                       head_dim, stream);
  return launch_list(list_mode == 1 ? kPerHead : kBand, q, k_data, v_data,
                     planes, sel_phys, sel_logic, lengths, nullptr, nullptr,
                     out, ws, B, H, n_rep, page, Tp, per_split, sm_scale,
                     band_sink, band_local, ring_span, ring_sink_tok,
                     kv_bits, k_pt, v_pt, head_dim, stream);
}

}  // extern "C"
