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
// against a few bytes per token): the tensor cores' 989 TFLOP/s in bf16.
// The first port (PR 1) ran the products on the f32 FMA pipes, 72x off
// that bound and 33x slower than one SDPA call.
//
// Design (the shared core is attn_sm90.cuh): a persistent block per SM
// walks (128-query tile, q head) items, heaviest tile first, with 2
// consumer warpgroups of 64 rows and one producer warp. The producer
// loads each item's Q tile (double buffered) and a ring of 3 K/V stages,
// which runs on across items, by TMA (tensor maps over q [T, Hq*D] and
// k / v [T, Hkv*D], 128-byte swizzle, encoded on the host per call), so
// copies stay in flight while the consumers run S = Q K^T and O += P V on
// wgmma (bf16, f32 accumulation; P rounded to bf16 as the TPU kernel's
// p.astype(bfloat16)). The tile skip is a loop bound: a one-block kernel
// launched first (flash_tile_ranges_kernel; plain version
// ops/cuda/flash_attention.live_tile_ranges) gives each q tile its live
// key-tile range by binary search, a streaming head walks its sink range
// and then its local band's range (the TPU kernel's stream_dead skip,
// without a test per tile), and the key tiles every row sees whole. Only
// tiles that hold a diagonal, segment edge or band edge take a mask: the
// producer reads their keys' segments and positions; a tile of the rows'
// own segment needs the position compare only. What is left between it
// and the bound (H100 SXM, 700 W): ~30% of the bf16 peak at 16K tokens,
// ~23% on 8 x 1,024-token prompts (the short items' diagonal tiles and
// epilogues); one warpgroup's softmax does not overlap its own products
// (issuing the next S first, as FA3 does, ran slower here: with the
// stage held, the consumer waits on the producer before its softmax).
// Head dim 64 or 128 (a template parameter): at 64 a row is one swizzled
// half, one TMA box per Q / K / V tile, 4 k steps in S and one m64n64 O
// accumulator.

#include "attn_sm90.cuh"

namespace {

using namespace sm90;

constexpr int NSTAGE = 3;       // K/V ring
constexpr int NRANGE = 6;       // ints per q tile from the tile-range kernel
// 2 consumer warpgroups + a producer warpgroup, of which one warp works
// (setmaxnreg acts on whole warpgroups: the idle warps give their
// registers to the consumers and exit)
constexpr int NT = 384;
constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;

// The shared-memory layout at head dim HD (64 or 128): a row of Q, K or V
// is NH = HD / 64 swizzled 128-byte halves
template <int HD>
struct FlashCfg {
  static_assert(HD == 64 || HD == 128, "head dim 64 or 128");
  static constexpr int NH = HD / 64;
  static constexpr int QTILE = NH * QHALF;            // a [128][HD] Q tile
  static constexpr int KTILE = NH * HALF;             // a [64][HD] K / V tile
  static constexpr int OFF_KV = 2 * QTILE;            // after 2 Q tiles
  static constexpr int OFF_META = OFF_KV + NSTAGE * 2 * KTILE;  // K, V
  static constexpr int META_BYTES =
      NSTAGE * BN * 4 * 2 + NSTAGE * 16 + (2 * NSTAGE + 4) * 8;
  static constexpr size_t SMEM = OFF_META + META_BYTES + 1024;  // + align
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One work item: a (128-query tile, q head) pair. Items are numbered
// heaviest tile first (order[]), all heads of a tile together.
struct Item {
  int h, hk, i0, dlo, dhi, ahi, blo, wlo, whi;
  bool dense;
  __device__ __forceinline__ Item(int item, int Hq, int Hkv,
                                  const int* __restrict__ flags,
                                  const int* __restrict__ ranges,
                                  const int* __restrict__ order) {
    h = item % Hq;
    const int qt = order[item / Hq];
    i0 = qt * BM;
    hk = h / (Hq / Hkv);
    dense = flags == nullptr || flags[hk] != 0;
    // live kv tiles: [dlo, dhi) for a dense head; a streaming head walks
    // [dlo, ahi) (its sinks), then [blo, dhi) (its local band); a dense
    // head sees the tiles [wlo, whi) whole
    const int* r = ranges + NRANGE * qt;
    dlo = r[0];
    dhi = r[1];
    ahi = dense ? dhi : min(r[2], dhi);
    blo = dense ? dhi : max(r[3], max(ahi, dlo));
    wlo = dense ? r[4] : 0;
    whi = dense ? r[5] : 0;
  }
};

// Persistent: block b takes items b, b + gridDim.x, ... (one block per
// SM), so one item's Q load and first K/V tiles overlap the previous
// item's tail: the ring of K/V stages runs across items, and Q is double
// buffered. HD: the head dim, 64 or 128.
template <int HD>
__global__ void __launch_bounds__(NT, 1) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
    const int* __restrict__ pos, const int* __restrict__ flags,
    const int* __restrict__ ranges, const int* __restrict__ order,
    __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int sink_size,
    int local_size, float scale_log2) {
  using C = FlashCfg<HD>;
  constexpr int NH = C::NH, QTILE = C::QTILE, KTILE = C::KTILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;            // 2 buffers of [NH][128][64] bf16
  unsigned char* kvs = base + C::OFF_KV;  // stage: K tile, V tile
  int* kseg = reinterpret_cast<int*>(base + C::OFF_META);  // [NSTAGE][BN]
  int* kpos = kseg + NSTAGE * BN;                        // [NSTAGE][BN]
  int* hdr = kpos + NSTAGE * BN;  // [NSTAGE][4]: j0 (-1 = item end), mask
  uint64_t* full = reinterpret_cast<uint64_t*>(hdr + NSTAGE * 4);
  uint64_t* empty = full + NSTAGE;
  uint64_t* qfull = empty + NSTAGE;    // [2]
  uint64_t* qempty = qfull + 2;        // [2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_items = ((T + BM - 1) / BM) * Hq;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(&full[st], 32);     // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[st], 8);     // one arrive per consumer warp
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);      // the Q tile's TMA
      mbar_init(&qempty[b], 8);     // every consumer warp done with it
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warp: per item its Q tile, then its K/V tiles ----
    reg_dealloc<REGS_PRODUCER>();
    if (warp != 8) return;
    Ring ring;
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const Item w(item, Hq, Hkv, flags, ranges, order);
      const int qb = it & 1;
      mbar_wait(&qempty[qb], ((it >> 1) & 1) ^ 1u);
      unsigned char* qd = qs + qb * QTILE;
      if (lane == 0) {
        mbar_arrive_tx(&qfull[qb], QTILE);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          tma_load_2d(qd + hh * QHALF, &qmap, &qfull[qb], w.h * HD + 64 * hh,
                      w.i0);
      }
      // the valid rows' segment and position ranges, for the whole-tile
      // test of a tile not known whole: read once the first such tile
      // comes, after the known ones' copies are under way
      int smin = 0x7fffffff, smax = -1, pmin = 0x7fffffff, pmax = -1;
      bool uniform = false, summed = false;
      auto summarize = [&]() {
        for (int r = lane; r < BM; r += 32) {
          const int i = w.i0 + r;
          const int sg = i < T ? seg[i] : -1;
          if (sg >= 0) {
            const int p = pos[i];
            smin = min(smin, sg);
            smax = max(smax, sg);
            pmin = min(pmin, p);
            pmax = max(pmax, p);
          }
        }
        smin = warp_min(smin);
        smax = warp_max(smax);
        pmin = warp_min(pmin);
        pmax = warp_max(pmax);
        uniform = smax >= 0 && smin == smax;
        summed = true;
      };
      auto push = [&](int jt) {
        const int st = ring.stage;
        mbar_wait(&empty[st], ring.phase ^ 1u);
        const int j0 = jt * BN;
        // keys every valid row sees: no segments or positions needed
        const bool known = jt >= w.wlo && jt < w.whi;
        if (!known && !summed) summarize();
        bool whole = uniform, same = uniform;
#pragma unroll
        for (int e = 0; e < 2 && !known; ++e) {
          const int c = lane + 32 * e, j = j0 + c;
          const int sg = j < T ? seg[j] : -1;
          const int p = j < T ? pos[j] : 0;
          kseg[st * BN + c] = sg;
          kpos[st * BN + c] = p;
          // the key is in the valid rows' one segment; every valid row of
          // the tile sees it
          same = same && sg == smin;
          whole = whole && sg == smin && p <= pmin &&
                  (w.dense || p < sink_size || pmax - p < local_size);
        }
        whole = known || __all_sync(0xffffffffu, whole);
        same = w.dense && __all_sync(0xffffffffu, same);
        if (lane == 0) {
          hdr[4 * st] = j0;
          // the tile's mask: 1 none, 2 causal (keys of the rows' one
          // segment, dense head), 0 the whole rule
          hdr[4 * st + 1] = whole ? 1 : same ? 2 : 0;
          mbar_arrive_tx(&full[st], 2 * KTILE);
          unsigned char* kd = kvs + st * 2 * KTILE;
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            tma_load_2d(kd + hh * HALF, &kmap, &full[st],
                        w.hk * HD + 64 * hh, j0);
            tma_load_2d(kd + KTILE + hh * HALF, &vmap, &full[st],
                        w.hk * HD + 64 * hh, j0);
          }
        } else {
          mbar_arrive(&full[st]);
        }
        ring.advance<NSTAGE>();
      };
      for (int jt = w.dlo; jt < w.ahi; ++jt) push(jt);
      for (int jt = w.blo; jt < w.dhi; ++jt) push(jt);
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);   // the item's end
      if (lane == 0) hdr[4 * ring.stage] = -1;
      mbar_arrive(&full[ring.stage]);
      ring.advance<NSTAGE>();
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    reg_alloc<REGS_CONSUMER>();
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int r0 = 64 * wg + 16 * wl + g;    // this thread's rows r0, r0 + 8
    Ring ring;
    int it = 0;
    // an item's decode and its rows' segments and positions are read one
    // item ahead, so their loads land under the previous item's work
    auto rows_of = [&](const Item& x, int (&sg)[2], int (&ps)[2]) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = x.i0 + r0 + 8 * hi;
        sg[hi] = i < T ? seg[i] : -1;
        ps[hi] = i < T ? pos[i] : 0;
      }
    };
    Item w(min((int)blockIdx.x, n_items - 1), Hq, Hkv, flags, ranges, order);
    int qseg[2], qpos[2];
    rows_of(w, qseg, qpos);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int item_n = min(item + (int)gridDim.x, n_items - 1);
      const Item wn(item_n, Hq, Hkv, flags, ranges, order);
      int seg_n[2], pos_n[2];
      rows_of(wn, seg_n, pos_n);
      float o0[32], o1[32], s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o0[i] = o1[i] = 0.0f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
      const int qb = it & 1;
      const uint32_t q0 = smem_u32(qs + qb * QTILE) + wg * 64 * 128;
      const uint32_t q1 = q0 + QHALF;
      mbar_wait(&qfull[qb], (it >> 1) & 1);
      while (true) {
        const int st = ring.stage;
        mbar_wait(&full[st], ring.phase);
        if (hdr[4 * st] < 0) {           // the item's end: release the
          __syncwarp();                  // marker stage and the Q tile
          if (lane == 0) {
            mbar_arrive(&empty[st]);
            mbar_arrive(&qempty[qb]);
          }
          ring.advance<NSTAGE>();
          break;
        }
        const int mask = hdr[4 * st + 1];
        const uint32_t kb = smem_u32(kvs + st * 2 * KTILE);
        qk_tile<false, NH>(s, q0, q1, kb, kb + HALF);
        if (mask == 1) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
        } else if (mask == 2) {          // padding rows are zeroed at the end
          const int* kp = kpos + st * BN;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int2 p2 =
                *reinterpret_cast<const int2*>(kp + nb * 8 + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int p = (e & 1) ? p2.y : p2.x;
              s[4 * nb + e] = p <= qpos[e >> 1] ? s[4 * nb + e] * scale_log2
                                                : -INFINITY;
            }
          }
        } else {
          const int* ks = kseg + st * BN;
          const int* kp = kpos + st * BN;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int2 sg2 =
                *reinterpret_cast<const int2*>(ks + nb * 8 + 2 * t4);
            const int2 p2 =
                *reinterpret_cast<const int2*>(kp + nb * 8 + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hi = e >> 1;
              const int sg = (e & 1) ? sg2.y : sg2.x;
              const int p = (e & 1) ? p2.y : p2.x;
              const bool ok = qseg[hi] >= 0 && sg == qseg[hi] &&
                              p <= qpos[hi] &&
                              (w.dense || p < sink_size ||
                               qpos[hi] - p < local_size);
              s[4 * nb + e] = ok ? s[4 * nb + e] * scale_log2 : -INFINITY;
            }
          }
        }
        softmax_tile<NH>(s, m, l, o0, o1);
        pv_tile<false, NH>(o0, o1, s, kb + KTILE, kb + KTILE + HALF);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        ring.advance<NSTAGE>();
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = w.i0 + r0 + 8 * hi;
        store_row<NH>(out + ((size_t)min(i, T - 1) * Hq + w.h) * HD, o0, o1,
                      hi, l[hi], qseg[hi] < 0, i < T, lane);
      }
      w = wn;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        qseg[hi] = seg_n[hi];
        qpos[hi] = pos_n[hi];
      }
    }
  }
}

constexpr int RT = 1024;        // threads of the tile-range kernel

// first index in [lo, hi) whose value is >= v (a[lo, hi) ascending), or hi
__device__ int lower_bound(const int* __restrict__ a, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Each 128-query tile's live 64-key tiles, and the q tiles heaviest first
// (see launch_flash_tile_ranges). One block.
__global__ void __launch_bounds__(RT) flash_tile_ranges_kernel(
    const int* __restrict__ seg, const int* __restrict__ pos, int T,
    int sink_size, int local_size, int band, int* __restrict__ ranges,
    int* __restrict__ order) {
  __shared__ int s_bad, s_nvalid;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_bad = 0;
    s_nvalid = T;
  }
  __syncthreads();
  // the usual packed batch: valid segment ids rise run by run, positions
  // rise within a run, padding only after the last valid token
  for (int j = tid; j < T; j += RT) {
    const int sj = seg[j];
    if (j == 0) {
      if (sj < 0) atomicMin(&s_nvalid, 0);
      continue;
    }
    const int sp = seg[j - 1];
    if ((sp < 0 && sj >= 0) ||
        (sp >= 0 && sj >= 0 &&
         (sj < sp || (sj == sp && pos[j] <= pos[j - 1]))))
      s_bad = 1;
    if (sp >= 0 && sj < 0) atomicMin(&s_nvalid, j);
  }
  __syncthreads();
  const bool bad = s_bad != 0;
  const int nv = s_nvalid;
  const int n_qt = (T + BM - 1) / BM, n_kt = (T + BN - 1) / BN;
  for (int qt = tid; qt < n_qt; qt += RT) {
    int dlo = 0, dhi = 0, ahi = 0, blo = 0, wlo = 0, whi = 0;
    if (bad) {           // any other input: every key tile, for every head
      dhi = ahi = blo = n_kt;
    } else {
      const int i0 = qt * BM, i1 = min(i0 + BM, nv);   // valid queries
      if (i0 < i1) {
        const int f = lower_bound(seg, 0, nv, seg[i0]);  // i0's segment start
        dlo = f / BN;
        dhi = (i1 + BN - 1) / BN;                        // causal: keys < i1
        ahi = blo = dhi;
        if (seg[i1 - 1] == seg[i0]) {
          // one segment: the key tiles at or past its start and wholly at
          // or before the first query are seen whole by every query
          wlo = (f + BN - 1) / BN;
          whi = max(wlo, (i0 + 1) / BN);
        }
        if (band) {
          // sinks: up to the last segment's first key at or past the sink
          const int fl = lower_bound(seg, f, nv, seg[i1 - 1]);
          const int se = lower_bound(pos, fl, i1, sink_size);
          ahi = se > f ? min((se + BN - 1) / BN, dhi) : dlo;
          // band: from the first query's oldest key in its band
          const int bs = lower_bound(pos, f, i0 + 1, pos[i0] - local_size + 1);
          blo = bs < i1 ? max(bs / BN, dlo) : dhi;
        }
      }
    }
    int* r = ranges + NRANGE * qt;
    r[0] = dlo;
    r[1] = dhi;
    r[2] = ahi;
    r[3] = blo;
    r[4] = wlo;
    r[5] = whi;
  }
  __syncthreads();
  // heaviest first: rank by (dense range length descending, tile index)
  for (int qt = tid; qt < n_qt; qt += RT) {
    const int w = ranges[NRANGE * qt + 1] - ranges[NRANGE * qt];
    int rank = 0;
    for (int o = 0; o < n_qt; ++o) {
      const int wo = ranges[NRANGE * o + 1] - ranges[NRANGE * o];
      rank += wo > w || (wo == w && o < qt);
    }
    order[rank] = qt;
  }
}

// A 2-D map over a row-major bf16 [rows, cols] matrix (rows `row_bytes`
// apart), boxes of box_rows x 64 columns (128 bytes) in the 128-byte
// swizzle; rows past the end read as 0.
int encode_rows(CUtensorMap* map, const void* base, uint64_t cols,
                uint64_t rows, uint64_t row_bytes, uint32_t box_rows) {
  return encode_swizzled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, cols,
                         rows, row_bytes, 64, box_rows);
}

}  // namespace

extern "C" {

// Writes ranges [n_qt, 6] int32 (n_qt = ceil(T / 128)): the live 64-key
// tiles of each 128-query tile, [0, 1) for a dense head; a streaming head
// (band != 0) walks [0, 2), then [max(3, 2), 1); a dense head sees the
// tiles [4, 5) whole (every valid query, every key). For the usual packed
// batch (valid segment ids rising run by run, positions rising within a
// run, padding only at the end) they are exact, by binary search; for any
// other input every tile is live. order [n_qt] int32: the q tiles by
// descending dense range length, ties in tile order. Returns
// cudaGetLastError() after the launch.
int launch_flash_tile_ranges(const void* segment_ids, const void* positions,
                             int T, int sink_size, int local_size, int band,
                             void* ranges, void* order, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  flash_tile_ranges_kernel<<<1, RT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(segment_ids), static_cast<const int*>(positions),
      T, sink_size, local_size, band, static_cast<int*>(ranges),
      static_cast<int*>(order));
  return (int)cudaGetLastError();
}

// Returns 0 when launched, else a cudaError_t value (a refused tensor map
// or launch included). flags: [Hkv] int32 (1 dense, 0 streaming) or null
// for all dense; ranges [ceil(T / 128), 6] and order [ceil(T / 128)]
// int32: scratch the tile-range kernel fills first (its band flag: flags
// not null). q, k, v 16-byte aligned. head_dim: 64 or 128.
int launch_flash_prefill(const void* q, const void* k, const void* v,
                         const void* segment_ids, const void* positions,
                         const void* flags, void* ranges, void* order,
                         void* out, int T, int Hq, int Hkv, int sink_size,
                         int local_size, float sm_scale, int head_dim,
                         void* stream) {
  if (T <= 0 || Hkv <= 0 || Hq % Hkv ||
      (head_dim != 64 && head_dim != 128) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t q_cols = (uint64_t)Hq * head_dim;
  const uint64_t kv_cols = (uint64_t)Hkv * head_dim;
  int err = encode_rows(&qmap, q, q_cols, T, q_cols * 2, BM);
  if (err == 0) err = encode_rows(&kmap, k, kv_cols, T, kv_cols * 2, BN);
  if (err == 0) err = encode_rows(&vmap, v, kv_cols, T, kv_cols * 2, BN);
  if (err != 0) return err;
  int dev = 0, n_sm = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return (int)cerr;
  // each instantiation's shared-memory size is set, and its register
  // budget checked, once per device
  const int which = head_dim == 64 ? 0 : 1;
  auto kernel = head_dim == 64 ? flash_prefill_kernel<64>
                               : flash_prefill_kernel<128>;
  const size_t smem =
      head_dim == 64 ? FlashCfg<64>::SMEM : FlashCfg<128>::SMEM;
  static bool ready[2][MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES || !ready[which][dev]) {
    cerr = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (cerr != cudaSuccess) return (int)cerr;
    cudaFuncAttributes attr;
    cerr = cudaFuncGetAttributes(&attr, kernel);
    if (cerr != cudaSuccess) return (int)cerr;
    if (!reg_budget_ok(attr.numRegs, 256, REGS_CONSUMER, 128, REGS_PRODUCER))
      return (int)cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) ready[which][dev] = true;
  }
  err = launch_flash_tile_ranges(segment_ids, positions, T, sink_size,
                                 local_size, flags != nullptr, ranges, order,
                                 stream);
  if (err != 0) return err;
  const int n_items = ((T + BM - 1) / BM) * Hq;
  const int grid = n_items < n_sm ? n_items : n_sm;   // one block per SM
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<const int*>(segment_ids),
      static_cast<const int*>(positions), static_cast<const int*>(flags),
      static_cast<const int*>(ranges), static_cast<const int*>(order),
      static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, sink_size, local_size,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // extern "C"
