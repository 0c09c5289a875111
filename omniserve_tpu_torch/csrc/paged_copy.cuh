// The copy warp of the two chunked-prefill kernels over the paged pool,
// paged_prefill.cu (row 7) and prefill_single_pass.cu (row 8), for Hopper
// (sm_90a).
//
// It walks the 64-key tiles of one (128 query rows, kv head, sequence)
// block's table IN PLACE: over a dense table up to the causal frontier
// min(context_len, max q_pos + 1); over a page list every slot, skipping,
// before a byte of it is requested, each tile that no row can see (a
// ballot over 32 slots at a time finds the next live slot: a streaming
// head of a 32K chunk reads its sink and ~8K band of the ring). It brings
// each live tile's rows (and, fine-grained, its four plane rows) into a
// ring of NR raw stages with cp.async.bulk on an mbarrier: one copy of the
// tile's 64 rows when they are consecutive rows of one page (a kv4 64-key
// sub-tile lies in one half of its page, so it takes its own rows slot %
// (page/2) and its own nibble), else one copy per key row. Per stage it
// leaves each key's position (NO_POS: no row may see it), its nibble
// shift, and a header: the tile's first key (-1: the walk ended) and
// whether every row of the block sees every key of it.
//
// Positions: row r of table slot s holds position kp = logic * page + r,
// logic = s (dense table) or sel_logic[b, s] (a page list, -1 dead). With
// ring_span > 0 the newest page's rows past the write head (logic == (ctx
// - 1) / page, r > (ctx - 1) % page) hold tokens one ring wrap older: kp
// -= ring_span * page, alive only at kp >= ring_sink_tok. A key is live
// iff kp < ctx and some row of the block may see it (causal, and for a
// streaming head the sink + local band).
//
// Query rows: row rq of a block is GQA rep rq % n_rep of chunk token t0 +
// rq / n_rep, and a block holds BM / n_rep whole tokens (any n_rep from 1
// to 8: at n_rep 7, 18 tokens in rows 0-125); the rows past them are dead
// (row_token).

#pragma once

#include "attn_sm90.cuh"

namespace sm90 {

// The chunk token of query row rq of the block whose first token is t0, or
// NO_POS for a dead row past the block's BM / n_rep whole tokens: every `t
// < Tc` test refuses it, so it loads no q row, has no position and stores
// nothing.
__device__ __forceinline__ int row_token(int t0, int rq, int n_rep) {
  return rq < BM / n_rep * n_rep ? t0 + rq / n_rep : NO_POS;
}

// The walk of one block.
struct PagedWalk {
  const uint8_t* k_data;      // the layer's pool rows
  const uint8_t* v_data;
  const float* planes;        // [P, 4, H, page] f32 (fine-grained)
  const int* block_tables;    // [B, W]
  const int* q_positions;     // [B, Tc], -1 = padding
  const int* context_lens;    // [B]
  const int* sel_logic;       // [B, W] or null (dense table)
  int b, h, H, Tc, t0, n_rep, page, W;
  int sink_size, local_size, ring_span, ring_sink_tok;
  bool dense;                 // not a streaming head
};

// The raw ring it fills: stage st holds the tile's K rows, then its V rows
// (BN rows of ROWB bytes each) at raws + st * 2 * BN * ROWB, planes [4][BN]
// at pl + st * 4 * BN, per-key positions and nibble shifts at kp / sh + st
// * BN, the header at hdr + 4 * st.
struct RawRing {
  unsigned char* raws;
  float* pl;
  int* kp;
  int* sh;
  int* hdr;
  uint64_t* full;    // count 32 (the copy warp's lanes) + bytes
  uint64_t* empty;   // the ring's consumers release a stage
};

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The bytes of one pool row (a token's K or V codes of one head) at head
// dim HD: HD under kv4 / kv8 (one byte a value), 2 HD under kv16.
__host__ __device__ constexpr int pool_row_bytes(int kv_bits, int hd) {
  return kv_bits == 16 ? 2 * hd : hd;
}

// Run by the 32 lanes of one warp. SPARSE: a page list and/or per-head
// flags; KV_BITS 4 (half-split nibble rows), 8 (byte rows) or 16 (bf16
// rows); FINE: copy the plane rows; HD: the head dim (64 or 128).
template <bool SPARSE, int KV_BITS, bool FINE, int NR, int HD = 128>
__device__ __forceinline__ void paged_copy_warp(const PagedWalk& w,
                                                const RawRing& rr, int lane) {
  constexpr bool KV4 = KV_BITS == 4;
  constexpr int ROWB = pool_row_bytes(KV_BITS, HD);   // bytes of a pool row
  constexpr int RAW = 2 * BN * ROWB;
  const int b = w.b, h = w.h, H = w.H, page = w.page, W = w.W;
  const int ctx = w.context_lens[b];
  const bool listed = SPARSE && w.sel_logic != nullptr;
  const int half = page / 2, rows = KV4 ? half : page;
  // the ring's write head: rows of page cb past it are one wrap older
  const int cb = (ctx - 1) / page, last_row = (ctx - 1) % page;
  int qlo = NO_POS, qhi = -1;
  for (int r = lane; r < BM; r += 32) {
    const int t = row_token(w.t0, r, w.n_rep);
    const int qp = t < w.Tc ? w.q_positions[(size_t)b * w.Tc + t] : -1;
    if (qp >= 0) {
      qlo = min(qlo, qp);
      qhi = max(qhi, qp);
    }
  }
  qlo = warp_min_i(qlo);
  qhi = warp_max_i(qhi);
  // over a dense table, keys at or past the frontier are visible to no
  // row of this tile; a page list is walked whole
  const int kv_end =
      qhi < 0 ? 0 : (listed ? W * page : min(min(ctx, qhi + 1), W * page));
  Ring ring;
  int win = -1;            // the 32-slot window of win_live
  uint32_t win_live = 0;   // slots of the window that may hold a live key
  for (int j0 = 0; j0 < kv_end;) {
    if constexpr (SPARSE) {
      const int sa = j0 / page, sb = min((j0 + BN - 1) / page, W - 1);
      if ((sa >> 5) != win) {
        win = sa >> 5;
        const int s = (win << 5) + lane;
        bool live = false;
        if (s < W) {
          const int logic = listed ? w.sel_logic[(size_t)b * W + s] : s;
          if (logic >= 0) {
            int plo = logic * page;
            const int phi = min(plo + page - 1, ctx - 1);
            if (w.ring_span > 0 && logic == cb) plo -= w.ring_span * page;
            live = plo <= phi && plo <= qhi &&
                   (w.dense || plo < w.sink_size ||
                    phi + w.local_size > qlo);
          }
        }
        win_live = __ballot_sync(0xffffffffu, live);
      }
      if ((sb >> 5) == win) {
        const int n = sb - sa + 1;
        const uint32_t span = (n >= 32 ? 0xffffffffu : ((1u << n) - 1u))
                              << (sa & 31);
        if ((win_live & span) == 0) {
          // on to the window's next live slot, or the next window
          const int hi_bit = (sb & 31) + 1;
          const uint32_t later =
              hi_bit >= 32 ? 0u : (win_live >> hi_bit) << hi_bit;
          const int next = later ? (win << 5) + __ffs(later) - 1
                                 : (win + 1) << 5;
          j0 = max(j0 + BN, (int)((long long)next * page / BN * BN));
          continue;
        }
      }
    }
    // each lane's two keys: position (NO_POS = no row needs it), where
    // it lives
    int kp[2], phys[2], row[2], shift[2], slot[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + lane + 32 * e;
      kp[e] = NO_POS;
      phys[e] = -1;
      row[e] = shift[e] = slot[e] = 0;
      if (j < kv_end) {
        const int s = j / page, r = j - s * page;
        if constexpr (SPARSE) {
          const int logic = listed ? w.sel_logic[(size_t)b * W + s] : s;
          int p = logic * page + r, lo = 0;
          if (w.ring_span > 0 && logic == cb && r > last_row) {
            p -= w.ring_span * page;
            lo = w.ring_sink_tok;
          }
          if (logic >= 0 && p < ctx && p >= lo && p <= qhi &&
              (w.dense || p < w.sink_size || p + w.local_size > qlo))
            kp[e] = p;
        } else {
          kp[e] = j;
        }
        if (kp[e] != NO_POS) {
          phys[e] = w.block_tables[(size_t)b * W + s];
          row[e] = KV4 ? r % half : r;
          shift[e] = (KV4 && r >= half) ? 4 : 0;
          slot[e] = r;
        }
      }
    }
    const uint32_t need0 = __ballot_sync(0xffffffffu, kp[0] != NO_POS);
    const uint32_t need1 = __ballot_sync(0xffffffffu, kp[1] != NO_POS);
    if ((need0 | need1) == 0) {     // skipped before a byte is requested
      j0 += BN;
      continue;
    }
    // the tile's 64 rows are consecutive rows of one page: one copy each
    const int sa = j0 / page, r0 = j0 - sa * page;
    const bool contig = sa == (j0 + BN - 1) / page && (page & 3) == 0 &&
                        (!KV4 || (r0 < half) == (r0 + BN - 1 < half));
    const int src = __ffs(need0 ? need0 : need1) - 1;
    const int phys_c =
        __shfl_sync(0xffffffffu, need0 ? phys[0] : phys[1], src);
    const uint32_t bytes =
        contig ? 2 * BN * ROWB + (FINE ? 4 * BN * 4 : 0)
               : (__popc(need0) + __popc(need1)) * 2 * ROWB;
    // every row of the block sees every key of the tile
    bool whole = true;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      whole = whole && kp[e] != NO_POS && kp[e] <= qlo &&
              (w.dense || kp[e] < w.sink_size || qhi - kp[e] < w.local_size);
    whole = __all_sync(0xffffffffu, whole);

    const int st = ring.stage;
    mbar_wait(&rr.empty[st], ring.phase ^ 1u);
    unsigned char* rk = rr.raws + st * RAW;
    unsigned char* rv = rk + BN * ROWB;
    float* pl = rr.pl + st * 4 * BN;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = lane + 32 * e;
      rr.kp[st * BN + c] = kp[e];
      rr.sh[st * BN + c] = shift[e];
      if (FINE && !contig && kp[e] != NO_POS) {
        const float* src_pl = w.planes + (size_t)phys[e] * 4 * H * page +
                              (size_t)h * page + slot[e];
#pragma unroll
        for (int pi = 0; pi < 4; ++pi)
          pl[pi * BN + c] = src_pl[(size_t)pi * H * page];
      }
    }
    if (lane == 0) {
      rr.hdr[4 * st] = j0;
      rr.hdr[4 * st + 1] = whole;
      mbar_arrive_tx(&rr.full[st], bytes);
    }
    __syncwarp();
    if (contig) {
      if (lane == 0) {
        const size_t prow =
            ((size_t)phys_c * H + h) * rows + (KV4 ? r0 % half : r0);
        bulk_load(rk, w.k_data + prow * ROWB, BN * ROWB, &rr.full[st]);
        bulk_load(rv, w.v_data + prow * ROWB, BN * ROWB, &rr.full[st]);
        if constexpr (FINE) {
#pragma unroll
          for (int pi = 0; pi < 4; ++pi)
            bulk_load(pl + pi * BN,
                      w.planes + ((size_t)phys_c * 4 + pi) * H * page +
                          (size_t)h * page + r0,
                      BN * 4, &rr.full[st]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kp[e] == NO_POS) continue;
        const int c = lane + 32 * e;
        const size_t prow = ((size_t)phys[e] * H + h) * rows + row[e];
        bulk_load(rk + c * ROWB, w.k_data + prow * ROWB, ROWB, &rr.full[st]);
        bulk_load(rv + c * ROWB, w.v_data + prow * ROWB, ROWB, &rr.full[st]);
      }
    }
    if (lane != 0) mbar_arrive(&rr.full[st]);
    ring.advance<NR>();
    j0 += BN;
  }
  mbar_wait(&rr.empty[ring.stage], ring.phase ^ 1u);   // the end marker
  if (lane == 0) rr.hdr[4 * ring.stage] = -1;
  mbar_arrive(&rr.full[ring.stage]);
}

}  // namespace sm90
