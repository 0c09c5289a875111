"""Plain PyTorch attention: the semantic contracts the kernels are held to.

Counterparts of ``omniserve_tpu.ops.attention_ref``:

- ``prefill_attention`` (:54): packed-varlen causal attention, dense heads
  and streaming heads (sink + local band); the plain version of the flash
  prefill kernel.
- ``paged_decode_attention`` (:151): single-query GQA attention over the
  paged pools (kv4 / kv8, fine-grained or per-tensor, and kv16): dense page
  lists, per-head page selections, and the streaming ring pool's
  sink+local band; the plain version of the decode kernels
  (``ops/cuda/decode_attention.py``).
- ``page_selector_scores`` (:281), ``select_topk_pages`` (:335): the
  query-aware page selector of dynamic-sparse decode.
- ``paged_prefill_attention`` (:391): a chunk's causal GQA attention over
  the paged pool (history + chunk), with per-head sink + local
  bands and an explicit per-row position map (the streaming ring); the plain
  version of the paged prefill kernel (``ops/cuda/paged_prefill.py``).

All compute in f32. LSE outputs (sequence parallelism) are queued in
ROADMAP.md and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch

from omniserve_tpu_torch.ops.paged_kv import KVPool, gather_kv_for_seq


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[T, Hkv, D] -> [T, Hkv*n_rep, D] (GQA group expansion)."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=1)


def prefill_attention(
    q: torch.Tensor,            # [T, Hq, D]
    k: torch.Tensor,            # [T, Hkv, D] (post-RoPE)
    v: torch.Tensor,            # [T, Hkv, D]
    segment_ids: torch.Tensor,  # [T] int, seq id per packed token (-1 pad)
    positions: torch.Tensor,    # [T] int, position within its sequence
    sm_scale: float,
    head_is_retrieval: Optional[torch.Tensor] = None,  # [Hq] bool
    sink_size: int = 0,
    local_size: int = 0,
    valid: Optional[torch.Tensor] = None,  # [T] bool, False = padding
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal self-attention over packed sequences.

    Query i attends key j iff both are valid, in the same segment, and
    ``pos_i >= pos_j``; rows with no valid key give zeros. Streaming heads
    (``head_is_retrieval == False``, when a band is given) also need
    ``pos_j < sink_size or pos_i - pos_j < local_size``. Queries are
    processed ``q_chunk`` rows at a time so the [Hq, rows, T] score block
    stays bounded on long packed prompts."""
    band = head_is_retrieval is not None and bool(sink_size or local_size)
    t, hq, _ = q.shape
    n_rep = hq // k.shape[1]
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    if valid is None:
        valid = segment_ids >= 0
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i0 in range(0, t, q_chunk):
        i1 = min(t, i0 + q_chunk)
        qf = q[i0:i1].float()
        scores = torch.einsum("thd,shd->hts", qf, kf) * sm_scale
        mask = (
            (segment_ids[i0:i1, None] == segment_ids[None, :])
            & (positions[i0:i1, None] >= positions[None, :])
            & valid[None, :] & valid[i0:i1, None]
        )[None]                                        # [1, rows, T]
        if band:
            in_band = (positions[None, :] < sink_size) | (
                positions[i0:i1, None] - positions[None, :] < local_size)
            mask = torch.where(head_is_retrieval[:, None, None], mask,
                               mask & in_band[None])   # [Hq, rows, T]
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
        out[i0:i1] = torch.einsum("hts,shd->thd", probs, vf).to(q.dtype)
    return out


def _sdpa(q, k, v, valid, sm_scale: float, n_rep: int) -> torch.Tensor:
    """q [B, Hq, D]; k, v [B, S, Hkv, D] f32; valid [B, Hkv, S] bool.
    Rows with no valid key give zeros. Returns [B, Hq, D] f32."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, hkv, n_rep, d)
    scores = torch.einsum("bhrd,bshd->bhrs", qf, k) * sm_scale
    mask = valid[:, :, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    any_valid = mask.any(dim=-1, keepdim=True)
    m = torch.where(any_valid, scores.amax(dim=-1, keepdim=True), 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = torch.where(any_valid, p / torch.clamp(l, min=1e-30), 0.0)
    out = torch.einsum("bhrs,bshd->bhrd", probs, v)
    return out.reshape(b, hq, d)


def paged_decode_attention(
    q: torch.Tensor,             # [B, Hq, D] (post-RoPE)
    pool: KVPool,                # retrieval pool
    layer: int,
    block_tables: torch.Tensor,  # [B, max_blocks] int
    context_lens: torch.Tensor,  # [B] int, tokens cached incl. current
    sm_scale: float,
    page_size: int,
    kv_bits: int,
    kv_zeros: bool,
    streaming_pool: Optional[KVPool] = None,
    streaming_block_tables: Optional[torch.Tensor] = None,  # [B, s+l blocks]
    head_is_retrieval: Optional[torch.Tensor] = None,  # [Hkv] bool
    head_rank: Optional[torch.Tensor] = None,          # [Hkv] rank in pool
    sink_blocks: int = 0,
    local_blocks: int = 0,
    page_idxes: Optional[torch.Tensor] = None,  # [B, Hkv, n_sel], -1 pad
    dec_sink_tokens: Optional[int] = None,
    dec_local_tokens: Optional[int] = None,
    return_lse: bool = False,
) -> torch.Tensor:
    """Single-query GQA attention with dual pools and dynamic sparsity.

    Head routing: kv head h uses the retrieval pool at row ``head_rank[h]``
    if ``head_is_retrieval[h]`` else the streaming ring pool at row
    ``head_rank[h]``. ``page_idxes`` (if given) restricts each retrieval
    head to the selected logical pages; the selector includes the newest
    page. Streaming heads attend the decode band only: positions below
    ``dec_sink_tokens`` or within the last ``dec_local_tokens`` (defaults:
    the whole ring), each ring slot holding the newest token mapped to it.
    """
    if return_lse:
        raise NotImplementedError(
            "LSE outputs are the sequence-parallel path; see ROADMAP.md "
            "queue 1 item 10"
        )
    b, hq, d = q.shape
    dev = q.device
    if head_is_retrieval is None:
        hkv = pool.num_heads
        head_is_retrieval = torch.ones(hkv, dtype=torch.bool, device=dev)
        head_rank = torch.arange(hkv, device=dev)
    else:
        hkv = head_is_retrieval.shape[0]
    n_rep = hq // hkv
    lens = context_lens.long()

    # -- retrieval pool (all kv heads; streaming heads overwritten below) --
    k_all, v_all = gather_kv_for_seq(pool, layer, block_tables, page_size,
                                     kv_bits, kv_zeros)
    tok = torch.arange(k_all.shape[1], device=dev)
    valid_r = (tok[None, :] < lens[:, None])[:, None, :].expand(b, hkv, -1)
    if page_idxes is not None:
        sel = torch.where(page_idxes < 0, -2, page_idxes).long()
        selected = ((tok // page_size)[None, None, :, None]
                    == sel[:, :, None, :]).any(-1)
        valid_r = valid_r & selected
    ranks_r = torch.clamp(head_rank.long(), 0, pool.num_heads - 1)
    out_r = _sdpa(q, k_all[:, :, ranks_r], v_all[:, :, ranks_r], valid_r,
                  sm_scale, n_rep)
    if streaming_pool is None:
        return out_r.to(q.dtype)

    # -- streaming ring pool --
    sk_all, sv_all = gather_kv_for_seq(streaming_pool, layer,
                                       streaming_block_tables, page_size,
                                       kv_bits, kv_zeros)
    n_ring_blocks = max(1, streaming_block_tables.shape[1] - sink_blocks)
    sink_tok = sink_blocks * page_size
    local_tok = n_ring_blocks * page_size          # ring capacity (tokens)
    band_sink = sink_tok if dec_sink_tokens is None else dec_sink_tokens
    band_local = local_tok if dec_local_tokens is None else dec_local_tokens
    stok = torch.arange((sink_blocks + n_ring_blocks) * page_size,
                        device=dev)
    r = stok - sink_tok
    ln = lens[:, None]
    # newest token each ring slot holds: the largest t < L with
    # (t - sink_tok) mod local_tok == r
    n_written = ln - sink_tok
    latest = torch.where(
        n_written > r,
        sink_tok + r + torch.div(n_written - 1 - r, local_tok,
                                 rounding_mode="floor") * local_tok,
        -1,
    )
    slot_token = torch.where((stok < sink_tok)[None, :], stok[None, :],
                             latest)
    s_valid = (slot_token >= 0) & (slot_token < ln) & (
        (slot_token < band_sink) | (slot_token >= ln - band_local)
    )
    valid_s = s_valid[:, None, :].expand(b, hkv, -1)
    ranks_s = torch.clamp(head_rank.long(), 0, streaming_pool.num_heads - 1)
    out_s = _sdpa(q, sk_all[:, :, ranks_s], sv_all[:, :, ranks_s], valid_s,
                  sm_scale, n_rep)
    retr_q = head_is_retrieval.repeat_interleave(n_rep)   # [Hq]
    return torch.where(retr_q[None, :, None], out_r, out_s).to(q.dtype)


def page_selector_scores(
    q: torch.Tensor,            # [B, Hq, D] current queries (post-RoPE)
    k_stats: torch.Tensor,      # [L, P, Hr, n_sub*2, D] pool stats
    layer: int,
    block_tables: torch.Tensor,  # [B, max_blocks]
    head_is_retrieval: torch.Tensor,  # [Hkv]
    head_rank: torch.Tensor,          # [Hkv]
) -> torch.Tensor:
    """Upper-bound score per (batch, kv head, logical page).

    score(page) = max over sub-chunks of max over the head's GQA queries of
    ``sum_d max(q_d*kmin_d, q_d*kmax_d)``; streaming heads get -inf. The
    JAX function scores the whole pool slab and gathers the scores (a
    row gather is slow on a TPU); here each sequence's stats rows are
    gathered first and only those are scored: same numbers, work
    proportional to the table width. Returns [B, Hkv, max_blocks] f32."""
    b, hq, d = q.shape
    hkv = head_is_retrieval.shape[0]
    n_rep = hq // hkv
    n_pages, hr = k_stats.shape[1], k_stats.shape[2]
    rows = k_stats[layer][torch.clamp(block_tables.long(), 0, n_pages - 1)]
    kmin, kmax = rows[:, :, :, 0::2], rows[:, :, :, 1::2]  # [B, W, Hr, S, D]
    qf = q.float().reshape(b, hkv, n_rep, d)
    # the kv head feeding pool row r (rank is a bijection on retrieval heads)
    match = (head_rank[None, :] == torch.arange(hr, device=q.device)[:, None]
             ) & head_is_retrieval[None, :]
    q_r = qf[:, match.int().argmax(dim=1)]                 # [B, Hr, n_rep, D]
    ub = torch.einsum("bhrd,bwhsd->bwhrs", torch.clamp(q_r, min=0.0), kmax) \
        + torch.einsum("bhrd,bwhsd->bwhrs", torch.clamp(q_r, max=0.0), kmin)
    pool_scores = ub.amax(dim=(3, 4))                      # [B, W, Hr]
    sel = pool_scores[:, :, torch.clamp(head_rank.long(), 0, hr - 1)]
    scores = torch.where(head_is_retrieval[None, None, :], sel,
                         float("-inf"))
    return scores.transpose(1, 2)                          # [B, Hkv, W]


def select_topk_pages(
    scores: torch.Tensor,        # [B, Hkv, max_blocks]
    context_lens: torch.Tensor,  # [B]
    budget_pages: int,
    page_size: int,
) -> torch.Tensor:
    """Top-(budget-1) pages by score plus, always, the newest page (slot
    0). If the history fits in the budget, all pages are selected. Exact
    ``torch.topk`` (the JAX function uses ``approx_max_k``: same page set
    on the CPU, another order). Returns logical page indices, -1 padded,
    [B, Hkv, budget_pages] int32."""
    b, hkv, max_blocks = scores.shape
    dev = scores.device
    n_pages = torch.div(context_lens.long() + page_size - 1, page_size,
                        rounding_mode="floor")             # [B]
    newest = n_pages - 1
    page_ids = torch.arange(max_blocks, device=dev)
    in_range = page_ids[None, :] < n_pages[:, None]        # [B, max_blocks]
    scored = torch.where(
        in_range[:, None, :]
        & (page_ids[None, None, :] != newest[:, None, None]),
        scores, float("-inf"),
    )
    k = min(budget_pages - 1, max_blocks)
    top_scores, top_idx = torch.topk(scored, k, dim=-1)
    top_idx = torch.where(top_scores > float("-inf"), top_idx, -1)
    sel = torch.cat([newest[:, None, None].expand(b, hkv, 1), top_idx],
                    dim=2)
    all_sel = torch.where(in_range, page_ids[None, :], -1)[:, None, :] \
        .expand(b, hkv, max_blocks)[:, :, :budget_pages]
    pad = budget_pages - sel.shape[2]
    sel = torch.nn.functional.pad(sel, (0, pad), value=-1)
    all_sel = torch.nn.functional.pad(
        all_sel, (0, budget_pages - all_sel.shape[2]), value=-1)
    fits = n_pages <= budget_pages                         # [B]
    return torch.where(fits[:, None, None], all_sel, sel).to(torch.int32)


def paged_prefill_attention(
    q: torch.Tensor,             # [B, Tq, Hq, D] current-chunk queries
    pool: KVPool,
    layer: int,
    block_tables: torch.Tensor,  # [B, W]
    q_positions: torch.Tensor,   # [B, Tq] absolute position (-1 = pad)
    context_lens: torch.Tensor,  # [B] tokens in the pool incl. the chunk
    sm_scale: float,
    page_size: int,
    kv_bits: int,
    kv_zeros: bool,
    head_is_retrieval: Optional[torch.Tensor] = None,
    sink_size: int = 0,
    local_size: int = 0,
    kv_positions: Optional[torch.Tensor] = None,  # [B, W*page], -1 dead
    return_lse: bool = False,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Chunked-prefill attention: queries attend CAUSALLY over the paged
    pool (history + the current chunk, which the caller appended first).

    Any pool width and granularity, in f32 over the dequantized pages, one
    sequence and ``q_chunk`` queries at a time, with the JAX reference's
    mask: pool row ``r`` holds position ``kv_pos = kv_positions[b, r]``
    (default ``r``; -1 = no token) and is visible to a query at ``q_pos``
    iff ``0 <= kv_pos <= q_pos``, ``kv_pos < context_lens[b]`` and
    ``q_pos >= 0``. Streaming heads (``head_is_retrieval`` [Hq] False, when
    a band is given) also need ``kv_pos < sink_size or q_pos - kv_pos <
    local_size``. Rows with nothing visible give zeros."""
    if return_lse:
        raise NotImplementedError(
            "LSE outputs of paged prefill are the sequence-parallel path; "
            "see ROADMAP.md queue 1 item 10"
        )
    band = head_is_retrieval is not None and bool(sink_size or local_size)
    b, tq, hq, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(b):
        k, v = gather_kv_for_seq(pool, layer, block_tables[i], page_size,
                                 kv_bits, kv_zeros)    # [t_kv, Hkv, D] f32
        n_rep = hq // k.shape[1]
        kf, vf = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        kv_pos = (torch.arange(k.shape[0], device=q.device)
                  if kv_positions is None else kv_positions[i].long())
        for i0 in range(0, tq, q_chunk):
            i1 = min(tq, i0 + q_chunk)
            qpos = q_positions[i, i0:i1].long()
            logits = torch.einsum("qhd,khd->hqk", q[i, i0:i1].float(),
                                  kf) * sm_scale
            mask = (
                (kv_pos[None, :] <= qpos[:, None])
                & (kv_pos[None, :] >= 0)
                & (kv_pos[None, :] < context_lens[i])
                & (qpos[:, None] >= 0)
            )[None]                                    # [1, rows, t_kv]
            if band:
                in_band = (kv_pos[None, :] < sink_size) | (
                    qpos[:, None] - kv_pos[None, :] < local_size)
                mask = torch.where(head_is_retrieval[:, None, None], mask,
                                   mask & in_band[None])
            logits = torch.where(mask, logits, -1e30)
            p = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
            out[i, i0:i1] = torch.einsum("hqk,khd->qhd", p, vf)
    return out.to(q.dtype)
