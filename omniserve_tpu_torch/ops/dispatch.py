"""Attention dispatch: Hopper kernels for CUDA tensors, plain versions for
CPU tensors.

Counterpart of ``omniserve_tpu.ops.dispatch`` for what the port serves,
over kv4 / kv8 pools (fine-grained or per-tensor) and kv16 pools alike:
whole-prompt prefill and chunked prefill over the paged pool (dense heads;
LServe's streaming heads with their sink + local band, over the ring
pool's page list in chunked prefill), the dense decode step with its KV
append fused in (kv4 / kv8 where ``supports`` holds) or split as the JAX
dispatch splits it (``append_kv_decode``, then
``paged_decode_attention``: every kv16 pool, and kv4 / kv8 at head_dim 64
or pages not a multiple of 128), and the split decode step of
dynamic-sparse decode (the same two calls over the retrieval and
streaming pools). Head dim 64 or 128 on a card.
Every other mode of the JAX dispatch raises ``NotImplementedError``
naming its ROADMAP.md item.

Two environment switches, read at call time with the JAX dispatch's names
and defaults (off), choose the JAX package's alternative kernels for CUDA
tensors: ``OMNISERVE_PREFILL_SINGLE_PASS=1`` sends kv4 / kv8 chunked
prefill to the single-pass kernel where ``single_pass_applies`` holds, and
``OMNISERVE_EMBED_DMA=1`` sends the decode step's embedding to the row
gather kernel (``embed_lookup``). With a switch on and its rule holding, a
build or launch failure raises: no call falls back.
"""

from __future__ import annotations

import os

import torch

from omniserve_tpu_torch.ops import attention_ref, cuda


def supports(kv_bits: int, page_size: int, head_dim: int) -> bool:
    """Whether the single-pass kernel serves this pool: the JAX package's
    rule (``omniserve_tpu/ops/pallas/decode_attention.py:67-88``), kept
    here as a copy: kv4 / kv8, page rows a multiple of 32, pages a multiple
    of 128 tokens, head_dim a multiple of 128."""
    if kv_bits not in (4, 8) or page_size <= 0:
        return False
    rows_pg = page_size // 2 if kv_bits == 4 else page_size
    return rows_pg % 32 == 0 and page_size % 128 == 0 and head_dim % 128 == 0


def single_pass_applies(kv_bits: int, page_size: int, head_dim: int,
                        return_lse: bool = False) -> bool:
    """Whether chunked prefill goes to the single-pass kernel: the JAX
    dispatch's rule (``omniserve_tpu/ops/dispatch.py:179-207``), with
    ``OMNISERVE_PREFILL_SINGLE_PASS`` read now."""
    return (os.environ.get("OMNISERVE_PREFILL_SINGLE_PASS", "0") == "1"
            and not return_lse and kv_bits in (4, 8)
            and supports(kv_bits, int(page_size), int(head_dim)))


def embed_lookup(table, ids):
    """Decode-step embedding rows. On a card with ``OMNISERVE_EMBED_DMA=1``
    the row gather kernel (which clamps ids into the table); otherwise
    ``table[ids]``, as the JAX dispatch (``omniserve_tpu/ops/dispatch.py:
    149-164``)."""
    if cuda.use_kernel(table) and \
            os.environ.get("OMNISERVE_EMBED_DMA", "0") == "1":
        from omniserve_tpu_torch.ops.cuda import embed_gather

        return embed_gather.embed_gather(table, ids)
    return table[ids]


def prefill_attention(q, k, v, segment_ids, positions, sm_scale,
                      head_is_retrieval=None, sink_size=0, local_size=0,
                      valid=None):
    """Packed-varlen causal attention [T, Hq, D]; streaming heads
    (``head_is_retrieval`` [Hq] False) keep the sink + local band."""
    if head_is_retrieval is not None and \
            tuple(head_is_retrieval.shape) != (q.shape[1],):
        raise ValueError(f"head_is_retrieval must be [{q.shape[1]}] (per q "
                         f"head), got {tuple(head_is_retrieval.shape)}")
    if cuda.use_kernel(q):
        from omniserve_tpu_torch.ops.cuda import flash_attention

        if valid is not None:
            segment_ids = segment_ids.masked_fill(~valid, -1)
        return flash_attention.flash_prefill(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            positions, sm_scale, head_is_retrieval=head_is_retrieval,
            sink_size=sink_size, local_size=local_size,
        )
    return attention_ref.prefill_attention(
        q, k, v, segment_ids, positions, sm_scale,
        head_is_retrieval=head_is_retrieval, sink_size=sink_size,
        local_size=local_size, valid=valid,
    )


def paged_decode_attention_fused(
    q, pool, streaming_pool, layer, block_tables, context_lens, k_new,
    v_new, *, sm_scale, page_size, kv_bits, kv_zeros,
    page_idxes=None, return_lse=False,
):
    """Decode attention WITH the step's KV append, one call.

    ``context_lens`` INCLUDE the new token. On a card, where ``supports``
    holds (kv4 / kv8, pages and head_dim multiples of 128): one kernel that
    attends and writes the new token into the pool (fine-grained or
    per-tensor); elsewhere the JAX dispatch's split path
    (``omniserve_tpu/ops/dispatch.py:76-118``), which these pools take on
    the TPU too: ``append_kv_decode``, then ``paged_decode_attention`` over
    the dense list (two kernels: rows 10 and 6). On the CPU: the split
    path. Returns (out, pool, streaming_pool); the pool is updated in
    place."""
    if streaming_pool is not None:
        raise NotImplementedError(
            "the fused append over a streaming (ring) pool is ROADMAP.md "
            "queue 2 item 2; the engine never reaches it: it builds a "
            "streaming pool only under --sparse-decode-mode, whose steps "
            "append through append_kv_decode"
        )
    if page_idxes is not None or return_lse:
        raise NotImplementedError(
            "the fused append takes no page selection (sparse decode runs "
            "append_kv_decode, then paged_decode_attention), and LSE outputs "
            "are sequence parallelism, ROADMAP.md queue 1 item 10"
        )
    from omniserve_tpu_torch.ops.cuda import decode_attention

    if not cuda.use_kernel(q):
        out = decode_attention.paged_decode_attention_fused_plain(
            q, pool, layer, block_tables, context_lens, k_new, v_new,
            sm_scale=sm_scale, page_size=page_size, kv_bits=kv_bits,
            kv_zeros=kv_zeros,
        )
    elif not supports(kv_bits, page_size, q.shape[-1]):
        pages, slots = decode_attention.append_targets(
            block_tables, context_lens, page_size)
        append_kv_decode(pool, layer, k_new, v_new, pages, slots, page_size,
                         kv_bits, kv_zeros)
        out = paged_decode_attention(
            q, pool, layer, block_tables, context_lens, sm_scale, page_size,
            kv_bits, kv_zeros)
    else:
        out = decode_attention.paged_decode_attention_fused(
            q.contiguous(), pool, layer, block_tables, context_lens,
            k_new.contiguous(), v_new.contiguous(),
            sm_scale=sm_scale, page_size=page_size, kv_bits=kv_bits,
        )
    return out, pool, streaming_pool


def append_kv_decode(pool, layer, k, v, page_ids, slots, page_size,
                     kv_bits, kv_zeros, update_stats=False, sub_chunks=4):
    """Decode-step KV append (+ optional K min/max stats), in place. Tokens
    must target distinct pages (the decode invariant); page id -1 marks an
    inactive token. kv4 / kv8 pools, fine-grained or per-tensor, and kv16
    pools."""
    from omniserve_tpu_torch.ops.cuda import kv_append

    if cuda.use_kernel(k):
        return kv_append.append_kv_decode(
            pool, layer, k.contiguous(), v.contiguous(),
            page_ids.to(torch.int32), slots.to(torch.int32), page_size,
            update_stats=update_stats, sub_chunks=sub_chunks,
        )
    return kv_append.append_kv_decode_plain(
        pool, layer, k, v, page_ids, slots, page_size,
        update_stats=update_stats, sub_chunks=sub_chunks, kv_bits=kv_bits,
        kv_zeros=kv_zeros,
    )


def append_kv_decode_pools(retrieval_pool, streaming_pool, layer, k, v,
                           retrieval, streaming, page_size, kv_bits,
                           kv_zeros, update_stats=False, sub_chunks=4):
    """The decode step's token into both of LServe's pools, in place:
    ``retrieval`` / ``streaming`` are (page ids [T] (-1 inactive), slots
    [T], src [H_pool]) of each pool, row h taking kv head ``src[h]`` of
    ``k`` / ``v`` [T, Hkv, D]; stats (``update_stats``) go to the retrieval
    pool only. On a card one kernel launch writes both (no head gather);
    on the CPU, per pool, the head gather and the JAX dispatch's scatter
    path. ``streaming_pool`` None: the retrieval pool alone."""
    from omniserve_tpu_torch.ops.cuda import kv_append

    if cuda.use_kernel(k):
        def targets(pages, slots, src):
            return (pages.to(torch.int32), slots.to(torch.int32),
                    src.to(torch.int64))

        return kv_append.append_kv_decode_pools(
            retrieval_pool, streaming_pool, layer, k, v,
            targets(*retrieval),
            None if streaming_pool is None else targets(*streaming),
            page_size, update_stats=update_stats, sub_chunks=sub_chunks,
        )
    return kv_append.append_kv_decode_pools_plain(
        retrieval_pool, streaming_pool, layer, k, v, retrieval, streaming,
        page_size, update_stats=update_stats, sub_chunks=sub_chunks,
        kv_bits=kv_bits, kv_zeros=kv_zeros,
    )


def paged_decode_attention(
    q, pool, layer, block_tables, context_lens, sm_scale, page_size,
    kv_bits, kv_zeros, streaming_pool=None, streaming_block_tables=None,
    head_is_retrieval=None, head_rank=None, sink_blocks=0, local_blocks=0,
    page_idxes=None, dec_sink_tokens=None, dec_local_tokens=None,
):
    """Decode attention WITHOUT the append, over the retrieval pool (dense
    history or the selector's ``page_idxes``) and, for streaming heads, the
    ring pool's sink + local band. On a card: the page-list kernels (kv16
    pools: the two-stage kernel's dense, per-head and band modes). On the
    CPU: ``attention_ref.paged_decode_attention``. kv4 / kv8 pools, fine-
    grained or per-tensor, and kv16 pools."""
    if cuda.use_kernel(q):
        from omniserve_tpu_torch.ops.cuda import decode_attention

        return decode_attention.paged_decode_attention(
            q.contiguous(), pool, layer, block_tables, context_lens,
            sm_scale, page_size, streaming_pool=streaming_pool,
            streaming_block_tables=streaming_block_tables,
            head_is_retrieval=head_is_retrieval, head_rank=head_rank,
            sink_blocks=sink_blocks, local_blocks=local_blocks,
            page_idxes=page_idxes, dec_sink_tokens=dec_sink_tokens,
            dec_local_tokens=dec_local_tokens,
        )
    return attention_ref.paged_decode_attention(
        q, pool, layer, block_tables, context_lens, sm_scale, page_size,
        kv_bits, kv_zeros, streaming_pool=streaming_pool,
        streaming_block_tables=streaming_block_tables,
        head_is_retrieval=head_is_retrieval, head_rank=head_rank,
        sink_blocks=sink_blocks, local_blocks=local_blocks,
        page_idxes=page_idxes, dec_sink_tokens=dec_sink_tokens,
        dec_local_tokens=dec_local_tokens,
    )


def paged_prefill_attention(
    q, pool, layer, block_tables, q_positions, context_lens, sm_scale,
    page_size, kv_bits, kv_zeros, head_is_retrieval=None, sink_size=0,
    local_size=0, sel_logic=None, ring_span_pages=0, ring_sink_tokens=0,
    return_lse=False,
):
    """Chunked-prefill attention of q [B, Tc, Hq, D] over the paged pool
    (history + the chunk, appended by the caller): kv4 / kv8 pools, fine-
    grained or per-tensor, and kv16 pools, each also under a page list or
    a band (LServe).

    ``sel_logic`` [B, W] names the logical page each table slot holds (-1
    dead); with ``ring_span_pages`` the source is the streaming ring, whose
    newest page's stale rows are relabelled one ring span back (valid from
    ``ring_sink_tokens``). Streaming heads (``head_is_retrieval`` [Hq]
    False) keep the sink + local band. On a card: the kernel reads them as
    they are: the single-pass kernel where ``single_pass_applies``, else
    the paged-prefill kernel. On the CPU: the plain version, which turns
    the list into a per-row position map as the JAX dispatch does. The
    rule, not the device, decides which kernel's plain version serves a CPU
    call."""
    if return_lse:
        raise NotImplementedError(
            "LSE outputs of paged prefill are the sequence-parallel path; "
            "see ROADMAP.md queue 1 item 10"
        )
    if single_pass_applies(kv_bits, page_size, q.shape[-1]):
        from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

        fn = (psp.paged_prefill_single_pass if cuda.use_kernel(q)
              else psp.paged_prefill_single_pass_plain)
    else:
        from omniserve_tpu_torch.ops.cuda import paged_prefill

        fn = (paged_prefill.paged_prefill_attention if cuda.use_kernel(q)
              else paged_prefill.paged_prefill_attention_plain)
    return fn(q.contiguous(), pool, layer, block_tables, q_positions,
              context_lens, sm_scale=sm_scale, page_size=page_size,
              head_is_retrieval=head_is_retrieval, sink_size=sink_size,
              local_size=local_size, sel_logic=sel_logic,
              ring_span_pages=ring_span_pages,
              ring_sink_tokens=ring_sink_tokens, kv_bits=kv_bits,
              kv_zeros=kv_zeros)
