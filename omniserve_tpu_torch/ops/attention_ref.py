"""Plain PyTorch attention: the semantic contracts the kernels are held to.

Counterparts of ``omniserve_tpu.ops.attention_ref``:

- ``prefill_attention`` (:54): packed-varlen causal attention, dense heads;
  the plain version of the flash prefill kernel.
- ``paged_decode_attention`` (:151): single-query GQA attention over the
  paged kv4 pool, dense page lists; half of the plain version of the fused
  decode kernel (``ops/cuda/decode_attention.py``).
- ``paged_prefill_attention`` (:391): a chunk's causal GQA attention over
  the paged kv4 pool (history + chunk); the plain version of the paged
  prefill kernel (``ops/cuda/paged_prefill.py``).

All compute in f32. The streaming/sparse modes of the JAX functions
(sink+local bands, dual pools, page selections, LSE outputs) are queued in
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
    head_is_retrieval: Optional[torch.Tensor] = None,
    sink_size: int = 0,
    local_size: int = 0,
    valid: Optional[torch.Tensor] = None,  # [T] bool, False = padding
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal self-attention over packed sequences.

    Query i attends key j iff both are valid, in the same segment, and
    ``pos_i >= pos_j``; rows with no valid key give zeros. Queries are
    processed ``q_chunk`` rows at a time so the [Hq, rows, T] score block
    stays bounded on long packed prompts."""
    if head_is_retrieval is not None and (sink_size or local_size):
        raise NotImplementedError(
            "streaming-head (sink+local) prefill is the LServe path; see "
            "ROADMAP.md queue 1 item 5"
        )
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
        )
        scores = scores.masked_fill(~mask[None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(mask.any(dim=-1)[None, :, None], probs, 0.0)
        out[i0:i1] = torch.einsum("hts,shd->thd", probs, vf).to(q.dtype)
    return out


def paged_decode_attention(
    q: torch.Tensor,             # [B, Hq, D] (post-RoPE)
    pool: KVPool,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_blocks] int
    context_lens: torch.Tensor,  # [B] int, tokens cached incl. current
    sm_scale: float,
    page_size: int,
    kv_bits: int,
    kv_zeros: bool,
    streaming_pool: Optional[KVPool] = None,
    page_idxes: Optional[torch.Tensor] = None,
    return_lse: bool = False,
) -> torch.Tensor:
    """Single-query GQA attention over each sequence's first
    ``context_lens`` cached tokens (dense page lists)."""
    if streaming_pool is not None or page_idxes is not None or return_lse:
        raise NotImplementedError(
            "streaming pools, page selections and LSE outputs are the "
            "LServe / sequence-parallel paths; see ROADMAP.md queue 1 "
            "items 5 and 10"
        )
    if kv_bits != 4 or not kv_zeros:
        raise NotImplementedError(
            "the port serves kv4 fine-grained pools; see "
            "ROADMAP.md queue 1 item 8"
        )
    b, hq, d = q.shape
    k, v = gather_kv_for_seq(pool, layer, block_tables, page_size)
    s_max, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    qf = q.float().reshape(b, hkv, n_rep, d)
    scores = torch.einsum("bhrd,bshd->bhrs", qf, k) * sm_scale
    tok = torch.arange(s_max, device=q.device)
    mask = (tok[None, :] < context_lens[:, None])[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    any_valid = mask.any(dim=-1, keepdim=True)
    m = torch.where(any_valid, scores.amax(dim=-1, keepdim=True), 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = torch.where(any_valid, p / torch.clamp(l, min=1e-30), 0.0)
    out = torch.einsum("bhrs,bshd->bhrd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)


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
    kv_positions: Optional[torch.Tensor] = None,
    return_lse: bool = False,
) -> torch.Tensor:
    """Chunked-prefill attention: queries attend CAUSALLY over the paged
    pool (history + the current chunk, which the caller appended first).

    Dense heads over a kv4 fine-grained pool, in f32 over the dequantized
    pages, one sequence at a time, with the JAX reference's mask: key
    position ``j`` is visible to a query at ``q_pos`` iff ``j <= q_pos``,
    ``j < context_lens[b]`` and ``q_pos >= 0``; padding rows give zeros."""
    if kv_positions is not None or return_lse or (
        head_is_retrieval is not None and (sink_size or local_size)
    ):
        raise NotImplementedError(
            "ring position maps and sink+local bands (LServe) and LSE "
            "outputs (sequence parallelism) of paged prefill are queued in "
            "ROADMAP.md queue 1 items 5 and 10"
        )
    b, tq, hq, d = q.shape
    outs = []
    for i in range(b):
        k, v = gather_kv_for_seq(pool, layer, block_tables[i], page_size,
                                 kv_bits, kv_zeros)    # [t_kv, Hkv, D] f32
        n_rep = hq // k.shape[1]
        kf, vf = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        logits = torch.einsum("qhd,khd->hqk", q[i].float(), kf) * sm_scale
        kv_pos = torch.arange(k.shape[0], device=q.device)
        qpos = q_positions[i].long()
        mask = (
            (kv_pos[None, :] <= qpos[:, None])
            & (kv_pos[None, :] < context_lens[i])
            & (qpos[:, None] >= 0)
        )                                              # [Tq, t_kv]
        logits = torch.where(mask[None], logits, -1e30)
        p = torch.where(mask[None], torch.softmax(logits, dim=-1), 0.0)
        outs.append(torch.einsum("hqk,khd->qhd", p, vf))
    return torch.stack(outs).to(q.dtype)
