"""Chunked-prefill attention over the paged pool (``csrc/paged_prefill.cu``).

Replaces ``omniserve_tpu/ops/pallas/paged_prefill.py:paged_prefill_attention``
(:268, kernel ``_prefill_kernel`` :39): dense heads over a block table
(launches counted as ``paged_prefill_attention`` over fine-grained kv4
pages, ``paged_prefill_kv8`` over fine-grained kv8 pages,
``paged_prefill_pt`` over per-tensor kv4 or kv8 pages and
``paged_prefill_kv16`` over bf16 pages), and, over the same pages, the
explicit page-list mode, with the streaming ring's relabel and the
per-head sink + local band, that LServe's chunked prefill runs over the
ring pool (counted as ``paged_prefill_ring`` over fine-grained kv4 pages,
``paged_prefill_ring_kv8``, ``paged_prefill_ring_pt`` and
``paged_prefill_ring_kv16``), at head_dim 64 or 128 (each name with
``_d64`` at 64). The plain version it is held
against is ``paged_prefill_attention_plain`` below: the list turned into a
per-row position map as ``omniserve_tpu/ops/dispatch.py:214-242`` does, then
``ops/attention_ref.paged_prefill_attention``. What bounds the kernel and how
it is laid out is in the CUDA source's header.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import attention_ref, cuda
from omniserve_tpu_torch.ops.paged_kv import KVPool, ring_token_positions

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "paged_prefill.cu"


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_paged_prefill.argtypes = (
            [_P] * 12 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]
        )
        lib.launch_paged_prefill.restype = _I
        lib._typed = True
    return lib


def kv_positions_of(sel_logic, context_lens, page_size: int,
                    ring_span_pages: int = 0, ring_sink_tokens: int = 0):
    """Per-row position map [B, S*page] of an explicit page list
    ``sel_logic`` [B, S] (slot s holds logical page ``sel_logic[b, s]``,
    -1 dead), as the JAX dispatch builds it for its plain version: a ring
    source through ``ring_token_positions`` (the newest page's stale rows
    relabelled one ring span back), another list directly."""
    n_slots = sel_logic.shape[1]
    if ring_span_pages:
        return ring_token_positions(context_lens, n_slots,
                                    ring_sink_tokens // page_size,
                                    ring_span_pages, page_size)
    off = torch.arange(page_size, device=sel_logic.device)[None, None, :]
    logic = sel_logic.long()[:, :, None]
    pos = torch.where(logic >= 0, logic * page_size + off, -1)
    return pos.reshape(sel_logic.shape[0], n_slots * page_size).to(
        torch.int32)


def paged_prefill_attention_plain(
    q, pool: KVPool, layer: int, block_tables, q_positions, context_lens, *,
    sm_scale: float, page_size: int, head_is_retrieval=None,
    sink_size: int = 0, local_size: int = 0,
    sel_logic: Optional[torch.Tensor] = None, ring_span_pages: int = 0,
    ring_sink_tokens: int = 0, kv_bits: int = 4, kv_zeros: bool = True,
):
    """Plain version: ``attention_ref.paged_prefill_attention``, with an
    explicit page list turned into its position map first."""
    kv_positions = None
    if sel_logic is not None:
        kv_positions = kv_positions_of(sel_logic, context_lens, page_size,
                                       ring_span_pages, ring_sink_tokens)
    return attention_ref.paged_prefill_attention(
        q, pool, layer, block_tables, q_positions, context_lens, sm_scale,
        page_size, kv_bits=kv_bits, kv_zeros=kv_zeros,
        head_is_retrieval=head_is_retrieval, sink_size=sink_size,
        local_size=local_size, kv_positions=kv_positions,
    )


def launch(fn, name: str, q, pool: KVPool, layer: int, block_tables,
           q_positions, context_lens, *, sm_scale: float, page_size: int,
           head_is_retrieval=None, sink_size: int = 0, local_size: int = 0,
           sel_logic=None, ring_span_pages: int = 0,
           ring_sink_tokens: int = 0, kv_bits: int = 4,
           kv_zeros: bool = True, head_dims=cuda.HEAD_DIMS) -> torch.Tensor:
    """Check the tensors of a chunked-prefill kernel call, launch ``fn``
    (this file's kernel or the single-pass one: the two take the same C
    arguments; ``head_dims`` those it is built for) and count it under
    ``name`` (``name + "_d64"`` at head_dim 64). Returns [B, Tc, Hq, D]
    bf16."""
    b, tc, hq, d = q.shape
    _, _, hkv, rows, _ = pool.k_data.shape
    n_rep = hq // hkv
    cuda.check_head_dim(d, "paged prefill kernel", head_dims)
    if n_rep * hkv != hq or not 1 <= n_rep <= cuda.MAX_N_REP:
        raise ValueError(
            f"paged prefill kernels need n_rep 1 to {cuda.MAX_N_REP}; got "
            f"{hq} q / {hkv} kv heads"
        )
    want_rows = {4: page_size // 2, 8: page_size, 16: page_size}.get(kv_bits)
    fine = kv_bits < 16 and kv_zeros
    pt = kv_bits < 16 and not kv_zeros
    if (rows != want_rows or (pool.kv_scales is None) == fine
            or (pool.k_scale_per_tensor is None) == pt):
        raise ValueError("paged prefill kernels serve kv4 / kv8 pools, fine-"
                         f"grained or per-tensor, and kv16 pools; got "
                         f"kv{kv_bits} (kv_zeros={kv_zeros}), {rows} rows of "
                         f"a {page_size}-token page")
    cuda.check(q, "q", torch.bfloat16)
    data_dtype = torch.bfloat16 if kv_bits == 16 else torch.uint8
    cuda.check(pool.k_data, "k_data", data_dtype)
    cuda.check(pool.v_data, "v_data", data_dtype, pool.k_data.shape)
    # the kernels copy whole pool rows asynchronously (16-byte units)
    for x, what in ((pool.k_data, "k_data"), (pool.v_data, "v_data"),
                    (pool.kv_scales, "kv_scales")):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned, got base % 16 "
                             f"= {x.data_ptr() % 16}")
    planes_ptr = k_pt = v_pt = None
    if fine:
        cuda.check(pool.kv_scales, "kv_scales", torch.float32)
        planes_ptr = pool.kv_scales[layer].data_ptr()
    if pt:
        num_layers = pool.k_data.shape[0]
        cuda.check(pool.k_scale_per_tensor, "k_scale_per_tensor",
                   torch.float32, (num_layers,))
        cuda.check(pool.v_scale_per_tensor, "v_scale_per_tensor",
                   torch.float32, (num_layers,))
        k_pt = pool.k_scale_per_tensor[layer].data_ptr()
        v_pt = pool.v_scale_per_tensor[layer].data_ptr()
    cuda.check(block_tables, "block_tables", torch.int32)
    cuda.check(q_positions, "q_positions", torch.int32, (b, tc))
    cuda.check(context_lens, "context_lens", torch.int32, (b,))
    if block_tables.shape[0] != b:
        raise ValueError("block_tables rows != batch")
    w = block_tables.shape[1]
    sel_ptr = flags_ptr = None
    if sel_logic is not None:
        cuda.check(sel_logic, "sel_logic", torch.int32, (b, w))
        sel_ptr = sel_logic.data_ptr()
    elif ring_span_pages:
        raise ValueError("ring_span_pages needs sel_logic")
    if head_is_retrieval is not None and bool(sink_size or local_size):
        if tuple(head_is_retrieval.shape) != (hq,):
            raise ValueError(f"head_is_retrieval must be [{hq}] (per q "
                             f"head), got {tuple(head_is_retrieval.shape)}")
        # per-q-head -> per-kv-head, as the Pallas wrappers do
        flags = head_is_retrieval[::n_rep].to(torch.int32).contiguous()
        cuda.check(flags, "head_is_retrieval", torch.int32, (hkv,))
        flags_ptr = flags.data_ptr()
    out = torch.empty_like(q)
    if b == 0 or tc == 0:
        return out
    err = fn(
        q.data_ptr(), pool.k_data[layer].data_ptr(),
        pool.v_data[layer].data_ptr(), planes_ptr, k_pt, v_pt,
        block_tables.data_ptr(), q_positions.data_ptr(),
        context_lens.data_ptr(), sel_ptr, flags_ptr, out.data_ptr(),
        b, tc, hkv, n_rep, page_size, w, int(sink_size), int(local_size),
        int(ring_span_pages), int(ring_sink_tokens), float(sm_scale),
        kv_bits, d, cuda.stream_handle(),
    )
    name = cuda.launch_name(name, d)
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1
    return out


def paged_prefill_attention(
    q: torch.Tensor,             # [B, Tc, Hq, D] bf16
    pool: KVPool,
    layer: int,
    block_tables: torch.Tensor,  # [B, W] int32
    q_positions: torch.Tensor,   # [B, Tc] int32, -1 = padding
    context_lens: torch.Tensor,  # [B] int32, history + chunk
    *,
    sm_scale: float,
    page_size: int,
    head_is_retrieval: Optional[torch.Tensor] = None,   # [Hq] bool
    sink_size: int = 0,
    local_size: int = 0,
    sel_logic: Optional[torch.Tensor] = None,           # [B, W] int32
    ring_span_pages: int = 0,
    ring_sink_tokens: int = 0,
    kv_bits: int = 4,
    kv_zeros: bool = True,
) -> torch.Tensor:
    """Kernel: causal GQA attention of the chunk over the pool, reading the
    pages in place. Without ``sel_logic`` the table is the dense history
    (slot = logical page); with it, slot s holds logical page
    ``sel_logic[b, s]`` (-1 dead) and ``ring_span_pages`` > 0 relabels the
    newest page's stale rows. Streaming heads (``head_is_retrieval`` False)
    keep the sink + local band. kv4 / kv8 pages, fine-grained or per-tensor
    (``kv_zeros=False``, the pool's scales read on the device), and kv16
    pages take every mode, at head_dim 64 or 128. Returns [B, Tc, Hq, D]
    bf16."""
    pt = kv_bits < 16 and not kv_zeros
    suffix = ("_kv16" if kv_bits == 16 else "_pt" if pt
              else "_kv8" if kv_bits == 8 else "")
    if sel_logic is not None:
        name = "paged_prefill_ring" + suffix
    else:
        name = ("paged_prefill" + suffix if suffix
                else "paged_prefill_attention")
    return launch(
        _lib().launch_paged_prefill, name, q, pool, layer, block_tables,
        q_positions, context_lens, sm_scale=sm_scale, page_size=page_size,
        head_is_retrieval=head_is_retrieval, sink_size=sink_size,
        local_size=local_size, sel_logic=sel_logic,
        ring_span_pages=ring_span_pages, ring_sink_tokens=ring_sink_tokens,
        kv_bits=kv_bits, kv_zeros=kv_zeros)
