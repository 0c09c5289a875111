"""Single-pass chunked-prefill attention in the integer domain
(``csrc/prefill_single_pass.cu``).

Replaces ``omniserve_tpu/ops/pallas/prefill_single_pass.py:
paged_prefill_single_pass`` (:291, kernel ``_psp_kernel`` :50): the same
contract as row 7 (``ops/cuda/paged_prefill.py``) over kv4 / kv8 pages,
fine-grained or per-tensor, a block table, a page list (with the streaming
ring's relabel) and the per-head sink + local band, computed on the raw
codes with per-key corrections (P rounded to f16 where the TPU kernel
rounds it to bf16; the CUDA source's header says why) on row 7's Hopper
core (wgmma, bulk-copied rings, row 7's copy warp; no dequantization:
the tiles hold the codes), launched through row 7's
``paged_prefill.launch`` (the two kernels take the same arguments). Launches are counted as ``paged_prefill_single_pass``
(fine-grained kv4, dense table),
``paged_prefill_single_pass_kv8`` (fine-grained kv8, dense table),
``paged_prefill_single_pass_pt`` (per-tensor kv4 or kv8, dense table) and
``paged_prefill_single_pass_list`` (a page list, the ring or the band, any
of those pools). The plain version it is held against is row 7's,
``paged_prefill.paged_prefill_attention_plain``: the contract the JAX test
holds the TPU kernel to (``tests/test_prefill_single_pass.py:47-59``). What
bounds the kernel and how it is laid out is in the CUDA source's header.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops.cuda import paged_prefill
from omniserve_tpu_torch.ops.paged_kv import KVPool

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "prefill_single_pass.cu"
UNIT = 128          # pages are multiples of it (the TPU kernel's contract)


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_prefill_single_pass.argtypes = (
            [_P] * 12 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]
        )
        lib.launch_prefill_single_pass.restype = _I
        lib._typed = True
    return lib


def paged_prefill_single_pass_plain(q, pool: KVPool, layer: int,
                                    block_tables, q_positions, context_lens,
                                    **kw):
    """Plain version: row 7's (``attention_ref.paged_prefill_attention``,
    an explicit page list turned into its position map first)."""
    if kw.get("kv_bits", 4) not in (4, 8):
        raise ValueError("the single-pass kernel serves kv4 / kv8 pools")
    return paged_prefill.paged_prefill_attention_plain(
        q, pool, layer, block_tables, q_positions, context_lens, **kw)


def launch_name(kv_bits: int, kv_zeros: bool, listed: bool) -> str:
    """The ``LAUNCHES`` entry of one call's mode."""
    if listed:
        return "paged_prefill_single_pass_list"
    if not kv_zeros:
        return "paged_prefill_single_pass_pt"
    return ("paged_prefill_single_pass_kv8" if kv_bits == 8
            else "paged_prefill_single_pass")


def paged_prefill_single_pass(
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
    """Kernel: causal GQA attention of the chunk over a kv4 / kv8 pool,
    reading whole pages in place. Without ``sel_logic`` the table is the
    dense history (slot = logical page); with it, slot s holds logical page
    ``sel_logic[b, s]`` (-1 dead) and ``ring_span_pages`` > 0 relabels the
    newest page's stale rows. Streaming heads (``head_is_retrieval`` False)
    keep the sink + local band. ``kv_zeros=False``: per-tensor codes, the
    pool's scales read on the device. Returns [B, Tc, Hq, D] bf16."""
    if kv_bits not in (4, 8) or page_size <= 0 or page_size % UNIT:
        raise ValueError(
            f"single-pass prefill kernel serves kv4 / kv8 pools with pages "
            f"of a multiple of {UNIT} tokens; got kv{kv_bits}, page "
            f"{page_size}")
    band = head_is_retrieval is not None and bool(sink_size or local_size)
    return paged_prefill.launch(
        _lib().launch_prefill_single_pass,
        launch_name(kv_bits, kv_zeros, sel_logic is not None or band), q,
        pool, layer, block_tables, q_positions, context_lens,
        sm_scale=sm_scale, page_size=page_size,
        head_is_retrieval=head_is_retrieval, sink_size=sink_size,
        local_size=local_size, sel_logic=sel_logic,
        ring_span_pages=ring_span_pages, ring_sink_tokens=ring_sink_tokens,
        kv_bits=kv_bits, kv_zeros=kv_zeros, head_dims=(128,))
