"""Packed-varlen causal flash prefill kernel (``csrc/flash_prefill.cu``).

Replaces ``omniserve_tpu/ops/pallas/flash_attention.py:flash_prefill``
(:150): dense heads (launches counted as ``flash_prefill``) and LServe's
per-head sink + local band with its tile skip (``flash_prefill_band``). The
plain version it is held against is ``ops/attention_ref.prefill_attention``
(re-exported here as ``prefill_attention_plain``). What bounds it and how
the kernel is laid out is in the CUDA source's header.

A launch runs two kernels: the tile-range kernel (each 128-query tile's
live 64-key tiles, the attention kernel's loop bounds, and the
heaviest-first launch order; plain version ``live_tile_ranges``), then the
attention kernel. ``check_tma_operand`` is the alignment TMA needs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.attention_ref import (
    prefill_attention as prefill_attention_plain,
)

__all__ = ["flash_prefill", "prefill_attention_plain", "live_tile_ranges",
           "tile_ranges", "check_tma_operand"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "flash_prefill.cu"
BLOCK_Q = 128     # query rows of a block (two consumer warpgroups)
BLOCK_K = 64      # keys of a K/V tile
RANGE_COLS = 6    # ints per q tile from the tile-range kernel


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_flash_prefill.argtypes = (
            [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P]
        )
        lib.launch_flash_prefill.restype = _I
        lib.launch_flash_tile_ranges.argtypes = [_P, _P] + [_I] * 4 + [_P] * 3
        lib.launch_flash_tile_ranges.restype = _I
        lib._typed = True
    return lib


def check_tma_operand(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` ([T, H, D], contiguous) can back a TMA tensor map
    of rows of H*D values: a 16-byte aligned base and a row stride that is
    a multiple of 16 bytes. The kernel takes it as it is; nothing is
    copied to make it fit."""
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for its tensor map")
    row_bytes = t.shape[1] * t.shape[2] * t.element_size()
    if t.data_ptr() % 16 or row_bytes % 16:
        raise ValueError(
            f"{name}: a TMA tensor map needs a 16-byte aligned base and row "
            f"stride; got base % 16 = {t.data_ptr() % 16}, row stride "
            f"{row_bytes} bytes")


def live_tile_ranges(
    segment_ids: torch.Tensor,   # [T] int, -1 = padding
    positions: torch.Tensor,     # [T] int
    sink_size: int = 0,
    local_size: int = 0,
    band: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash kernel's tile-range kernel
    (``csrc/flash_prefill.cu`` flash_tile_ranges_kernel): for each tile of
    ``BLOCK_Q`` queries, the ``BLOCK_K``-key tiles that can hold a visible
    (query, key) pair, the kernel's loop bounds.

    Returns (ranges [n_qt, 6] int32, order [n_qt] int32). A dense head of
    q tile i walks key tiles [ranges[i, 0], ranges[i, 1]); a streaming
    head walks its sinks [ranges[i, 0], ranges[i, 2]), then its local band
    [max(ranges[i, 3], ranges[i, 2]), ranges[i, 1]). Every valid query of
    the tile sees every key of the tiles [ranges[i, 4], ranges[i, 5]) (a
    dense head loads no segments or positions for them). ``order`` lists the q
    tiles by descending dense range length (heaviest first; ties in tile
    order). Computed on the tensors' device without a host sync.

    Exact for the usual packed batch (valid segment ids rising run by run,
    positions rising within a run, padding only after the last valid
    token): a tile's keys start at its first query's segment start and end
    at its last query (causal), and the band's edges are binary searches
    for a position. Any other input walks every key tile."""
    t = segment_ids.shape[0]
    dev = segment_ids.device
    n_qt = -(-t // BLOCK_Q)
    n_kt = -(-t // BLOCK_K)
    seg = segment_ids.long()
    pos = positions.long()
    sp, sj = seg[:-1], seg[1:]
    bad = (((sp < 0) & (sj >= 0))
           | ((sp >= 0) & (sj >= 0)
              & ((sj < sp) | ((sj == sp) & (pos[1:] <= pos[:-1]))))).any()
    n_valid = torch.where(seg < 0, torch.arange(t, device=dev), t).min()
    # (segment, position) rises over the valid prefix of a usual batch
    off, sh = 1 << 31, 1 << 32

    def key(sg, p):
        return sg * sh + (p + off).clamp(0, sh - 1)

    comp = torch.where(torch.arange(t, device=dev) < n_valid, key(seg, pos),
                       torch.iinfo(torch.long).max)
    i0 = torch.arange(n_qt, device=dev) * BLOCK_Q
    i1 = torch.minimum(i0 + BLOCK_Q, n_valid)
    live = i0 < i1
    a0 = torch.clamp(i0, max=t - 1)
    a1 = torch.clamp(i1 - 1, 0, t - 1)
    f = torch.searchsorted(comp, key(seg[a0], torch.full_like(a0, -off)))
    d_lo = torch.div(f, BLOCK_K, rounding_mode="floor")
    d_hi = torch.div(i1 + BLOCK_K - 1, BLOCK_K, rounding_mode="floor")
    a_hi, b_lo = d_hi, d_hi
    if band:
        se = torch.minimum(torch.searchsorted(
            comp, key(seg[a1], torch.full_like(a1, int(sink_size)))), i1)
        a_hi = torch.where(
            se > f, torch.minimum(torch.div(se + BLOCK_K - 1, BLOCK_K,
                                            rounding_mode="floor"), d_hi),
            d_lo)
        bs = torch.minimum(torch.searchsorted(
            comp, key(seg[a0], pos[a0] - int(local_size) + 1)), i0 + 1)
        b_lo = torch.where(bs < i1, torch.maximum(
            torch.div(bs, BLOCK_K, rounding_mode="floor"), d_lo), d_hi)
    # one segment: the key tiles from its start to the first query
    one = seg[a1] == seg[a0]
    w_lo = torch.div(f + BLOCK_K - 1, BLOCK_K, rounding_mode="floor")
    w_hi = torch.maximum(w_lo, torch.div(i0 + 1, BLOCK_K,
                                         rounding_mode="floor"))
    zero = torch.zeros_like(d_lo)
    w_lo, w_hi = (torch.where(one, x, zero) for x in (w_lo, w_hi))
    cols = [torch.where(live, x, zero)
            for x in (d_lo, d_hi, a_hi, b_lo, w_lo, w_hi)]
    full = torch.full_like(d_lo, n_kt)
    cols = [torch.where(bad, x, c) for x, c in
            zip((zero, full, full, full, zero, zero), cols)]
    ranges = torch.stack(cols, dim=1).to(torch.int32)
    work = ranges[:, 1] - ranges[:, 0]
    order = torch.sort(-work, stable=True).indices.to(torch.int32)
    return ranges.contiguous(), order.contiguous()


def tile_ranges(segment_ids: torch.Tensor, positions: torch.Tensor,
                sink_size: int = 0, local_size: int = 0,
                band: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile-range kernel alone, on CUDA tensors (the flash prefill
    launch runs it first): what ``live_tile_ranges`` computes."""
    t = segment_ids.shape[0]
    cuda.check(segment_ids, "segment_ids", torch.int32, (t,))
    cuda.check(positions, "positions", torch.int32, (t,))
    n_qt = -(-t // BLOCK_Q)
    ranges = torch.empty((n_qt, RANGE_COLS), dtype=torch.int32,
                         device=segment_ids.device)
    order = torch.empty((n_qt,), dtype=torch.int32, device=segment_ids.device)
    err = _lib().launch_flash_tile_ranges(
        segment_ids.data_ptr(), positions.data_ptr(), t, int(sink_size),
        int(local_size), int(band), ranges.data_ptr(), order.data_ptr(),
        cuda.stream_handle())
    cuda.raise_on_error(err, "flash_tile_ranges")
    return ranges, order


def flash_prefill(
    q: torch.Tensor,            # [T, Hq, D] bf16
    k: torch.Tensor,            # [T, Hkv, D] bf16
    v: torch.Tensor,            # [T, Hkv, D] bf16
    segment_ids: torch.Tensor,  # [T] int32, -1 = padding
    positions: torch.Tensor,    # [T] int32
    sm_scale: float,
    head_is_retrieval: Optional[torch.Tensor] = None,   # [Hq] bool
    sink_size: int = 0,
    local_size: int = 0,
) -> torch.Tensor:
    """Causal attention within segments; streaming heads
    (``head_is_retrieval`` False, when a sink or local size is given) keep
    the sink + local band. A call is counted as ``flash_prefill_band`` only
    when at least one kv head streams (``_d64`` at head_dim 64). Head dim
    64 or 128. Returns [T, Hq, D] bf16."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    cuda.check_head_dim(d, "flash_prefill")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    cuda.check(q, "q", torch.bfloat16)
    cuda.check(k, "k", torch.bfloat16, (t, hkv, d))
    cuda.check(v, "v", torch.bfloat16, (t, hkv, d))
    cuda.check(segment_ids, "segment_ids", torch.int32, (t,))
    cuda.check(positions, "positions", torch.int32, (t,))
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        check_tma_operand(x, name)
    flags = None
    band = head_is_retrieval is not None and bool(sink_size or local_size)
    if band:
        if tuple(head_is_retrieval.shape) != (hq,):
            raise ValueError(f"head_is_retrieval must be [{hq}] (per q "
                             f"head), got {tuple(head_is_retrieval.shape)}")
        # per-q-head -> per-kv-head, as the Pallas wrapper does
        flags = head_is_retrieval[:: hq // hkv].to(torch.int32).contiguous()
        cuda.check(flags, "head_is_retrieval", torch.int32, (hkv,))
        if bool(flags.all()):
            # no kv head streams: the dense kernel, counted as such (one
            # host read of the Hkv flags per call)
            flags, band = None, False
    out = torch.empty_like(q)
    if t == 0:
        return out
    # scratch of the tile-range kernel the launch runs first
    n_qt = -(-t // BLOCK_Q)
    ranges = torch.empty((n_qt, RANGE_COLS), dtype=torch.int32,
                         device=q.device)
    order = torch.empty((n_qt,), dtype=torch.int32, device=q.device)
    err = _lib().launch_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
        positions.data_ptr(), None if flags is None else flags.data_ptr(),
        ranges.data_ptr(), order.data_ptr(), out.data_ptr(), t, hq, hkv,
        int(sink_size), int(local_size), float(sm_scale), d,
        cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "flash_prefill")
    cuda.LAUNCHES[cuda.launch_name(
        "flash_prefill_band" if band else "flash_prefill", d)] += 1
    return out
