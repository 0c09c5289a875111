"""Paged, quantized KV cache: pool layout and the prefill append.

PyTorch counterpart of ``omniserve_tpu.ops.paged_kv`` with the same layout,
so pools compare byte for byte with the JAX package's:

- kv4 (packed): data [L, P, H, page/2, D] uint8 in the HALF-SPLIT layout:
  token t of a page lives at byte row ``t % (page/2)``, in the high nibble
  iff ``t >= page/2`` (``kv4_slot_to_row_nibble``).
- kv8: data [L, P, H, page, D] uint8, one byte per value, token t of a
  page at row t. Fine-grained codes carry no bias: the value is ``(code -
  zero) * scale``, as for kv4.
- kv16: data [L, P, H, page, D] bfloat16, the values as they are (no
  scales).
- fine-grained scale planes: [L, P, 4, H, page] float32, stored folded
  (see ``KVPool``).
- per-tensor KV (``kv_zeros=False``, kv4 or kv8): no planes; one
  calibrated scale per layer for K and one for V ([L] float32, kept beside
  the data), codes biased by 8 (kv4) or 128 (kv8): the value is ``(code -
  bias) * scale``.
- K min/max sub-chunk stats (retrieval pool under sparse decode):
  [L, P, H, 2*n_sub, D] float32, row 2s = sub-chunk s min, row 2s+1 = max.

One page id indexes every layer's pool (leading layer axis). The top page
is a trash page the block manager never hands out.

Unlike the JAX package, updates are IN PLACE on the pool tensors (the
engine owns one pool; copying a multi-GB pool per step would only waste
memory and bandwidth). ``append_kv`` returns the same pool for symmetry
with the JAX signature.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omniserve_tpu_torch.ops.quantization import (
    kv_quantize_fine_grained,
    kv_quantize_per_tensor,
)


class KVPool(NamedTuple):
    """One KV pool (all layers).

    ``kv_scales[L, P, 4, H, page]`` (f32) holds the four fine-grained
    quant-param planes pre-folded for the decode kernel's rank-1 terms:

        plane 0: k_scale
        plane 1: k_scale * (k_zero + 128)
        plane 2: v_scale
        plane 3: v_zero + 128
    """

    k_data: torch.Tensor
    v_data: torch.Tensor
    kv_scales: Optional[torch.Tensor]
    # [L, P, H, n_sub*2, D] f32: row 2i = sub-chunk i min, 2i+1 = max
    k_stats: Optional[torch.Tensor] = None
    # per-tensor calibrated scales [L] f32 (None in fine-grained / kv16)
    k_scale_per_tensor: Optional[torch.Tensor] = None
    v_scale_per_tensor: Optional[torch.Tensor] = None

    def clone(self) -> "KVPool":
        """A deep copy (checks run a kernel and its plain version on twin
        pools)."""
        return KVPool(*(None if t is None else t.clone() for t in self))

    @property
    def num_pages(self) -> int:
        return self.k_data.shape[1]

    @property
    def num_heads(self) -> int:
        return self.k_data.shape[2]

    def _plane(self, i):
        return None if self.kv_scales is None else self.kv_scales[:, :, i]

    @property
    def k_scale(self):
        return self._plane(0)

    @property
    def k_zero(self):
        p0, p1 = self._plane(0), self._plane(1)
        if p0 is None:
            return None
        return p1 / torch.clamp(p0, min=1e-20) - 128.0

    @property
    def v_scale(self):
        return self._plane(2)

    @property
    def v_zero(self):
        p3 = self._plane(3)
        return None if p3 is None else p3 - 128.0


def _check_bits(kv_bits: int) -> None:
    if kv_bits not in (4, 8, 16):
        raise ValueError(f"kv_bits must be 4/8/16, got {kv_bits}")


def make_kv_pool(
    num_layers: int,
    num_pages: int,
    num_heads: int,
    page_size: int,
    head_dim: int,
    kv_bits: int = 4,
    kv_zeros: bool = True,
    with_stats: bool = False,
    sub_chunks: int = 4,
    device="cuda:0",
) -> KVPool:
    """Zeroed kv4, kv8 or kv16 pool on ``device``: fine-grained planes
    (kv4/kv8 with ``kv_zeros``), per-tensor scales (kv4/kv8 without; unit
    scales, as the JAX package has under dummy weights, until
    ``CacheEngine.load_kv_scales`` writes calibrated ones), or neither
    (kv16).

    ``num_pages`` includes the top TRASH page (the block manager reserves
    it, as in the JAX package). ``with_stats`` adds the K min/max
    sub-chunk stats the page selector scores."""
    _check_bits(kv_bits)
    if kv_bits == 4 and page_size % 2:
        raise ValueError(f"kv4 pages need an even page size, got {page_size}")
    L, P, H, D = num_layers, num_pages, num_heads, head_dim
    rows = page_size // 2 if kv_bits == 4 else page_size
    shape = (L, P, H, rows, D)
    dtype = torch.bfloat16 if kv_bits == 16 else torch.uint8
    fine = kv_bits < 16 and kv_zeros
    per_tensor = kv_bits < 16 and not kv_zeros

    return KVPool(
        k_data=torch.zeros(shape, dtype=dtype, device=device),
        v_data=torch.zeros(shape, dtype=dtype, device=device),
        kv_scales=torch.zeros(
            (L, P, 4, H, page_size), dtype=torch.float32, device=device
        ) if fine else None,
        k_stats=torch.zeros(
            (L, P, H, sub_chunks * 2, D), dtype=torch.float32, device=device
        ) if with_stats else None,
        k_scale_per_tensor=torch.ones(
            (L,), dtype=torch.float32, device=device) if per_tensor else None,
        v_scale_per_tensor=torch.ones(
            (L,), dtype=torch.float32, device=device) if per_tensor else None,
    )


def ring_logical_blocks(
    context_lens: torch.Tensor,   # [B] tokens
    n_slots: int,
    sink_blocks: int,
    local_blocks: int,
    page_size: int,
) -> torch.Tensor:
    """Logical block id currently held by each streaming-ring slot.

    The ring maps logical block b -> slot ``sink + (b - sink) % local``;
    this inverts it: slot s holds the LARGEST logical block <= the current
    block that maps to s, or -1 if the slot has not been written yet.
    Returns [B, n_slots] int32."""
    lens = context_lens.long()
    cb = torch.div(lens[:, None] - 1, page_size, rounding_mode="floor")
    slots = torch.arange(n_slots, device=lens.device)[None, :]
    sink_logic = torch.where(slots <= cb, slots, -1)
    raw = cb - torch.remainder(cb - slots, max(local_blocks, 1))
    ring_logic = torch.where((cb >= sink_blocks) & (raw >= sink_blocks),
                             raw, -1)
    out = torch.where(slots < sink_blocks, sink_logic, ring_logic)
    return torch.where(lens[:, None] > 0, out, -1).to(torch.int32)


def ring_token_positions(
    context_lens: torch.Tensor,   # [B] tokens
    n_slots: int,
    sink_blocks: int,
    local_blocks: int,
    page_size: int,
) -> torch.Tensor:
    """Token position held by every row of the streaming ring, or -1.

    Token-granular inverse of the ring mapping: the current ring page's
    rows past the write head still hold last-wrap tokens. Returns
    [B, n_slots*page_size] int32 (slot-major row order)."""
    logic = ring_logical_blocks(
        context_lens, n_slots, sink_blocks, local_blocks, page_size
    ).long()[:, :, None]                                   # [B, S, 1]
    off = torch.arange(page_size, device=logic.device)[None, None, :]
    pos = logic * page_size + off                          # [B, S, page]
    lens = context_lens.long()[:, None, None]
    cb = torch.div(lens - 1, page_size, rounding_mode="floor")
    stale = (logic == cb) & (off > torch.remainder(lens - 1, page_size))
    pos = torch.where(stale, pos - local_blocks * page_size, pos)
    sink_tok = sink_blocks * page_size
    ok = (logic >= 0) & (pos < lens) & torch.where(
        stale, pos >= sink_tok, pos >= 0
    )
    pos = torch.where(ok, pos, -1)
    return pos.reshape(pos.shape[0], n_slots * page_size).to(torch.int32)


def kv4_slot_to_row_nibble(slot, page_size: int):
    """Token slot within a page -> (byte_row, is_high_nibble) for kv4."""
    half = page_size // 2
    return slot % half, slot // half


def _scatter_nibbles(
    data: torch.Tensor,      # [P, H, rows, D] uint8, one layer (view)
    q: torch.Tensor,         # [T, H, D] uint8 codes in [0, 15]
    page_ids: torch.Tensor,  # [T] (all valid)
    slots: torch.Tensor,     # [T]
    page_size: int,
) -> None:
    """In-place nibble read-modify-write of T tokens into one layer.

    Two passes (low nibbles, then high nibbles) so two tokens sharing one
    byte in the same call compose, as in the JAX package."""
    h = data.shape[1]
    row, is_hi = kv4_slot_to_row_nibble(slots, page_size)
    heads = torch.arange(h, device=data.device)
    for nibble, keep, shift in ((0, 0xF0, 0), (1, 0x0F, 4)):
        sel = is_hi == nibble
        pg, rw, qq = page_ids[sel], row[sel], q[sel]
        idx = (pg[:, None], heads[None, :], rw[:, None])  # -> [t, H, D]
        cur = data[idx]
        data[idx] = (cur & keep) | (qq << shift)


def _quantize_kv(x, kv_bits: int, kv_zeros: bool, pt_scale):
    """[..., D] -> (stored values, scale, zero) per kv-quant mode."""
    if kv_bits == 16:
        return x.to(torch.bfloat16), None, None
    if kv_zeros:
        return kv_quantize_fine_grained(x, kv_bits)
    return kv_quantize_per_tensor(x, pt_scale, kv_bits), None, None


def append_kv(
    pool: KVPool,
    layer: int,
    k: torch.Tensor,         # [T, H, D] post-RoPE keys (float)
    v: torch.Tensor,         # [T, H, D] values
    page_ids: torch.Tensor,  # [T] physical page per token (-1 = skip)
    slots: torch.Tensor,     # [T] slot within page
    page_size: int,
    kv_bits: int,
    kv_zeros: bool,
    unique_pages: bool = False,
    page_aligned: bool = False,
) -> KVPool:
    """Quantize T tokens and write them into one layer of a pool, in place.

    Tokens with ``page_ids < 0`` are dropped. Same bytes as the JAX
    package's ``append_kv`` in every mode: ``unique_pages=True`` (decode:
    every token targets a distinct page) and ``page_aligned=True`` (chunked
    prefill: groups of ``page_size`` consecutive slots, one page per group)
    are promises the JAX function uses to pick a faster scatter; here one
    write path serves every mode, so the flags change nothing. kv8 and kv16
    write one row per token at row ``slot``; per-tensor pools quantize with
    the layer's scales and write no planes."""
    _check_bits(kv_bits)
    keep = page_ids >= 0
    page_ids, slots = page_ids[keep].long(), slots[keep].long()
    pt_k = pt_v = None
    if pool.k_scale_per_tensor is not None:
        pt_k = pool.k_scale_per_tensor[layer]
        pt_v = pool.v_scale_per_tensor[layer]
    qk, k_scale, k_zero = _quantize_kv(k[keep], kv_bits, kv_zeros, pt_k)
    qv, v_scale, v_zero = _quantize_kv(v[keep], kv_bits, kv_zeros, pt_v)
    if kv_bits == 4:
        _scatter_nibbles(pool.k_data[layer], qk, page_ids, slots, page_size)
        _scatter_nibbles(pool.v_data[layer], qv, page_ids, slots, page_size)
    else:
        heads = torch.arange(pool.num_heads, device=qk.device)
        idx = (page_ids[:, None], heads[None, :], slots[:, None])
        pool.k_data[layer][idx] = qk
        pool.v_data[layer][idx] = qv
    if k_scale is None:
        return pool
    planes = (k_scale, k_scale * (k_zero + 128.0), v_scale, v_zero + 128.0)
    sc = pool.kv_scales[layer]                     # [P, 4, H, page]
    for i, vals in enumerate(planes):
        # [T] pages x [T] slots with the head dim sliced -> [T, H] values
        sc[page_ids, i, :, slots] = vals
    return pool


def update_k_stats(
    pool: KVPool,
    layer: int,
    k: torch.Tensor,         # [T, H, D] post-RoPE keys
    page_ids: torch.Tensor,  # [T] (-1 = skip)
    slots: torch.Tensor,     # [T]
    page_size: int,
    sub_chunks: int,
) -> KVPool:
    """Merge T keys into the per-sub-chunk K min/max stats, in place: a
    scatter-min / scatter-max over (page, head, sub-chunk) cells."""
    if pool.k_stats is None:
        return pool
    keep = page_ids >= 0
    pages, sub = page_ids[keep].long(), slots[keep].long() // (
        page_size // sub_chunks)
    kf = k[keep].to(pool.k_stats.dtype)                   # [t, H, D]
    _, p, h, s2, d = pool.k_stats.shape
    heads = torch.arange(h, device=kf.device)
    rows = ((pages[:, None] * h + heads[None, :]) * s2
            + 2 * sub[:, None]).reshape(-1)               # [t*H] min rows
    flat = pool.k_stats[layer].view(p * h * s2, d)
    idx = rows[:, None].expand(-1, d)
    kf = kf.reshape(-1, d)
    flat.scatter_reduce_(0, idx, kf, "amin", include_self=True)
    flat.scatter_reduce_(0, idx + 1, kf, "amax", include_self=True)
    return pool


def _reset_stats_rows(stats: torch.Tensor, page_ids: torch.Tensor) -> None:
    """stats [..., P, H, 2S, D] (a view): pages' rows to (+inf, -inf).

    Ids < 0 go to the trash page (the top page, which no sequence owns), so
    the op has no data-dependent shape and can sit in a captured decode
    step."""
    pages = torch.where(page_ids < 0, stats.shape[-4] - 1, page_ids).long()
    # the fill value as a device tensor: a Python scalar would be copied
    # from the host, which a graph capture refuses
    inf = torch.full((), float("inf"), dtype=stats.dtype, device=stats.device)
    stats[..., pages, :, 0::2, :] = inf
    stats[..., pages, :, 1::2, :] = -inf


def reset_page_stats(pool: KVPool, layer: int,
                     page_ids: torch.Tensor) -> KVPool:
    """Re-initialize one layer's stats of freshly allocated pages
    (+inf/-inf), in place; ids < 0 land on the trash page."""
    if pool.k_stats is not None:
        _reset_stats_rows(pool.k_stats[layer], page_ids)
    return pool


def reset_page_stats_all_layers(pool: KVPool,
                                page_ids: torch.Tensor) -> KVPool:
    """Reset the given pages' stats across every layer at once.

    Called at the start of a step with the pages the scheduler newly
    allocated: pages are recycled dirty, and stale min/max would corrupt
    the selector's upper bounds."""
    if pool.k_stats is not None:
        _reset_stats_rows(pool.k_stats, page_ids)
    return pool


def gather_kv_for_seq(
    pool: KVPool,
    layer: int,
    block_table: torch.Tensor,  # [..., W] physical page ids
    page_size: int,
    kv_bits: int = 4,
    kv_zeros: bool = True,
):
    """Dequantize whole pages: k, v [..., W*page, H, D] f32 in token order.

    ``omniserve_tpu.ops.paged_kv.gather_kv_for_seq`` for one sequence's
    table [W]; a [B, W] table gathers B sequences at once. Plain path
    only: it materializes every listed page."""
    _check_bits(kv_bits)
    idx = block_table.long()
    bias = 8.0 if kv_bits == 4 else 128.0

    def one(data, scale, zero, pt):
        pages = data[layer][idx]                      # [..., W, H, rows, D]
        if kv_bits == 4:
            # half-split page: lo nibbles are slots [0, page/2), hi the rest
            vals = torch.cat([(pages & 0xF).float(), (pages >> 4).float()],
                             dim=-2)                  # [..., W, H, page, D]
        else:
            vals = pages.float()                      # row = slot
        if kv_bits == 16:
            out = vals
        elif kv_zeros:
            out = ((vals - zero[layer][idx][..., None])
                   * scale[layer][idx][..., None])
        else:
            out = (vals - bias) * pt[layer]
        out = out.transpose(-3, -2)                   # [..., W, page, H, D]
        return out.reshape(*out.shape[:-4], -1, *out.shape[-2:])

    return (one(pool.k_data, pool.k_scale, pool.k_zero,
                pool.k_scale_per_tensor),
            one(pool.v_data, pool.v_scale, pool.v_zero,
                pool.v_scale_per_tensor))
