"""Paged, quantized KV cache: pool layout and the prefill append.

PyTorch counterpart of ``omniserve_tpu.ops.paged_kv`` with the same layout,
so pools compare byte for byte with the JAX package's:

- kv4 (packed): data [L, P, H, page/2, D] uint8 in the HALF-SPLIT layout:
  token t of a page lives at byte row ``t % (page/2)``, in the high nibble
  iff ``t >= page/2`` (``kv4_slot_to_row_nibble``).
- fine-grained scale planes: [L, P, 4, H, page] float32, stored folded
  (see ``KVPool``).

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

from omniserve_tpu_torch.ops.quantization import kv_quantize_fine_grained


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


def _unsupported(what: str):
    return NotImplementedError(
        f"{what} is outside what the port serves (kv4 fine-grained "
        "pools); see ROADMAP.md queue 1 item 8"
    )


def make_kv_pool(
    num_layers: int,
    num_pages: int,
    num_heads: int,
    page_size: int,
    head_dim: int,
    kv_bits: int = 4,
    kv_zeros: bool = True,
    device="cuda:0",
) -> KVPool:
    """Zeroed kv4 fine-grained pool on ``device``.

    ``num_pages`` includes the top TRASH page (the block manager reserves
    it, as in the JAX package)."""
    if kv_bits != 4 or not kv_zeros:
        raise _unsupported(f"kv{kv_bits} / kv_zeros={kv_zeros} pools")
    if page_size % 2:
        raise ValueError(f"kv4 pages need an even page size, got {page_size}")
    L, P, H, D = num_layers, num_pages, num_heads, head_dim
    shape = (L, P, H, page_size // 2, D)
    return KVPool(
        k_data=torch.zeros(shape, dtype=torch.uint8, device=device),
        v_data=torch.zeros(shape, dtype=torch.uint8, device=device),
        kv_scales=torch.zeros(
            (L, P, 4, H, page_size), dtype=torch.float32, device=device
        ),
    )


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
    page_aligned: bool = False,
) -> KVPool:
    """Quantize T tokens and write them into one layer of a pool, in place.

    Tokens with ``page_ids < 0`` are dropped. Same bytes as the JAX
    package's ``append_kv`` in every mode: ``page_aligned=True`` (chunked
    prefill: groups of ``page_size`` consecutive slots, one page per group)
    is a promise the JAX function uses to pick a faster scatter; here one
    write path serves every mode, so the flag changes nothing."""
    if kv_bits != 4 or not kv_zeros:
        raise _unsupported(f"kv{kv_bits} / kv_zeros={kv_zeros} appends")
    keep = page_ids >= 0
    page_ids, slots = page_ids[keep].long(), slots[keep].long()
    qk, k_scale, k_zero = kv_quantize_fine_grained(k[keep], kv_bits)
    qv, v_scale, v_zero = kv_quantize_fine_grained(v[keep], kv_bits)
    _scatter_nibbles(pool.k_data[layer], qk, page_ids, slots, page_size)
    _scatter_nibbles(pool.v_data[layer], qv, page_ids, slots, page_size)
    planes = (k_scale, k_scale * (k_zero + 128.0), v_scale, v_zero + 128.0)
    sc = pool.kv_scales[layer]                     # [P, 4, H, page]
    for i, vals in enumerate(planes):
        # [T] pages x [T] slots with the head dim sliced -> [T, H] values
        sc[page_ids, i, :, slots] = vals
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
    if kv_bits != 4 or not kv_zeros:
        raise _unsupported(f"kv{kv_bits} / kv_zeros={kv_zeros} gathers")
    idx = block_table.long()

    def one(data, scale, zero):
        pages = data[layer][idx]                      # [..., W, H, rows, D]
        # half-split page: lo nibbles are slots [0, page/2), hi the rest
        vals = torch.cat([(pages & 0xF).float(), (pages >> 4).float()],
                         dim=-2)                      # [..., W, H, page, D]
        out = (vals - zero[layer][idx][..., None]) * scale[layer][idx][..., None]
        out = out.transpose(-3, -2)                   # [..., W, page, H, D]
        return out.reshape(*out.shape[:-4], -1, *out.shape[-2:])

    return (one(pool.k_data, pool.k_scale, pool.k_zero),
            one(pool.v_data, pool.v_scale, pool.v_zero))
