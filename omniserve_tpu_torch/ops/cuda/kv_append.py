"""Decode-step KV append with the optional K min/max page stats
(``csrc/kv_append.cu``).

Replaces ``omniserve_tpu/ops/pallas/kv_append.py:append_kv_decode`` (:156)
in its kv4 and kv8 modes, fine-grained or per-tensor (launches counted as
``kv_append_decode`` over fine-grained kv4, ``kv_append_decode_kv8`` over
fine-grained kv8, ``kv_append_decode_pt`` over per-tensor kv4 or kv8),
and its kv16 mode, the bf16 rows stored as they are
(``kv_append_decode_kv16``), at head_dim 64 or 128 (``_d64`` appended to
the name at 64). Two entries launch the one kernel:
``append_kv_decode`` writes one pool; ``append_kv_decode_pools`` writes
LServe's retrieval and streaming pools in one launch, each pool row
reading its kv head's K and V rows through the pool's row -> head map
(``decode_attention.pool_head_sources``), so no head gather runs before
it. Either counts one launch under the pool mode's name.
Their plain versions, ``append_kv_decode_plain`` and
``append_kv_decode_pools_plain``, are the JAX package's scatter path
(``omniserve_tpu/ops/dispatch.py:136-146``): ``append_kv`` with
``unique_pages=True``, then ``update_k_stats``, once per pool. What bounds
the kernel and how it is laid out is in the CUDA source's header.

Both update the pools IN PLACE. The plain versions drop inactive tokens
(page id < 0); the kernel writes them to the trash page (the pool's top
page, which no sequence owns).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.paged_kv import KVPool, append_kv, update_k_stats

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "kv_append.cu"
MAX_PAGE = cuda.MAX_PAGE
_NO_POOL = (None,) * 9 + (0, 0)


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_kv_append_decode.argtypes = (
            [_P, _P] + [_I] * 7 + ([_P] * 9 + [_I, _I]) * 2 + [_I, _P]
        )
        lib.launch_kv_append_decode.restype = _I
        lib._typed = True
    return lib


def append_kv_decode_plain(
    pool: KVPool, layer: int, k, v, page_ids, slots, page_size: int,
    update_stats: bool = False, sub_chunks: int = 4, kv_bits: int = 4,
    kv_zeros: bool = True,
) -> KVPool:
    """Plain version: scatter append, then the stats merge."""
    append_kv(pool, layer, k, v, page_ids, slots, page_size, kv_bits=kv_bits,
              kv_zeros=kv_zeros, unique_pages=True)
    if update_stats and pool.k_stats is not None:
        update_k_stats(pool, layer, k, page_ids, slots, page_size,
                       sub_chunks)
    return pool


def append_kv_decode_pools_plain(
    retrieval_pool: KVPool, streaming_pool: Optional[KVPool], layer: int, k,
    v, retrieval, streaming, page_size: int, update_stats: bool = False,
    sub_chunks: int = 4, kv_bits: int = 4, kv_zeros: bool = True,
) -> Tuple[KVPool, Optional[KVPool]]:
    """Plain version of the two-pool entry: each pool's head gather, then
    ``append_kv_decode_plain`` into it (stats into the retrieval pool
    only)."""
    pages, slots, src = retrieval
    append_kv_decode_plain(retrieval_pool, layer, k[:, src], v[:, src],
                           pages, slots, page_size, update_stats, sub_chunks,
                           kv_bits, kv_zeros)
    if streaming_pool is not None:
        pages, slots, src = streaming
        append_kv_decode_plain(streaming_pool, layer, k[:, src], v[:, src],
                               pages, slots, page_size, kv_bits=kv_bits,
                               kv_zeros=kv_zeros)
    return retrieval_pool, streaming_pool


def _pool_mode(pool: KVPool, page_size: int):
    """(kv_bits, per-tensor) of a pool, from its page rows and dtype."""
    rows = pool.k_data.shape[3]
    kv16 = pool.k_data.dtype == torch.bfloat16
    kv_bits = 16 if kv16 else 8 if rows == page_size else 4
    pt = pool.k_scale_per_tensor is not None
    if (rows * (2 if kv_bits == 4 else 1) != page_size
            or page_size > MAX_PAGE
            or (pool.kv_scales is None) != (kv16 or pt)):
        raise ValueError("append kernel serves kv4 and kv8 pools, fine-"
                         "grained or per-tensor, and kv16 pools, with pages "
                         f"of at most {MAX_PAGE} tokens; got {rows} rows of "
                         f"a {page_size}-token page")
    return kv_bits, pt


def _side(pool: KVPool, layer: int, page_ids, slots, src, h_in: int,
          stats: bool, sub_chunks: int):
    """The C arguments of one pool: its layer's tensors, targets and
    row -> head map (null: row h takes head h)."""
    num_layers, num_pages, hp, _, d = pool.k_data.shape
    t = page_ids.shape[0]
    cuda.check(page_ids, "page_ids", torch.int32, (t,))
    cuda.check(slots, "slots", torch.int32, (t,))
    if src is None:
        if hp != h_in:
            raise ValueError(f"append kernel: {h_in} K/V heads for {hp} pool "
                             "rows needs a row -> head map")
    else:
        cuda.check(src, "src", torch.int64, (hp,))
    kv16 = pool.k_data.dtype == torch.bfloat16
    data_dtype = torch.bfloat16 if kv16 else torch.uint8
    cuda.check(pool.k_data, "k_data", data_dtype)
    cuda.check(pool.v_data, "v_data", data_dtype, pool.k_data.shape)
    planes_ptr = k_pt = v_pt = None
    if pool.k_scale_per_tensor is not None:
        cuda.check(pool.k_scale_per_tensor, "k_scale_per_tensor",
                   torch.float32, (num_layers,))
        cuda.check(pool.v_scale_per_tensor, "v_scale_per_tensor",
                   torch.float32, (num_layers,))
        # device addresses of this layer's scales: never read on the host
        k_pt = pool.k_scale_per_tensor[layer].data_ptr()
        v_pt = pool.v_scale_per_tensor[layer].data_ptr()
    elif not kv16:
        cuda.check(pool.kv_scales, "kv_scales", torch.float32)
        planes_ptr = pool.kv_scales[layer].data_ptr()
    stats_ptr = None
    if stats and pool.k_stats is not None:
        cuda.check(pool.k_stats, "k_stats", torch.float32,
                   (num_layers, num_pages, hp, 2 * sub_chunks, d))
        stats_ptr = pool.k_stats[layer].data_ptr()
    return (pool.k_data[layer].data_ptr(), pool.v_data[layer].data_ptr(),
            planes_ptr, k_pt, v_pt, stats_ptr, page_ids.data_ptr(),
            slots.data_ptr(), None if src is None else src.data_ptr(), hp,
            num_pages)


def _rows(x: torch.Tensor, name: str, dtype) -> Tuple[torch.Tensor, int]:
    """x [T, H, D] as the kernel reads it: heads D apart, tokens `stride`
    apart (a view of the fused qkv output stays in place)."""
    if x.dtype != dtype or not x.is_cuda:
        cuda.check(x, name, dtype)
    align = 16 if dtype == torch.float32 else 8
    if (x.stride(2) != 1 or x.stride(1) != x.shape[2] or x.stride(0) % 4
            or x.data_ptr() % align):
        x = x.contiguous()
    return x, x.stride(0)


def _launch(k, v, page_size: int, sub_chunks: int, kv_bits: int, side_a,
            side_b, name: str) -> None:
    t, _, d = k.shape
    cuda.check_head_dim(d, "append kernel")
    if k.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"k must be bf16 or f32, got {k.dtype}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v must have shape {tuple(k.shape)}, got "
                         f"{tuple(v.shape)}")
    if page_size % sub_chunks:
        raise ValueError("page size must divide into sub_chunks")
    k, k_stride = _rows(k, "k", k.dtype)
    v, v_stride = _rows(v, "v", k.dtype)
    err = _lib().launch_kv_append_decode(
        k.data_ptr(), v.data_ptr(), int(k.dtype == torch.float32), k_stride,
        v_stride, t, page_size, sub_chunks, kv_bits, *side_a, *side_b, d,
        cuda.stream_handle(),
    )
    name = cuda.launch_name(name, d)
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1


def launch_name(kv_bits: int, pt: bool, head_dim: int = 128) -> str:
    """The ``LAUNCHES`` entry of a pool mode (``_d64`` at head_dim 64)."""
    return cuda.launch_name(
        "kv_append_decode_kv16" if kv_bits == 16
        else "kv_append_decode_pt" if pt
        else "kv_append_decode_kv8" if kv_bits == 8
        else "kv_append_decode", head_dim)


def append_kv_decode(
    pool: KVPool,
    layer: int,
    k: torch.Tensor,         # [T, H, D] bf16 or f32
    v: torch.Tensor,         # [T, H, D]
    page_ids: torch.Tensor,  # [T] int32 (-1 = inactive)
    slots: torch.Tensor,     # [T] int32
    page_size: int,
    update_stats: bool = False,
    sub_chunks: int = 4,
) -> KVPool:
    """Kernel: write one token per sequence into its page: kv4 / kv8
    quantized (fine-grained codes and plane lanes, or per-tensor codes with
    the layer's scales, read on the device), kv16 as bf16 rows; with
    ``update_stats``, also the K min/max rows. Tokens must target distinct
    pages. The pool's width comes from its page rows and dtype."""
    kv_bits, pt = _pool_mode(pool, page_size)
    side = _side(pool, layer, page_ids, slots, None, k.shape[1],
                 update_stats, sub_chunks)
    _launch(k, v, page_size, sub_chunks, kv_bits, side, _NO_POOL,
            launch_name(kv_bits, pt))
    return pool


def append_kv_decode_pools(
    retrieval_pool: KVPool,
    streaming_pool: Optional[KVPool],
    layer: int,
    k: torch.Tensor,         # [T, Hkv, D] bf16 or f32, all kv heads
    v: torch.Tensor,         # [T, Hkv, D]
    retrieval,               # (page_ids [T], slots [T] int32, src [Hr] int64)
    streaming,               # the same for the streaming pool, or None
    page_size: int,
    update_stats: bool = False,
    sub_chunks: int = 4,
) -> Tuple[KVPool, Optional[KVPool]]:
    """Kernel, one launch: the step's token into both of LServe's pools,
    pool row h of each taking kv head ``src[h]`` of ``k`` / ``v`` (read in
    place); with ``update_stats``, the K min/max rows of the retrieval pool.
    Both pools in one KV mode; tokens target distinct pages of each pool.
    No host sync: safe inside a captured decode step."""
    kv_bits, pt = _pool_mode(retrieval_pool, page_size)
    h_in = k.shape[1]
    side_a = _side(retrieval_pool, layer, *retrieval, h_in, update_stats,
                   sub_chunks)
    side_b = _NO_POOL
    if streaming_pool is not None:
        if _pool_mode(streaming_pool, page_size) != (kv_bits, pt):
            raise ValueError("append kernel: both pools must share a KV "
                             "mode")
        side_b = _side(streaming_pool, layer, *streaming, h_in, False,
                       sub_chunks)
    _launch(k, v, page_size, sub_chunks, kv_bits, side_a, side_b,
            launch_name(kv_bits, pt))
    return retrieval_pool, streaming_pool
