"""Decode-step KV append with the optional K min/max page stats
(``csrc/kv_append.cu``).

Replaces ``omniserve_tpu/ops/pallas/kv_append.py:append_kv_decode`` (:156)
in its kv4 and kv8 modes, fine-grained or per-tensor (launches counted as
``kv_append_decode`` over fine-grained kv4, ``kv_append_decode_kv8`` over
fine-grained kv8, ``kv_append_decode_pt`` over per-tensor kv4 or kv8),
and its kv16 mode, the bf16 rows stored as they are
(``kv_append_decode_kv16``).
Its plain version, ``append_kv_decode_plain``, is the JAX package's scatter
path (``omniserve_tpu/ops/dispatch.py:136-146``): ``append_kv`` with
``unique_pages=True``, then ``update_k_stats``. What bounds the kernel and
how it is laid out is in the CUDA source's header.

Both update the pool IN PLACE. The plain version drops inactive tokens
(page id < 0); the kernel writes them to the trash page (the pool's top
page, which no sequence owns).
"""

from __future__ import annotations

import ctypes

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.paged_kv import KVPool, append_kv, update_k_stats

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "kv_append.cu"
HEAD_DIM = 128
MAX_PAGE = 256


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_kv_append_decode.argtypes = (
            [_P, _P, _I] + [_P] * 8 + [_I] * 6 + [_P]
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
    t, h, d = k.shape
    _, num_pages, hp, rows, _ = pool.k_data.shape
    kv16 = pool.k_data.dtype == torch.bfloat16
    kv_bits = 16 if kv16 else 8 if rows == page_size else 4
    pt = pool.k_scale_per_tensor is not None
    if d != HEAD_DIM or h != hp:
        raise ValueError(
            f"append kernel needs head_dim {HEAD_DIM} and one K/V row per "
            f"pool head; got head_dim {d}, {h} rows for {hp} pool heads"
        )
    if (rows * (2 if kv_bits == 4 else 1) != page_size
            or page_size > MAX_PAGE
            or (pool.kv_scales is None) != (kv16 or pt)):
        raise ValueError("append kernel serves kv4 and kv8 pools, fine-"
                         "grained or per-tensor, and kv16 pools, with pages "
                         f"of at most {MAX_PAGE} tokens; got {rows} rows of "
                         f"a {page_size}-token page")
    if k.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"k must be bf16 or f32, got {k.dtype}")
    cuda.check(k, "k", k.dtype)
    cuda.check(v, "v", k.dtype, (t, h, d))
    cuda.check(page_ids, "page_ids", torch.int32, (t,))
    cuda.check(slots, "slots", torch.int32, (t,))
    data_dtype = torch.bfloat16 if kv16 else torch.uint8
    cuda.check(pool.k_data, "k_data", data_dtype)
    cuda.check(pool.v_data, "v_data", data_dtype, pool.k_data.shape)
    planes_ptr = k_pt = v_pt = None
    if pt:
        num_layers = pool.k_data.shape[0]
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
    if update_stats and pool.k_stats is not None:
        cuda.check(pool.k_stats, "k_stats", torch.float32,
                   (pool.k_data.shape[0], num_pages, h, 2 * sub_chunks, d))
        if page_size % sub_chunks:
            raise ValueError("page size must divide into sub_chunks")
        stats_ptr = pool.k_stats[layer].data_ptr()
    err = _lib().launch_kv_append_decode(
        k.data_ptr(), v.data_ptr(), int(k.dtype == torch.float32),
        page_ids.data_ptr(), slots.data_ptr(),
        pool.k_data[layer].data_ptr(), pool.v_data[layer].data_ptr(),
        planes_ptr, k_pt, v_pt, stats_ptr, t, h, num_pages, page_size,
        sub_chunks, kv_bits, cuda.stream_handle(),
    )
    name = ("kv_append_decode_kv16" if kv16 else "kv_append_decode_pt" if pt
            else "kv_append_decode_kv8" if kv_bits == 8
            else "kv_append_decode")
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1
    return pool
