"""Chunked-prefill attention over the paged kv4 pool
(``csrc/paged_prefill.cu``).

Replaces ``omniserve_tpu/ops/pallas/paged_prefill.py:paged_prefill_attention``
(:268, kernel ``_prefill_kernel`` :39) for dense heads over a kv4
fine-grained pool. The plain version it is held against is
``ops/attention_ref.paged_prefill_attention`` (``paged_prefill_attention_plain``
below). What bounds the kernel and how it is laid out is in the CUDA
source's header.
"""

from __future__ import annotations

import ctypes

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import attention_ref, cuda
from omniserve_tpu_torch.ops.paged_kv import KVPool

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "paged_prefill.cu"
HEAD_DIM = 128
N_REPS = (1, 2, 4, 8)


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_paged_prefill.argtypes = (
            [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P]
        )
        lib.launch_paged_prefill.restype = _I
        lib._typed = True
    return lib


def paged_prefill_attention_plain(q, pool: KVPool, layer: int, block_tables,
                                  q_positions, context_lens, *,
                                  sm_scale: float, page_size: int):
    """Plain version: ``attention_ref.paged_prefill_attention``."""
    return attention_ref.paged_prefill_attention(
        q, pool, layer, block_tables, q_positions, context_lens, sm_scale,
        page_size, kv_bits=4, kv_zeros=True,
    )


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
) -> torch.Tensor:
    """Kernel: causal GQA attention of the chunk over the pool, reading the
    pages in place. Returns [B, Tc, Hq, D] bf16."""
    b, tc, hq, d = q.shape
    _, _, hkv, rows, _ = pool.k_data.shape
    n_rep = hq // hkv
    if d != HEAD_DIM or n_rep * hkv != hq or n_rep not in N_REPS:
        raise ValueError(
            f"paged prefill kernel needs head_dim {HEAD_DIM} and n_rep in "
            f"{N_REPS}; got head_dim {d}, {hq} q / {hkv} kv heads"
        )
    if rows * 2 != page_size or pool.kv_scales is None:
        raise ValueError("paged prefill kernel serves kv4 fine-grained pools")
    cuda.check(q, "q", torch.bfloat16)
    cuda.check(pool.k_data, "k_data", torch.uint8)
    cuda.check(pool.v_data, "v_data", torch.uint8, pool.k_data.shape)
    cuda.check(pool.kv_scales, "kv_scales", torch.float32)
    cuda.check(block_tables, "block_tables", torch.int32)
    cuda.check(q_positions, "q_positions", torch.int32, (b, tc))
    cuda.check(context_lens, "context_lens", torch.int32, (b,))
    if block_tables.shape[0] != b:
        raise ValueError("block_tables rows != batch")
    out = torch.empty_like(q)
    if b == 0 or tc == 0:
        return out
    err = _lib().launch_paged_prefill(
        q.data_ptr(), pool.k_data[layer].data_ptr(),
        pool.v_data[layer].data_ptr(), pool.kv_scales[layer].data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), b, tc, hkv, n_rep,
        page_size, block_tables.shape[1], float(sm_scale),
        cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "paged_prefill_attention")
    cuda.LAUNCHES["paged_prefill_attention"] += 1
    return out
