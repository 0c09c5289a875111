"""Embedding row gather of the decode step (``csrc/embed_gather.cu``).

Replaces ``omniserve_tpu/ops/pallas/embed_gather.py:embed_gather`` (:46,
kernel ``_kernel`` :26): ``table[clamp(ids, 0, V - 1)]``, launches counted as
``embed_gather``. The plain version it is held against is
``embed_gather_plain`` below. The launch neither syncs with the host nor
allocates outside torch's allocator, so the decode windows capture it into
their CUDA graphs. What bounds the kernel and how it is laid out is in the
CUDA source's header.
"""

from __future__ import annotations

import ctypes

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "embed_gather.cu"
_DTYPES = (torch.bfloat16, torch.float32)
_ID_DTYPES = (torch.int32, torch.int64)


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_embed_gather.argtypes = [_P, _P, _P, ctypes.c_longlong,
                                            _I, _I, _I, _P]
        lib.launch_embed_gather.restype = _I
        lib._typed = True
    return lib


def embed_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[clamp(ids, 0, V - 1)]``."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Kernel: rows ``table[clamp(ids, 0, V - 1)]`` of a [V, D] bf16 / f32
    table for [B] int32 / int64 ids. Returns [B, D] of the table's dtype."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"embed gather takes a [V, D] table and [B] ids; "
                         f"got {tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype not in _DTYPES or ids.dtype not in _ID_DTYPES:
        raise TypeError(f"embed gather takes a {_DTYPES} table and "
                        f"{_ID_DTYPES} ids; got {table.dtype}, {ids.dtype}")
    cuda.check(table, "table", table.dtype)
    cuda.check(ids, "ids", ids.dtype)
    v, d = table.shape
    row_bytes = d * table.element_size()
    if v == 0 or row_bytes % 16:
        raise ValueError(f"embed gather needs a non-empty table with rows of "
                         f"a multiple of 16 bytes; got {tuple(table.shape)} "
                         f"{table.dtype}")
    b = ids.shape[0]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0:
        return out
    err = _lib().launch_embed_gather(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), v, row_bytes, b,
        ids.element_size(), cuda.stream_handle())
    cuda.raise_on_error(err, "embed_gather")
    cuda.LAUNCHES["embed_gather"] += 1
    return out
