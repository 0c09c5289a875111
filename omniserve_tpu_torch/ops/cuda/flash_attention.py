"""Packed-varlen causal flash prefill kernel (``csrc/flash_prefill.cu``).

Replaces ``omniserve_tpu/ops/pallas/flash_attention.py:flash_prefill``
(:150): dense heads (launches counted as ``flash_prefill``) and LServe's
per-head sink + local band with its tile skip (``flash_prefill_band``). The
plain version it is held against is ``ops/attention_ref.prefill_attention``
(re-exported here as ``prefill_attention_plain``). What bounds it and how
the kernel is laid out is in the CUDA source's header.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.attention_ref import (
    prefill_attention as prefill_attention_plain,
)

__all__ = ["flash_prefill", "prefill_attention_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "flash_prefill.cu"
HEAD_DIM = 128


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_flash_prefill.argtypes = (
            [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P]
        )
        lib.launch_flash_prefill.restype = _I
        lib._typed = True
    return lib


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
    when at least one kv head streams. Returns [T, Hq, D] bf16."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    if d != HEAD_DIM:
        raise ValueError(f"flash_prefill is built for head_dim {HEAD_DIM}, "
                         f"got {d}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    cuda.check(q, "q", torch.bfloat16)
    cuda.check(k, "k", torch.bfloat16, (t, hkv, d))
    cuda.check(v, "v", torch.bfloat16, (t, hkv, d))
    cuda.check(segment_ids, "segment_ids", torch.int32, (t,))
    cuda.check(positions, "positions", torch.int32, (t,))
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
    err = _lib().launch_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
        positions.data_ptr(), None if flags is None else flags.data_ptr(),
        out.data_ptr(), t, hq, hkv, int(sink_size), int(local_size),
        float(sm_scale), cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "flash_prefill")
    cuda.LAUNCHES["flash_prefill_band" if band else "flash_prefill"] += 1
    return out
