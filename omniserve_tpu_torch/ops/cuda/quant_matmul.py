"""W4A8 per-channel, W4A8 per-group and W8A8 GEMM kernels
(``csrc/quant_gemm.cu``).

Replace ``omniserve_tpu/ops/pallas/quant_matmul.py``:
``w4a8_matmul_per_channel`` (:151), ``w4a8_matmul_per_group`` (:281) and
``w8a8_matmul`` (:406). The plain
versions they are held against are ``ops/matmul.py``'s ``*_ref``
(re-exported here as ``*_plain``). What bounds them and how the kernel is
laid out is in the CUDA source's header.
"""

from __future__ import annotations

import ctypes

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.matmul import (
    w4a8_matmul_per_channel_ref as w4a8_matmul_per_channel_plain,
    w4a8_matmul_per_group_ref as w4a8_matmul_per_group_plain,
    w8a8_matmul_ref as w8a8_matmul_plain,
)

__all__ = [
    "w4a8_matmul_per_channel", "w4a8_matmul_per_channel_plain",
    "w4a8_matmul_per_group", "w4a8_matmul_per_group_plain",
    "w8a8_matmul", "w8a8_matmul_plain",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "quant_gemm.cu"


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_w4a8_per_channel.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.launch_w4a8_per_channel.restype = _I
        lib.launch_w4a8_per_group.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        lib.launch_w4a8_per_group.restype = _I
        lib.launch_w8a8.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.launch_w8a8.restype = _I
        lib._typed = True
    return lib


def _check_common(a_i8, a_scale, w_scale, k_w, n, out_dtype):
    m, k = a_i8.shape
    cuda.check(a_i8, "a_i8", torch.int8)
    cuda.check(a_scale, "a_scale", torch.float32, (m,))
    cuda.check(w_scale, "w_scale", torch.float32, (n,))
    if k_w % 128 or n % 4:
        raise ValueError(
            f"quant GEMM needs the weight's K rows ({k_w}) % 128 == 0 and "
            f"N ({n}) % 4 == 0"
        )
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    return m, k


def w4a8_matmul_per_channel(a_i8, qweight, s1_scales, s1_szeros, a_scale,
                            a_sum, out_dtype=torch.bfloat16):
    """[M, K] int8 x half-split packed [K/2, N] uint4 -> [M, N]."""
    k2, n = qweight.shape
    m, k = _check_common(a_i8, a_scale, s1_scales, k2, n, out_dtype)
    if k != 2 * k2:
        raise ValueError(f"a_i8 K {k} != 2 * qweight rows {k2}")
    cuda.check(qweight, "qweight", torch.uint8)
    cuda.check(s1_szeros, "s1_szeros", torch.float32, (n,))
    cuda.check(a_sum, "a_sum", torch.float32, (m,))
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    err = _lib().launch_w4a8_per_channel(
        a_i8.data_ptr(), qweight.data_ptr(), s1_scales.data_ptr(),
        s1_szeros.data_ptr(), a_scale.data_ptr(), a_sum.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), m, n, k,
        cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "w4a8_matmul_per_channel")
    cuda.LAUNCHES["w4a8_matmul_per_channel"] += 1
    return out


def w4a8_matmul_per_group(a_i8, qweight, s1_scales, s2_scales, s2_zeros,
                          a_scale, group_size=128, out_dtype=torch.bfloat16):
    """[M, K] int8 x half-split packed [K/2, N] uint4 with per-group int8
    scales and zeros [K/group, N] -> [M, N]. Needs group_size % 32 == 0 and
    (K/2) % group_size == 0 (the plain version takes any group size); s2
    must lie in [0, 17], as the derived quantizer gives it."""
    k2, n = qweight.shape
    m, k = _check_common(a_i8, a_scale, s1_scales, k2, n, out_dtype)
    if k != 2 * k2:
        raise ValueError(f"a_i8 K {k} != 2 * qweight rows {k2}")
    if group_size <= 0 or group_size % 32 or k2 % group_size:
        raise ValueError(
            f"per-group GEMM kernel needs group_size % 32 == 0 and K/2 "
            f"({k2}) % group_size == 0, got group_size {group_size}"
        )
    cuda.check(qweight, "qweight", torch.uint8)
    cuda.check(s2_scales, "s2_scales", torch.int8, (k // group_size, n))
    cuda.check(s2_zeros, "s2_zeros", torch.int8, (k // group_size, n))
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    err = _lib().launch_w4a8_per_group(
        a_i8.data_ptr(), qweight.data_ptr(), s1_scales.data_ptr(),
        s2_scales.data_ptr(), s2_zeros.data_ptr(), a_scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), m, n, k, group_size,
        cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "w4a8_matmul_per_group")
    cuda.LAUNCHES["w4a8_matmul_per_group"] += 1
    return out


def w8a8_matmul(a_i8, qweight, w_scales, a_scale, out_dtype=torch.bfloat16):
    """[M, K] int8 x [K, N] int8 -> [M, N]."""
    k_w, n = qweight.shape
    m, k = _check_common(a_i8, a_scale, w_scales, k_w, n, out_dtype)
    if k != k_w:
        raise ValueError(f"a_i8 K {k} != qweight rows {k_w}")
    cuda.check(qweight, "qweight", torch.int8)
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    err = _lib().launch_w8a8(
        a_i8.data_ptr(), qweight.data_ptr(), w_scales.data_ptr(),
        a_scale.data_ptr(), out.data_ptr(), int(out_dtype == torch.float32),
        m, n, k, cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "w8a8_matmul")
    cuda.LAUNCHES["w8a8_matmul"] += 1
    return out
