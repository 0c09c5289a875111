"""W4A8 per-channel, W4A8 per-group and W8A8 GEMM kernels
(``csrc/quant_gemm.cu``).

Replace ``omniserve_tpu/ops/pallas/quant_matmul.py``:
``w4a8_matmul_per_channel`` (:151), ``w4a8_matmul_per_group`` (:281) and
``w8a8_matmul`` (:406). The plain
versions they are held against are ``ops/matmul.py``'s ``*_ref``
(re-exported here as ``*_plain``). What bounds them and how the kernels
are laid out is in the CUDA source's header.

The per-channel kernel has two bodies, chosen by ``channel_plan`` from the
shapes alone (a captured launch keeps its grid): at decode M it splits K
over the blocks of a cluster, which sum their int32 partials before the one
f32 epilogue. ``channel_split_psums_plain`` and ``channel_epilogue_plain``
are the plain versions of those two steps.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.matmul import (
    _int8_matmul,
    w4a8_matmul_per_channel_ref as w4a8_matmul_per_channel_plain,
    w4a8_matmul_per_group_ref as w4a8_matmul_per_group_plain,
    w8a8_matmul_ref as w8a8_matmul_plain,
)

__all__ = [
    "channel_plan", "channel_split_psums_plain", "channel_epilogue_plain",
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
        lib.launch_w4a8_per_channel.argtypes = [_P] * 7 + [_I] * 8 + [_P]
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


# ---------------------------------------------------------------------------
# Per channel: the plan of the two bodies, and the plain split-K
# ---------------------------------------------------------------------------

STAGE_ROWS = 128      # packed weight rows (k of each K half) a stage holds
DECODE_MAX_M = 128    # the decode body serves M <= this
MAX_SPLIT = 8         # blocks of a cluster (the portable limit)


class ChannelPlan(NamedTuple):
    mt: int           # M rows a block computes
    n_wg: int         # consumer warpgroups (128 output channels each)
    splits: int       # blocks (of one cluster) that share an output tile
    per_split: int    # stages of STAGE_ROWS packed rows a block takes
    blocks: int       # the grid's block count


# resident blocks an SM holds of the decode body, by M tile (its ring)
_PER_SM = {32: 2, 64: 2, 128: 1}


def channel_plan(m: int, n: int, k: int, sm_count: int) -> ChannelPlan:
    """The per-channel kernel's tiles and split over K, from shapes alone.

    Decode (M <= 128): one warpgroup on 128 channels x an M tile of 32, 64
    or 128 rows; K/2 cut into runs of ``per_split`` stages over ``splits``
    blocks (at most 8, a cluster), so that the channel tiles times the
    splits come near one wave of resident blocks; at an M tile of 128 whose
    channel tiles alone fill that wave, two warpgroups on 256 channels, no
    split (on an H100 faster there, slower where K must be split).
    Prefill: two warpgroups on 256 channels x 128 rows, no split."""
    n_stages = max(int(k) // 2 // STAGE_ROWS, 1)
    if m <= DECODE_MAX_M:
        mt = 32 if m <= 32 else 64 if m <= 64 else 128
        n_wg = 1
        tiles = -(-int(n) // 128)
        resident = _PER_SM[mt] * int(sm_count)
        want = min(max((resident + tiles // 2) // tiles, 1), MAX_SPLIT,
                   n_stages)
        if mt == 128 and tiles >= resident:
            # the channel tiles alone fill the card: two warpgroups share
            # each activation tile (half its reloads), no split
            n_wg, tiles, want = 2, -(-int(n) // 256), 1
    else:
        mt, n_wg, want = 128, 2, 1
        tiles = -(-int(m) // 128) * -(-int(n) // 256)
    per = -(-n_stages // want)
    splits = -(-n_stages // per)
    return ChannelPlan(mt, n_wg, splits, per, tiles * splits)


def channel_split_psums_plain(a_i8, qweight, per_split: int):
    """The int32 partials of a split: for each run s of ``per_split``
    stages (``STAGE_ROWS`` packed rows each), the products of that run's
    rows of both K halves -> [S, M, N] int32 (their sum is the psum)."""
    k2 = qweight.shape[0]
    rows = per_split * STAGE_ROWS
    parts = []
    for r0 in range(0, k2, rows):
        r1 = min(k2, r0 + rows)
        w = qweight[r0:r1]
        lo = (w & 0xF).to(torch.int8)
        hi = (w >> 4).to(torch.int8)
        parts.append(_int8_matmul(a_i8[:, r0:r1], lo)
                     + _int8_matmul(a_i8[:, k2 + r0:k2 + r1], hi))
    return torch.stack(parts)


def channel_epilogue_plain(psum, s1_scales, s1_szeros, a_scale, a_sum,
                           out_dtype=torch.bfloat16):
    """The one f32 epilogue of the int32 psum, in the reference's op
    order."""
    out = (psum.float() * s1_scales[None, :] * a_scale[:, None]
           - s1_szeros[None, :] * a_sum[:, None])
    return out.to(out_dtype)


def w4a8_matmul_per_channel(a_i8, qweight, s1_scales, s1_szeros, a_scale,
                            a_sum, out_dtype=torch.bfloat16):
    """[M, K] int8 x half-split packed [K/2, N] uint4 -> [M, N], on the
    plan of ``channel_plan``. Needs K/2 % 128 == 0 and N % 16 == 0 (the
    TMA boxes' rows)."""
    k2, n = qweight.shape
    m, k = _check_common(a_i8, a_scale, s1_scales, k2, n, out_dtype)
    if k != 2 * k2:
        raise ValueError(f"a_i8 K {k} != 2 * qweight rows {k2}")
    if n % 16:
        raise ValueError(f"per-channel GEMM kernel needs N ({n}) % 16 == 0")
    cuda.check(qweight, "qweight", torch.uint8)
    cuda.check(s1_szeros, "s1_szeros", torch.float32, (n,))
    cuda.check(a_sum, "a_sum", torch.float32, (m,))
    plan = channel_plan(m, n, k, cuda.sm_count(a_i8.device))
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    err = _lib().launch_w4a8_per_channel(
        a_i8.data_ptr(), qweight.data_ptr(), s1_scales.data_ptr(),
        s1_szeros.data_ptr(), a_scale.data_ptr(), a_sum.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), m, n, k, plan.mt,
        plan.n_wg, plan.splits, plan.per_split, cuda.stream_handle(),
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
