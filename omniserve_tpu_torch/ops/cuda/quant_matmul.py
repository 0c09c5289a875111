"""W4A8 per-channel, W4A8 per-group and W8A8 GEMM kernels
(``csrc/quant_gemm.cu``).

Replace ``omniserve_tpu/ops/pallas/quant_matmul.py``:
``w4a8_matmul_per_channel`` (:151), ``w4a8_matmul_per_group`` (:281) and
``w8a8_matmul`` (:406). The plain
versions they are held against are ``ops/matmul.py``'s ``*_ref``
(re-exported here as ``*_plain``). What bounds them and how the kernels
are laid out is in the CUDA source's header.

All three run one int8 ``wgmma`` body with two shapes, chosen by
``gemm_plan`` from the mode and the shapes alone (a captured launch keeps
its grid): at decode M it splits the weight rows over the blocks of a
cluster, which sum their int32 partials before the one f32 epilogue.
``channel_split_psums_plain``, ``w8a8_split_psums_plain`` and
``group_split_psums_plain`` with ``channel_epilogue_plain`` and
``scale_epilogue_plain`` are the plain versions of those two steps. W8A8
and per group at N % 16 != 0 (no supported model's shape) take the
mma.sync body instead (``gemm_plan`` gives None).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.matmul import (
    _int8_matmul,
    dequant_per_group,
    w4a8_matmul_per_channel_ref as w4a8_matmul_per_channel_plain,
    w4a8_matmul_per_group_ref as w4a8_matmul_per_group_plain,
    w8a8_matmul_ref as w8a8_matmul_plain,
)

__all__ = [
    "MODES", "gemm_plan", "channel_plan", "weight_rows",
    "channel_split_psums_plain",
    "w8a8_split_psums_plain", "group_split_psums_plain",
    "channel_epilogue_plain", "scale_epilogue_plain",
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
        lib.launch_w4a8_per_group.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.launch_w4a8_per_group.restype = _I
        lib.launch_w8a8.argtypes = [_P] * 5 + [_I] * 8 + [_P]
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


def _check_aligned(**tensors) -> None:
    """The wgmma body's TMA and vector loads need 16-byte aligned bases (a
    stacked layer's view is, when its rows are a multiple of 16 bytes)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned for the "
                             f"wgmma GEMM body")


# ---------------------------------------------------------------------------
# The plan of the two bodies, and the plain split-K
# ---------------------------------------------------------------------------

STAGE_ROWS = 128      # weight rows a stage holds (k of each K half for W4)
DECODE_MAX_M = 128    # the decode body serves M <= this
MAX_SPLIT = 8         # blocks of a cluster (the portable limit)
MODES = ("channel", "w8", "group")   # W4 per channel, W8A8, W4 per group


class ChannelPlan(NamedTuple):
    mt: int           # M rows a block computes
    n_wg: int         # consumer warpgroups (128 output channels each)
    splits: int       # blocks (of one cluster) that share an output tile
    per_split: int    # stages of STAGE_ROWS weight rows a block takes
    blocks: int       # the grid's block count


# resident blocks an SM holds of the decode body, by M tile (the
# per-channel rings; those of W8 and per group are no larger)
_PER_SM = {32: 2, 64: 2, 128: 1}


def weight_rows(mode: str, k: int) -> int:
    """Rows of the weight the stages walk: K/2 packed rows for W4, K for
    W8."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return int(k) if mode == "w8" else int(k) // 2


def gemm_plan(mode: str, m: int, n: int, k: int,
              sm_count: int) -> Optional[ChannelPlan]:
    """The wgmma body's tiles and split over the weight rows, from the mode
    and the shapes alone; None where N % 16 != 0 (its TMA rows): W8A8 and
    per group then take the mma.sync body, per channel is refused.

    Decode (M <= 128): one warpgroup on 128 channels x an M tile of 32, 64
    or 128 rows; the weight rows' stages (``weight_rows`` / 128) cut into
    runs of ``per_split`` over ``splits`` blocks (at most 8, a cluster), so
    that the channel tiles times the splits come near one wave of resident
    blocks (a shape whose channel tiles alone fill it, as the lm_head's,
    is not split); at an M tile of 128 whose channel tiles alone fill that
    wave, two warpgroups on 256 channels, no split (on an H100 faster
    there, slower where K must be split). Prefill: two warpgroups on 256
    channels x 128 rows, no split."""
    if int(n) % 16:
        return None
    n_stages = max(weight_rows(mode, k) // STAGE_ROWS, 1)
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


def channel_plan(m: int, n: int, k: int, sm_count: int) -> ChannelPlan:
    """The per-channel kernel's plan (``gemm_plan`` of mode "channel"):
    stages of 128 packed rows of each K half."""
    return gemm_plan("channel", m, n, k, sm_count)


def _runs(rows: int, per_split: int):
    """The [r0, r1) weight rows of each split's run of stages."""
    step = per_split * STAGE_ROWS
    return [(r0, min(rows, r0 + step)) for r0 in range(0, rows, step)]


def channel_split_psums_plain(a_i8, qweight, per_split: int):
    """The int32 partials of a split: for each run s of ``per_split``
    stages (``STAGE_ROWS`` packed rows each), the products of that run's
    rows of both K halves -> [S, M, N] int32 (their sum is the psum)."""
    k2 = qweight.shape[0]
    parts = []
    for r0, r1 in _runs(k2, per_split):
        w = qweight[r0:r1]
        lo = (w & 0xF).to(torch.int8)
        hi = (w >> 4).to(torch.int8)
        parts.append(_int8_matmul(a_i8[:, r0:r1], lo)
                     + _int8_matmul(a_i8[:, k2 + r0:k2 + r1], hi))
    return torch.stack(parts)


def w8a8_split_psums_plain(a_i8, qweight, per_split: int):
    """W8A8's int32 partials: for each run of ``per_split`` stages of
    ``STAGE_ROWS`` rows of the [K, N] int8 weight, that run's product ->
    [S, M, N] int32."""
    return torch.stack([_int8_matmul(a_i8[:, r0:r1], qweight[r0:r1])
                        for r0, r1 in _runs(qweight.shape[0], per_split)])


def group_split_psums_plain(a_i8, qweight, s2_scales, s2_zeros,
                            group_size: int, per_split: int):
    """The per-group GEMM's int32 partials: the weights dequantized as the
    reference does, then for each run of ``per_split`` stages of packed
    rows, the products of that run's rows of both K halves -> [S, M, N]."""
    k2 = qweight.shape[0]
    w_i8 = dequant_per_group(qweight, s2_scales, s2_zeros, group_size)
    return torch.stack([
        _int8_matmul(a_i8[:, r0:r1], w_i8[r0:r1])
        + _int8_matmul(a_i8[:, k2 + r0:k2 + r1], w_i8[k2 + r0:k2 + r1])
        for r0, r1 in _runs(k2, per_split)])


def channel_epilogue_plain(psum, s1_scales, s1_szeros, a_scale, a_sum,
                           out_dtype=torch.bfloat16):
    """The one f32 epilogue of the int32 psum, in the reference's op
    order."""
    out = (psum.float() * s1_scales[None, :] * a_scale[:, None]
           - s1_szeros[None, :] * a_sum[:, None])
    return out.to(out_dtype)


def scale_epilogue_plain(psum, w_scale, a_scale, out_dtype=torch.bfloat16):
    """The one f32 epilogue of W8A8 and per group (w_scale is s1 there), in
    the reference's op order."""
    out = psum.float() * w_scale[None, :] * a_scale[:, None]
    return out.to(out_dtype)


def _plan_args(plan: Optional[ChannelPlan]):
    return (0, 0, 1, 1) if plan is None else (
        plan.mt, plan.n_wg, plan.splits, plan.per_split)


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
        out.data_ptr(), int(out_dtype == torch.float32), m, n, k,
        *_plan_args(plan), cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "w4a8_matmul_per_channel")
    cuda.LAUNCHES[cuda.gemm_launch_name("w4a8_matmul_per_channel")] += 1
    return out


def w4a8_matmul_per_group(a_i8, qweight, s1_scales, s2_scales, s2_zeros,
                          a_scale, group_size=128, out_dtype=torch.bfloat16):
    """[M, K] int8 x half-split packed [K/2, N] uint4 with per-group int8
    scales and zeros [K/group, N] -> [M, N], on the plan of ``gemm_plan``
    (mode "group"). Needs group_size % 32 == 0 and (K/2) % group_size == 0
    (the plain version takes any group size); s2 must lie in [0, 17], as
    the derived quantizer gives it."""
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
    plan = gemm_plan("group", m, n, k, cuda.sm_count(a_i8.device))
    if plan is not None:
        _check_aligned(a_i8=a_i8, qweight=qweight, s1_scales=s1_scales,
                       s2_scales=s2_scales, s2_zeros=s2_zeros)
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    err = _lib().launch_w4a8_per_group(
        a_i8.data_ptr(), qweight.data_ptr(), s1_scales.data_ptr(),
        s2_scales.data_ptr(), s2_zeros.data_ptr(), a_scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), m, n, k, group_size,
        *_plan_args(plan), cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "w4a8_matmul_per_group")
    cuda.LAUNCHES[cuda.gemm_launch_name("w4a8_matmul_per_group")] += 1
    return out


def w8a8_matmul(a_i8, qweight, w_scales, a_scale, out_dtype=torch.bfloat16):
    """[M, K] int8 x [K, N] int8 -> [M, N], on the plan of ``gemm_plan``
    (mode "w8")."""
    k_w, n = qweight.shape
    m, k = _check_common(a_i8, a_scale, w_scales, k_w, n, out_dtype)
    if k != k_w:
        raise ValueError(f"a_i8 K {k} != qweight rows {k_w}")
    cuda.check(qweight, "qweight", torch.int8)
    plan = gemm_plan("w8", m, n, k, cuda.sm_count(a_i8.device))
    if plan is not None:
        _check_aligned(a_i8=a_i8, qweight=qweight, w_scales=w_scales)
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    err = _lib().launch_w8a8(
        a_i8.data_ptr(), qweight.data_ptr(), w_scales.data_ptr(),
        a_scale.data_ptr(), out.data_ptr(), int(out_dtype == torch.float32),
        m, n, k, *_plan_args(plan), cuda.stream_handle(),
    )
    cuda.raise_on_error(err, "w8a8_matmul")
    cuda.LAUNCHES[cuda.gemm_launch_name("w8a8_matmul")] += 1
    return out
