"""Quantized matmuls: W4A8 per-channel, W4A8 per-group and W8A8, and the
bf16 product of a W16A16 body.

The ``*_ref`` functions are the semantic contracts of
``omniserve_tpu.ops.matmul`` (:77-134) in PyTorch, with exact int32
accumulation; they are the plain versions the Hopper kernels
(``ops/cuda/quant_matmul.py``) are held against. The public entry points
send CUDA tensors to the kernels and CPU tensors to the plain versions.

Epilogue contracts:

- per-channel: out[m,n] = psum[m,n] * s1[n] * a_scale[m]
                          - s1_szero[n] * a_sum[m]
- per-group:   w_i8 = wrap_int8(w_u4 * s2[g, n] + s2_zero[g, n]) per
               group g of K (an int16 product in the JAX package, wrapped
               to int8 as ``astype(int8)`` does);
               out = psum * s1[n] * a_scale[m]
- w8a8:        out = psum * w_scale[n] * a_scale[m]

Stacked [L, ...] weights are indexed by layer as views (``qweight[layer]``
is no copy): the kernel reads that layer through the view's pointer.
"""

from __future__ import annotations

import torch

from omniserve_tpu_torch.ops import cuda


def _int8_matmul(a_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """[..., M, K] x [..., K, N] int8 contraction with an exact int32
    result (batched over the leading dims).

    On the CPU an int32 product; on a card (which has no int32 GEMM) a
    float64 product, exact for every int8 contraction shorter than 2^38."""
    if a_i8.is_cuda:
        return (a_i8.double() @ w_i8.double()).to(torch.int32)
    return a_i8.to(torch.int32) @ w_i8.to(torch.int32)


def _unpack_halves(qweight: torch.Tensor):
    """Half-split packed [..., K/2, N] uint8 -> (low, high) int8 halves in
    [0, 15]."""
    return (qweight & 0xF).to(torch.int8), (qweight >> 4).to(torch.int8)


def w4a8_matmul_per_channel_ref(
    a_i8: torch.Tensor,       # [M, K] int8
    qweight: torch.Tensor,    # [K/2, N] uint8 (half-split packed uint4)
    s1_scales: torch.Tensor,  # [N] f32
    s1_szeros: torch.Tensor,  # [N] f32
    a_scale: torch.Tensor,    # [M] f32
    a_sum: torch.Tensor,      # [M] f32 (scale * int8 row-sum)
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    k2 = qweight.shape[0]
    w_lo, w_hi = _unpack_halves(qweight)
    psum = _int8_matmul(a_i8[:, :k2], w_lo) + _int8_matmul(a_i8[:, k2:], w_hi)
    out = (
        psum.float() * s1_scales[None, :] * a_scale[:, None]
        - s1_szeros[None, :] * a_sum[:, None]
    )
    return out.to(out_dtype)


def dequant_per_group(qweight, s2_scales, s2_zeros, group_size):
    """Half-split packed [..., K/2, N] uint4 with per-group s2 / zeros
    [..., K/G, N] -> the [..., K, N] int8 weights: wrap_int8(w_u4 * s2 +
    zero) per group."""
    *lead, k2, n = qweight.shape
    k = 2 * k2
    w_u4 = torch.cat([qweight & 0xF, qweight >> 4], dim=-2).to(torch.int32)
    w = (w_u4.reshape(*lead, k // group_size, group_size, n)
         * s2_scales.to(torch.int32)[..., None, :]
         + s2_zeros.to(torch.int32)[..., None, :])
    # two's-complement wrap to int8, as JAX's int16 -> int8 astype
    return (((w + 128) & 0xFF) - 128).to(torch.int8).reshape(*lead, k, n)


def w4a8_matmul_per_group_ref(
    a_i8: torch.Tensor,       # [M, K] int8
    qweight: torch.Tensor,    # [K/2, N] uint8 (half-split packed uint4)
    s1_scales: torch.Tensor,  # [N] f32
    s2_scales: torch.Tensor,  # [K/group, N] int8
    s2_zeros: torch.Tensor,   # [K/group, N] int8
    a_scale: torch.Tensor,    # [M] f32
    group_size: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    psum = _int8_matmul(a_i8, dequant_per_group(qweight, s2_scales,
                                                s2_zeros, group_size))
    out = psum.float() * s1_scales[None, :] * a_scale[:, None]
    return out.to(out_dtype)


def w8a8_matmul_ref(
    a_i8: torch.Tensor,      # [M, K] int8
    qweight: torch.Tensor,   # [K, N] int8
    w_scales: torch.Tensor,  # [N] f32
    a_scale: torch.Tensor,   # [M] f32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    psum = _int8_matmul(a_i8, qweight)
    out = psum.float() * w_scales[None, :] * a_scale[:, None]
    return out.to(out_dtype)


def w4a8_matmul_per_channel(
    a_i8, qweight, s1_scales, s1_szeros, a_scale, a_sum,
    out_dtype=torch.bfloat16, layer=None,
):
    """``layer`` selects a layer of STACKED [L, ...] weights (a view)."""
    if layer is not None:
        qweight, s1_scales, s1_szeros = (
            qweight[layer], s1_scales[layer], s1_szeros[layer]
        )
    if cuda.use_kernel(a_i8):
        from omniserve_tpu_torch.ops.cuda import quant_matmul

        return quant_matmul.w4a8_matmul_per_channel(
            a_i8, qweight, s1_scales, s1_szeros, a_scale, a_sum,
            out_dtype=out_dtype,
        )
    return w4a8_matmul_per_channel_ref(
        a_i8, qweight, s1_scales, s1_szeros, a_scale, a_sum,
        out_dtype=out_dtype,
    )


def w4a8_matmul_per_group(
    a_i8, qweight, s1_scales, s2_scales, s2_zeros, a_scale, group_size=128,
    out_dtype=torch.bfloat16, layer=None,
):
    """``layer`` selects a layer of STACKED [L, ...] weights (a view)."""
    if layer is not None:
        qweight, s1_scales, s2_scales, s2_zeros = (
            qweight[layer], s1_scales[layer], s2_scales[layer],
            s2_zeros[layer],
        )
    if cuda.use_kernel(a_i8):
        from omniserve_tpu_torch.ops.cuda import quant_matmul

        return quant_matmul.w4a8_matmul_per_group(
            a_i8, qweight, s1_scales, s2_scales, s2_zeros, a_scale,
            group_size=group_size, out_dtype=out_dtype,
        )
    return w4a8_matmul_per_group_ref(
        a_i8, qweight, s1_scales, s2_scales, s2_zeros, a_scale,
        group_size=group_size, out_dtype=out_dtype,
    )


def bf16_matmul(x: torch.Tensor, weight: torch.Tensor,
                layer=None) -> torch.Tensor:
    """The W16A16 body's product: [M, K] x [K, N] bf16 with f32
    accumulation, rounded to bf16. The JAX package leaves it to XLA
    (``jnp.dot``, no Pallas kernel), so it stays a plain product here:
    ``torch.matmul`` on a card, an f32 product on the CPU (whose bf16
    matmul rounds differently)."""
    if layer is not None:
        weight = weight[layer]
    x = x.to(torch.bfloat16)
    if x.is_cuda:
        return x @ weight
    return (x.float() @ weight.float()).to(torch.bfloat16)


def w8a8_matmul(a_i8, qweight, w_scales, a_scale, out_dtype=torch.bfloat16,
                layer=None):
    if layer is not None:
        qweight, w_scales = qweight[layer], w_scales[layer]
    if cuda.use_kernel(a_i8):
        from omniserve_tpu_torch.ops.cuda import quant_matmul

        return quant_matmul.w8a8_matmul(
            a_i8, qweight, w_scales, a_scale, out_dtype=out_dtype
        )
    return w8a8_matmul_ref(a_i8, qweight, w_scales, a_scale,
                           out_dtype=out_dtype)
