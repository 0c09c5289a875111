"""QoQ quantization library (weights, activations, KV cache) in PyTorch.

Same numerical contracts as ``omniserve_tpu.ops.quantization`` (the
reference's QServe formats); integer results are bit-identical to it:

- W4 per-channel: ``w_u4 = round(W / s1) + zp`` in [0, 15]; stored scale
  ``s1`` and scaled zero ``s1_szero = zp * s1``. GEMM epilogue:
  ``out = psum * s1 * a_scale - s1_szero * a_sum``.
- W4 per-group (progressive): stage 1 int8 per channel, ``w_i8 =
  round(W / s1)``; stage 2 uint4 per group of ``group_size`` input
  channels with int8 scale and zero, ``w_i8 ~= w_u4 * s2 + s2_zero``
  (int16 product, wrapped to int8). GEMM epilogue: ``out = psum * s1 *
  a_scale``.
- W8 per-channel symmetric: ``w_i8 = round(W / s1)``.
- A8 per-token symmetric: ``a_i8 = round(x * 127 / amax)``.
- KV fine-grained (per-token-per-head asymmetric):
  ``scale = (max - min) / L``, ``zero = -L * min / (max - min)``,
  ``q = round(x / scale + zero)`` in [0, L], L = 15 (kv4) / 255 (kv8).
- KV per-tensor (symmetric, one calibrated scale per layer and K or V):
  ``q = clip(round(x / scale), -qmax-1, qmax) + qmax+1``, qmax = 7 (kv4) /
  127 (kv8): the stored code carries a bias of 8 / 128.

Rounding is round-half-even everywhere: ``torch.round`` rounds half to
even, like ``jnp.rint``.

Packing: 4-bit values are packed two per byte with a HALF-SPLIT along the
packed axis — byte[i] holds w[i] in the low nibble and w[i + n/2] in the
high nibble — so unpacking yields two contiguous halves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INT4_LEVELS = 15
INT8_LEVELS = 255
EPS = 1e-8


class QuantizedWeightPerChannel(NamedTuple):
    """W4 per-channel: packed uint4 weights + fp scale/scaled-zero per OC."""

    qweight: torch.Tensor    # [(L,) K/2, N] uint8, half-split packed
    s1_scales: torch.Tensor  # [(L,) N] float32
    s1_szeros: torch.Tensor  # [(L,) N] float32 (= zero_point * s1)


class QuantizedWeightPerGroup(NamedTuple):
    """W4 per-group: packed uint4 + int8 second-level scale/zero per group."""

    qweight: torch.Tensor    # [(L,) K/2, N] uint8, half-split packed
    s1_scales: torch.Tensor  # [(L,) N] float32
    s2_scales: torch.Tensor  # [(L,) K/group, N] int8
    s2_zeros: torch.Tensor   # [(L,) K/group, N] int8 (= -zp * s2)


class QuantizedWeightW8(NamedTuple):
    qweight: torch.Tensor    # [(L,) K, N] int8
    scales: torch.Tensor     # [(L,) N] float32


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as IEEE division on every device. PyTorch multiplies a
    CUDA tensor by the reciprocal of a Python-scalar divisor, which can
    land one ulp away from the JAX contract (and from the kernels).

    The 0-d divisor is filled on the device (no host-to-device copy), so
    the quantizers can be captured in a CUDA graph."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def pack_int4(w_u4: torch.Tensor, dim: int = 0, shards: int = 1) -> torch.Tensor:
    """Half-split nibble packing along ``dim``: byte[i] = w[i] | w[i+n/2] << 4.

    ``shards > 1`` applies the half-split independently within each of
    ``shards`` contiguous blocks (the JAX package's tensor-parallel row
    shards)."""
    n = w_u4.shape[dim]
    assert n % (2 * shards) == 0, f"pack dim {n} not divisible by 2*{shards}"
    if shards > 1:
        return torch.cat(
            [pack_int4(part, dim) for part in w_u4.chunk(shards, dim)], dim
        )
    lo, hi = w_u4.to(torch.uint8).chunk(2, dim)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [.., n/2, ..] uint8 -> [.., n, ..] int8."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    return torch.cat([lo, hi], dim)


def quantize_weight_per_channel(
    w: torch.Tensor,
    s1_scales: Optional[torch.Tensor] = None,
    zeros: Optional[torch.Tensor] = None,
    k_shards: int = 1,
) -> QuantizedWeightPerChannel:
    """Quantize fp weight [N(out), K(in)] to uint4 per output channel.

    ``zeros`` is the INTEGER zero point; both are derived from min/max
    when not given."""
    w = w.float()
    if s1_scales is None:
        w_max = w.amax(dim=1)
        w_min = w.amin(dim=1)
        s1_scales = torch.clamp(ieee_div(w_max - w_min, INT4_LEVELS), min=EPS)
        zeros = torch.clamp(torch.round(-w_min / s1_scales), 0, INT4_LEVELS)
    assert zeros is not None
    w_u4 = torch.round(w / s1_scales[:, None]) + zeros[:, None]
    w_u4 = torch.clamp(w_u4, 0, INT4_LEVELS).to(torch.uint8)
    qweight = pack_int4(w_u4.t(), dim=0, shards=k_shards)
    return QuantizedWeightPerChannel(
        qweight=qweight.contiguous(),
        s1_scales=s1_scales.float(),
        s1_szeros=(zeros * s1_scales).float(),
    )


def quantize_weight_per_group(
    w: torch.Tensor,
    group_size: int = 128,
    s1_scales: Optional[torch.Tensor] = None,
    s2_scales: Optional[torch.Tensor] = None,
    zeros: Optional[torch.Tensor] = None,
    k_shards: int = 1,
) -> QuantizedWeightPerGroup:
    """Progressive W4 quantization of fp weight [N(out), K(in)].

    Stage 1: int8 per channel; stage 2: uint4 per group of ``group_size``
    input channels with integer int8 scales. Params not given are derived:
    stage-1 symmetric amax over 119 (stage-2 headroom), stage-2 asymmetric
    min/max of the int8 values. The integer zero point is capped at
    ``floor(127 / s2)`` so the stored ``-zeros * s2`` cannot wrap int8."""
    w = w.float()
    n_out, k_in = w.shape
    assert k_in % group_size == 0
    n_groups = k_in // group_size
    if s1_scales is None:
        s1_scales = torch.clamp(ieee_div(w.abs().amax(dim=1), 119.0),
                                min=EPS)
    w_i8 = torch.clamp(torch.round(w / s1_scales[:, None]), -128, 127)
    wg = w_i8.reshape(n_out, n_groups, group_size)
    if s2_scales is None:
        g_max = wg.amax(dim=2)
        g_min = wg.amin(dim=2)
        s2_scales = torch.ceil(torch.clamp(
            ieee_div(g_max - g_min, INT4_LEVELS), min=1.0))
        zeros = torch.clamp(torch.round(-g_min / s2_scales), 0, INT4_LEVELS)
        cap = torch.floor(torch.full_like(s2_scales, 127.0) / s2_scales)
        zeros = torch.minimum(zeros, cap)
    assert zeros is not None and s2_scales is not None
    s2_scales, zeros = s2_scales.float(), zeros.float()
    w_u4 = torch.round(wg / s2_scales[..., None]) + zeros[..., None]
    w_u4 = torch.clamp(w_u4, 0, INT4_LEVELS).to(torch.uint8)
    w_u4 = w_u4.reshape(n_out, k_in)
    qweight = pack_int4(w_u4.t(), dim=0, shards=k_shards)
    # layout [K/group, N]: the kernel indexes groups along the K axis. The
    # casts to int8 saturate, as XLA's convert does: a caller's calibrated
    # s2 / zeros can pass the int8 range (the derived ones cannot)
    return QuantizedWeightPerGroup(
        qweight=qweight.contiguous(),
        s1_scales=s1_scales.float(),
        s2_scales=_to_int8(s2_scales).t().contiguous(),
        s2_zeros=_to_int8(-zeros * s2_scales).t().contiguous(),
    )


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    """float -> int8, saturating at the ends of the range."""
    return torch.clamp(x, -128, 127).to(torch.int8)


def dequantize_per_group(q: QuantizedWeightPerGroup,
                         group_size: int) -> torch.Tensor:
    """Reconstruct fp weight [K, N] from the per-group quantized form."""
    w_u4 = unpack_int4(q.qweight, dim=0).to(torch.int32)
    k_in, n_out = w_u4.shape
    n_groups = q.s2_scales.shape[0]
    w_u4 = w_u4.reshape(n_groups, group_size, n_out)
    w_i8 = (w_u4 * q.s2_scales.to(torch.int32)[:, None, :]
            + q.s2_zeros.to(torch.int32)[:, None, :])
    return w_i8.reshape(k_in, n_out).float() * q.s1_scales[None, :]


def quantize_weight_w8(
    w: torch.Tensor, scales: Optional[torch.Tensor] = None
) -> QuantizedWeightW8:
    """Symmetric per-channel int8 quantization of fp weight [N, K]."""
    w = w.float()
    if scales is None:
        scales = torch.clamp(ieee_div(w.abs().amax(dim=1), 127.0), min=EPS)
    w_i8 = torch.clamp(torch.round(w / scales[:, None]), -128, 127)
    return QuantizedWeightW8(
        qweight=w_i8.to(torch.int8).t().contiguous(), scales=scales.float()
    )


def quantize_activations(
    x: torch.Tensor, fuse_sum: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Per-token int8 quant: returns (a_i8 [M,K], scale [M], sum [M]|None).

    ``sum`` is the per-token sum of the dequantized int8 values
    (``scale * int_sum``), which cancels the per-channel weight zero point
    in the W4A8 epilogue."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=-1), min=EPS)
    scale = ieee_div(amax, 127.0)
    a_i8 = torch.clamp(torch.round(x / scale[..., None]), -128, 127).to(
        torch.int8
    )
    a_sum = None
    if fuse_sum:
        a_sum = a_i8.float().sum(dim=-1) * scale
    return a_i8, scale, a_sum


def kv_quant_params_fine_grained(
    x: torch.Tensor, bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric per-vector quant params over the last dim."""
    levels = INT4_LEVELS if bits == 4 else INT8_LEVELS
    x = x.float()
    x_max = x.amax(dim=-1)
    x_min = x.amin(dim=-1)
    rng = torch.clamp(x_max - x_min, min=EPS)
    scale = ieee_div(rng, levels)
    zero = -levels * x_min / rng
    return scale, zero


def kv_quantize_fine_grained(
    x: torch.Tensor, bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize [..., D] to unsigned ints with per-vector scale/zero."""
    levels = INT4_LEVELS if bits == 4 else INT8_LEVELS
    scale, zero = kv_quant_params_fine_grained(x, bits)
    q = torch.round(x.float() / scale[..., None] + zero[..., None])
    q = torch.clamp(q, 0, levels).to(torch.uint8)
    return q, scale, zero


def kv_quantize_per_tensor(x: torch.Tensor, scale: torch.Tensor,
                           bits: int) -> torch.Tensor:
    """Symmetric per-tensor quant with a calibrated 0-d scale tensor (IEEE
    division on every device), stored biased to unsigned: ``q + 2^(b-1)``.
    """
    qmax = 7 if bits == 4 else 127
    q = torch.clamp(torch.round(x.float() / scale.float()), -qmax - 1, qmax)
    return (q + (qmax + 1)).to(torch.uint8)
