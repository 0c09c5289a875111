"""QoQ quantization library (weights, activations, KV cache) in PyTorch.

Same numerical contracts as ``omniserve_tpu.ops.quantization`` (the
reference's QServe formats); integer results are bit-identical to it:

- W4 per-channel: ``w_u4 = round(W / s1) + zp`` in [0, 15]; stored scale
  ``s1`` and scaled zero ``s1_szero = zp * s1``. GEMM epilogue:
  ``out = psum * s1 * a_scale - s1_szero * a_sum``.
- W8 per-channel symmetric: ``w_i8 = round(W / s1)``.
- A8 per-token symmetric: ``a_i8 = round(x * 127 / amax)``.
- KV fine-grained (per-token-per-head asymmetric):
  ``scale = (max - min) / L``, ``zero = -L * min / (max - min)``,
  ``q = round(x / scale + zero)`` in [0, L], L = 15 (kv4) / 255 (kv8).

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
