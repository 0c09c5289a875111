"""Mixture-of-experts ops: top-k routing, capacity dispatch, expert GEMMs.

PyTorch counterparts of ``omniserve_tpu.ops.moe``, with the same
static-capacity design: each token's top-k experts take slots of an
[E, C, D] buffer in token order (``t * k + j``), tokens past an expert's
capacity go to one overflow slot ``E * C`` that is dropped, and the expert
outputs come back weighted by the renormalized router probabilities.

Every op keeps static shapes and never reads a value back to the host (no
``.item()``, no boolean-mask indexing, no ``nonzero``), so a decode step
that runs them can be captured in a CUDA graph and replayed. Duplicate
writes land only on the overflow slot, which is dropped.

The batched GEMMs (``*_bmm``) are the plain per-expert contracts with the
same epilogues as ``ops/matmul.py``; the served (stacked-layer) path runs
the expert GEMMs one expert at a time on the Hopper kernels instead
(``models/mixtral._expert_bmm``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omniserve_tpu_torch.ops.matmul import (
    _int8_matmul,
    _unpack_halves,
    dequant_per_group,
)


class MoERouting(NamedTuple):
    combine_weights: torch.Tensor  # [T, k] f32 renormalized top-k probs
    slot: torch.Tensor             # [T*k] int32 into E*C (+overflow E*C)
    keep: torch.Tensor             # [T*k] bool


def route_topk(
    router_logits: torch.Tensor,   # [T, E] f32
    top_k: int,
    capacity: int,
    valid: Optional[torch.Tensor] = None,   # [T] bool; False = padding row
) -> MoERouting:
    """Top-k expert choice with position-in-expert capacity slots.

    ``valid`` keeps padding and inactive rows out of the capacity count
    (they route alike and would take real tokens' slots). Among equal
    probabilities the lower expert index comes first, as ``lax.top_k``
    orders them (a stable descending sort; ``torch.topk`` leaves ties
    unordered on a card)."""
    t, e = router_logits.shape
    x = router_logits.float()
    ex = torch.exp(x - x.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(-1)                                  # [T*k]
    onehot = (flat_e[:, None] == torch.arange(
        e, device=flat_e.device)[None, :]).to(torch.int32)    # [T*k, E]
    if valid is not None:
        v_rep = _repeat_rows(valid, top_k)
        onehot = onehot * v_rep[:, None].to(torch.int32)
    pos_in_e = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=1) - 1
    keep = (pos_in_e >= 0) & (pos_in_e < capacity)
    slot = flat_e * capacity + torch.clamp(pos_in_e, 0, capacity - 1)
    slot = torch.where(keep, slot, e * capacity)              # overflow slot
    return MoERouting(topv, slot.to(torch.int32), keep)


def local_routing(routing: MoERouting, e_start: int, e_local: int,
                  capacity: int) -> MoERouting:
    """Remap a GLOBAL routing to one expert-parallel rank's local experts:
    slots of experts outside [e_start, e_start + e_local) move to the
    local overflow slot and lose their keep bit."""
    lo = e_start * capacity
    span = e_local * capacity
    rel = routing.slot - lo
    in_range = (rel >= 0) & (rel < span) & routing.keep
    slot = torch.where(in_range, rel, span)
    return MoERouting(routing.combine_weights, slot.to(torch.int32),
                      in_range)


def _repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each row ``k`` times in a row ([T, ...] -> [T*k, ...]), as
    ``jnp.repeat(x, k, axis=0)``; an expand, whose size the host knows."""
    return x.unsqueeze(1).expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


def dispatch(x: torch.Tensor, routing: MoERouting, num_experts: int,
             capacity: int) -> torch.Tensor:
    """[T, D] -> [E, C, D] (the overflow slot dropped); empty slots are
    zero."""
    d = x.shape[1]
    k = routing.combine_weights.shape[1]
    buf = x.new_zeros((num_experts * capacity + 1, d))
    buf[routing.slot.long()] = _repeat_rows(x, k)
    return buf[:-1].view(num_experts, capacity, d)


def dispatch_rows(vals: torch.Tensor, routing: MoERouting, num_experts: int,
                  capacity: int) -> torch.Tensor:
    """[T] per-token scalars -> [E, C] (e.g. act scales / act sums)."""
    k = routing.combine_weights.shape[1]
    buf = vals.new_zeros((num_experts * capacity + 1,))
    buf[routing.slot.long()] = _repeat_rows(vals, k)
    return buf[:-1].view(num_experts, capacity)


def combine(y: torch.Tensor, routing: MoERouting, t: int) -> torch.Tensor:
    """[E, C, D] expert outputs -> [T, D] f32 weighted sum over top-k."""
    e, c, d = y.shape
    flat = torch.cat([y.reshape(e * c, d), y.new_zeros((1, d))])
    gathered = flat[routing.slot.long()]                       # [T*k, D]
    k = routing.combine_weights.shape[1]
    w = routing.combine_weights.reshape(-1) * routing.keep.float()
    out = gathered.float() * w[:, None]
    return out.view(t, k, d).sum(dim=1)


# ---------------------------------------------------------------------------
# Batched (per-expert) quantized matmuls: the plain contracts
# ---------------------------------------------------------------------------


def w4a8_bmm_per_channel(
    a_i8: torch.Tensor,       # [E, C, K] int8
    qweight: torch.Tensor,    # [E, K/2, N] uint8
    s1_scales: torch.Tensor,  # [E, N]
    s1_szeros: torch.Tensor,  # [E, N]
    a_scale: torch.Tensor,    # [E, C]
    a_sum: torch.Tensor,      # [E, C]
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    k2 = qweight.shape[1]
    w_lo, w_hi = _unpack_halves(qweight)
    psum = (_int8_matmul(a_i8[:, :, :k2], w_lo)
            + _int8_matmul(a_i8[:, :, k2:], w_hi))
    out = (
        psum.float() * s1_scales[:, None, :] * a_scale[:, :, None]
        - s1_szeros[:, None, :] * a_sum[:, :, None]
    )
    return out.to(out_dtype)


def w4a8_bmm_per_group(
    a_i8: torch.Tensor,       # [E, C, K]
    qweight: torch.Tensor,    # [E, K/2, N]
    s1_scales: torch.Tensor,  # [E, N]
    s2_scales: torch.Tensor,  # [E, K/g, N] int8
    s2_zeros: torch.Tensor,   # [E, K/g, N] int8
    a_scale: torch.Tensor,    # [E, C]
    group_size: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    w_i8 = dequant_per_group(qweight, s2_scales, s2_zeros, group_size)
    psum = _int8_matmul(a_i8, w_i8)
    out = psum.float() * s1_scales[:, None, :] * a_scale[:, :, None]
    return out.to(out_dtype)


def w8a8_bmm(
    a_i8: torch.Tensor,       # [E, C, K]
    qweight: torch.Tensor,    # [E, K, N] int8
    w_scales: torch.Tensor,   # [E, N]
    a_scale: torch.Tensor,    # [E, C]
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    psum = _int8_matmul(a_i8, qweight)
    out = psum.float() * w_scales[:, None, :] * a_scale[:, :, None]
    return out.to(out_dtype)


def bf16_bmm(a: torch.Tensor, w: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """[E, C, K] x [E, K, N] bf16 with f32 accumulation (the W16A16 body):
    ``torch.bmm`` on a card, an f32 product on the CPU (whose bf16 matmul
    rounds differently), as ``ops/matmul.bf16_matmul``."""
    a = a.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a, w).to(out_dtype)
    return (a.float() @ w.float()).to(out_dtype)
