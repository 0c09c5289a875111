"""The port's MoE ops (``omniserve_tpu_torch/ops/moe.py``) and MoE block
(``models/mixtral.moe_mlp``) against the JAX package's (CPU).

Mirrors ``tests/test_mixtral.py``: routing (slots and keep bits equal,
combine weights within 1e-6), dispatch / dispatch_rows / combine /
local_routing equal on the same routing, capacity drops, padding rows
that take no capacity, the four plain batched GEMMs (int32 accumulations
equal, f32 outputs within 1e-5), and the MoE block in all four bodies:
the port's served path (one stacked-layer GEMM per expert) equal to its
batched path, and both against the JAX block run op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.models import mixtral as j_mixtral
from omniserve_tpu.ops import moe as j_moe
from omniserve_tpu_torch.models import mixtral as t_mixtral
from omniserve_tpu_torch.models.convert import params_from_numpy
from omniserve_tpu_torch.ops import moe as t_moe
from omniserve_tpu_torch.ops.matmul import _int8_matmul

WEIGHT_RTOL = 1e-6     # combine weights
BMM_RTOL = 1e-5        # the batched GEMMs' f32 outputs


def _t(a):
    return torch.from_numpy(np.array(a))


def routing_pair(t, e, k, cap, seed, valid=None, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32) * 2
    if ties:    # whole rows of equal logits: the lower index first
        logits[::3] = 0.5
    jr = j_moe.route_topk(jnp.asarray(logits), k, cap,
                          valid=None if valid is None else jnp.asarray(valid))
    tr = t_moe.route_topk(_t(logits), k, cap,
                          valid=None if valid is None else _t(valid))
    return jr, tr


def assert_routing_equal(tr, jr):
    np.testing.assert_array_equal(tr.slot.numpy(), np.asarray(jr.slot))
    np.testing.assert_array_equal(tr.keep.numpy(), np.asarray(jr.keep))
    np.testing.assert_allclose(tr.combine_weights.numpy(),
                               np.asarray(jr.combine_weights),
                               rtol=WEIGHT_RTOL, atol=WEIGHT_RTOL)
    assert tr.slot.dtype == torch.int32 and tr.keep.dtype == torch.bool


@pytest.mark.parametrize("t,e,k,cap,masked,ties", [
    (24, 8, 2, 8, False, False),
    (24, 8, 2, 8, True, False),
    (40, 4, 2, 8, False, True),     # drops: 80 choices over 32 slots
    (16, 8, 1, 8, True, True),
    (33, 6, 3, 16, True, False),
])
def test_route_topk_matches_jax(t, e, k, cap, masked, ties):
    valid = None
    if masked:
        valid = np.random.default_rng(t).random(t) > 0.3
    jr, tr = routing_pair(t, e, k, cap, seed=t + e, valid=valid, ties=ties)
    assert_routing_equal(tr, jr)
    # every kept slot is unique and inside its expert's capacity
    kept = tr.slot.numpy()[tr.keep.numpy()]
    assert len(set(kept)) == len(kept) and (kept < e * cap).all()


def test_dispatch_combine_local_routing_match_jax():
    t, d, e, k, cap = 20, 48, 4, 2, 8
    jr, tr = routing_pair(t, e, k, cap, seed=3,
                          valid=np.arange(t) % 5 != 0)
    assert_routing_equal(tr, jr)
    rng = np.random.default_rng(1)
    x_i8 = rng.integers(-128, 128, (t, d), dtype=np.int8)
    x_bf = jnp.asarray(rng.standard_normal((t, d)), jnp.bfloat16)
    scale = rng.random(t).astype(np.float32)
    # the same routing into both (the one routing held equal above)
    t_same = t_moe.MoERouting(_t(np.asarray(jr.combine_weights)),
                              _t(np.asarray(jr.slot)),
                              _t(np.asarray(jr.keep)))
    np.testing.assert_array_equal(
        t_moe.dispatch(_t(x_i8), t_same, e, cap).numpy(),
        np.asarray(j_moe.dispatch(jnp.asarray(x_i8), jr, e, cap)))
    got_bf = t_moe.dispatch(_t(np.asarray(x_bf, np.float32)).to(
        torch.bfloat16), t_same, e, cap)
    np.testing.assert_array_equal(
        got_bf.float().numpy(),
        np.asarray(j_moe.dispatch(x_bf, jr, e, cap), np.float32))
    np.testing.assert_array_equal(
        t_moe.dispatch_rows(_t(scale), t_same, e, cap).numpy(),
        np.asarray(j_moe.dispatch_rows(jnp.asarray(scale), jr, e, cap)))
    y = jnp.asarray(rng.standard_normal((e, cap, d)), jnp.bfloat16)
    got = t_moe.combine(_t(np.asarray(y, np.float32)).to(torch.bfloat16),
                        t_same, t)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_moe.combine(y, jr, t)))
    # expert-parallel ranks: the same remap, every kept slot on one rank
    kept_total = 0
    for rank in range(2):
        jl = j_moe.local_routing(jr, rank * 2, 2, cap)
        tl = t_moe.local_routing(t_same, rank * 2, 2, cap)
        assert_routing_equal(tl, jl)
        kept_total += int(tl.keep.sum())
    assert kept_total == int(tr.keep.sum())


def test_routing_capacity_drops():
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]]).repeat(12, 1)
    routing = t_moe.route_topk(logits, top_k=1, capacity=8)
    # all 12 tokens pick expert 0; only the first 8 fit
    assert int(routing.keep.sum()) == 8
    assert routing.keep[:8].all() and not routing.keep[8:].any()
    assert (routing.slot[8:] == 4 * 8).all()       # the overflow slot


def test_padding_rows_do_not_consume_capacity():
    """12 padding rows before 4 real tokens, all preferring expert 0 (the
    rectangular chunk layout): masked, the real tokens keep their slots."""
    t, e, k, cap = 16, 8, 2, 8
    logits = torch.full((t, e), -10.0)
    logits[:, 0] = 5.0
    logits[:, 1] = 1.0
    valid = torch.zeros(t, dtype=torch.bool)
    valid[12:] = True
    keep = t_moe.route_topk(logits, k, cap, valid=valid).keep.view(t, k)
    assert keep[12:].all(), "real tokens were evicted by padding rows"
    assert not keep[:12].any(), "padding rows occupied expert slots"
    keep_u = t_moe.route_topk(logits, k, cap).keep.view(t, k)
    assert not keep_u[12:, 0].any()   # the failure mode without the mask


def bmm_inputs(seed, e=3, c=8, k=64, n=48):
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (e, c, k), dtype=np.int8)
    a_scale = rng.random((e, c)).astype(np.float32)
    a[:, -2:] = 0           # empty capacity rows: no codes, no scale
    a_scale[:, -2:] = 0
    return rng, a, a_scale


def test_int8_bmm_matches_jax():
    rng, a, _ = bmm_inputs(0)
    w = rng.integers(-128, 128, (3, 64, 48), dtype=np.int8)
    got = _int8_matmul(_t(a), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_moe._int8_bmm(jnp.asarray(a),
                                                jnp.asarray(w))))


@pytest.mark.parametrize("body", ["per_channel", "per_group", "w8a8",
                                  "bf16"])
def test_bmm_matches_jax(body):
    rng, a, a_scale = bmm_inputs(1)
    e, c, k = a.shape
    n = 48
    f32 = dict(out_dtype=jnp.float32)
    if body == "per_channel":
        qw = rng.integers(0, 256, (e, k // 2, n), dtype=np.uint8)
        s1 = rng.random((e, n)).astype(np.float32) * 1e-2
        sz = 8 * s1
        a_sum = rng.random((e, c)).astype(np.float32) * (a_scale > 0)
        args = (a, qw, s1, sz, a_scale, a_sum)
        want = j_moe.w4a8_bmm_per_channel(*map(jnp.asarray, args), **f32)
        got = t_moe.w4a8_bmm_per_channel(*map(_t, args),
                                         out_dtype=torch.float32)
    elif body == "per_group":
        qw = rng.integers(0, 256, (e, k // 2, n), dtype=np.uint8)
        s1 = rng.random((e, n)).astype(np.float32) * 1e-2
        s2 = rng.integers(1, 18, (e, k // 32, n), dtype=np.int8)
        sz = (-8 * s2).astype(np.int8)
        args = (a, qw, s1, s2, sz, a_scale)
        want = j_moe.w4a8_bmm_per_group(*map(jnp.asarray, args),
                                        group_size=32, **f32)
        got = t_moe.w4a8_bmm_per_group(*map(_t, args), group_size=32,
                                       out_dtype=torch.float32)
    elif body == "w8a8":
        qw = rng.integers(-128, 128, (e, k, n), dtype=np.int8)
        ws = rng.random((e, n)).astype(np.float32) * 1e-2
        args = (a, qw, ws, a_scale)
        want = j_moe.w8a8_bmm(*map(jnp.asarray, args), **f32)
        got = t_moe.w8a8_bmm(*map(_t, args), out_dtype=torch.float32)
    else:
        x = jnp.asarray(rng.standard_normal((e, c, k)), jnp.bfloat16)
        w = jnp.asarray(rng.standard_normal((e, k, n)) * 0.1, jnp.bfloat16)
        want = j_moe.bf16_bmm(x, w, out_dtype=jnp.float32)
        got = t_moe.bf16_bmm(_t(np.asarray(x, np.float32)),
                             _t(np.asarray(w, np.float32)).to(torch.bfloat16),
                             out_dtype=torch.float32)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=BMM_RTOL,
                               atol=BMM_RTOL * np.abs(want).max())
    if body != "bf16":      # empty capacity rows stay zero, no NaN
        assert (got[:, -2:] == 0).all()


BODIES = {
    "w4a8": dict(weight_bits=4, act_bits=8),
    "w4a8-g32": dict(weight_bits=4, act_bits=8, group_size=32),
    "w8a8": dict(weight_bits=8, act_bits=8),
    "w16a16": dict(weight_bits=16, act_bits=16),
}


def moe_spec_kwargs(**extra):
    kw = dict(num_layers=2, hidden=64, intermediate=96, num_q_heads=4,
              num_kv_heads=2, head_dim=16, vocab=128, kv_bits=16,
              kv_zeros=False, page_size=16, num_experts=4, top_k=2)
    kw.update(extra)
    return kw


@pytest.mark.parametrize("body", list(BODIES))
def test_moe_mlp_matches_jax(body):
    """The MoE block on 24 rows (4 of them padding) of layer 1 of the JAX
    draw carried across: the port's stacked-layer path equals its batched
    path, and both equal the JAX block run op by op (its scanned path, one
    GEMM per expert)."""
    kw = moe_spec_kwargs(**BODIES[body])
    jspec = j_mixtral.MixtralSpec(**kw)
    tspec = t_mixtral.MixtralSpec(**kw)
    jparams = j_mixtral.make_random_params(jspec, seed=2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    t = 24
    h = jnp.asarray(rng.standard_normal((t, 64)), jnp.bfloat16)
    valid = np.arange(t) < 20
    with jax.disable_jit():
        want = j_mixtral.moe_mlp(h, jparams["layers"], jspec, layer=1,
                                 valid=jnp.asarray(valid))
    want = np.asarray(want, np.float32)
    th = _t(np.asarray(h, np.float32)).to(torch.bfloat16)
    lp = tparams["layers"]
    got = t_mixtral.moe_mlp(th, lp, tspec, layer=1, valid=_t(valid))
    one = {name: (a[1] if isinstance(a, torch.Tensor)
                  else type(a)(*(f[1] for f in a)))
           for name, a in lp.items()}
    batched = t_mixtral.moe_mlp(th, one, tspec, valid=_t(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  batched.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("body", list(BODIES))
def test_quantize_expert_stack_matches_jax(body):
    """[L, E, N, K] fp expert stacks quantized one (layer, expert) at a
    time, as the HF loader quantizes each matrix it reads: byte for byte
    the JAX package's ``_quantize_expert_stack`` (op by op)."""
    kw = moe_spec_kwargs(**BODIES[body])
    w = (np.random.default_rng(9).standard_normal((2, 3, 48, 64))
         * 0.02).astype(np.float32)
    with jax.disable_jit():
        want = j_mixtral._quantize_expert_stack(w, j_mixtral.MixtralSpec(**kw))
    got = t_mixtral.quantize_expert_stack(w, t_mixtral.MixtralSpec(**kw),
                                          device="cpu")
    pairs = ([(got, want)] if isinstance(got, torch.Tensor)
             else list(zip(got, want)))
    for a, b in pairs:
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(np.int16)
        np.testing.assert_array_equal(a.numpy(), b)
