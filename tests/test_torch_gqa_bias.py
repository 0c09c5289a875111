"""GQA groups of any size up to 8 and the Qwen2 QKV bias: the port against
the JAX package (CPU).

Yi-34B serves 56 q heads over 8 kv heads (n_rep 7), Qwen2-7B 28 over 4
(n_rep 7), Qwen1.5-72B 64 over 64 with a QKV bias. The same numpy inputs
go through the JAX function and its counterpart in ``omniserve_tpu_torch``
at small width (head_dim 128, 2 kv heads, 2 layers):

- decode attention at n_rep 7 and 3: the fused append (pool bytes equal
  to the JAX append's; outputs 1e-5 of the JAX reference, both f32, and
  5e-2 of the Pallas single-pass kernel in interpret mode, which quantizes
  q and p to int8, ``tests/test_decode_attention_sp.py:78``), and the dual
  pools' per-head lists and streaming band (1e-4 of the JAX reference, as
  ``tests/test_torch_lserve_ops.py``; 5e-2 of the Pallas ``_ph`` and band
  kernels in interpret mode);
- chunked prefill at n_rep 7, dense and over a wrapped ring (1e-5 of the
  JAX reference, 2e-2 of the Pallas kernel in interpret mode,
  ``tests/test_paged_prefill.py``'s tolerance);
- ``FLIP_GATES``: the gates of the 2-layer forwards at these groups and
  with the bias (``tests/test_torch_gqa_bias_forward.py``), and why.

Both engines at a Qwen2 shape are in ``tests/test_torch_gqa_bias_engine.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops.paged_kv import append_kv as j_append_kv
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu.ops.pallas import decode_attention as j_sp
from omniserve_tpu.ops.pallas.paged_prefill import (
    paged_prefill_attention as j_paged_prefill,
)
from omniserve_tpu_torch.models.convert import pool_from_numpy
from omniserve_tpu_torch.ops import dispatch
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec
from tests.test_torch_lserve_ops import (
    FLAGS, LENS, LOCAL_B, RANK, SINK_B, build_dual_pools, decode_kwargs,
)
from tests.test_torch_lserve_prefill import check_ring_prefill

D = 128
EXACT = 1e-5        # f32 plain versions against the JAX reference
LIST_TOL = 1e-4     # the dual-pool composition against the JAX reference
PALLAS_DECODE = 5e-2
PALLAS_PREFILL = 2e-2


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def bf16_exact(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return N(T(x).to(torch.bfloat16).float())


# -- decode attention -------------------------------------------------------


def filled_pool(rng, page, h, lengths, tables, layers=2):
    pool = j_make_kv_pool(layers, tables.size + 1, h, page, D, kv_bits=4,
                          kv_zeros=True)
    for lay in range(layers):
        for s, ln in enumerate(lengths):
            pos = np.arange(ln)
            pool = j_append_kv(
                pool, lay,
                jnp.asarray(rng.standard_normal((ln, h, D)), jnp.float32),
                jnp.asarray(rng.standard_normal((ln, h, D)), jnp.float32),
                jnp.asarray(tables[s][pos // page]), jnp.asarray(pos % page),
                page_size=page, kv_bits=4, kv_zeros=True,
            )
    return pool


@pytest.mark.parametrize("n_rep", [7, 3])
def test_fused_decode_matches_jax_and_pallas(n_rep):
    """The fused decode (append, then attend) at n_rep 7 and 3 over two
    rows and an inactive one: the port's dispatch (its plain version on
    the CPU) against the JAX append + reference (outputs 1e-5, pool bytes
    equal) and the Pallas single-pass kernel's append mode in interpret
    mode (5e-2)."""
    rng = np.random.default_rng(20 + n_rep)
    page, h = 128, 2
    lengths_old = [page + 17, page - 1, 0]
    b, w = len(lengths_old), 2
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    tables[2] = 0
    jpool = filled_pool(rng, page, h, lengths_old[:2], tables[:2])
    tpool = pool_from_numpy(jpool, "cpu")
    q = bf16_exact(rng, (b, h * n_rep, D))
    k_new, v_new = bf16_exact(rng, (b, h, D)), bf16_exact(rng, (b, h, D))
    lens = np.asarray(lengths_old, np.int32) + 1
    lens[2] = 0
    sm = D ** -0.5

    got, tpool, _ = dispatch.paged_decode_attention_fused(
        T(q), tpool, None, 1, T(tables), T(lens), T(k_new), T(v_new),
        sm_scale=sm, page_size=page, kv_bits=4, kv_zeros=True)
    tgt = np.where(lens > 0, (lens - 1) // page, 0)
    slot = np.where(lens > 0, (lens - 1) % page, 0).astype(np.int32)
    phys = np.where(lens > 0, tables[np.arange(b), tgt], -1).astype(np.int32)
    jsplit = j_append_kv(jpool, 1, jnp.asarray(k_new), jnp.asarray(v_new),
                         jnp.asarray(phys), jnp.asarray(slot), page_size=page,
                         kv_bits=4, kv_zeros=True)
    for name in ("k_data", "v_data", "kv_scales"):
        np.testing.assert_array_equal(N(getattr(tpool, name)),
                                      np.asarray(getattr(jsplit, name)))
    want = np.asarray(j_ref.paged_decode_attention(
        jnp.asarray(q), jsplit, 1, jnp.asarray(tables), jnp.asarray(lens),
        sm, page, 4, True))
    np.testing.assert_allclose(N(got), want, rtol=EXACT, atol=EXACT)
    assert np.abs(want[:2]).max() > 1e-2
    np.testing.assert_array_equal(N(got)[2], 0.0)

    n_pg = (lens + page - 1) // page
    tile = np.arange(w)
    sel_logic = np.where(tile[None, :] < n_pg[:, None], tile[None, :], -1)
    sel_phys = np.where(sel_logic >= 0, tables, 0)
    pallas, _ = j_sp.paged_mqa_attention_single_pass(
        jnp.asarray(q).reshape(b, h, n_rep, D), jpool, 1,
        jnp.asarray(sel_phys), jnp.asarray(sel_logic), jnp.asarray(lens),
        sm_scale=sm, page_size=page, kv_zeros=True,
        append=(jnp.asarray(k_new), jnp.asarray(v_new),
                jnp.asarray(np.where(lens > 0, tgt, -1).astype(np.int32)),
                jnp.asarray(slot)),
        interpret=True)
    np.testing.assert_allclose(
        N(got)[:2], np.asarray(pallas).reshape(b, h * n_rep, D)[:2],
        rtol=PALLAS_DECODE, atol=PALLAS_DECODE)


@pytest.fixture(scope="module")
def dual_pools():
    return build_dual_pools()


def test_dual_pool_decode_matches_jax_and_pallas(dual_pools):
    """LServe's decode at n_rep 7 over ``build_dual_pools``' four kv heads
    (two retrieval heads, two streaming over a wrapped ring): 3 selected
    pages a retrieval head and the ring's band of 128 sink + 256 local
    tokens. The port's dispatch and its page-list composition against the
    JAX reference (1e-4); the per-head list and the band plain versions
    against the Pallas ``_ph`` and single-pass band kernels in interpret
    mode (5e-2)."""
    dp = dual_pools
    n_rep, layer, page = 7, 1, 128
    sm, dec = D ** -0.5, (page, 2 * page)
    b = len(LENS)
    q = np.random.default_rng(31).normal(
        size=(b, 4 * n_rep, D)).astype(np.float32)
    # the newest page first, then one more per head where there is one
    n_pg = -(-LENS // page)
    sel = np.full((b, 4, 3), -1, np.int32)
    for i, n in enumerate(n_pg):
        if n:
            sel[i, :, 0] = n - 1
            sel[i, :, 1] = np.arange(4) % n
    sel[:, ~FLAGS] = -1
    want = np.asarray(j_ref.paged_decode_attention(
        jnp.asarray(q), dp["jr"], layer, jnp.asarray(dp["tables"]),
        jnp.asarray(LENS), sm, page, 4, True,
        **decode_kwargs(dp, "jax", sel, dec=dec)))
    targs = (T(q), dp["tr"], layer, T(dp["tables"]), T(LENS), sm, page)
    got = dispatch.paged_decode_attention(
        *targs, 4, True, **decode_kwargs(dp, "torch", sel, dec=dec))
    np.testing.assert_allclose(N(got), want, rtol=0, atol=LIST_TOL)
    lists = t_dec.paged_decode_attention(
        *targs, **decode_kwargs(dp, "torch", sel, dec=dec))
    np.testing.assert_allclose(N(lists), want, rtol=0, atol=LIST_TOL)
    assert np.abs(want[:3]).max() > 1e-2 and not want[3].any()

    q4 = q.reshape(b, 4, n_rep, D)
    # retrieval heads: the per-head lists
    sel_r = sel[:, FLAGS]
    safe = np.clip(sel_r, 0, dp["tables"].shape[1] - 1)
    phys_r = np.take_along_axis(np.repeat(dp["tables"][:, None, :], 2, 1),
                                safe, axis=2)
    phys_r = np.where(sel_r >= 0, phys_r, 0).astype(np.int32)
    q_r = np.ascontiguousarray(q4[:, FLAGS])
    pallas_ph = np.asarray(j_sp.paged_mqa_attention_single_pass_ph(
        jnp.asarray(q_r), dp["jr"], layer, jnp.asarray(phys_r),
        jnp.asarray(sel_r), jnp.asarray(LENS), sm_scale=sm, page_size=page,
        kv_zeros=True, interpret=True))
    plain_ph = t_dec.page_list_attention_plain(
        T(q_r), dp["tr"], layer, T(phys_r), T(sel_r), T(LENS), sm_scale=sm,
        page_size=page)
    np.testing.assert_allclose(N(plain_ph), pallas_ph, rtol=PALLAS_DECODE,
                               atol=PALLAS_DECODE)
    # streaming heads: the band over the ring's compact list
    phys_s, logic_s, span = t_dec.streaming_page_lists(
        T(dp["stables"]), T(LENS), SINK_B, page, dec[1])
    q_s = np.ascontiguousarray(q4[:, ~FLAGS])
    band = dict(band_sink_tokens=dec[0], band_local_tokens=dec[1],
                ring_span_pages=span, ring_sink_tokens=SINK_B * page)
    assert span == LOCAL_B
    pallas_band = np.asarray(j_sp.paged_mqa_attention_single_pass(
        jnp.asarray(q_s), dp["js"], layer, jnp.asarray(N(phys_s)),
        jnp.asarray(N(logic_s)), jnp.asarray(LENS), sm_scale=sm,
        page_size=page, kv_zeros=True, interpret=True, **band))
    plain_band = t_dec.page_list_attention_plain(
        T(q_s), dp["ts"], layer, phys_s, logic_s, T(LENS), sm_scale=sm,
        page_size=page, **band)
    np.testing.assert_allclose(N(plain_band), pallas_band,
                               rtol=PALLAS_DECODE, atol=PALLAS_DECODE)
    # the heads' rows in the pools: retrieval heads 0, 2 -> rows 0, 1
    assert RANK.tolist() == [0, 0, 1, 1]
    np.testing.assert_allclose(N(plain_ph), want.reshape(
        b, 4, n_rep, D)[:, FLAGS], rtol=0, atol=LIST_TOL)
    np.testing.assert_allclose(N(plain_band), want.reshape(
        b, 4, n_rep, D)[:, ~FLAGS], rtol=0, atol=LIST_TOL)


# -- chunked prefill --------------------------------------------------------


def test_paged_prefill_dense_matches_jax_and_pallas():
    """A 24-token chunk after 40 tokens of history at n_rep 7 (a ragged
    second row): the port's dispatch against the JAX reference (1e-5) and
    the Pallas kernel in interpret mode (2e-2)."""
    rng = np.random.default_rng(41)
    b, h, n_rep, page, history, chunk = 2, 2, 7, 16, 40, 24
    total = history + chunk
    w = -(-total // page)
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    jpool = filled_pool(rng, page, h, [total, total], tables, layers=1)
    q = rng.normal(size=(b, chunk, h * n_rep, D)).astype(np.float32)
    q_pos = np.tile(history + np.arange(chunk), (b, 1)).astype(np.int32)
    ctx = np.full(b, total, np.int32)
    q_pos[1, 17:] = -1
    ctx[1] = history + 17
    args = (0, 0.088, page, 4, True)
    want = np.asarray(j_ref.paged_prefill_attention(
        jnp.asarray(q), jpool, 0, jnp.asarray(tables), jnp.asarray(q_pos),
        jnp.asarray(ctx), *args[1:]))
    pallas = np.asarray(j_paged_prefill(
        jnp.asarray(q), jpool, 0, jnp.asarray(tables), jnp.asarray(q_pos),
        jnp.asarray(ctx), *args[1:], tile_q=8, interpret=True))
    got = N(dispatch.paged_prefill_attention(
        T(q), pool_from_numpy(jpool, "cpu"), 0, T(tables), T(q_pos), T(ctx),
        *args[1:]))
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got[0], pallas[0], rtol=PALLAS_PREFILL,
                               atol=PALLAS_PREFILL)
    np.testing.assert_allclose(got[1, :17], pallas[1, :17],
                               rtol=PALLAS_PREFILL, atol=PALLAS_PREFILL)
    np.testing.assert_array_equal(got[1, 17:], 0.0)


def test_paged_prefill_ring_matches_jax_and_pallas():
    """An 8-token chunk over a wrapped 1 + 4 page ring with stale rows past
    the write head, one streaming kv head at n_rep 7
    (``tests/test_torch_lserve_prefill.check_ring_prefill``)."""
    check_ring_prefill(61, 4, True, pallas_tol=PALLAS_PREFILL, n_rep=7)


# The gates of the model's forwards (``tests/test_torch_gqa_bias_forward.py``)
# where an activation code flips. Both forwards run the same integer GEMMs
# in the same f32 op order, but XLA and torch round an f32 product,
# reduction or cos / sin a last ulp apart here and there (the GEMM
# epilogue, the norms' sums, ``tests/test_torch_ops.py::test_rope``); at
# these widths such an ulp flips an int8 activation code now and then (a
# step of 1/127 of its row's max), and from there on the two forwards
# differ by more than rounding. Measured on the CPU over these shapes and
# nine seeds of the draw (3, 5, 7, 11, 13, 17, 19, 23, 29): the logits
# moved by up to 2.4e-2 of their scale, K / V codes by one step at most,
# up to 3.3e-3 of the pool's code bytes, the planes by up to 1.24e-2.
# The gates leave a margin of 1.6-3 over those. A step before any flip is
# held at 1e-4 and pools equal, and the bias's f32 order is checked
# element by element (``tests/test_torch_llama.check_forward``).
FLIP_GATES = dict(logits=4e-2, planes=2e-2, codes=1e-2)
