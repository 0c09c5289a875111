"""The port's attention plain versions against the JAX package (CPU).

- flash prefill's plain version vs ``flash_prefill`` (Pallas, interpret
  mode) and vs ``attention_ref.prefill_attention``: 2e-2, the tolerance of
  ``tests/test_pallas_flash_attention.py``;
- paged decode attention vs ``attention_ref.paged_decode_attention``;
- the fused decode's plain version (append, then attend) vs
  ``paged_mqa_attention_single_pass(append=...)`` (Pallas, interpret
  mode): outputs at 5e-2 (``tests/test_decode_attention_sp.py``), pool
  bytes exact;
- the paged prefill's plain version vs ``attention_ref.paged_prefill_
  attention`` (both f32 over the same dequantized pages: 1e-5) and vs the
  Pallas ``paged_prefill_attention`` in interpret mode (2e-2, the
  tolerance of ``tests/test_paged_prefill.py``); the dequantized gather
  and the page-aligned append byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops.paged_kv import append_kv as j_append_kv
from omniserve_tpu.ops.paged_kv import gather_kv_for_seq as j_gather
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu.ops.pallas import decode_attention as j_sp
from omniserve_tpu.ops.pallas.flash_attention import flash_prefill
from omniserve_tpu.ops.pallas.paged_prefill import (
    paged_prefill_attention as j_paged_prefill,
)
from omniserve_tpu_torch.models.convert import pool_from_numpy
from omniserve_tpu_torch.ops import attention_ref as t_ref
from omniserve_tpu_torch.ops import dispatch
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec
from omniserve_tpu_torch.ops.cuda import flash_attention as t_flash
from omniserve_tpu_torch.ops.cuda import paged_prefill as t_pp


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def packed_segments(lens, t_total):
    seg = np.full(t_total, -1, np.int32)
    pos = np.zeros(t_total, np.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        pos[o:o + n] = np.arange(n)
        o += n
    return seg, pos


@pytest.mark.parametrize("lens,hq,hkv", [([128], 4, 2), ([50, 37, 20], 4, 1)])
def test_flash_prefill_plain(lens, hq, hkv):
    rng = np.random.default_rng(0)
    t, d = 128, 32
    q = rng.standard_normal((t, hq, d)).astype(np.float32)
    k = rng.standard_normal((t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((t, hkv, d)).astype(np.float32)
    seg, pos = packed_segments(lens, t)
    sm = d ** -0.5
    got = N(t_flash.prefill_attention_plain(T(q), T(k), T(v), T(seg),
                                            T(pos), sm))
    ones = jnp.ones((hq,), jnp.int32)
    pallas = np.asarray(flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(pos), sm, ones, 0, 0, False, interpret=True,
    ))
    ref = np.asarray(j_ref.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(pos), sm, valid=jnp.asarray(seg >= 0),
    ))
    real = seg >= 0        # padding rows: each side zeroes them its own way
    np.testing.assert_allclose(got[real], pallas[real], atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    # the chunked query loop of the plain version changes nothing
    got_chunked = N(t_ref.prefill_attention(T(q), T(k), T(v), T(seg),
                                            T(pos), sm, q_chunk=16))
    np.testing.assert_allclose(got_chunked, got, atol=1e-6, rtol=1e-6)


def test_prefill_dispatch_raises_outside_slice():
    """The sink + local band serves (``tests/test_torch_lserve_prefill.py``);
    flags that are not one per q head are refused."""
    x = torch.zeros(4, 2, 8)
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="per q head"):
        dispatch.prefill_attention(x, x, x, seg, seg, 1.0,
                                   head_is_retrieval=torch.ones(3, dtype=bool),
                                   sink_size=4, local_size=4)
    out = dispatch.prefill_attention(
        x, x, x, seg, torch.arange(4, dtype=torch.int32), 1.0,
        head_is_retrieval=torch.ones(2, dtype=bool), sink_size=4,
        local_size=4)
    assert out.shape == x.shape


def build_pool(rng, page, h, d, lengths, tables, layers=2):
    pool = j_make_kv_pool(layers, tables.size + 1, h, page, d, kv_bits=4,
                          kv_zeros=True)
    for lay in range(layers):
        for s, ln in enumerate(lengths):
            k = rng.standard_normal((ln, h, d)).astype(np.float32)
            v = rng.standard_normal((ln, h, d)).astype(np.float32)
            pos = np.arange(ln)
            pool = j_append_kv(
                pool, lay, jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(tables[s][pos // page]), jnp.asarray(pos % page),
                page_size=page, kv_bits=4, kv_zeros=True,
            )
    return pool


def test_paged_decode_attention_plain():
    rng = np.random.default_rng(1)
    page, h, d, n_rep = 16, 2, 32, 2
    lengths = [3 * page + 5, page, 1]
    tables = rng.permutation(len(lengths) * 4).astype(np.int32).reshape(-1, 4)
    jpool = build_pool(rng, page, h, d, lengths, tables)
    q = rng.standard_normal((len(lengths), h * n_rep, d)).astype(np.float32)
    sm = d ** -0.5
    want = np.asarray(j_ref.paged_decode_attention(
        jnp.asarray(q), jpool, 1, jnp.asarray(tables),
        jnp.asarray(lengths, jnp.int32), sm, page, 4, True,
    ))
    tpool = pool_from_numpy(jpool, "cpu")
    got = N(t_ref.paged_decode_attention(
        T(q), tpool, 1, T(tables), T(np.asarray(lengths, np.int32)), sm,
        page, 4, True,
    ))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fused_decode_plain_matches_pallas_append():
    """The plain fused decode (append, then attend) against the Pallas
    single-pass kernel's append mode: same outputs, same pool bytes."""
    rng = np.random.default_rng(2)
    page, h, d, n_rep = 128, 2, 128, 2
    lengths_old = [page * 2 + 17, page - 1, 3 * page, 0]
    b = len(lengths_old)
    w = 4
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    tables[3] = 0          # an inactive row's table is all zeros
    jpool = build_pool(rng, page, h, d, lengths_old[:3], tables[:3])
    tpool = pool_from_numpy(jpool, "cpu")

    def bf16_exact(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return N(T(x).to(torch.bfloat16).float())

    q = bf16_exact((b, h * n_rep, d))
    k_new = bf16_exact((b, h, d))
    v_new = bf16_exact((b, h, d))
    lens = np.asarray(lengths_old, np.int32) + 1
    lens[3] = 0                                   # an inactive row
    sm = d ** -0.5

    n_pg = (lens + page - 1) // page
    tile = np.arange(w)
    sel_logic = np.where(tile[None, :] < n_pg[:, None], tile[None, :], -1)
    sel_phys = np.where(sel_logic >= 0, tables, 0)
    tgt = np.where(lens > 0, (lens - 1) // page, -1).astype(np.int32)
    slot = np.where(lens > 0, (lens - 1) % page, 0).astype(np.int32)
    want, jpool_out = j_sp.paged_mqa_attention_single_pass(
        jnp.asarray(q).reshape(b, h, n_rep, d), jpool, 1,
        jnp.asarray(sel_phys), jnp.asarray(sel_logic), jnp.asarray(lens),
        sm_scale=sm, page_size=page, kv_zeros=True,
        append=(jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(tgt),
                jnp.asarray(slot)),
        interpret=True,
    )
    got, tpool_out, _ = dispatch.paged_decode_attention_fused(
        T(q), tpool, None, 1, T(tables), T(lens), T(k_new), T(v_new),
        sm_scale=sm, page_size=page, kv_bits=4, kv_zeros=True,
    )
    want = np.asarray(want).reshape(b, h * n_rep, d)
    np.testing.assert_allclose(N(got)[:3], want[:3], rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(N(got)[3], 0.0)

    # pool bytes: exactly the JAX split path's (append_kv, the contract the
    # Pallas kernel is itself tested against) ...
    active = lens > 0
    phys = np.where(active, tables[np.arange(b), np.maximum(tgt, 0)], -1)
    jsplit = j_append_kv(
        jpool, 1, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(phys),
        jnp.asarray(slot), page_size=page, kv_bits=4, kv_zeros=True,
    )
    for name in ("k_data", "v_data", "kv_scales"):
        np.testing.assert_array_equal(N(getattr(tpool_out, name)),
                                      np.asarray(getattr(jsplit, name)))
    # ... and the Pallas kernel's, up to codes at exact .5 rounding ties
    # (bf16 inputs hit them), where its interpret-mode rounding can land one
    # step away from round-half-even; its planes round in its own op order
    # (held at 1e-5 by tests/test_decode_attention_sp.py as well)
    np.testing.assert_allclose(N(tpool_out.kv_scales),
                               np.asarray(jpool_out.kv_scales),
                               rtol=1e-5, atol=1e-6)
    n_ties = 0
    for x in (k_new, v_new):
        xs = x[active]
        lo, hi = xs.min(-1, keepdims=True), xs.max(-1, keepdims=True)
        rng_ = np.maximum(hi - lo, 1e-8)
        y = xs / (rng_ / 15) + (-15 * lo / rng_)
        n_ties += int((np.abs(y - np.floor(y) - 0.5) == 0).sum())
    for name in ("k_data", "v_data"):
        a_ = N(getattr(tpool_out, name)).astype(int)
        b_ = np.asarray(getattr(jpool_out, name)).astype(int)
        for shift in (0, 4):
            assert np.abs(((a_ >> shift) & 15) - ((b_ >> shift) & 15)).max() \
                <= 1
        n_ties -= int((a_ != b_).sum())
    assert n_ties >= 0


def test_append_targets():
    bt = torch.tensor([[5, 6, 7], [8, 9, 10]], dtype=torch.int32)
    pages, slots = t_dec.append_targets(bt, torch.tensor([17, 0]), 8)
    assert pages.tolist() == [7, -1]
    assert int(slots[0]) == 0


def random_pools(rng, kv_bits, kv_zeros, n_pages, h, page, d, layers=2):
    """A JAX pool of random codes (fine-grained planes or per-tensor
    scales that span N(0, 1) values), or of N(0, 1) bf16 values (kv16),
    and its port twin."""
    if kv_bits == 16:
        pool = j_make_kv_pool(layers, n_pages, h, page, d, kv_bits=16)
        pool = pool._replace(**{n: jnp.asarray(rng.standard_normal(
            pool.k_data.shape).astype(np.float32), jnp.bfloat16)
            for n in ("k_data", "v_data")})
        return pool, pool_from_numpy(pool, "cpu")
    pt = {}
    if not kv_zeros:
        qmax = 7 if kv_bits == 4 else 127
        pt = {n: jnp.asarray(rng.uniform(2.5, 3.5, layers) / qmax,
                             jnp.float32)
              for n in ("k_scale_per_tensor", "v_scale_per_tensor")}
    pool = j_make_kv_pool(layers, n_pages, h, page, d, kv_bits=kv_bits,
                          kv_zeros=kv_zeros, **pt)
    pool = pool._replace(**{n: jnp.asarray(rng.integers(
        0, 256, pool.k_data.shape, dtype=np.uint8))
        for n in ("k_data", "v_data")})
    if kv_zeros:
        pool = pool._replace(kv_scales=jnp.asarray(rng.uniform(
            0.05, 0.5, pool.kv_scales.shape).astype(np.float32)))
    return pool, pool_from_numpy(pool, "cpu")


def test_decode_dispatch_raises_outside_slice():
    """The fused append serves kv4 and kv8 pools, fine-grained or
    per-tensor, and kv16 pools through the split path
    (``tests/test_torch_kv16_pertensor.py``); a streaming pool raises
    naming its ROADMAP item at any width. What only sparse decode reaches
    (a page selection or a streaming pool at the split attention, a
    non-kv16 split append) serves kv8, per-tensor kv4 / kv8 and kv16 pools,
    equal to the JAX package (attention 1e-5, append bytes): the
    selection and the streaming pool over kv16 pools, which raised before
    LServe served them, run too."""
    q = torch.zeros(1, 2, 8)
    for kv_bits, kv_zeros in ((4, True), (16, True), (8, False), (4, False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dispatch.paged_decode_attention_fused(
                q, None, object(), 0, None, None, None, None, sm_scale=1.0,
                page_size=8, kv_bits=kv_bits, kv_zeros=kv_zeros,
            )

    rng = np.random.default_rng(9)
    page, h, d, b = 16, 2, 32, 2
    tables = np.array([[3, 0, 5], [1, 4, 2]], np.int32)
    stables = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    lens = np.array([40, 27], np.int32)
    sel = np.array([[[2, 0], [2, -1]], [[1, 0], [1, 0]]], np.int32)
    qn = rng.standard_normal((b, 2 * h, d)).astype(np.float32)
    flags, rank = np.array([True, False]), np.array([0, 0], np.int32)
    sm = d ** -0.5
    for kv_bits, kv_zeros in ((8, True), (8, False), (4, False), (16, True)):
        jr, tr = random_pools(rng, kv_bits, kv_zeros, 7, h, page, d)
        js, ts = random_pools(rng, kv_bits, kv_zeros, 7, 1, page, d)
        js = js._replace(k_scale_per_tensor=jr.k_scale_per_tensor,
                         v_scale_per_tensor=jr.v_scale_per_tensor)
        ts = ts._replace(k_scale_per_tensor=tr.k_scale_per_tensor,
                         v_scale_per_tensor=tr.v_scale_per_tensor)
        args = (1, tables, lens, sm, page, kv_bits, kv_zeros)
        dual = dict(head_is_retrieval=flags, head_rank=rank, sink_blocks=1,
                    local_blocks=2, streaming_block_tables=stables,
                    page_idxes=sel[:, :, :1])
        for kw in (dict(page_idxes=sel), dual):
            want = j_ref.paged_decode_attention(
                jnp.asarray(qn), jr, *args[:1],
                *(jnp.asarray(a) for a in args[1:3]), *args[3:],
                **({"streaming_pool": js} if "head_rank" in kw else {}),
                **{k: jnp.asarray(v) for k, v in kw.items()
                   if isinstance(v, np.ndarray)},
                **{k: v for k, v in kw.items()
                   if not isinstance(v, np.ndarray)})
            got = dispatch.paged_decode_attention(
                T(qn), tr, *args[:1], *(T(a) for a in args[1:3]), *args[3:],
                **({"streaming_pool": ts} if "head_rank" in kw else {}),
                **{k: T(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()})
            np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5,
                                       rtol=1e-5)
            assert np.abs(np.asarray(want)).max() > 1e-2
        k_new = rng.standard_normal((b, h, d)).astype(np.float32)
        v_new = rng.standard_normal((b, h, d)).astype(np.float32)
        pages, slots = np.array([6, -1], np.int32), np.array([3, 9], np.int32)
        jout = j_dispatch.append_kv_decode(
            jr, 0, jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(pages), jnp.asarray(slots), page, kv_bits, kv_zeros)
        dispatch.append_kv_decode(tr, 0, T(k_new), T(v_new), T(pages),
                                  T(slots), page, kv_bits, kv_zeros)
        for name in ("k_data", "v_data", "kv_scales"):
            if getattr(jout, name) is not None:
                np.testing.assert_array_equal(
                    N(getattr(tr, name).float()),
                    np.asarray(getattr(jout, name), np.float32))


# -- paged prefill (chunked prefill attention) ---------------------------

PP_B, PP_HKV, PP_NREP, PP_D, PP_PAGE = 2, 2, 2, 128, 16


def paged_prefill_setup(history, chunk, seed=0):
    """Pools holding ``history + chunk`` tokens per sequence (the JAX
    test's geometry, tests/test_paged_prefill.py:16-35); q for the chunk."""
    rng = np.random.default_rng(seed)
    total = history + chunk
    n_blocks = -(-total // PP_PAGE) + 1
    pool = j_make_kv_pool(1, PP_B * n_blocks + 1, PP_HKV, PP_PAGE, PP_D,
                          kv_bits=4, kv_zeros=True)
    tables = np.arange(PP_B * n_blocks, dtype=np.int32).reshape(PP_B,
                                                                n_blocks)
    for i in range(PP_B):
        pos = np.arange(total)
        pool = j_append_kv(
            pool, 0,
            jnp.asarray(rng.normal(size=(total, PP_HKV, PP_D)), jnp.float32),
            jnp.asarray(rng.normal(size=(total, PP_HKV, PP_D)), jnp.float32),
            jnp.asarray(tables[i][pos // PP_PAGE]),
            jnp.asarray(pos % PP_PAGE), PP_PAGE, 4, True,
        )
    q = rng.normal(size=(PP_B, chunk, PP_HKV * PP_NREP, PP_D)).astype(
        np.float32)
    q_pos = np.tile(history + np.arange(chunk), (PP_B, 1)).astype(np.int32)
    ctx = np.full(PP_B, total, np.int32)
    return pool, tables, q, q_pos, ctx


def run_paged_prefill_three_ways(pool, tables, q, q_pos, ctx):
    args = (0, 0.088, PP_PAGE, 4, True)
    want = np.asarray(j_ref.paged_prefill_attention(
        jnp.asarray(q), pool, 0, jnp.asarray(tables), jnp.asarray(q_pos),
        jnp.asarray(ctx), *args[1:]))
    pallas = np.asarray(j_paged_prefill(
        jnp.asarray(q), pool, 0, jnp.asarray(tables), jnp.asarray(q_pos),
        jnp.asarray(ctx), *args[1:], tile_q=8, interpret=True))
    got = N(dispatch.paged_prefill_attention(
        T(q), pool_from_numpy(pool, "cpu"), 0, T(tables), T(q_pos), T(ctx),
        *args[1:]))
    return got, want, pallas


@pytest.mark.parametrize("history,chunk", [(0, 24), (40, 24)])
def test_paged_prefill_plain(history, chunk):
    got, want, pallas = run_paged_prefill_three_ways(
        *paged_prefill_setup(history, chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-2, atol=2e-2)


def test_paged_prefill_plain_ragged_query_padding():
    """tests/test_paged_prefill.py:67-84: the second sequence's chunk is
    shorter; its padding rows give zeros and poison nothing."""
    pool, tables, q, q_pos, ctx = paged_prefill_setup(16, 16)
    q_pos[1, 8:] = -1
    ctx[1] = 16 + 8
    got, want, pallas = run_paged_prefill_three_ways(pool, tables, q, q_pos,
                                                     ctx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, :8], pallas[:, :8], rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_array_equal(got[1, 8:], 0.0)
    # the kernel wrapper's plain version is the same function
    plain = N(t_pp.paged_prefill_attention_plain(
        T(q), pool_from_numpy(pool, "cpu"), 0, T(tables), T(q_pos), T(ctx),
        sm_scale=0.088, page_size=PP_PAGE))
    np.testing.assert_array_equal(plain, got)


def test_gather_kv_for_seq_matches_jax():
    pool, tables, _, _, _ = paged_prefill_setup(40, 24, seed=3)
    tpool = pool_from_numpy(pool, "cpu")
    for i in range(PP_B):
        jk, jv = j_gather(pool, 0, jnp.asarray(tables[i]), PP_PAGE, 4, True)
        tk, tv = t_kv.gather_kv_for_seq(tpool, 0, T(tables[i]), PP_PAGE, 4,
                                        True)
        np.testing.assert_array_equal(N(tk), np.asarray(jk))
        np.testing.assert_array_equal(N(tv), np.asarray(jv))
    # a [B, W] table gathers the same rows
    bk, _ = t_kv.gather_kv_for_seq(tpool, 0, T(tables), PP_PAGE)
    np.testing.assert_array_equal(N(bk[1]), np.asarray(j_gather(
        pool, 0, jnp.asarray(tables[1]), PP_PAGE, 4, True)[0]))


def test_append_kv_page_aligned_bytes_match_jax():
    """Chunked prefill's page-aligned append: two chunk rows of two pages
    each, the second row's tail padded (page -1), into a pool that already
    holds other sequences' history."""
    rng = np.random.default_rng(4)
    page, h, d = 16, 2, 32
    jpool = build_pool(rng, page, h, d, [20, 7],
                       np.arange(12, dtype=np.int32).reshape(2, 6), layers=1)
    tables = np.array([[3, 4], [9, 10]], np.int32)
    t = 2 * 2 * page
    k = rng.standard_normal((t, h, d)).astype(np.float32)
    v = rng.standard_normal((t, h, d)).astype(np.float32)
    pos = np.tile(np.arange(2 * page), 2)
    pages = np.repeat(tables, page, axis=1).reshape(-1)
    pages[2 * page + 20:] = -1                       # padding tail of row 2
    slots = pos % page
    want = j_append_kv(jpool, 0, jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(pages), jnp.asarray(slots), page, 4, True,
                       page_aligned=True)
    got = t_kv.append_kv(pool_from_numpy(jpool, "cpu"), 0, T(k), T(v),
                         T(pages), T(slots), page, 4, True, page_aligned=True)
    for name in ("k_data", "v_data", "kv_scales"):
        np.testing.assert_array_equal(N(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def test_paged_prefill_dispatch_raises_outside_slice():
    """Bands and page lists serve over kv4 / kv8 pages, fine-grained or
    per-tensor (``tests/test_torch_lserve_prefill.py``; kv8 and per-tensor
    below, equal to the JAX dispatch at 1e-5), and kv8, kv16 and
    per-tensor pages over a dense table (``tests/test_torch_precision.py``,
    ``tests/test_torch_kv16_pertensor.py``), and kv16 pages under a page
    list or band (below, equal to the JAX dispatch at 1e-5; they raised
    before LServe served kv16); LSE outputs (sequence parallelism)
    raise."""
    q = torch.zeros(1, 2, 2, 8)
    kw = dict(sm_scale=1.0, page_size=8, kv_bits=4, kv_zeros=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        dispatch.paged_prefill_attention(q, None, 0, None, None, None,
                                         return_lse=True, **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        dispatch.paged_prefill_attention(
            q, None, 0, None, None, None, head_is_retrieval=torch.ones(2),
            sink_size=4, local_size=4, return_lse=True, **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        t_ref.paged_prefill_attention(q, None, 0, None, None, None, 1.0, 8,
                                      4, True, kv_positions=torch.zeros(1),
                                      return_lse=True)
    rng = np.random.default_rng(11)
    page, hkv, d = 8, 2, 32
    table = np.array([[4, 1, 6, 0, 3]], np.int32)
    sel = np.array([[0, 3, 1, -1, 2]], np.int32)
    ctx = np.array([30], np.int32)
    qn = rng.standard_normal((1, 6, 2 * hkv, d)).astype(np.float32)
    q_pos = np.arange(24, 30, dtype=np.int32)[None]
    flags = np.array([True, True, False, False])
    for kv_bits, kv_zeros in ((8, True), (8, False), (4, False), (16, True)):
        jpool, tpool = random_pools(rng, kv_bits, kv_zeros, 7, hkv, page, d,
                                    layers=1)
        for extra in (dict(sel_logic=sel),
                      dict(head_is_retrieval=flags, sink_size=4,
                           local_size=12)):
            want = j_dispatch.paged_prefill_attention(
                jnp.asarray(qn), jpool, 0, jnp.asarray(table),
                jnp.asarray(q_pos), jnp.asarray(ctx), d ** -0.5, page,
                kv_bits, kv_zeros, **{k: jnp.asarray(v) if isinstance(
                    v, np.ndarray) else v for k, v in extra.items()})
            got = dispatch.paged_prefill_attention(
                T(qn), tpool, 0, T(table), T(q_pos), T(ctx), d ** -0.5,
                page, kv_bits, kv_zeros, **{k: T(v) if isinstance(
                    v, np.ndarray) else v for k, v in extra.items()})
            np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5,
                                       rtol=1e-5)
            assert np.abs(np.asarray(want)).max() > 1e-2
