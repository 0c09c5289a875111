"""LServe's decode-side ops of the port against the JAX package (CPU).

The same numpy inputs go through the JAX function and its counterpart in
``omniserve_tpu_torch``: K min/max page stats, the ring maps of the
streaming pool, the decode append (pool bytes, planes and stats exact),
the page selector (scores 1e-5; selections as page SETS, because the JAX
``approx_max_k`` orders its picks differently from an exact top-k), and
decode attention over the retrieval pool's selected pages and the
streaming pool's sink + local band (1e-4 against the JAX reference in
f32; 5e-2 against the Pallas per-head kernel in interpret mode, which
quantizes q and p to int8). The append and the dual-pool decode also run
over kv8 and per-tensor (kv4 / kv8) pools, LServe's other KV modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops import paged_kv as j_kv
from omniserve_tpu.ops.pallas import decode_attention as j_sp
from omniserve_tpu_torch.models.convert import pool_from_numpy
from omniserve_tpu_torch.ops import attention_ref as t_ref
from omniserve_tpu_torch.ops import dispatch as t_dispatch
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec

PAGE, D, SUB = 128, 128, 4
L = 2
FIELDS = ("k_data", "v_data", "kv_scales", "k_stats", "k_scale_per_tensor",
          "v_scale_per_tensor")
# LServe's KV modes: label -> (kv_bits, kv_zeros)
KV_MODES = {"kv4": (4, True), "kv8": (8, True), "kv4-pt": (4, False),
            "kv8-pt": (8, False)}


def to_torch_pool(jpool):
    class _P:
        pass

    p = _P()
    for name in FIELDS:
        a = getattr(jpool, name)
        setattr(p, name, None if a is None else np.asarray(a))
    return pool_from_numpy(p, "cpu")


def assert_pools_equal(tpool, jpool, skip_pages=()):
    for name in FIELDS:
        want = getattr(jpool, name)
        got = getattr(tpool, name)
        if want is None:
            assert got is None
            continue
        if want.ndim == 1:              # per-tensor scales [L]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            continue
        keep = [p for p in range(want.shape[1]) if p not in skip_pages]
        if got.dtype == torch.bfloat16:     # kv16 values, compared exactly
            got, want = got.float(), np.asarray(want, np.float32)
        np.testing.assert_array_equal(got.numpy()[:, keep],
                                      np.asarray(want)[:, keep], err_msg=name)


def pt_scales(rng, kv_bits):
    """Per-layer K and V scales that span the codes of N(0, 1) values."""
    qmax = 7 if kv_bits == 4 else 127
    return tuple(jnp.asarray(rng.uniform(2.5, 3.5, L).astype(np.float32)
                             / qmax) for _ in range(2))


def fresh_pools(n_pages, heads, with_stats, seed=0, kv_bits=4,
                kv_zeros=True):
    """A JAX pool and its port twin with the same random (dirty) content."""
    rng = np.random.default_rng(seed)
    k_pt = v_pt = None
    if not kv_zeros:
        k_pt, v_pt = pt_scales(rng, kv_bits)
    jpool = j_kv.make_kv_pool(L, n_pages, heads, PAGE, D, kv_bits=kv_bits,
                              kv_zeros=kv_zeros, with_stats=with_stats,
                              sub_chunks=SUB, k_scale_per_tensor=k_pt,
                              v_scale_per_tensor=v_pt)
    jpool = jpool._replace(
        k_data=jnp.asarray(rng.integers(0, 256, jpool.k_data.shape,
                                        dtype=np.uint8)),
        v_data=jnp.asarray(rng.integers(0, 256, jpool.v_data.shape,
                                        dtype=np.uint8)),
    )
    if kv_zeros:
        jpool = jpool._replace(kv_scales=jnp.asarray(rng.uniform(
            0.01, 1.0, jpool.kv_scales.shape).astype(np.float32)))
    if with_stats:
        jpool = jpool._replace(k_stats=jnp.asarray(
            rng.normal(size=jpool.k_stats.shape).astype(np.float32)))
    return jpool, to_torch_pool(jpool)


def test_k_stats_update_and_reset_match_jax():
    rng = np.random.default_rng(1)
    jpool, tpool = fresh_pools(7, 2, with_stats=True)
    # reset two pages in one layer, then three (and a -1) in all layers
    ids = np.array([3, -1, 5], np.int32)
    jpool = j_kv.reset_page_stats(jpool, 1, jnp.asarray(ids))
    t_kv.reset_page_stats(tpool, 1, torch.from_numpy(ids))
    ids = np.array([0, 2, -1, 3], np.int32)
    jpool = j_kv.reset_page_stats_all_layers(jpool, jnp.asarray(ids))
    t_kv.reset_page_stats_all_layers(tpool, torch.from_numpy(ids))
    # the port sends -1 to the trash page (the top page); JAX drops it
    assert_pools_equal(tpool, jpool, skip_pages=(6,))
    assert np.isinf(tpool.k_stats.numpy()[:, [0, 2, 3]]).all()

    # merge 300 tokens (two share every (page, sub-chunk) cell; some dropped)
    t = 300
    k = rng.normal(size=(t, 2, D)).astype(np.float32)
    pages = rng.choice([0, 2, 3, 5, -1], size=t).astype(np.int32)
    slots = rng.integers(0, PAGE, t).astype(np.int32)
    for layer in range(L):
        jpool = j_kv.update_k_stats(jpool, layer, jnp.asarray(k),
                                    jnp.asarray(pages), jnp.asarray(slots),
                                    PAGE, SUB)
        t_kv.update_k_stats(tpool, layer, torch.from_numpy(k),
                            torch.from_numpy(pages), torch.from_numpy(slots),
                            PAGE, SUB)
    assert_pools_equal(tpool, jpool, skip_pages=(6,))


@pytest.mark.parametrize("sink_b,local_b", [(1, 2), (2, 4), (0, 3)])
def test_ring_maps_match_jax(sink_b, local_b):
    lens = np.array([0, 1, 5, PAGE, PAGE + 1, 2 * PAGE, 3 * PAGE + 7,
                     7 * PAGE - 1, 7 * PAGE, 11 * PAGE + 64], np.int32)
    n_slots = sink_b + local_b
    for jf, tf in ((j_kv.ring_logical_blocks, t_kv.ring_logical_blocks),
                   (j_kv.ring_token_positions, t_kv.ring_token_positions)):
        want = np.asarray(jf(jnp.asarray(lens), n_slots, sink_b, local_b,
                             PAGE))
        got = tf(torch.from_numpy(lens), n_slots, sink_b, local_b, PAGE)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_stats", [True, False])
def test_append_kv_decode_plain_matches_jax(with_stats):
    """Eight tokens to distinct pages (two inactive), three steps on the
    same pages: pool bytes, planes and stats equal the JAX CPU path's."""
    check_append_matches_jax(with_stats, "kv4")


@pytest.mark.parametrize("mode", ["kv8", "kv4-pt", "kv8-pt"])
@pytest.mark.parametrize("with_stats", [True, False])
def test_append_kv_decode_kv_modes_match_jax(with_stats, mode):
    """The same over kv8 and per-tensor pools (LServe's other KV modes):
    pool bytes, planes (kv8), per-tensor scales and stats equal the JAX
    CPU path's (``append_kv``, then ``update_k_stats``)."""
    check_append_matches_jax(with_stats, mode)


def check_append_matches_jax(with_stats, mode):
    rng = np.random.default_rng(2)
    heads = 2
    kv_bits, kv_zeros = KV_MODES[mode]
    jpool, tpool = fresh_pools(12, heads, with_stats=with_stats, seed=3,
                               kv_bits=kv_bits, kv_zeros=kv_zeros)
    pages = np.array([4, 9, -1, 0, 7, -1, 2, 10], np.int32)
    for step, slot0 in enumerate((5, 63, 64)):
        slots = ((slot0 + np.arange(8) * 17) % PAGE).astype(np.int32)
        # bf16-representable values, as the model hands them over
        k = np.array(jnp.asarray(rng.normal(size=(8, heads, D)),
                                 jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(rng.normal(size=(8, heads, D)),
                                 jnp.bfloat16).astype(jnp.float32))
        layer = step % L
        jpool = j_dispatch.append_kv_decode(
            jpool, layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
            jnp.asarray(slots), PAGE, kv_bits, kv_zeros,
            update_stats=with_stats, sub_chunks=SUB)
        out = t_dispatch.append_kv_decode(
            tpool, layer, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pages), torch.from_numpy(slots), PAGE, kv_bits,
            kv_zeros, update_stats=with_stats, sub_chunks=SUB)
        assert out is tpool                      # in place
    assert_pools_equal(tpool, jpool)


@pytest.mark.parametrize("mode", ["kv4", "kv8-pt"])
def test_append_kv_decode_pools_plain_matches_pallas(mode):
    """The two-pool decode append's plain composition (the port's CPU path
    of ``_write_kv``'s decode branch: one call for LServe's retrieval and
    streaming pools, each pool row taking its kv head through the pool's
    row -> head map) against the JAX package's ``append_kv_decode``
    called once per pool on the gathered heads, in interpret mode as
    ``tests/test_pallas_kv_append.py`` runs it: pool bytes, stats
    (retrieval pool only) and scales equal on every page but the trash
    page, planes within that test's 1e-6 (the Pallas kernel's planes sit
    an ulp off the JAX scatter path's, which the port's equal exactly)."""
    from omniserve_tpu.ops.pallas.kv_append import append_kv_decode

    rng = np.random.default_rng(12)
    kv_bits, kv_zeros = KV_MODES[mode]
    src_r, src_s = np.array([0, 2]), np.array([3, 1])   # rows -> kv heads
    jr, tr = fresh_pools(6, 2, with_stats=True, seed=13, kv_bits=kv_bits,
                         kv_zeros=kv_zeros)
    js, ts = fresh_pools(6, 2, with_stats=False, seed=14, kv_bits=kv_bits,
                         kv_zeros=kv_zeros)
    pages_r = np.array([3, -1, 0], np.int32)
    pages_s = np.array([1, -1, 4], np.int32)
    slots_r = np.array([5, 9, 100], np.int32)
    slots_s = np.array([64, 9, 127], np.int32)
    k = np.array(jnp.asarray(rng.normal(size=(3, 4, D)),
                             jnp.bfloat16).astype(jnp.float32))
    v = np.array(jnp.asarray(rng.normal(size=(3, 4, D)),
                             jnp.bfloat16).astype(jnp.float32))
    layer = 1
    jr = append_kv_decode(jr, layer, jnp.asarray(k[:, src_r]),
                          jnp.asarray(v[:, src_r]), jnp.asarray(pages_r),
                          jnp.asarray(slots_r), PAGE, kv_bits, kv_zeros,
                          update_stats=True, sub_chunks=SUB, interpret=True)
    js = append_kv_decode(js, layer, jnp.asarray(k[:, src_s]),
                          jnp.asarray(v[:, src_s]), jnp.asarray(pages_s),
                          jnp.asarray(slots_s), PAGE, kv_bits, kv_zeros,
                          interpret=True)
    t = torch.from_numpy
    out = t_dispatch.append_kv_decode_pools(
        tr, ts, layer, t(k), t(v), (t(pages_r), t(slots_r), t(src_r)),
        (t(pages_s), t(slots_s), t(src_s)), PAGE, kv_bits, kv_zeros,
        update_stats=True, sub_chunks=SUB)
    assert out[0] is tr and out[1] is ts           # in place
    keep = slice(0, jr.k_data.shape[1] - 1)         # the trash page out
    for tpool, jpool in ((tr, jr), (ts, js)):
        if jpool.kv_scales is not None:
            np.testing.assert_allclose(tpool.kv_scales.numpy()[:, keep],
                                       np.asarray(jpool.kv_scales)[:, keep],
                                       rtol=1e-6)
        assert_pools_equal(tpool._replace(kv_scales=None),
                           jpool._replace(kv_scales=None),
                           skip_pages=(jr.k_data.shape[1] - 1,))


# ---------------------------------------------------------------------------
# A dual-pool fixture: 4 kv heads (2 retrieval, 2 streaming), three sequences
# ---------------------------------------------------------------------------

SINK_B, LOCAL_B = 1, 2
FLAGS = np.array([True, False, True, False])
RANK = np.array([0, 0, 1, 1], np.int32)
N_REP = 2
# longer than sink + ring (wrapped, mid page); wrapped, page boundary;
# shorter than the sink page (newest page among the sinks); inactive
LENS = np.array([5 * PAGE + 37, 4 * PAGE, 90, 0], np.int32)


def ring_slot(blk):
    return np.where(blk < SINK_B, blk, SINK_B + (blk - SINK_B) % LOCAL_B)


def build_dual_pools(kv_bits=4, kv_zeros=True):
    """Both pools filled as a whole-prompt prefill fills them (streaming
    writes that the ring would overwrite are dropped); per-tensor pools
    carry the same per-layer scales, as ``CacheEngine.load_kv_scales``
    gives both."""
    rng = np.random.default_rng(5)
    b, w = len(LENS), 6
    tables = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    stables = rng.permutation(b * 3).astype(np.int32).reshape(b, 3)
    pt = {}
    if not kv_zeros:
        pt = dict(zip(("k_scale_per_tensor", "v_scale_per_tensor"),
                      pt_scales(np.random.default_rng(6), kv_bits)))
    jr = j_kv.make_kv_pool(L, b * w + 1, 2, PAGE, D, kv_bits=kv_bits,
                           kv_zeros=kv_zeros, with_stats=True,
                           sub_chunks=SUB, **pt)
    js = j_kv.make_kv_pool(L, b * 3 + 1, 2, PAGE, D, kv_bits=kv_bits,
                           kv_zeros=kv_zeros, **pt)
    jr = j_kv.reset_page_stats_all_layers(jr, jnp.asarray(tables.reshape(-1)))
    for i, n in enumerate(LENS):
        if n == 0:
            continue
        pos = np.arange(n)
        blk = pos // PAGE
        k = rng.normal(size=(n, 4, D)).astype(np.float32)
        v = rng.normal(size=(n, 4, D)).astype(np.float32)
        pages_r = tables[i, blk]
        dead = (pos >= SINK_B * PAGE) & (pos < n - LOCAL_B * PAGE)
        pages_s = np.where(dead, -1, stables[i, ring_slot(blk)])
        slots = (pos % PAGE).astype(np.int32)
        for layer in range(L):
            kk = jnp.asarray(k * (1 + layer))
            jr = j_kv.append_kv(jr, layer, kk[:, FLAGS], jnp.asarray(
                v[:, FLAGS]), jnp.asarray(pages_r), jnp.asarray(slots),
                PAGE, kv_bits, kv_zeros)
            jr = j_kv.update_k_stats(jr, layer, kk[:, FLAGS],
                                     jnp.asarray(pages_r),
                                     jnp.asarray(slots), PAGE, SUB)
            js = j_kv.append_kv(js, layer, kk[:, ~FLAGS], jnp.asarray(
                v[:, ~FLAGS]), jnp.asarray(pages_s.astype(np.int32)),
                jnp.asarray(slots), PAGE, kv_bits, kv_zeros)
    q = rng.normal(size=(b, 4 * N_REP, D)).astype(np.float32)
    return dict(jr=jr, js=js, tr=to_torch_pool(jr), ts=to_torch_pool(js),
                tables=tables, stables=stables, q=q, kv_bits=kv_bits,
                kv_zeros=kv_zeros)


@pytest.fixture(scope="module")
def dual_pools():
    return build_dual_pools()


def selections(dp, layer, budget):
    jscores = j_ref.page_selector_scores(
        jnp.asarray(dp["q"]), dp["jr"].k_stats, layer,
        jnp.asarray(dp["tables"]), jnp.asarray(FLAGS), jnp.asarray(RANK))
    tscores = t_ref.page_selector_scores(
        torch.from_numpy(dp["q"]), dp["tr"].k_stats, layer,
        torch.from_numpy(dp["tables"]), torch.from_numpy(FLAGS),
        torch.from_numpy(RANK))
    jsel = j_ref.select_topk_pages(jscores, jnp.asarray(LENS), budget, PAGE)
    tsel = t_ref.select_topk_pages(tscores, torch.from_numpy(LENS), budget,
                                   PAGE)
    return jscores, tscores, jsel, tsel


@pytest.mark.parametrize("budget", [3, 4, 8])
def test_page_selector_matches_jax(dual_pools, budget):
    dp = dual_pools
    for layer in range(L):
        jscores, tscores, jsel, tsel = selections(dp, layer, budget)
        js_, ts_ = np.asarray(jscores), tscores.numpy()
        n_pages = -(-LENS // PAGE)
        for i, n in enumerate(n_pages):
            # whole pages only: a sub-chunk never written keeps +-inf stats,
            # whose bound is NaN by design (the newest page is forced in)
            full = LENS[i] // PAGE
            np.testing.assert_allclose(ts_[i, FLAGS, :full],
                                       js_[i, FLAGS, :full], rtol=1e-5,
                                       atol=1e-5)
            assert np.isneginf(ts_[i, ~FLAGS]).all()
        jsel, tsel = np.asarray(jsel), tsel.numpy()
        assert tsel.shape == jsel.shape == (len(LENS), 4, budget)
        assert tsel.dtype == np.int32
        for i, n in enumerate(n_pages):
            for h in range(4):
                assert set(tsel[i, h]) == set(jsel[i, h]), (i, h)
                if n > budget and FLAGS[h]:
                    assert tsel[i, h, 0] == n - 1       # newest page first
                    assert len(set(tsel[i, h]) - {-1}) == budget
        # selection really drops pages for the long sequences at budget 3
        if budget == 3:
            assert set(tsel[0, 0]) < set(range(6))


def decode_kwargs(dp, lib, page_idxes=None, streaming=True, dec=(None, None)):
    a = (lambda x: None if x is None else jnp.asarray(x)) if lib == "jax" \
        else (lambda x: None if x is None else torch.from_numpy(np.array(x)))
    kw = dict(head_is_retrieval=a(FLAGS), head_rank=a(RANK),
              sink_blocks=SINK_B, local_blocks=LOCAL_B,
              page_idxes=a(page_idxes), dec_sink_tokens=dec[0],
              dec_local_tokens=dec[1])
    if streaming:
        kw.update(streaming_pool=dp["js" if lib == "jax" else "ts"],
                  streaming_block_tables=a(dp["stables"]))
    return kw


@pytest.mark.parametrize("dec", [(None, None), (PAGE, 2 * PAGE), (64, 100)])
@pytest.mark.parametrize("budget", [None, 3])
def test_paged_decode_attention_dual_pools_matches_jax(dual_pools, budget,
                                                       dec):
    """Selected pages (retrieval heads) + the ring's band (streaming
    heads): the port's plain version against the JAX reference, and the
    page-list composition (what the card runs, here on its plain list
    version) against both. Covers a wrapped ring mid page and on a page
    boundary, a context inside the sink page, an inactive row, and a band
    narrower than the ring."""
    dp = dual_pools
    sm = D ** -0.5
    for layer in range(L):
        sel = None
        if budget is not None:
            sel = np.asarray(selections(dp, layer, budget)[2])
        want = np.asarray(j_ref.paged_decode_attention(
            jnp.asarray(dp["q"]), dp["jr"], layer, jnp.asarray(dp["tables"]),
            jnp.asarray(LENS), sm, PAGE, 4, True,
            **decode_kwargs(dp, "jax", sel, dec=dec)))
        tq = torch.from_numpy(dp["q"])
        targs = (tq, dp["tr"], layer, torch.from_numpy(dp["tables"]),
                 torch.from_numpy(LENS), sm, PAGE)
        got = t_dispatch.paged_decode_attention(
            *targs, 4, True, **decode_kwargs(dp, "torch", sel, dec=dec))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        lists = t_dec.paged_decode_attention(
            *targs, **decode_kwargs(dp, "torch", sel, dec=dec))
        np.testing.assert_allclose(lists.numpy(), want, rtol=0, atol=1e-4)
        assert np.abs(want[:3]).max() > 1e-2 and not want[3].any()


def test_streaming_page_lists_after_wrap(dual_pools):
    """The compact streaming list: the sink page, then the newest ring
    blocks resolved to the LOGICAL blocks they hold."""
    dp = dual_pools
    phys, logic, span = t_dec.streaming_page_lists(
        torch.from_numpy(dp["stables"]), torch.from_numpy(LENS), SINK_B, PAGE,
        2 * PAGE)
    assert span == LOCAL_B
    st = dp["stables"]
    # 5 pages + 37 tokens: current block 5 in ring slot 1, block 4 in slot 2
    assert logic[0].tolist() == [0, 5, 4]
    assert phys[0].tolist() == [st[0, 0], st[0, 1], st[0, 2]]
    # exactly 4 pages: current block 3 in slot 1, block 2 in slot 2
    assert logic[1].tolist() == [0, 3, 2]
    assert phys[1].tolist() == [st[1, 0], st[1, 1], st[1, 2]]
    # inside the sink page: no ring block yet; inactive: nothing
    assert logic[2].tolist() == [0, -1, -1]
    assert logic[3].tolist() == [-1, -1, -1]


def test_selected_pages_match_pallas_ph_kernel_interpret(dual_pools):
    """The port's plain per-head page-list attention against the Pallas
    ``_ph`` kernel run in interpret mode on the same lists."""
    dp = dual_pools
    layer, budget = 1, 3
    sel = np.asarray(selections(dp, layer, budget)[2])[:, FLAGS]  # [B,Hr,n]
    b = len(LENS)
    safe = np.clip(sel, 0, dp["tables"].shape[1] - 1)
    sel_phys = np.take_along_axis(
        np.repeat(dp["tables"][:, None, :], 2, 1), safe, axis=2)
    sel_phys = np.where(sel >= 0, sel_phys, 0).astype(np.int32)
    q_r = dp["q"].reshape(b, 4, N_REP, D)[:, FLAGS]
    want = np.asarray(j_sp.paged_mqa_attention_single_pass_ph(
        jnp.asarray(q_r), dp["jr"], layer, jnp.asarray(sel_phys),
        jnp.asarray(sel), jnp.asarray(LENS), sm_scale=D ** -0.5,
        page_size=PAGE, kv_zeros=True, interpret=True))
    got = t_dec.page_list_attention_plain(
        torch.from_numpy(np.ascontiguousarray(q_r)), dp["tr"], layer,
        torch.from_numpy(sel_phys), torch.from_numpy(sel),
        torch.from_numpy(LENS), sm_scale=D ** -0.5, page_size=PAGE)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)
    # and the port's own selected_page_lists gives the same lists
    t_phys, t_logic = t_dec.selected_page_lists(
        torch.from_numpy(np.asarray(selections(dp, layer, budget)[2])),
        torch.from_numpy(dp["tables"]), torch.tensor([0, 2]))
    np.testing.assert_array_equal(t_logic.numpy(), sel)
    np.testing.assert_array_equal(t_phys.numpy(), sel_phys)


@pytest.mark.parametrize("mode", ["kv8", "kv4-pt", "kv8-pt"])
def test_dual_pool_decode_kv_modes_match_jax(mode):
    """LServe's sparse decode over kv8 and per-tensor pools: the dual-pool
    attention (3 selected pages a retrieval head, the ring's band of 128
    sink + 256 local tokens) of the port's plain version and of its
    page-list composition against the JAX reference (1e-4, both f32 over
    the same codes), and the per-head list plain version against the
    Pallas ``_ph`` kernel in interpret mode with the pool's per-tensor
    scales (5e-2, as above)."""
    dp = build_dual_pools(*KV_MODES[mode])
    kv_bits, kv_zeros = dp["kv_bits"], dp["kv_zeros"]
    sm, layer, budget, dec = D ** -0.5, 1, 3, (PAGE, 2 * PAGE)
    sel = np.asarray(selections(dp, layer, budget)[2])
    want = np.asarray(j_ref.paged_decode_attention(
        jnp.asarray(dp["q"]), dp["jr"], layer, jnp.asarray(dp["tables"]),
        jnp.asarray(LENS), sm, PAGE, kv_bits, kv_zeros,
        **decode_kwargs(dp, "jax", sel, dec=dec)))
    targs = (torch.from_numpy(dp["q"]), dp["tr"], layer,
             torch.from_numpy(dp["tables"]), torch.from_numpy(LENS), sm, PAGE)
    got = t_dispatch.paged_decode_attention(
        *targs, kv_bits, kv_zeros, **decode_kwargs(dp, "torch", sel, dec=dec))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    lists = t_dec.paged_decode_attention(
        *targs, **decode_kwargs(dp, "torch", sel, dec=dec))
    np.testing.assert_allclose(lists.numpy(), want, rtol=0, atol=1e-4)
    assert np.abs(want[:3]).max() > 1e-2 and not want[3].any()

    sel_r = sel[:, FLAGS]
    b = len(LENS)
    safe = np.clip(sel_r, 0, dp["tables"].shape[1] - 1)
    sel_phys = np.take_along_axis(
        np.repeat(dp["tables"][:, None, :], 2, 1), safe, axis=2)
    sel_phys = np.where(sel_r >= 0, sel_phys, 0).astype(np.int32)
    q_r = np.ascontiguousarray(dp["q"].reshape(b, 4, N_REP, D)[:, FLAGS])
    jr = dp["jr"]
    pt = (None if kv_zeros else (jr.k_scale_per_tensor[layer],
                                 jr.v_scale_per_tensor[layer]))
    want_ph = np.asarray(j_sp.paged_mqa_attention_single_pass_ph(
        jnp.asarray(q_r), jr, layer, jnp.asarray(sel_phys),
        jnp.asarray(sel_r), jnp.asarray(LENS), sm_scale=sm, page_size=PAGE,
        kv_zeros=kv_zeros, pt_scales=pt, interpret=True))
    got_ph = t_dec.page_list_attention_plain(
        torch.from_numpy(q_r), dp["tr"], layer, torch.from_numpy(sel_phys),
        torch.from_numpy(sel_r), torch.from_numpy(LENS), sm_scale=sm,
        page_size=PAGE)
    np.testing.assert_allclose(got_ph.numpy(), want_ph, rtol=5e-2, atol=5e-2)
