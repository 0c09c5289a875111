"""Head dim 64 (Llama-3.2-1B, TinyLlama): the port against the JAX package
(CPU).

At head_dim 64 the JAX package's ``decode_attention.supports`` is False, so
its dispatch splits every decode step into the KV append (row 10) and the
two-stage decode (row 6, ``paged_attention.paged_mqa_attention``, pages
gathered first) over the dense history, the selector's per-head lists and
the streaming band. The same numpy inputs go through the JAX function and
its counterpart in ``omniserve_tpu_torch``:

- row 6: the port's page-list composition on the CPU (the plain version of
  the card's two-stage kernel, ``page_list_attention_plain``) against the
  JAX dispatch's Pallas path in interpret mode at D 64 and 32, over kv4 /
  kv8 pools, fine-grained and per-tensor, over a dense list, per-head lists
  and the band of a wrapped ring (2e-2, ``tests/test_pallas_paged_
  attention.py:68``'s tolerance) and against the JAX reference (1e-5);
- rows 9 and 7 at D 64: whole-prompt flash prefill (dense and the band)
  and chunked prefill (dense kv4, a per-tensor kv8 ring) against the
  Pallas kernels in interpret mode (2e-2) and the JAX reference (1e-5);
- row 10 at D 64: the plain append against the Pallas kernel in interpret
  mode, pool bytes and K stats equal;
- the route: the port's decode routing (``uses_two_stage``) against the
  JAX ``supports`` rule over a grid of (kv bits, page, head_dim), and
  ``dispatch.paged_decode_attention_fused`` at head_dim 64 against the JAX
  dispatch (output 1e-5, pool bytes equal);
- F4's rule: ``LlamaSpec.check_supported`` on a CUDA device refuses
  head_dims other than 64 / 128 and pages over 256 tokens, naming the
  limit; on the CPU it takes them all.

The 2-layer forwards at head_dim 64 are in
``tests/test_torch_head_dim64_forward.py``, both engines in
``tests/test_torch_head_dim64_engine.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops import paged_kv as j_kv
from omniserve_tpu.ops.pallas import decode_attention as j_sp
from omniserve_tpu.ops.pallas import flash_attention as j_flash
from omniserve_tpu.ops.pallas import kv_append as j_append
from omniserve_tpu.ops.pallas import paged_attention as j_pa
from omniserve_tpu.ops.pallas import paged_prefill as j_pp
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.ops import attention_ref as t_ref
from omniserve_tpu_torch.ops import dispatch as t_dispatch
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec
from omniserve_tpu_torch.ops.cuda import kv_append as t_append
from omniserve_tpu_torch.ops.cuda import paged_prefill as t_pp
from tests.test_torch_lserve_ops import assert_pools_equal, to_torch_pool

EXACT = 1e-5          # f32 plain versions against the JAX reference
PALLAS_TOL = 2e-2     # tests/test_pallas_paged_attention.py:68
PAGE = 16
SINK_B, LOCAL_B = 1, 2
FLAGS = np.array([True, False, True, False])
RANK = np.array([0, 0, 1, 1], np.int32)
N_REP = 4
# longer than sink + ring (wrapped, mid page); wrapped, page boundary;
# inside the sink page; inactive
LENS = np.array([5 * PAGE + 7, 4 * PAGE, 9, 0], np.int32)
KV_MODES = {"kv4": (4, True), "kv8": (8, True), "kv4-pt": (4, False),
            "kv8-pt": (8, False)}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ring_slot(blk):
    return np.where(blk < SINK_B, blk, SINK_B + (blk - SINK_B) % LOCAL_B)


def dual_pools(d, kv_bits, kv_zeros, seed=5):
    """LServe's retrieval pool (with K stats) and streaming ring pool, two
    rows each, filled as a whole-prompt prefill fills them (ring writes
    that a later wrap overwrites dropped), in both frameworks."""
    rng = np.random.default_rng(seed)
    b, w = len(LENS), 6
    tables = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    stables = rng.permutation(b * 3).astype(np.int32).reshape(b, 3)
    pt = {}
    if not kv_zeros:
        qmax = 7 if kv_bits == 4 else 127
        pt = dict(k_scale_per_tensor=jnp.asarray([3.1 / qmax], jnp.float32),
                  v_scale_per_tensor=jnp.asarray([2.9 / qmax], jnp.float32))
    jr = j_kv.make_kv_pool(1, b * w + 1, 2, PAGE, d, kv_bits=kv_bits,
                           kv_zeros=kv_zeros, **pt)
    js = j_kv.make_kv_pool(1, b * 3 + 1, 2, PAGE, d, kv_bits=kv_bits,
                           kv_zeros=kv_zeros, **pt)
    for i, n in enumerate(LENS):
        if n == 0:
            continue
        pos = np.arange(n)
        blk = pos // PAGE
        k = rng.normal(size=(n, 4, d)).astype(np.float32)
        v = rng.normal(size=(n, 4, d)).astype(np.float32)
        dead = (pos >= SINK_B * PAGE) & (pos < n - LOCAL_B * PAGE)
        pages_s = np.where(dead, -1, stables[i, ring_slot(blk)])
        slots = jnp.asarray((pos % PAGE).astype(np.int32))
        jr = j_kv.append_kv(jr, 0, jnp.asarray(k[:, FLAGS]),
                            jnp.asarray(v[:, FLAGS]),
                            jnp.asarray(tables[i, blk]), slots, PAGE,
                            kv_bits, kv_zeros)
        js = j_kv.append_kv(js, 0, jnp.asarray(k[:, ~FLAGS]),
                            jnp.asarray(v[:, ~FLAGS]),
                            jnp.asarray(pages_s.astype(np.int32)), slots,
                            PAGE, kv_bits, kv_zeros)
    q = rng.normal(size=(b, 4 * N_REP, d)).astype(np.float32)
    return dict(jr=jr, js=js, tr=to_torch_pool(jr), ts=to_torch_pool(js),
                tables=tables, stables=stables, q=q)


def decode_kwargs(dp, lib, page_idxes=None):
    a = (lambda x: None if x is None else jnp.asarray(x)) if lib == "jax" \
        else (lambda x: None if x is None else T(np.array(x)))
    return dict(head_is_retrieval=a(FLAGS), head_rank=a(RANK),
                sink_blocks=SINK_B, local_blocks=LOCAL_B,
                page_idxes=a(page_idxes),
                streaming_pool=dp["js" if lib == "jax" else "ts"],
                streaming_block_tables=a(dp["stables"]))


# -- row 6: the two-stage decode --------------------------------------------


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("mode", list(KV_MODES))
def test_two_stage_decode_plain_matches_jax_and_pallas(mode, d):
    """Row 6's kv4 / kv8 modes (fine-grained and per-tensor) where the
    JAX package runs them, head_dim 64 and 32: the dense history of a
    single pool, then the dual pools with the selector's per-head lists
    (two pages a retrieval head, in no order, a dead entry) and the
    streaming band over the wrapped ring. The port's page-list composition
    (``page_list_attention_plain`` per call) against the JAX dispatch's
    Pallas path in interpret mode (2e-2) and the JAX reference (1e-5)."""
    kv_bits, kv_zeros = KV_MODES[mode]
    assert not j_sp.supports(kv_bits, PAGE, d)
    dp = dual_pools(d, kv_bits, kv_zeros)
    sm = d ** -0.5
    b = len(LENS)
    # the dense history: one pool, every kv head a retrieval head
    q = np.random.default_rng(7).normal(size=(b, 2 * N_REP, d)).astype(
        np.float32)
    jargs = (jnp.asarray(q), dp["jr"], 0, jnp.asarray(dp["tables"]),
             jnp.asarray(LENS), sm, PAGE, kv_bits, kv_zeros)
    pallas = np.asarray(j_pa.paged_decode_attention(*jargs, interpret=True),
                        np.float32)
    want = np.asarray(j_ref.paged_decode_attention(*jargs), np.float32)
    got = t_dec.paged_decode_attention(
        T(q), dp["tr"], 0, T(dp["tables"]), T(LENS), sm, PAGE).numpy()
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got, pallas, rtol=PALLAS_TOL, atol=PALLAS_TOL)
    assert np.abs(want[:3]).max() > 1e-2 and not want[3].any()
    # the dual pools: per-head lists and the band
    sel = np.full((b, 4, 3), -1, np.int32)
    n_pg = -(-LENS // PAGE)
    for i, n in enumerate(n_pg):
        if n:
            sel[i, :, 0] = n - 1
            sel[i, :, 2] = np.arange(4) % n
    sel[:, ~FLAGS] = -1
    jargs = (jnp.asarray(dp["q"]), dp["jr"], 0, jnp.asarray(dp["tables"]),
             jnp.asarray(LENS), sm, PAGE, kv_bits, kv_zeros)
    pallas = np.asarray(j_pa.paged_decode_attention(
        *jargs, interpret=True, **decode_kwargs(dp, "jax", sel)), np.float32)
    want = np.asarray(j_ref.paged_decode_attention(
        *jargs, **decode_kwargs(dp, "jax", sel)), np.float32)
    got = t_dec.paged_decode_attention(
        T(dp["q"]), dp["tr"], 0, T(dp["tables"]), T(LENS), sm, PAGE,
        **decode_kwargs(dp, "torch", sel)).numpy()
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got, pallas, rtol=PALLAS_TOL, atol=PALLAS_TOL)
    assert np.abs(want[:3]).max() > 1e-2 and not want[3].any()


# -- rows 9, 7 and 10 at head_dim 64 -----------------------------------------


@pytest.mark.parametrize("band", [False, True])
def test_flash_prefill_plain_d64_matches_jax_and_pallas(band):
    """Whole-prompt prefill at head_dim 64, two packed prompts, 8 q over 2
    kv heads (n_rep 4), dense and with one kv head streaming (sink 16,
    local 48): the port's plain version against the Pallas flash kernel in
    interpret mode (2e-2) and the JAX reference (1e-5)."""
    rng = np.random.default_rng(64 + band)
    d, lens, hkv = 64, [90, 38], 2
    t, hq = sum(lens), hkv * N_REP
    q, k, v = (jnp.asarray(rng.normal(size=(t, h, d)), jnp.bfloat16)
               .astype(jnp.float32) for h in (hq, hkv, hkv))
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]) \
        .astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    sm = d ** -0.5
    jkw, tkw = {}, {}
    if band:
        flags = np.repeat(np.array([True, False]), N_REP)
        jkw = dict(head_is_retrieval=jnp.asarray(flags), sink_size=16,
                   local_size=48)
        tkw = dict(head_is_retrieval=T(flags), sink_size=16, local_size=48)
    want = np.asarray(j_ref.prefill_attention(
        q, k, v, jnp.asarray(seg), jnp.asarray(pos), sm, **jkw))
    pallas = np.asarray(j_flash.prefill_attention(
        q, k, v, jnp.asarray(seg), jnp.asarray(pos), sm, interpret=True,
        **jkw), np.float32)
    tq, tk, tv = (T(np.asarray(x)) for x in (q, k, v))
    got = t_dispatch.prefill_attention(tq, tk, tv, T(seg), T(pos), sm,
                                       **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got, pallas, rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_paged_prefill_plain_d64_matches_jax_and_pallas():
    """Chunked prefill at head_dim 64: a 16-token chunk after 37 tokens of
    history over a kv4 pool (dense heads), then an 8-token chunk over a
    per-tensor kv8 ring of 1 + 2 pages (wrapped, stale rows past the write
    head) with the band: the port's dispatch against the JAX dispatch
    (1e-5) and the Pallas kernel in interpret mode (2e-2)."""
    rng = np.random.default_rng(66)
    d, hkv = 64, 2
    sm = d ** -0.5
    # dense kv4
    hist, tq = 37, 16
    ctx = np.array([hist + tq], np.int32)
    table = np.array([[3, 0, 5, 1]], np.int32)
    jpool = j_kv.make_kv_pool(1, 7, hkv, PAGE, d, kv_bits=4, kv_zeros=True)
    pos = np.arange(int(ctx[0]))
    jpool = j_kv.append_kv(
        jpool, 0, jnp.asarray(rng.normal(size=(len(pos), hkv, d)),
                              jnp.float32),
        jnp.asarray(rng.normal(size=(len(pos), hkv, d)), jnp.float32),
        jnp.asarray(table[0, pos // PAGE]), jnp.asarray(pos % PAGE), PAGE,
        4, True)
    q = rng.normal(size=(1, tq, hkv * N_REP, d)).astype(np.float32)
    q_pos = np.arange(hist, hist + tq, dtype=np.int32)[None]
    jargs = (jnp.asarray(q), jpool, 0, jnp.asarray(table), jnp.asarray(q_pos),
             jnp.asarray(ctx), sm, PAGE, 4, True)
    want = np.asarray(j_dispatch.paged_prefill_attention(*jargs))
    pallas = np.asarray(j_pp.paged_prefill_attention(*jargs, interpret=True),
                        np.float32)
    got = t_dispatch.paged_prefill_attention(
        T(q), to_torch_pool(jpool), 0, T(table), T(q_pos), T(ctx), sm, PAGE,
        4, True).numpy()
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got, pallas, rtol=PALLAS_TOL, atol=PALLAS_TOL)
    # a per-tensor kv8 ring with the band
    n_slots, length, tq = SINK_B + LOCAL_B, 61, 8
    qmax = 127
    jpool = j_kv.make_kv_pool(
        1, n_slots + 1, 1, PAGE, d, kv_bits=8, kv_zeros=False,
        k_scale_per_tensor=jnp.asarray([1.6 / qmax], jnp.float32),
        v_scale_per_tensor=jnp.asarray([1.4 / qmax], jnp.float32))
    pos = np.arange(length)
    table = np.arange(n_slots, dtype=np.int32)[None]
    jpool = j_kv.append_kv(
        jpool, 0, jnp.asarray(rng.normal(size=(length, 1, d)) * 0.5,
                              jnp.float32),
        jnp.asarray(rng.normal(size=(length, 1, d)) * 0.5, jnp.float32),
        jnp.asarray(table[0, ring_slot(pos // PAGE)]),
        jnp.asarray(pos % PAGE), PAGE, 8, False)
    ctx = np.array([length], np.int32)
    q = rng.normal(size=(1, tq, N_REP, d)).astype(np.float32)
    q_pos = np.arange(length - tq, length, dtype=np.int32)[None]
    band = dict(sink_size=PAGE, local_size=2 * PAGE,
                ring_span_pages=LOCAL_B, ring_sink_tokens=SINK_B * PAGE)
    flags = np.zeros(N_REP, bool)
    j_sel = j_kv.ring_logical_blocks(jnp.asarray(ctx), n_slots, SINK_B,
                                     LOCAL_B, PAGE)
    t_sel = t_kv.ring_logical_blocks(T(ctx), n_slots, SINK_B, LOCAL_B, PAGE)
    jargs = (jnp.asarray(q), jpool, 0, jnp.asarray(table), jnp.asarray(q_pos),
             jnp.asarray(ctx), sm, PAGE, 8, False)
    want = np.asarray(j_dispatch.paged_prefill_attention(
        *jargs, head_is_retrieval=jnp.asarray(flags), sel_logic=j_sel,
        **band))
    pallas = np.asarray(j_pp.paged_prefill_attention(
        *jargs, head_is_retrieval=jnp.asarray(flags), sel_logic=j_sel,
        interpret=True, **band), np.float32)
    got = t_dispatch.paged_prefill_attention(
        T(q), to_torch_pool(jpool), 0, T(table), T(q_pos), T(ctx), sm, PAGE,
        8, False, head_is_retrieval=T(flags), sel_logic=t_sel,
        **band).numpy()
    assert (t_sel.numpy() > n_slots - 1).any()          # the ring wrapped
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got, pallas, rtol=PALLAS_TOL, atol=PALLAS_TOL)
    direct = t_pp.paged_prefill_attention_plain(
        T(q), to_torch_pool(jpool), 0, T(table), T(q_pos), T(ctx),
        sm_scale=sm, page_size=PAGE, head_is_retrieval=T(flags),
        sel_logic=t_sel, kv_bits=8, kv_zeros=False, **band).numpy()
    np.testing.assert_array_equal(direct, got)


@pytest.mark.parametrize("mode", ["kv4", "kv8-pt", "kv16"])
def test_append_plain_d64_matches_pallas(mode):
    """The decode step's append at head_dim 64 with K stats: the port's
    plain version (what row 10 is held to on the card) against the Pallas
    kernel in interpret mode over dirty pages, two tokens inactive: pool
    bytes and stats equal on every page but the trash page, planes within
    ``tests/test_pallas_kv_append.py``'s 1e-6 (the Pallas kernel's folded
    planes sit an ulp off the JAX scatter path's, which the port's equal
    exactly, ``tests/test_torch_lserve_ops.py``)."""
    kv_bits, kv_zeros = KV_MODES.get(mode, (16, True))
    rng = np.random.default_rng(67)
    d, h, t, n_pages = 64, 2, 6, 9
    pt = {}
    if not kv_zeros:
        pt = dict(k_scale_per_tensor=jnp.asarray([2.9 / 127], jnp.float32),
                  v_scale_per_tensor=jnp.asarray([3.1 / 127], jnp.float32))
    jpool = j_kv.make_kv_pool(1, n_pages, h, PAGE, d, kv_bits=kv_bits,
                              kv_zeros=kv_zeros, with_stats=True, **pt)
    if kv_bits == 16:
        dirty = dict(k_data=jnp.asarray(rng.normal(
            size=jpool.k_data.shape).astype(np.float32), jnp.bfloat16))
    else:
        dirty = dict(k_data=jnp.asarray(rng.integers(
            0, 256, jpool.k_data.shape, dtype=np.uint8)))
    dirty["k_stats"] = jnp.asarray(rng.normal(
        size=jpool.k_stats.shape).astype(np.float32))
    jpool = jpool._replace(**dirty)
    tpool = to_torch_pool(jpool)
    k = rng.normal(size=(t, h, d)).astype(np.float32)
    v = rng.normal(size=(t, h, d)).astype(np.float32)
    pages = np.array([4, -1, 0, 7, -1, 2], np.int32)
    slots = np.array([3, 0, 15, 8, 1, 0], np.int32)
    jpool = j_append.append_kv_decode(
        jpool, 0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
        jnp.asarray(slots), PAGE, kv_bits, kv_zeros, update_stats=True,
        interpret=True)
    t_append.append_kv_decode_plain(
        tpool, 0, T(k), T(v), T(pages), T(slots), PAGE, update_stats=True,
        kv_bits=kv_bits, kv_zeros=kv_zeros)
    keep = slice(0, n_pages - 1)                    # the trash page out
    if jpool.kv_scales is not None:
        np.testing.assert_allclose(tpool.kv_scales.numpy()[:, keep],
                                   np.asarray(jpool.kv_scales)[:, keep],
                                   rtol=1e-6)
    assert_pools_equal(tpool._replace(kv_scales=None),
                       jpool._replace(kv_scales=None),
                       skip_pages=(n_pages - 1,))


# -- the route ---------------------------------------------------------------


def test_decode_route_matches_jax_supports():
    """Over a grid of (kv bits, page, head_dim), the port sends a decode
    to rows 4 / 5 (the single-pass kernels) exactly where the JAX
    ``supports`` rule holds, and to row 6 everywhere else, kv16 pools
    always."""
    for kv_bits in (4, 8, 16):
        for page in (16, 32, 64, 128, 192, 256):
            for d in (32, 64, 96, 128, 256):
                pool = t_kv.make_kv_pool(1, 2, 1, page, d, kv_bits=kv_bits,
                                         device="cpu")
                want = j_sp.supports(kv_bits, page, d)
                assert t_dispatch.supports(kv_bits, page, d) == want
                assert t_dec.uses_two_stage(pool, page, d) == (not want), \
                    (kv_bits, page, d)


@pytest.mark.parametrize("mode", list(KV_MODES))
def test_fused_decode_d64_matches_jax_dispatch(mode):
    """``dispatch.paged_decode_attention_fused`` at head_dim 64 (its split
    path: the append, then row 6's plain version) against the JAX
    dispatch's: output 1e-5, pool bytes equal."""
    kv_bits, kv_zeros = KV_MODES[mode]
    dp = dual_pools(64, kv_bits, kv_zeros, seed=8)
    rng = np.random.default_rng(9)
    d, b = 64, len(LENS)
    sm = d ** -0.5
    lens = LENS + (LENS > 0)
    q = rng.normal(size=(b, 2 * N_REP, d)).astype(np.float32)
    k_new = rng.normal(size=(b, 2, d)).astype(np.float32)
    v_new = rng.normal(size=(b, 2, d)).astype(np.float32)
    tables = dp["tables"]
    tgt = np.where(lens > 0, (lens - 1) // PAGE, 0)
    slot = np.where(lens > 0, (lens - 1) % PAGE, 0).astype(np.int32)
    phys = np.where(lens > 0, tables[np.arange(b), tgt], -1).astype(np.int32)
    want, jpool, _ = j_dispatch.paged_decode_attention_fused(
        jnp.asarray(q), dp["jr"], None, 0, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(phys), jnp.asarray(slot), None, None, sm_scale=sm,
        page_size=PAGE, kv_bits=kv_bits, kv_zeros=kv_zeros)
    got, tpool, _ = t_dispatch.paged_decode_attention_fused(
        T(q), dp["tr"], None, 0, T(tables), T(lens), T(k_new), T(v_new),
        sm_scale=sm, page_size=PAGE, kv_bits=kv_bits, kv_zeros=kv_zeros)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EXACT,
                               atol=EXACT)
    assert_pools_equal(tpool, jpool, skip_pages=(dp["tr"].k_data.shape[1]
                                                 - 1,))


# -- F4 ----------------------------------------------------------------------


def test_check_supported_refuses_on_a_card_only():
    """F4: on a CUDA device ``check_supported`` refuses head_dim 80, 96 and
    256 and pages of 384 / 512 tokens, naming the limit and ROADMAP.md
    queue 2 item G; it takes head_dim 64 / 128 and pages up to 256. On the
    CPU it takes every one of them."""
    base = dict(num_layers=1, num_q_heads=8, num_kv_heads=2, vocab=128,
                intermediate=256, weight_bits=4, act_bits=8, kv_bits=4,
                kv_zeros=True)

    def spec(d, page):
        return t_llama.LlamaSpec(hidden=8 * d, head_dim=d, page_size=page,
                                 **base)

    for d in (80, 96, 256):
        with pytest.raises(NotImplementedError,
                           match=f"head_dim {d}.*64 or 128.*queue 2 item G"):
            spec(d, 64).check_supported("cuda")
    for page in (384, 512):
        with pytest.raises(NotImplementedError,
                           match=f"{page}-token pages.*256.*queue 2 item G"):
            spec(64, page).check_supported(torch.device("cuda:0"))
    for d in (64, 128):
        for page in (16, 64, 128, 256):
            spec(d, page).check_supported("cuda")
    for d in (64, 80, 96, 128, 256):
        for page in (64, 256, 384, 512):
            spec(d, page).check_supported("cpu")
            spec(d, page).check_supported()
