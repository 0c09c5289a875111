"""QServe's precision matrix in the port against the JAX package (CPU).

- the per-group (progressive) weight quantizer and its dequantization:
  codes, s1, s2 planes byte for byte, for g in {32, 128} and one or two
  K shards, and a hand-made s2 = 17 weight whose int8 reconstruction wraps;
- the per-group GEMM's plain version against the JAX reference and the
  Pallas kernel in interpret mode at the shapes of
  ``tests/test_pallas_quant_matmul.py``, within its 1e-5;
- the kv8 pool: layout, ``append_kv`` bytes and planes, ``gather_kv_for_seq``
  equal to JAX; the fused decode's plain version (append, then attend)
  against the JAX dispatch within 5e-2 (``tests/test_decode_attention_sp.
  py``) with pool bytes equal, and against the Pallas kernel's append mode;
  dense paged prefill against the JAX reference (1e-5, both f32 over the
  same pages) and the Pallas kernel in interpret mode (2e-2,
  ``tests/test_paged_prefill.py``);
- a 2-layer tiny forward of every newly served precision (prefill, one
  decode step; a chunked prefill for kv8) against the op-by-op JAX forward,
  logits within 1e-4 of their scale (the integer GEMMs are exact and the
  f32 op order is the JAX one, see ``tests/test_torch_llama.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops import matmul as j_mm
from omniserve_tpu.ops import quantization as j_q
from omniserve_tpu.ops.paged_kv import append_kv as j_append_kv
from omniserve_tpu.ops.paged_kv import gather_kv_for_seq as j_gather
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu.ops.pallas import decode_attention as j_sp
from omniserve_tpu.ops.pallas import quant_matmul as j_pk
from omniserve_tpu.ops.pallas.paged_prefill import (
    paged_prefill_attention as j_paged_prefill,
)
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import (
    params_from_numpy,
    pool_from_numpy,
)
from omniserve_tpu_torch.ops import dispatch
from omniserve_tpu_torch.ops import matmul as t_mm
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops import quantization as t_q
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec
from omniserve_tpu_torch.ops.cuda import paged_prefill as t_pp
from omniserve_tpu_torch.worker.model_runner import chunked_prefill_batches

LOGIT_RTOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def assert_fields_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(N(a), np.asarray(b), err_msg=name)


# -- per-group weights ----------------------------------------------------


@pytest.mark.parametrize("group_size,k_shards", [(32, 1), (32, 2), (128, 1),
                                                 (128, 2)])
def test_per_group_quantizer_matches_jax(group_size, k_shards):
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((96, 512)) * 0.05).astype(np.float32)
    w[5, :40] = 0.7                  # a group near the int8 edge
    want = j_q.quantize_weight_per_group(jnp.asarray(w), group_size,
                                         k_shards=k_shards)
    got = t_q.quantize_weight_per_group(T(w), group_size, k_shards=k_shards)
    assert isinstance(got, t_q.QuantizedWeightPerGroup)
    assert_fields_equal(got, want)
    if k_shards == 1:
        np.testing.assert_array_equal(
            N(t_q.dequantize_per_group(got, group_size)),
            np.asarray(j_q.dequantize_per_group(want, group_size)))


def s2_17_weight(rng, n=128, k=256, g=32):
    """A weight whose caller-given s1 leaves no stage-2 headroom: every
    group spans the whole int8 range, so s2 = 17 and the codes reach 15;
    ``15 * 17 + s2_zero`` then leaves int8 and must wrap as JAX wraps."""
    w = rng.uniform(-1.0, 1.0, (n, k)).astype(np.float32)
    wg = w.reshape(n, k // g, g)
    wg[:, :, 0], wg[:, :, 1] = 1.0, -1.0 - 1.0 / 127
    s1 = np.full(n, 1.0 / 127, np.float32)
    return w, s1


def test_per_group_s2_17_wraps_as_jax():
    rng = np.random.default_rng(11)
    g = 32
    w, s1 = s2_17_weight(rng, g=g)
    want = j_q.quantize_weight_per_group(jnp.asarray(w), g,
                                         s1_scales=jnp.asarray(s1))
    got = t_q.quantize_weight_per_group(T(w), g, s1_scales=T(s1))
    assert_fields_equal(got, want)
    assert int(N(got.s2_scales).max()) == 17
    # hand-made codes at the edge: u4 = 15, s2 = 17, and zeros that push
    # the int16 reconstruction past +127 and below -128
    k2, n = got.qweight.shape
    qweight = np.full((k2, n), 0xFF, np.uint8)
    s2 = np.full((2 * k2 // g, n), 17, np.int8)
    s2z = rng.choice(np.array([-8, 0, 100, -128, 127], np.int8),
                     size=s2.shape)
    x = rng.standard_normal((8, 2 * k2)).astype(np.float32)
    a_i8, a_scale, _ = j_q.quantize_activations(jnp.asarray(x))
    for qw, sc, zr in ((qweight, s2, s2z),
                       (N(got.qweight), N(got.s2_scales), N(got.s2_zeros))):
        ref = np.asarray(j_mm.w4a8_matmul_per_group_ref(
            a_i8, jnp.asarray(qw), jnp.asarray(s1), jnp.asarray(sc),
            jnp.asarray(zr), a_scale, group_size=g, out_dtype=jnp.float32))
        out = N(t_mm.w4a8_matmul_per_group_ref(
            T(a_i8), T(qw), T(s1), T(sc), T(zr), T(a_scale), group_size=g,
            out_dtype=torch.float32))
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("m,k,n,g", [(4, 512, 256, 128), (33, 1024, 128, 64)])
def test_per_group_ref_matches_jax_and_pallas(m, k, n, g):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((n, k), dtype=np.float32) * 0.05
    q = j_q.quantize_weight_per_group(jnp.asarray(w), group_size=g)
    x = rng.standard_normal((m, k), dtype=np.float32)
    a_i8, a_scale, _ = j_q.quantize_activations(jnp.asarray(x))
    args = (a_i8, q.qweight, q.s1_scales, q.s2_scales, q.s2_zeros, a_scale)
    want = np.asarray(j_mm.w4a8_matmul_per_group_ref(
        *args, group_size=g, out_dtype=jnp.float32))
    pallas = np.asarray(j_pk.w4a8_matmul_per_group(
        *args, group_size=g, out_dtype=jnp.float32, interpret=True))
    got = N(t_mm.w4a8_matmul_per_group(
        *(T(a) for a in args), group_size=g, out_dtype=torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    # stacked [L, ...] weights: the layer's view gives the same product
    stacked = [T(np.stack([np.zeros_like(a), a])) for a in args[1:5]]
    got_l = N(t_mm.w4a8_matmul_per_group(
        T(a_i8), *stacked, T(a_scale), group_size=g, out_dtype=torch.float32,
        layer=1))
    np.testing.assert_array_equal(got_l, got)


# -- kv8 pools ---------------------------------------------------------------


def kv8_pool(rng, page, h, d, lengths, tables, layers=2):
    """A JAX kv8 pool holding ``lengths`` tokens per sequence."""
    pool = j_make_kv_pool(layers, tables.size + 1, h, page, d, kv_bits=8,
                          kv_zeros=True)
    for lay in range(layers):
        for s, ln in enumerate(lengths):
            pos = np.arange(ln)
            pool = j_append_kv(
                pool, lay,
                jnp.asarray(rng.standard_normal((ln, h, d)), jnp.float32),
                jnp.asarray(rng.standard_normal((ln, h, d)), jnp.float32),
                jnp.asarray(tables[s][pos // page]), jnp.asarray(pos % page),
                page_size=page, kv_bits=8, kv_zeros=True,
            )
    return pool


def test_kv8_pool_layout_and_append_match_jax():
    rng = np.random.default_rng(12)
    page, h, d = 16, 2, 32
    jpool = j_make_kv_pool(2, 7, h, page, d, kv_bits=8, kv_zeros=True)
    tpool = t_kv.make_kv_pool(2, 7, h, page, d, kv_bits=8, device="cpu")
    for name in ("k_data", "v_data", "kv_scales"):
        a, b = getattr(tpool, name), getattr(jpool, name)
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
    # a prefill-style append (two sequences, a dropped padding row) and a
    # decode-style append on top, into layer 1
    t = 40
    k = rng.standard_normal((t, h, d)).astype(np.float32)
    v = rng.standard_normal((t, h, d)).astype(np.float32)
    pages = np.repeat(np.array([3, 0, 5], np.int32), [16, 16, 8])
    pages[-1] = -1
    slots = np.concatenate([np.arange(16), np.arange(16),
                            np.arange(8)]).astype(np.int32)
    steps = [(k, v, pages, slots)]
    kd = rng.standard_normal((2, h, d)).astype(np.float32)
    steps.append((kd, kd[::-1].copy(), np.array([5, 6], np.int32),
                  np.array([8, 0], np.int32)))
    for kk, vv, pg, sl in steps:
        jpool = j_append_kv(jpool, 1, jnp.asarray(kk), jnp.asarray(vv),
                            jnp.asarray(pg), jnp.asarray(sl), page, 8, True)
        t_kv.append_kv(tpool, 1, T(kk), T(vv), T(pg), T(sl), page, 8, True)
        for name in ("k_data", "v_data", "kv_scales"):
            np.testing.assert_array_equal(N(getattr(tpool, name)),
                                          np.asarray(getattr(jpool, name)))


def test_kv8_gather_matches_jax():
    rng = np.random.default_rng(13)
    page, h, d = 16, 2, 32
    tables = np.array([[4, 1, 5], [2, 3, 0]], np.int32)
    jpool = kv8_pool(rng, page, h, d, [37, 20], tables)
    tpool = pool_from_numpy(jpool, "cpu")
    for i in range(2):
        jk, jv = j_gather(jpool, 1, jnp.asarray(tables[i]), page, 8, True)
        tk, tv = t_kv.gather_kv_for_seq(tpool, 1, T(tables[i]), page, 8,
                                        True)
        np.testing.assert_array_equal(N(tk), np.asarray(jk))
        np.testing.assert_array_equal(N(tv), np.asarray(jv))
    bk, _ = t_kv.gather_kv_for_seq(tpool, 1, T(tables), page, 8)
    np.testing.assert_array_equal(N(bk[1]), np.asarray(j_gather(
        jpool, 1, jnp.asarray(tables[1]), page, 8, True)[0]))


def test_kv8_fused_decode_plain_matches_jax():
    """The plain fused decode over a kv8 pool against the JAX dispatch
    (its split path on the CPU) and the Pallas single-pass kernel's append
    mode in interpret mode: outputs within 5e-2, pool bytes and planes
    equal to the JAX split path's."""
    rng = np.random.default_rng(14)
    page, h, d, n_rep, w = 128, 2, 128, 2, 4
    lengths_old = [page * 2 + 17, page - 1, 3 * page, 0]
    b = len(lengths_old)
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    tables[3] = 0
    jpool = kv8_pool(rng, page, h, d, lengths_old[:3], tables[:3])
    tpool = pool_from_numpy(jpool, "cpu")
    # what the first call reads (it appends into ``tpool`` in place)
    pool_in = [t.clone() for t in tpool if t is not None]

    def bf16_exact(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return N(T(x).to(torch.bfloat16).float())

    q = bf16_exact((b, h * n_rep, d))
    k_new, v_new = bf16_exact((b, h, d)), bf16_exact((b, h, d))
    lens = np.asarray(lengths_old, np.int32) + 1
    lens[3] = 0
    sm = d ** -0.5
    tgt = np.where(lens > 0, (lens - 1) // page, 0)
    slot = np.where(lens > 0, (lens - 1) % page, 0).astype(np.int32)
    phys = np.where(lens > 0, tables[np.arange(b), tgt], -1).astype(np.int32)
    want, jpool_out, _ = j_dispatch.paged_decode_attention_fused(
        jnp.asarray(q), jpool, None, 1, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(phys), jnp.asarray(slot), None, None, sm_scale=sm,
        page_size=page, kv_bits=8, kv_zeros=True)
    got, tpool_out, _ = dispatch.paged_decode_attention_fused(
        T(q), tpool, None, 1, T(tables), T(lens), T(k_new), T(v_new),
        sm_scale=sm, page_size=page, kv_bits=8, kv_zeros=True)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_array_equal(N(got)[3], 0.0)
    for name in ("k_data", "v_data", "kv_scales"):
        np.testing.assert_array_equal(N(getattr(tpool_out, name)),
                                      np.asarray(getattr(jpool_out, name)))
    # the Pallas kernel's kv8 append mode on the same inputs
    n_pg = (lens + page - 1) // page
    tile = np.arange(w)
    sel_logic = np.where(tile[None, :] < n_pg[:, None], tile[None, :], -1)
    pallas, _ = j_sp.paged_mqa_attention_single_pass(
        jnp.asarray(q).reshape(b, h, n_rep, d), jpool, 1,
        jnp.asarray(np.where(sel_logic >= 0, tables, 0)),
        jnp.asarray(sel_logic), jnp.asarray(lens), sm_scale=sm,
        page_size=page, kv_zeros=True,
        append=(jnp.asarray(k_new), jnp.asarray(v_new),
                jnp.asarray(np.where(lens > 0, tgt, -1).astype(np.int32)),
                jnp.asarray(slot)),
        interpret=True,
    )
    np.testing.assert_allclose(
        N(got)[:3], np.asarray(pallas).reshape(b, h * n_rep, d)[:3],
        rtol=5e-2, atol=5e-2)
    # the kernel wrapper's plain version is the same function
    tpool2 = pool_from_numpy(jpool, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        pool_in, [t for t in tpool2 if t is not None])), (
        "the JAX calls changed the pool the second call reads")
    plain = t_dec.paged_decode_attention_fused_plain(
        T(q), tpool2, 1, T(tables), T(lens), T(k_new), T(v_new), sm_scale=sm,
        page_size=page, kv_bits=8)
    # ROADMAP.md queue 3 F6: the threads this call ran under, if it differs
    np.testing.assert_array_equal(
        N(plain), N(got), err_msg=f"torch threads {torch.get_num_threads()}; "
        f"{torch.__config__.parallel_info()}")


@pytest.mark.parametrize("history,chunk", [(0, 24), (40, 24)])
def test_kv8_paged_prefill_plain_matches_jax(history, chunk):
    rng = np.random.default_rng(15)
    page, h, n_rep, d, b = 16, 2, 2, 128, 2
    total = history + chunk
    n_blocks = -(-total // page) + 1
    tables = np.arange(b * n_blocks, dtype=np.int32).reshape(b, n_blocks)
    jpool = kv8_pool(rng, page, h, d, [total] * b, tables, layers=1)
    q = rng.normal(size=(b, chunk, h * n_rep, d)).astype(np.float32)
    q_pos = np.tile(history + np.arange(chunk), (b, 1)).astype(np.int32)
    ctx = np.full(b, total, np.int32)
    q_pos[1, chunk - 5:] = -1                 # ragged query padding
    ctx[1] = total - 5
    args = (0.088, page, 8, True)
    jargs = (jnp.asarray(q), jpool, 0, jnp.asarray(tables),
             jnp.asarray(q_pos), jnp.asarray(ctx), *args)
    want = np.asarray(j_ref.paged_prefill_attention(*jargs))
    pallas = np.asarray(j_paged_prefill(*jargs, tile_q=8, interpret=True))
    tpool = pool_from_numpy(jpool, "cpu")
    got = N(dispatch.paged_prefill_attention(
        T(q), tpool, 0, T(tables), T(q_pos), T(ctx), *args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    live = q_pos >= 0
    np.testing.assert_allclose(got[live], pallas[live], rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got[~live], 0.0)
    plain = N(t_pp.paged_prefill_attention_plain(
        T(q), tpool, 0, T(tables), T(q_pos), T(ctx), sm_scale=0.088,
        page_size=page, kv_bits=8))
    np.testing.assert_array_equal(plain, got)


# -- 2-layer forwards ------------------------------------------------------

PAGE = 16
PRECISIONS = {                      # precision -> (w, a, kv)
    "w4a8kv4": (4, 8, 4), "w4a8kv8": (4, 8, 8), "w8a8kv8": (8, 8, 8),
    "w8a8kv4": (8, 8, 4), "w16a16kv8": (16, 16, 8), "w16a16kv4": (16, 16, 4),
}


def spec_kwargs(precision, group_size):
    w, a, kv = PRECISIONS[precision]
    return dict(
        num_layers=2, hidden=64, intermediate=128, num_q_heads=4,
        num_kv_heads=2, head_dim=16, vocab=128, page_size=PAGE,
        rope_base=500000.0, weight_bits=w, act_bits=a, kv_bits=kv,
        kv_zeros=True, group_size=group_size, lm_head_bits=8,
    )


def assert_logits_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)


def assert_pools_close(tpool, jpool, kv_bits):
    """Codes equal but for a rare step at an exact rounding tie."""
    for name in ("k_data", "v_data"):
        a = N(getattr(tpool, name)).astype(int)
        b = np.asarray(getattr(jpool, name)).astype(int)
        if kv_bits == 4:
            for shift in (0, 4):
                assert np.abs(((a >> shift) & 15)
                              - ((b >> shift) & 15)).max() <= 1
        else:
            assert np.abs(a - b).max() <= 1
        assert (a != b).mean() < 1e-3, name
    np.testing.assert_allclose(N(tpool.kv_scales), np.asarray(jpool.kv_scales),
                               rtol=1e-3, atol=1e-6)


def jax_and_port_params(precision, group_size, seed):
    j_spec = j_llama.LlamaSpec(**spec_kwargs(precision, group_size))
    t_spec = t_llama.LlamaSpec(**spec_kwargs(precision, group_size))
    t_spec.check_supported()
    jparams = j_llama.make_random_packed_params(j_spec, seed=seed)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return j_spec, t_spec, jparams, tparams


FORWARD_CASES = [("w4a8kv4", 32), ("w4a8kv8", -1), ("w4a8kv8", 32),
                 ("w8a8kv8", -1), ("w8a8kv4", -1), ("w16a16kv8", -1),
                 ("w16a16kv4", -1)]


@pytest.mark.parametrize("precision,group_size", FORWARD_CASES)
def test_forward_matches_jax(precision, group_size):
    j_spec, t_spec, jparams, tparams = jax_and_port_params(
        precision, group_size, seed=3)
    body = type(tparams["layers"]["qkv"]).__name__
    assert body == {4: ("QuantizedWeightPerGroup" if group_size > 0
                        else "QuantizedWeightPerChannel"),
                    8: "QuantizedWeightW8", 16: "Tensor"}[t_spec.weight_bits]
    kv = t_spec.kv_bits
    rng = np.random.default_rng(4)
    lens = [13, 20]
    t_pad, w = 48, 3
    tables = np.array([[4, 1, 7], [2, 6, 0]], np.int32)
    tokens = np.zeros(t_pad, np.int32)
    pos = np.zeros(t_pad, np.int32)
    seg = np.full(t_pad, -1, np.int32)
    o = 0
    for i, n in enumerate(lens):
        tokens[o:o + n] = rng.integers(0, 128, n)
        pos[o:o + n] = np.arange(n)
        seg[o:o + n] = i
        o += n
    last = np.cumsum(lens) - 1
    jpool = j_make_kv_pool(2, 9, 2, PAGE, 16, kv_bits=kv, kv_zeros=True)
    tpool = t_kv.make_kv_pool(2, 9, 2, PAGE, 16, kv_bits=kv, device="cpu")
    j_batch = j_llama.PrefillBatch(
        token_ids=jnp.asarray(tokens), positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), block_tables=jnp.asarray(tables),
        streaming_block_tables=jnp.zeros((2, 1), jnp.int32),
        last_token_idx=jnp.asarray(last, jnp.int32),
        seq_lens=jnp.asarray(lens, jnp.int32),
        new_page_ids=jnp.full((8,), -1, jnp.int32),
    )
    t_batch = t_llama.PrefillBatch(
        token_ids=T(tokens), positions=T(pos), segment_ids=T(seg),
        block_tables=T(tables), last_token_idx=T(last),
    )
    with jax.disable_jit():
        j_logits, jpool, _, _ = j_llama.llama_forward(
            jparams, jpool, None, j_batch, j_spec, is_prefill=True)
    t_logits, tpool, _, _ = t_llama.llama_forward(
        tparams, tpool, None, t_batch, t_spec, is_prefill=True)
    assert_logits_close(N(t_logits), np.asarray(j_logits))
    assert_pools_close(tpool, jpool, kv)

    nxt = np.append(np.asarray(j_logits).argmax(-1), 0).astype(np.int32)
    dpos = np.array(lens + [0], np.int32)
    active = np.array([True, True, False])
    dtables = np.concatenate([tables, np.zeros((1, w), np.int32)])
    j_dec = j_llama.DecodeBatch(
        token_ids=jnp.asarray(nxt), positions=jnp.asarray(dpos),
        block_tables=jnp.asarray(dtables),
        streaming_block_tables=jnp.zeros((3, 1), jnp.int32),
        active=jnp.asarray(active), new_page_ids=jnp.full((8,), -1, jnp.int32),
        refresh_selection=jnp.asarray(False),
        cached_page_idxes=jnp.full((2, 3, 1, 1), -1, jnp.int32),
    )
    t_dec_batch = t_llama.DecodeBatch(
        token_ids=T(nxt), positions=T(dpos), block_tables=T(dtables),
        active=T(active),
    )
    with jax.disable_jit():
        j_logits, jpool, _, _ = j_llama.llama_forward(
            jparams, jpool, None, j_dec, j_spec, is_prefill=False)
    t_logits, tpool, _, _ = t_llama.llama_forward(
        tparams, tpool, None, t_dec_batch, t_spec, is_prefill=False)
    assert_logits_close(N(t_logits)[:2], np.asarray(j_logits)[:2])
    assert_pools_close(tpool, jpool, kv)


@pytest.mark.parametrize("precision,group_size", [("w4a8kv8", 32),
                                                  ("w16a16kv8", -1)])
def test_chunked_prefill_kv8_matches_jax(precision, group_size):
    """Two prompts in [2, 32] chunks: the second chunk of the 40-token
    prompt reads the first back from the kv8 pool (dense paged prefill)."""
    j_spec, t_spec, jparams, tparams = jax_and_port_params(
        precision, group_size, seed=6)
    rng = np.random.default_rng(7)
    seqs = [(rng.integers(0, 128, 40).tolist(), [4, 1, 7]),
            (rng.integers(0, 128, 23).tolist(), [2, 6])]
    jpool = j_make_kv_pool(2, 9, 2, PAGE, 16, kv_bits=8, kv_zeros=True)
    tpool = t_kv.make_kv_pool(2, 9, 2, PAGE, 16, kv_bits=8, device="cpu")
    j_final = t_final = None
    n_chunks = 0
    for t_batch, ends in chunked_prefill_batches(seqs, 64, PAGE, "cpu"):
        n_chunks += 1
        j_batch = j_llama.PrefillBatch(
            token_ids=jnp.asarray(N(t_batch.token_ids), jnp.int32),
            positions=jnp.asarray(N(t_batch.positions)),
            segment_ids=jnp.asarray(N(t_batch.segment_ids)),
            block_tables=jnp.asarray(N(t_batch.block_tables)),
            streaming_block_tables=jnp.zeros((2, 1), jnp.int32),
            last_token_idx=jnp.asarray(N(t_batch.last_token_idx), jnp.int32),
            seq_lens=jnp.asarray(N(t_batch.seq_lens)),
            new_page_ids=jnp.full((8,), -1, jnp.int32),
            context_lens=jnp.asarray(N(t_batch.context_lens)),
        )
        with jax.disable_jit():
            j_logits, jpool, _, _ = j_llama.llama_forward(
                jparams, jpool, None, j_batch, j_spec, is_prefill=True)
        t_logits, tpool, _, _ = t_llama.llama_forward(
            tparams, tpool, None, t_batch, t_spec, is_prefill=True)
        m = N(ends)[:, None]
        j_logits, t_logits = np.asarray(j_logits), N(t_logits)
        j_final = j_logits if j_final is None else np.where(m, j_logits,
                                                            j_final)
        t_final = t_logits if t_final is None else np.where(m, t_logits,
                                                            t_final)
    assert n_chunks == 2
    assert_logits_close(t_final, j_final)
    assert_pools_close(tpool, jpool, 8)
