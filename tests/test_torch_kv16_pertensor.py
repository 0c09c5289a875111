"""kv16 pools and per-tensor KV in the port against the JAX package (CPU).

- the per-tensor quantizer byte for byte (kv4 and kv8 codes, exact .5
  ties and clipped values);
- kv16 and per-tensor (kv4, kv8) pools: layout, ``append_kv`` bytes and
  ``gather_kv_for_seq`` equal to JAX, with per-layer scales drawn so the
  codes span their range (unit scales would leave most codes at the bias);
- decode over a kv16 pool: the fused entry's plain path (append, then
  attend) against the JAX dispatch's split path, the JAX reference and
  the two-stage Pallas kernel (``paged_attention.paged_decode_attention``,
  interpret mode), within 5e-2 (``tests/test_decode_attention_sp.py``),
  pools equal; the list kernel's plain version over the dense list;
- the per-tensor fused decode against the JAX dispatch and the Pallas
  single-pass kernel's per-tensor append mode, within 5e-2, pools equal;
- dense paged prefill over kv16 and per-tensor pages against the JAX
  reference (1e-5: both f32 over the same pages) and the Pallas kernel in
  interpret mode (2e-2, ``tests/test_paged_prefill.py``);
- 2-layer tiny forwards of ``w16a16kv16`` and of ``w8a8kv8`` and
  ``w4a8kv4`` per-tensor with calibrated scales (whole-prompt prefill, a
  decode step, a chunked prefill) against the op-by-op JAX forward, logits
  within 1e-4 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops import quantization as j_q
from omniserve_tpu.ops.paged_kv import append_kv as j_append_kv
from omniserve_tpu.ops.paged_kv import gather_kv_for_seq as j_gather
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu.ops.pallas import decode_attention as j_sp
from omniserve_tpu.ops.pallas import paged_attention as j_pa
from omniserve_tpu.ops.pallas.paged_prefill import (
    paged_prefill_attention as j_paged_prefill,
)
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import (
    params_from_numpy,
    pool_from_numpy,
)
from omniserve_tpu_torch.ops import dispatch
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops import quantization as t_q
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec
from omniserve_tpu_torch.worker.model_runner import chunked_prefill_batches

LOGIT_RTOL = 1e-4
# mode -> (kv_bits, kv_zeros)
MODES = {"kv16": (16, True), "pt4": (4, False), "pt8": (8, False)}
FIELDS = ("k_data", "v_data", "kv_scales", "k_scale_per_tensor",
          "v_scale_per_tensor")


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def J(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_pools_equal(tpool, jpool):
    for name in FIELDS:
        a, b = getattr(tpool, name), getattr(jpool, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(N(a), J(b), err_msg=name)


def pt_scales(rng, layers, kv_bits, x_amax=3.5):
    """Per-layer K and V scales whose codes span the range of N(0, 1)."""
    qmax = 7 if kv_bits == 4 else 127
    return [(x_amax / qmax * rng.uniform(0.8, 1.2, layers)).astype(
        np.float32) for _ in range(2)]


def set_pt_scales(pool, ks, vs):
    """Per-tensor scales into a port pool (its unit ones stay without)."""
    if ks is not None:
        pool.k_scale_per_tensor.copy_(torch.as_tensor(ks))
        pool.v_scale_per_tensor.copy_(torch.as_tensor(vs))


def make_pools(rng, mode, layers, n_pages, h, page, d):
    kv_bits, kv_zeros = MODES[mode]
    ks = vs = None
    if not kv_zeros:
        ks, vs = pt_scales(rng, layers, kv_bits)
    jpool = j_make_kv_pool(
        layers, n_pages, h, page, d, kv_bits=kv_bits, kv_zeros=kv_zeros,
        k_scale_per_tensor=None if ks is None else jnp.asarray(ks),
        v_scale_per_tensor=None if vs is None else jnp.asarray(vs))
    tpool = t_kv.make_kv_pool(
        layers, n_pages, h, page, d, kv_bits=kv_bits, kv_zeros=kv_zeros,
        device="cpu")
    set_pt_scales(tpool, ks, vs)
    return jpool, tpool


def filled_pool(rng, mode, page, h, d, lengths, tables, layers=2):
    """A JAX pool holding ``lengths[s]`` random tokens of each sequence s
    (pages from ``tables[s]``) in every layer."""
    kv_bits, kv_zeros = MODES[mode]
    jpool, _ = make_pools(rng, mode, layers, int(np.max(tables)) + 2, h,
                          page, d)
    for lay in range(layers):
        for s, ln in enumerate(lengths):
            pos = np.arange(ln)
            jpool = j_append_kv(
                jpool, lay,
                jnp.asarray(rng.standard_normal((ln, h, d)), jnp.float32),
                jnp.asarray(rng.standard_normal((ln, h, d)), jnp.float32),
                jnp.asarray(tables[s][pos // page]), jnp.asarray(pos % page),
                page_size=page, kv_bits=kv_bits, kv_zeros=kv_zeros,
            )
    return jpool


def bf16_exact(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return N(T(x).to(torch.bfloat16).float())


# -- quantizer and pools ---------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
def test_per_tensor_quantizer_matches_jax(bits):
    rng = np.random.default_rng(20)
    qmax = 7 if bits == 4 else 127
    scale = np.float32(3.5 / qmax)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    # exact .5 ties (round half to even) and values past the clip
    x[0, :8] = (np.arange(8) - 3.5).astype(np.float32) * scale
    x[1, :4] = np.float32([-1, 1, -2, 2]) * (qmax + 3) * scale
    want = np.asarray(j_q.kv_quantize_per_tensor(jnp.asarray(x),
                                                 jnp.asarray(scale), bits))
    got = N(t_q.kv_quantize_per_tensor(T(x), T(scale), bits))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.min() == 0
    assert got.max() == 2 * qmax + 1


@pytest.mark.parametrize("mode", list(MODES))
def test_pool_layout_and_append_match_jax(mode):
    rng = np.random.default_rng(21)
    page, h, d = 16, 2, 32
    jpool, tpool = make_pools(rng, mode, 2, 7, h, page, d)
    for name in FIELDS:
        a, b = getattr(tpool, name), getattr(jpool, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert tuple(a.shape) == b.shape, name
            assert str(a.dtype).split(".")[-1] == str(b.dtype), name
    assert_pools_equal(tpool, jpool)
    kv_bits, kv_zeros = MODES[mode]
    # a prefill-style append (two sequences, a dropped padding row) and a
    # decode-style append on top, into layer 1
    t = 40
    k = rng.standard_normal((t, h, d)).astype(np.float32)
    v = rng.standard_normal((t, h, d)).astype(np.float32)
    pages = np.repeat(np.array([3, 0, 5], np.int32), [16, 16, 8])
    pages[-1] = -1
    slots = np.concatenate([np.arange(16), np.arange(16),
                            np.arange(8)]).astype(np.int32)
    kd = rng.standard_normal((2, h, d)).astype(np.float32)
    for kk, vv, pg, sl in ((k, v, pages, slots),
                           (kd, kd[::-1].copy(), np.array([5, 6], np.int32),
                            np.array([8, 0], np.int32))):
        jpool = j_append_kv(jpool, 1, jnp.asarray(kk), jnp.asarray(vv),
                            jnp.asarray(pg), jnp.asarray(sl), page, kv_bits,
                            kv_zeros)
        t_kv.append_kv(tpool, 1, T(kk), T(vv), T(pg), T(sl), page, kv_bits,
                       kv_zeros)
        assert_pools_equal(tpool, jpool)
    if not kv_zeros:      # the codes really span the range
        codes = N(tpool.k_data[1]).astype(int)
        lo, hi = (codes & 15, codes >> 4) if kv_bits == 4 else (codes, codes)
        assert min(lo.min(), hi.min()) <= 2
        assert max(lo.max(), hi.max()) >= (13 if kv_bits == 4 else 200)


@pytest.mark.parametrize("mode", list(MODES))
def test_gather_matches_jax(mode):
    rng = np.random.default_rng(22)
    page, h, d = 16, 2, 32
    kv_bits, kv_zeros = MODES[mode]
    tables = np.array([[4, 1, 5], [2, 3, 0]], np.int32)
    jpool = filled_pool(rng, mode, page, h, d, [37, 20], tables)
    tpool = pool_from_numpy(jax.tree.map(np.asarray, jpool), "cpu")
    assert_pools_equal(tpool, jpool)
    for i in range(2):
        jk, jv = j_gather(jpool, 1, jnp.asarray(tables[i]), page, kv_bits,
                          kv_zeros)
        tk, tv = t_kv.gather_kv_for_seq(tpool, 1, T(tables[i]), page,
                                        kv_bits, kv_zeros)
        np.testing.assert_array_equal(N(tk), J(jk))
        np.testing.assert_array_equal(N(tv), J(jv))
    bk, _ = t_kv.gather_kv_for_seq(tpool, 1, T(tables), page, kv_bits,
                                   kv_zeros)
    np.testing.assert_array_equal(N(bk[1]), J(j_gather(
        jpool, 1, jnp.asarray(tables[1]), page, kv_bits, kv_zeros)[0]))


# -- decode ------------------------------------------------------------------


def decode_case(rng, mode):
    page, h, d, n_rep, w = 128, 2, 128, 2, 4
    lengths_old = [page * 2 + 17, page - 1, 3 * page, 0]
    b = len(lengths_old)
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    tables[3] = 0
    jpool = filled_pool(rng, mode, page, h, d, lengths_old[:3], tables[:3])
    q = bf16_exact(rng, (b, h * n_rep, d))
    k_new, v_new = bf16_exact(rng, (b, h, d)), bf16_exact(rng, (b, h, d))
    lens = np.asarray(lengths_old, np.int32) + 1
    lens[3] = 0
    tgt = np.where(lens > 0, (lens - 1) // page, 0)
    slot = np.where(lens > 0, (lens - 1) % page, 0).astype(np.int32)
    phys = np.where(lens > 0, tables[np.arange(b), tgt], -1).astype(np.int32)
    return dict(page=page, h=h, d=d, n_rep=n_rep, w=w, b=b, tables=tables,
                jpool=jpool, q=q, k_new=k_new, v_new=v_new, lens=lens,
                tgt=tgt, slot=slot, phys=phys, sm=d ** -0.5)


def fused_both(c, mode):
    """The JAX dispatch (its split path on the CPU) and the port's fused
    entry on the same inputs; returns (want, jpool', got, tpool')."""
    kv_bits, kv_zeros = MODES[mode]
    want, jpool_out, _ = j_dispatch.paged_decode_attention_fused(
        jnp.asarray(c["q"]), c["jpool"], None, 1, jnp.asarray(c["tables"]),
        jnp.asarray(c["lens"]), jnp.asarray(c["k_new"]),
        jnp.asarray(c["v_new"]), jnp.asarray(c["phys"]),
        jnp.asarray(c["slot"]), None, None, sm_scale=c["sm"],
        page_size=c["page"], kv_bits=kv_bits, kv_zeros=kv_zeros)
    tpool = pool_from_numpy(jax.tree.map(np.asarray, c["jpool"]), "cpu")
    got, tpool_out, _ = dispatch.paged_decode_attention_fused(
        T(c["q"]), tpool, None, 1, T(c["tables"]), T(c["lens"]),
        T(c["k_new"]), T(c["v_new"]), sm_scale=c["sm"], page_size=c["page"],
        kv_bits=kv_bits, kv_zeros=kv_zeros)
    np.testing.assert_allclose(N(got), J(want), rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(N(got)[3], 0.0)
    assert_pools_equal(tpool_out, jpool_out)
    return want, jpool_out, got, tpool_out


def test_kv16_decode_plain_matches_jax():
    """kv16 decode: the port's fused entry (on the CPU append, then the
    plain attention) against the JAX dispatch, the JAX reference over the
    appended pool, and the two-stage Pallas kernel in interpret mode; the
    list kernel's plain version over the dense list gives the same."""
    rng = np.random.default_rng(23)
    c = decode_case(rng, "kv16")
    _, jpool_out, got, tpool_out = fused_both(c, "kv16")
    args = (1, jnp.asarray(c["tables"]), jnp.asarray(c["lens"]), c["sm"],
            c["page"], 16, True)
    ref = J(j_ref.paged_decode_attention(jnp.asarray(c["q"]), jpool_out,
                                         *args))
    np.testing.assert_allclose(N(got), ref, rtol=5e-2, atol=5e-2)
    assert not j_sp.supports(16, c["page"], c["d"])   # the two-stage path
    pallas = J(j_pa.paged_decode_attention(
        jnp.asarray(c["q"]), jpool_out, *args, interpret=True))
    np.testing.assert_allclose(N(got)[:3], pallas[:3], rtol=5e-2, atol=5e-2)
    b, h, n_rep, d = c["b"], c["h"], c["n_rep"], c["d"]
    lists = t_dec.dense_page_lists(T(c["tables"]), T(c["lens"]), c["page"])
    plain = t_dec.page_list_attention_plain(
        T(c["q"]).reshape(b, h, n_rep, d), tpool_out, 1, *lists,
        T(c["lens"]), sm_scale=c["sm"], page_size=c["page"])
    np.testing.assert_allclose(N(plain).reshape(b, h * n_rep, d), N(got),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["pt4", "pt8"])
def test_per_tensor_fused_decode_plain_matches_jax(mode):
    """Per-tensor fused decode: against the JAX dispatch (outputs within
    5e-2, pool bytes equal) and the Pallas single-pass kernel's per-tensor
    append mode in interpret mode."""
    rng = np.random.default_rng(24)
    c = decode_case(rng, mode)
    _, _, got, _ = fused_both(c, mode)
    b, h, n_rep, d, w = c["b"], c["h"], c["n_rep"], c["d"], c["w"]
    lens = c["lens"]
    n_pg = (lens + c["page"] - 1) // c["page"]
    tile = np.arange(w)
    sel_logic = np.where(tile[None, :] < n_pg[:, None], tile[None, :], -1)
    jpool = c["jpool"]
    pallas, _ = j_sp.paged_mqa_attention_single_pass(
        jnp.asarray(c["q"]).reshape(b, h, n_rep, d), jpool, 1,
        jnp.asarray(np.where(sel_logic >= 0, c["tables"], 0)),
        jnp.asarray(sel_logic), jnp.asarray(lens), sm_scale=c["sm"],
        page_size=c["page"], kv_zeros=False,
        pt_scales=(jpool.k_scale_per_tensor[1], jpool.v_scale_per_tensor[1]),
        append=(jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
                jnp.asarray(np.where(lens > 0, c["tgt"], -1).astype(
                    np.int32)),
                jnp.asarray(c["slot"])),
        interpret=True,
    )
    np.testing.assert_allclose(
        N(got)[:3], np.asarray(pallas).reshape(b, h * n_rep, d)[:3],
        rtol=5e-2, atol=5e-2)


# -- paged prefill -----------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("history,chunk", [(0, 24), (40, 24)])
def test_paged_prefill_plain_matches_jax(mode, history, chunk):
    rng = np.random.default_rng(25)
    kv_bits, kv_zeros = MODES[mode]
    page, h, n_rep, d, b = 16, 2, 2, 128, 2
    total = history + chunk
    n_blocks = -(-total // page) + 1
    tables = np.arange(b * n_blocks, dtype=np.int32).reshape(b, n_blocks)
    jpool = filled_pool(rng, mode, page, h, d, [total] * b, tables,
                        layers=1)
    q = rng.normal(size=(b, chunk, h * n_rep, d)).astype(np.float32)
    q = N(T(q).to(torch.bfloat16).float())
    q_pos = np.tile(history + np.arange(chunk), (b, 1)).astype(np.int32)
    ctx = np.full(b, total, np.int32)
    q_pos[1, chunk - 5:] = -1                 # ragged query padding
    ctx[1] = total - 5
    args = (0.088, page, kv_bits, kv_zeros)
    jargs = (jnp.asarray(q), jpool, 0, jnp.asarray(tables),
             jnp.asarray(q_pos), jnp.asarray(ctx), *args)
    want = np.asarray(j_ref.paged_prefill_attention(*jargs))
    pallas = J(j_paged_prefill(*jargs, tile_q=8, interpret=True))
    tpool = pool_from_numpy(jax.tree.map(np.asarray, jpool), "cpu")
    got = N(dispatch.paged_prefill_attention(
        T(q), tpool, 0, T(tables), T(q_pos), T(ctx), *args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    live = q_pos >= 0
    np.testing.assert_allclose(got[live], pallas[live], rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got[~live], 0.0)


# -- 2-layer forwards ----------------------------------------------------------

PAGE = 16
# label -> (weight bits, act bits, kv bits, kv_zeros, per-layer K and V
# scales): per-tensor scales calibrated as max |x| / qmax of the tiny
# model's K and V (0.6-1.3 in size), as a checkpoint's would be
FORWARDS = {
    "w16a16kv16": (16, 16, 16, True, None),
    "w8a8kv8-pt": (8, 8, 8, False, ([0.0069, 0.0102], [0.0094, 0.0084])),
    "w4a8kv4-pt": (4, 8, 4, False, ([0.089, 0.104], [0.095, 0.093])),
}


def spec_kwargs(label):
    w, a, kv, zeros, _ = FORWARDS[label]
    return dict(
        num_layers=2, hidden=64, intermediate=128, num_q_heads=4,
        num_kv_heads=2, head_dim=16, vocab=128, page_size=PAGE,
        rope_base=500000.0, weight_bits=w, act_bits=a, kv_bits=kv,
        kv_zeros=zeros, lm_head_bits=8,
    )


def assert_logits_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)


def assert_pools_close(tpool, jpool):
    """Per-tensor codes equal but for a rare step at an exact rounding tie
    (under 1e-3 of them). kv16 pages hold the qkv product's bf16 values as
    they are: the two forwards sum that product in other f32 orders, which
    flips the bf16 rounding of about one value in a thousand (under 1e-2
    of them), and a value that cancels to near zero can move by more than
    its own ulp (within 1e-3 of the pool's largest value)."""
    for name in ("k_data", "v_data"):
        a, b = N(getattr(tpool, name)), J(getattr(jpool, name))
        if a.dtype == np.uint8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            assert (a != b).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-2,
                                       atol=1e-3 * np.abs(b).max())
            assert (a != b).mean() < 1e-2, name


def forward_setup(label, seed):
    j_spec = j_llama.LlamaSpec(**spec_kwargs(label))
    t_spec = t_llama.LlamaSpec(**spec_kwargs(label))
    t_spec.check_supported()
    jparams = j_llama.make_random_packed_params(j_spec, seed=seed)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return j_spec, t_spec, jparams, tparams


def forward_pools(label, n_pages):
    """Twin pools; per-tensor ones with the label's calibrated scales."""
    _, _, kv, zeros, scales = FORWARDS[label]
    ks = vs = None
    if scales is not None:
        ks, vs = (np.float32(x) for x in scales)
    jpool = j_make_kv_pool(
        2, n_pages, 2, PAGE, 16, kv_bits=kv, kv_zeros=zeros,
        k_scale_per_tensor=None if ks is None else jnp.asarray(ks),
        v_scale_per_tensor=None if vs is None else jnp.asarray(vs))
    tpool = t_kv.make_kv_pool(
        2, n_pages, 2, PAGE, 16, kv_bits=kv, kv_zeros=zeros, device="cpu")
    set_pt_scales(tpool, ks, vs)
    return jpool, tpool


@pytest.mark.parametrize("label", list(FORWARDS))
def test_forward_matches_jax(label):
    j_spec, t_spec, jparams, tparams = forward_setup(label, seed=3)
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
    jpool, tpool = forward_pools(label, 9)
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
    assert_pools_close(tpool, jpool)

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
    assert_pools_close(tpool, jpool)


@pytest.mark.parametrize("label", list(FORWARDS))
def test_chunked_prefill_matches_jax(label):
    """Two prompts in [2, 32] chunks: the second chunk of the 40-token
    prompt reads the first back from the kv16 / per-tensor pool (dense
    paged prefill)."""
    j_spec, t_spec, jparams, tparams = forward_setup(label, seed=6)
    rng = np.random.default_rng(7)
    seqs = [(rng.integers(0, 128, 40).tolist(), [4, 1, 7]),
            (rng.integers(0, 128, 23).tolist(), [2, 6])]
    jpool, tpool = forward_pools(label, 9)
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
    assert_pools_close(tpool, jpool)
