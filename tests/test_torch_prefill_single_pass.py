"""The single-pass prefill (row 8) and the decode-step embedding gather
(row 11) of the port against the JAX package (CPU).

The same numpy inputs go through the JAX function and its counterpart in
``omniserve_tpu_torch``:

- the plain version of the single-pass kernel against the Pallas kernel in
  interpret mode (2e-2, ``tests/test_prefill_single_pass.py``'s tolerance:
  the kernel rounds q and P to bf16) in four modes (fine-grained kv4,
  per-tensor kv8, the streaming band, a wrapped ring), and against the
  JAX reference over the JAX test's grid (f32 on both sides: 1e-5);
- the dispatch rule that sends chunked prefill to the single-pass kernel,
  against the JAX dispatch's rule, and both switches on the CPU (the plain
  paths);
- the plain version of the row gather against the Pallas kernel in
  interpret mode, byte for byte, out-of-range ids included.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import paged_kv as j_kv
from omniserve_tpu.ops.pallas.decode_attention import supports as j_supports
from omniserve_tpu.ops.pallas.embed_gather import embed_gather as j_embed
from omniserve_tpu.ops.pallas.prefill_single_pass import (
    paged_prefill_single_pass as j_psp,
)
from omniserve_tpu_torch.models.convert import pool_from_numpy
from omniserve_tpu_torch.ops import dispatch as t_dispatch
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops.cuda import embed_gather as t_embed
from omniserve_tpu_torch.ops.cuda import paged_prefill as t_pp
from omniserve_tpu_torch.ops.cuda import prefill_single_pass as t_psp

B, HKV, NREP, D, PAGE = 2, 2, 2, 128, 16
HQ = HKV * NREP
SM = 0.088
EXACT = 1e-5          # f32 plain versions against the JAX reference
KERNEL_TOL = 2e-2     # against the Pallas kernel (bf16 q and P)
PT_SCALE = {4: 3.5 / 7, 8: 3.5 / 127}   # per-tensor scales: codes span


def T(a):
    return torch.from_numpy(np.array(a))


class _NumpyPool:
    def __init__(self, jpool):
        for name in jpool._fields:
            a = getattr(jpool, name)
            setattr(self, name, None if a is None else np.array(a))


def bf16_normal(rng, shape):
    """bf16-representable f32 values: the Pallas kernel rounds q to bf16."""
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                      .astype(jnp.float32))


def setup(rng, kv_bits, kv_zeros, history, chunk, total_lens=None):
    """A pool with each sequence's history + chunk appended by the JAX
    ``append_kv`` (pages of the two sequences in order), in both
    frameworks, and a chunk of queries ending at each context."""
    lens = total_lens or [history + chunk] * B
    n_blocks = -(-max(lens) // PAGE) + 1
    pt = {}
    if not kv_zeros:
        pt = {f"{kv}_scale_per_tensor": jnp.full((1,), PT_SCALE[kv_bits],
                                                 jnp.float32)
              for kv in "kv"}
    pool = j_kv.make_kv_pool(1, B * n_blocks + 1, HKV, PAGE, D,
                             kv_bits=kv_bits, kv_zeros=kv_zeros, **pt)
    tables = np.arange(B * n_blocks, dtype=np.int32).reshape(B, n_blocks)
    for i, t in enumerate(lens):
        k = rng.normal(size=(t, HKV, D)).astype(np.float32)
        v = rng.normal(size=(t, HKV, D)).astype(np.float32)
        pool = j_kv.append_kv(pool, 0, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(tables[i][np.arange(t) // PAGE]),
                              jnp.asarray(np.arange(t) % PAGE), PAGE,
                              kv_bits, kv_zeros)
    q = bf16_normal(rng, (B, chunk, HQ, D))
    q_pos = np.stack([n - chunk + np.arange(chunk) for n in lens]).astype(
        np.int32)
    ctx = np.asarray(lens, np.int32)
    return pool, tables, q, q_pos, ctx


def both(jpool, tables, q, q_pos, ctx):
    """The JAX arrays and the port's tensors of one call."""
    j = (jnp.asarray(q), jpool, 0, jnp.asarray(tables), jnp.asarray(q_pos),
         jnp.asarray(ctx))
    t = (T(q), pool_from_numpy(_NumpyPool(jpool), "cpu"), 0, T(tables),
         T(q_pos), T(ctx))
    return j, t


def port_plain(targs, kv_bits, kv_zeros, **kw):
    return t_psp.paged_prefill_single_pass_plain(
        *targs, sm_scale=SM, page_size=PAGE, kv_bits=kv_bits,
        kv_zeros=kv_zeros, **kw).numpy()


# -- the plain version against the Pallas kernel in interpret mode ---------


@pytest.mark.parametrize("mode", ["kv4", "kv8_pt", "band"])
def test_plain_matches_pallas_kernel(mode):
    """Fine-grained kv4 (history 40, chunk 24), per-tensor kv8, and the
    band (kv head 1 streaming, sink 16, local 16) over a dense table."""
    rng = np.random.default_rng(11)
    kv_bits, kv_zeros = (8, False) if mode == "kv8_pt" else (4, True)
    history = 48 if mode == "band" else 40
    chunk = 16 if mode == "band" else 24
    jargs, targs = both(*setup(rng, kv_bits, kv_zeros, history, chunk))
    kw, jkw = {}, {}
    if mode == "band":
        flags = np.repeat([True, False], NREP)
        kw = dict(head_is_retrieval=T(flags), sink_size=16, local_size=16)
        jkw = dict(kw, head_is_retrieval=jnp.asarray(flags))
    want = np.asarray(j_psp(*jargs, SM, PAGE, kv_bits, kv_zeros, tile_q=8,
                            interpret=True, **jkw), np.float32)
    got = port_plain(targs, kv_bits, kv_zeros, **kw)
    np.testing.assert_allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    if mode == "band":   # the band changed the streaming head's rows
        dense = port_plain(targs, kv_bits, kv_zeros)
        assert np.array_equal(got[:, :, :NREP], dense[:, :, :NREP])
        assert not np.allclose(got[:, :, NREP:], dense[:, :, NREP:])


def test_plain_matches_pallas_kernel_wrapped_ring():
    """The streaming heads' call over a 1 + 4 page ring wrapped by a
    100-token context (stale rows past the write head relabelled one ring
    span back): ``sel_logic`` + ``ring_span_pages`` in both."""
    rng = np.random.default_rng(12)
    sink_b, local_b, length, tq, h = 1, 4, 100, 8, 1
    n_slots = sink_b + local_b
    jpool = j_kv.make_kv_pool(1, n_slots + 1, h, PAGE, D, kv_bits=4,
                              kv_zeros=True)
    pos = np.arange(length)
    blk = pos // PAGE
    slot = np.where(blk < sink_b, blk, sink_b + (blk - sink_b) % local_b)
    jpool = j_kv.append_kv(
        jpool, 0, jnp.asarray(rng.normal(size=(length, h, D)), jnp.float32),
        jnp.asarray(rng.normal(size=(length, h, D)), jnp.float32),
        jnp.asarray(slot), jnp.asarray(pos % PAGE), PAGE, 4, True)
    table = np.arange(n_slots, dtype=np.int32)[None]
    q = bf16_normal(rng, (1, tq, h * NREP, D))
    q_pos = np.arange(length - tq, length, dtype=np.int32)[None]
    ctx = np.array([length], np.int32)
    jargs, targs = both(jpool, table, q, q_pos, ctx)
    j_sel = j_kv.ring_logical_blocks(jnp.asarray(ctx), n_slots, sink_b,
                                     local_b, PAGE)
    t_sel = t_kv.ring_logical_blocks(T(ctx), n_slots, sink_b, local_b, PAGE)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
    assert (t_sel.numpy() > n_slots - 1).any()          # the ring wrapped
    flags = np.zeros(h * NREP, bool)
    # a local band of 56 reaches the stale rows (positions 36-47)
    band = dict(sink_size=PAGE, local_size=56)
    ring = dict(ring_span_pages=local_b, ring_sink_tokens=sink_b * PAGE)
    kv_pos = t_psp.paged_prefill.kv_positions_of(t_sel, T(ctx), PAGE,
                                                 local_b, sink_b * PAGE)[0]
    stale = kv_pos[t_sel[0].repeat_interleave(PAGE) == (length - 1) // PAGE]
    assert int(stale.min()) == 36 and int(stale.max()) == 99
    want = np.asarray(j_psp(*jargs, SM, PAGE, 4, True,
                            head_is_retrieval=jnp.asarray(flags),
                            sel_logic=j_sel, tile_q=8, interpret=True,
                            **band, **ring), np.float32)
    got = port_plain(targs, 4, True, head_is_retrieval=T(flags),
                     sel_logic=t_sel, **band, **ring)
    np.testing.assert_allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)


# -- the plain version against the JAX reference (the JAX test's grid) ------


@pytest.mark.parametrize("kv_bits,kv_zeros,history,chunk", [
    (bits, zeros, h, c) for bits, zeros, (h, c) in itertools.product(
        (4, 8), (True, False), ((0, 24), (40, 24), (96, 16)))])
def test_plain_matches_reference(kv_bits, kv_zeros, history, chunk):
    rng = np.random.default_rng(100 * kv_bits + history + kv_zeros)
    jargs, targs = both(*setup(rng, kv_bits, kv_zeros, history, chunk))
    want = np.asarray(j_ref.paged_prefill_attention(
        *jargs, SM, PAGE, kv_bits, kv_zeros))
    got = port_plain(targs, kv_bits, kv_zeros)
    np.testing.assert_allclose(got, want, atol=EXACT, rtol=EXACT)


def test_plain_matches_reference_uneven():
    """Ragged q counts across the batch (the second sequence has 11 valid
    queries of 24): padded rows give zeros, valid rows the reference's."""
    rng = np.random.default_rng(5)
    pool, tables, q, _, _ = setup(rng, 4, True, 0, 24, total_lens=[24, 11])
    q_pos = np.stack([np.arange(24),
                      np.where(np.arange(24) < 11, np.arange(24), -1)]
                     ).astype(np.int32)
    ctx = np.array([24, 11], np.int32)
    jargs, targs = both(pool, tables, q, q_pos, ctx)
    want = np.asarray(j_ref.paged_prefill_attention(*jargs, SM, PAGE, 4,
                                                    True))
    got = port_plain(targs, 4, True)
    np.testing.assert_allclose(got[0], want[0], atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(got[1, :11], want[1, :11], atol=EXACT,
                               rtol=EXACT)
    assert not got[1, 11:].any()


def test_plain_refuses_kv16():
    with pytest.raises(ValueError, match="kv4 / kv8"):
        t_psp.paged_prefill_single_pass_plain(
            None, None, 0, None, None, None, sm_scale=SM, page_size=PAGE,
            kv_bits=16)


# -- the dispatch rule and the switches -------------------------------------


def jax_rule(kv_bits, page_size, head_dim, return_lse, switch_on):
    """``omniserve_tpu/ops/dispatch.py:179-193``, transcribed."""
    single_pass = switch_on and not return_lse
    if single_pass:
        single_pass = (j_supports(kv_bits, page_size, head_dim)
                       if kv_bits in (4, 8) else False)
    return single_pass


@pytest.mark.parametrize("switch_on", [False, True])
def test_single_pass_rule_matches_jax(monkeypatch, switch_on):
    monkeypatch.setenv("OMNISERVE_PREFILL_SINGLE_PASS",
                       "1" if switch_on else "0")
    grid = itertools.product((4, 8, 16), (16, 32, 64, 128, 192, 256, 384),
                             (64, 128, 256), (False, True))
    n_on = 0
    for kv_bits, page, hd, lse in grid:
        want = jax_rule(kv_bits, page, hd, lse, switch_on)
        assert t_dispatch.single_pass_applies(kv_bits, page, hd, lse) == \
            want, (kv_bits, page, hd, lse)
        assert t_dispatch.supports(kv_bits, page, hd) == j_supports(
            kv_bits, page, hd)
        n_on += want
    # kv4 / kv8 x pages 128, 256, 384 x head dims 128, 256, without LSE
    assert n_on == (12 if switch_on else 0)


def test_single_pass_rule_off_by_default(monkeypatch):
    monkeypatch.delenv("OMNISERVE_PREFILL_SINGLE_PASS", raising=False)
    assert not t_dispatch.single_pass_applies(4, 128, 128)
    monkeypatch.setenv("OMNISERVE_PREFILL_SINGLE_PASS", "1")
    assert t_dispatch.single_pass_applies(4, 128, 128)
    assert not t_dispatch.single_pass_applies(4, 128, 128, return_lse=True)


def test_switches_on_cpu_take_the_plain_paths(monkeypatch):
    """With both switches on, CPU tensors still go to the plain versions:
    the dispatch's chunked prefill equals the plain version and the
    embedding lookup equals ``table[ids]``."""
    monkeypatch.setenv("OMNISERVE_PREFILL_SINGLE_PASS", "1")
    monkeypatch.setenv("OMNISERVE_EMBED_DMA", "1")
    rng = np.random.default_rng(9)
    _, targs = both(*setup(rng, 8, True, 40, 24))
    via = t_dispatch.paged_prefill_attention(*targs, SM, PAGE, 8, True)
    assert torch.equal(via, t_psp.paged_prefill_single_pass_plain(
        *targs, sm_scale=SM, page_size=PAGE, kv_bits=8, kv_zeros=True))
    table = T(rng.normal(size=(50, 64)).astype(np.float32))
    ids = torch.tensor([3, 0, 49, 7])
    assert torch.equal(t_dispatch.embed_lookup(table, ids), table[ids])


@pytest.mark.parametrize("kv_bits,kv_zeros", [(8, True), (4, False),
                                              (8, False)])
def test_switch_serves_lserve_modes_on_cpu(monkeypatch, kv_bits, kv_zeros):
    """Where the rule holds, the rule and not the device decides what is
    served: a page list with a band over a kv8 or per-tensor pool goes to
    the single-pass plain version on the CPU with the switch on, as it goes
    to the kernel on a card, and with the switch off to row 7's plain
    version (row 7 serves these LServe modes too), which computes the same
    function."""
    rng = np.random.default_rng(13)
    page, n_pages, chunk = 128, 4, 16
    rows = page // 2 if kv_bits == 4 else page
    k, v = (T(rng.integers(0, 256, (1, n_pages, HKV, rows, D), np.uint8))
            for _ in range(2))
    if kv_zeros:
        levels = 2 ** kv_bits
        ks, vs = (rng.uniform(0.1, 0.4, (1, n_pages, HKV, page)) * 16
                  / levels for _ in range(2))
        kz, vz = (rng.integers(0, levels, (1, n_pages, HKV, page))
                  for _ in range(2))
        planes = T(np.stack([ks, ks * (kz + 128.0), vs, vz + 128.0],
                            axis=2).astype(np.float32))
        pool = t_kv.KVPool(k, v, planes)
    else:
        pool = t_kv.KVPool(
            k, v, None,
            k_scale_per_tensor=torch.full((1,), PT_SCALE[kv_bits]),
            v_scale_per_tensor=torch.full((1,), PT_SCALE[kv_bits]))
    tables = torch.tensor([[2, 0, 3]], dtype=torch.int32)
    sel = torch.tensor([[0, -1, 1]], dtype=torch.int32)
    ctx = torch.tensor([200], dtype=torch.int32)
    q_pos = (200 - chunk + torch.arange(chunk, dtype=torch.int32))[None]
    q = T(bf16_normal(rng, (1, chunk, HQ, D)))
    kw = dict(head_is_retrieval=T(np.repeat([True, False], NREP)),
              sink_size=32, local_size=64, sel_logic=sel)
    args = (q, pool, 0, tables, q_pos, ctx, SM, page, kv_bits, kv_zeros)
    monkeypatch.setenv("OMNISERVE_PREFILL_SINGLE_PASS", "1")
    got = t_dispatch.paged_prefill_attention(*args, **kw)
    assert torch.equal(got, t_psp.paged_prefill_single_pass_plain(
        *args[:6], sm_scale=SM, page_size=page, kv_bits=kv_bits,
        kv_zeros=kv_zeros, **kw))
    assert bool(torch.isfinite(got).all()) and got.abs().max() > 0
    monkeypatch.setenv("OMNISERVE_PREFILL_SINGLE_PASS", "0")
    off = t_dispatch.paged_prefill_attention(*args, **kw)
    assert torch.equal(off, t_pp.paged_prefill_attention_plain(
        *args[:6], sm_scale=SM, page_size=page, kv_bits=kv_bits,
        kv_zeros=kv_zeros, **kw))
    torch.testing.assert_close(off, got, atol=1e-5, rtol=1e-5)


# -- the embedding row gather -----------------------------------------------


def _bits(x):
    """The bytes of an array (bf16 / f32) as unsigned integers."""
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [1, 24, 128])
def test_embed_gather_plain_matches_pallas(dtype, b):
    rng = np.random.default_rng(b)
    tbl = jnp.asarray(rng.normal(size=(307, 256)), jnp.float32).astype(
        getattr(jnp, dtype))
    ids = rng.integers(0, 307, size=b).astype(np.int32)
    want = j_embed(tbl, jnp.asarray(ids), interpret=True)
    t_tbl = T(np.asarray(tbl.astype(jnp.float32))).to(getattr(torch, dtype))
    got = t_embed.embed_gather_plain(t_tbl, T(ids))
    assert got.dtype == t_tbl.dtype and got.shape == (b, 256)
    np.testing.assert_array_equal(
        _bits(got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
              .numpy()), _bits(want))


def test_embed_gather_plain_clamps_like_pallas():
    """Ids below 0 and at or past V read the first and the last row, as
    the Pallas wrapper's clip does (``table[ids]`` would wrap -3)."""
    rng = np.random.default_rng(8)
    tbl = rng.normal(size=(64, 128)).astype(np.float32)
    ids = np.array([-3, 0, 63, 64, 99], np.int32)
    want = np.asarray(j_embed(jnp.asarray(tbl), jnp.asarray(ids),
                              interpret=True))
    got = t_embed.embed_gather_plain(T(tbl), T(ids))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert not torch.equal(got[0], T(tbl)[-3])
