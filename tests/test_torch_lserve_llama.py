"""The port's sparse-decode forward against the JAX package's (CPU).

LServe's decode side (``sparse_decode``, half of the kv heads streaming):
a whole-prompt prefill into both pools, then six decode steps that cross a
page boundary onto a recycled (dirty) page and two selector refreshes. The
JAX forward runs op by op (``jax.disable_jit()``), where it and the port
execute the same integer GEMMs and the same f32 op order: logits agree to
1e-4 of their scale, pool bytes, planes and K stats are equal, and the page
selections are equal as sets (``approx_max_k`` orders its picks its own
way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import params_from_numpy, pool_from_numpy
from tests.test_torch_llama import codes_moved, recorded_gemms

PAGE = 16
LOGIT_RTOL = 1e-4
N_LAYERS, HKV, BUDGET, INTERVAL = 2, 2, 3, 4
FLAGS = np.array([[True, False]] * N_LAYERS)


def spec_kwargs():
    return dict(
        num_layers=N_LAYERS, hidden=64, intermediate=128, num_q_heads=4,
        num_kv_heads=HKV, head_dim=16, vocab=128, page_size=PAGE,
        rope_base=500000.0, weight_bits=4, act_bits=8, kv_bits=4,
        kv_zeros=True, lm_head_bits=8, sparse_decode=True, sink_blocks=1,
        local_blocks=2, dec_sink_tokens=PAGE, dec_local_tokens=2 * PAGE,
        sub_chunks=4, budget_pages=BUDGET, selector_interval=INTERVAL,
    )


FIELDS = ("k_data", "v_data", "kv_scales", "k_stats", "k_scale_per_tensor",
          "v_scale_per_tensor")


class _NumpyPool:
    def __init__(self, jpool):
        for name in FIELDS:
            a = getattr(jpool, name)
            setattr(self, name, None if a is None else np.array(a))


def assert_pools_equal(tpool, jpool, what):
    """Every page but the trash page (the top one): the JAX scatters drop a
    -1 page id, the port sends its stats reset to the trash page."""
    for name in FIELDS:
        want = getattr(jpool, name)
        if want is None:
            assert getattr(tpool, name) is None
            continue
        keep = slice(None) if want.ndim == 1 else slice(None, -1)
        got = getattr(tpool, name)
        if got.dtype == torch.bfloat16:     # kv16 values, compared exactly
            got, want = got.float(), np.asarray(want, np.float32)
        np.testing.assert_array_equal(
            got.numpy()[:, keep] if want.ndim > 1 else got.numpy(),
            np.asarray(want)[:, keep] if want.ndim > 1 else np.asarray(want),
            err_msg=f"{what}: {name}")


def assert_logits_close(got, want, rtol=LOGIT_RTOL):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def assert_pools_near(tpool, jpool, what, gates, moved=False):
    """``assert_pools_equal`` under ``gates`` (``check_sparse_forward``'s
    ``flip_gates``): fewer than gates["codes"] of the kv4 / kv8 codes
    different, each at most one step apart unless a GEMM read other
    activation codes (``moved``), float fields (planes, K stats, kv16
    values) within gates["planes"] of their scale, every page but the
    trash page."""
    for name in FIELDS:
        want = getattr(jpool, name)
        if want is None:
            assert getattr(tpool, name) is None
            continue
        got = getattr(tpool, name)
        if got.dtype == torch.bfloat16:
            got = got.float()
        a = got.numpy()
        b = np.asarray(want, np.float32 if a.dtype != np.uint8 else None)
        if b.ndim > 1:
            a, b = a[:, :-1], b[:, :-1]
        if a.dtype == np.uint8:
            ai, bi = a.astype(int), b.astype(int)
            nibbles = a.shape[3] * 2 == PAGE      # kv4: two codes a byte
            for shift, mask in ((0, 15), (4, 15)) if nibbles else ((0, 255),):
                assert moved or np.abs(((ai >> shift) & mask)
                                       - ((bi >> shift) & mask)).max() <= 1, \
                    (what, name)
            assert (ai != bi).mean() < gates["codes"], (what, name)
            continue
        finite = np.isfinite(b)
        assert (np.isfinite(a) == finite).all(), (what, name)
        scale = max(float(np.abs(b[finite]).max()), 1e-30)
        np.testing.assert_allclose(a[finite], b[finite], rtol=0,
                                   atol=gates["planes"] * scale,
                                   err_msg=f"{what}: {name}")


def test_sparse_prefill_then_decode_matches_jax():
    crossed, refreshed = check_sparse_forward()
    assert crossed == 1 and refreshed == 2


def check_sparse_forward(overrides=None, n_steps=6, flip_gates=None,
                         family=None):
    """A whole-prompt prefill, then ``n_steps`` decode steps of both
    forwards (``spec_kwargs`` with ``overrides``: other KV modes, kv16
    included, sparse prefill, no sparse decode) from the same weights and
    dirty pools:
    logits at 1e-4 of their scale, pools equal, selections equal as sets.
    Per-tensor pools carry the same calibrated-range scales in both
    pools. ``flip_gates`` (for widths where an XLA-vs-torch last-ulp
    difference moves a K / V value or an activation code, as
    ``tests/test_torch_llama.check_forward``'s): logits at 1e-4 until a
    GEMM reads other activation codes in the two packages, then at
    flip_gates["logits"]; pools per ``assert_pools_near``; selections as
    sets until a step whose pools or codes moved. ``family`` (None: the
    Llama family) is a model family's (spec classes (JAX, port), the JAX
    random draw, forwards (JAX, port)), as ``tests/test_torch_mixtral.
    MIXTRAL``. Returns (decode steps that began a page, selector
    refreshes)."""
    kw = dict(spec_kwargs(), **(overrides or {}))
    (j_cls, t_cls), j_draw, (j_forward, t_forward) = family or (
        (j_llama.LlamaSpec, t_llama.LlamaSpec),
        j_llama.make_random_packed_params,
        (j_llama.llama_forward, t_llama.llama_forward))
    j_spec = j_cls(**kw)
    t_spec = t_cls(**kw)
    t_spec.check_supported()
    sparse = t_spec.sparse_decode
    # without sparse decode every kv head is a retrieval head, as the
    # engines build it (no streaming pool)
    flags = FLAGS if sparse else np.ones_like(FLAGS)
    jparams = j_draw(j_spec, seed=11, retrieval_flags=flags)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert tparams["attn_meta"]["retrieval_flags"].dtype == torch.bool
    tmeta = t_llama.make_attn_meta(t_spec, flags, device="cpu")
    for key in ("retrieval_flags", "head_rank"):
        np.testing.assert_array_equal(tmeta[key].numpy(),
                                      np.asarray(jparams["attn_meta"][key]))

    rng = np.random.default_rng(12)
    # seq 0: 5 pages less 3 tokens (longer than sink + ring = 3 pages; its
    # 4th decode token starts page 5); seq 1: inside the second page
    lens = [5 * PAGE - 3, PAGE + 9]
    tables = np.array([[4, 1, 7, 9, 3, 6], [2, 8, 0, 0, 0, 0]], np.int32)
    stables = np.array([[3, 0, 5], [1, 4, 2]], np.int32)
    tokens = np.concatenate([rng.integers(0, kw["vocab"], n)
                             for n in lens]).astype(
        np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]).astype(
        np.int32)
    last = (np.cumsum(lens) - 1).astype(np.int32)
    # as the runner does: every page of both tables resets the K stats
    new_pages = np.array([4, 1, 7, 9, 3, 3, 0, 5, 2, 8, 1, 4, 2], np.int32)

    # dirty pools (recycled pages): random bytes, planes and stats
    kv_bits, kv_zeros = t_spec.kv_bits, t_spec.kv_zeros
    pt = {}
    if not kv_zeros:   # K/V of this model stay within ~1.5
        qmax = 7 if kv_bits == 4 else 127
        pt = dict(k_scale_per_tensor=jnp.asarray([1.5 / qmax, 1.7 / qmax],
                                                 jnp.float32),
                  v_scale_per_tensor=jnp.asarray([1.4 / qmax, 1.6 / qmax],
                                                 jnp.float32))
    heads = 1 if sparse else HKV
    jr = j_make_kv_pool(N_LAYERS, 11, heads, PAGE, kw["head_dim"],
                        kv_bits=kv_bits,
                        kv_zeros=kv_zeros, with_stats=sparse, **pt)
    js = j_make_kv_pool(N_LAYERS, 7, 1, PAGE, kw["head_dim"], kv_bits=kv_bits,
                        kv_zeros=kv_zeros, **pt) if sparse else None
    if kv_bits == 16:       # dirty bf16 values
        jr = jr._replace(k_data=jnp.asarray(rng.normal(
            size=jr.k_data.shape).astype(np.float32), jnp.bfloat16))
    else:
        jr = jr._replace(k_data=jnp.asarray(rng.integers(
            0, 256, jr.k_data.shape, dtype=np.uint8)))
    if jr.kv_scales is not None:
        jr = jr._replace(kv_scales=jnp.asarray(rng.uniform(
            0.1, 1, jr.kv_scales.shape).astype(np.float32)))
    if sparse:
        jr = jr._replace(k_stats=jnp.asarray(rng.normal(
            size=jr.k_stats.shape).astype(np.float32) * 50))
    tr = pool_from_numpy(_NumpyPool(jr), "cpu")
    ts = pool_from_numpy(_NumpyPool(js), "cpu") if sparse else None
    assert (tr.k_stats is not None) == sparse

    j_batch = j_llama.PrefillBatch(
        token_ids=jnp.asarray(tokens), positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), block_tables=jnp.asarray(tables),
        streaming_block_tables=jnp.asarray(stables),
        last_token_idx=jnp.asarray(last), seq_lens=jnp.asarray(lens,
                                                               jnp.int32),
        new_page_ids=jnp.asarray(new_pages),
    )
    t_batch = t_llama.PrefillBatch(
        token_ids=torch.from_numpy(tokens), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg),
        block_tables=torch.from_numpy(tables),
        last_token_idx=torch.from_numpy(last),
        seq_lens=torch.tensor(lens, dtype=torch.int32),
        streaming_block_tables=torch.from_numpy(stables) if sparse else None,
        new_page_ids=torch.from_numpy(new_pages),
    )
    flipped = False

    def compare(t_logits, j_logits, pools, what):
        """Logits, then each (port pool, JAX pool, label) of ``pools``;
        returns whether every pool was equal."""
        nonlocal flipped
        if flip_gates is None:
            assert_logits_close(t_logits, j_logits)
            for tp, jp, name in pools:
                assert_pools_equal(tp, jp, f"{what} {name}")
            return True
        flipped |= codes_moved(seen) > 0
        assert_logits_close(t_logits, j_logits,
                            flip_gates["logits"] if flipped else LOGIT_RTOL)
        equal = True
        for tp, jp, name in pools:
            try:
                assert_pools_equal(tp, jp, f"{what} {name}")
            except AssertionError:
                equal = False
                assert_pools_near(tp, jp, f"{what} {name}", flip_gates,
                                  flipped)
        return equal

    with recorded_gemms() as seen:
        with jax.disable_jit():
            j_logits, jr, js, _ = j_forward(
                jparams, jr, js, j_batch, j_spec, is_prefill=True)
        t_logits, _, _, sel = t_forward(
            tparams, tr, ts, t_batch, t_spec, is_prefill=True)
    assert sel is None
    same = compare(t_logits.numpy(), np.asarray(j_logits),
                   [(tr, jr, "retrieval")]
                   + ([(ts, js, "streaming")] if sparse else []), "prefill")

    # six decode steps, rows (seq 0, seq 1, inactive)
    nxt = np.append(np.asarray(j_logits).argmax(-1), 0).astype(np.int32)
    dpos = np.array(lens + [0], np.int32)
    active = np.array([True, True, False])
    dtables = np.concatenate([tables, np.zeros((1, 6), np.int32)])
    dstables = np.concatenate([stables, np.zeros((1, 3), np.int32)])
    j_cache = jnp.full((N_LAYERS, 3, HKV, BUDGET), -1, jnp.int32)
    t_cache = torch.full((N_LAYERS, 3, HKV, BUDGET), -1, dtype=torch.int32)
    crossed = refreshed = 0
    for step in range(n_steps):
        refresh = step % INTERVAL == 0
        fresh = [int(dtables[i, dpos[i] // PAGE]) for i in range(2)
                 if dpos[i] % PAGE == 0]
        crossed += len(fresh)
        refreshed += refresh
        npg = np.array(fresh + [-1] * (8 - len(fresh)), np.int32)
        j_dec = j_llama.DecodeBatch(
            token_ids=jnp.asarray(nxt), positions=jnp.asarray(dpos),
            block_tables=jnp.asarray(dtables),
            streaming_block_tables=jnp.asarray(dstables),
            active=jnp.asarray(active), new_page_ids=jnp.asarray(npg),
            refresh_selection=jnp.asarray(refresh),
            cached_page_idxes=j_cache,
        )
        t_dec = t_llama.DecodeBatch(
            token_ids=torch.from_numpy(nxt.copy()),
            positions=torch.from_numpy(dpos.copy()),
            block_tables=torch.from_numpy(dtables),
            active=torch.from_numpy(active),
            streaming_block_tables=(torch.from_numpy(dstables) if sparse
                                    else None),
            new_page_ids=torch.from_numpy(npg),
            refresh_selection=refresh, cached_page_idxes=t_cache,
        )
        with recorded_gemms() as seen:
            with jax.disable_jit():
                j_logits, jr, js, j_cache = j_forward(
                    jparams, jr, js, j_dec, j_spec, is_prefill=False)
            t_logits, _, _, t_cache = t_forward(
                tparams, tr, ts, t_dec, t_spec, is_prefill=False)
        same = compare(t_logits.numpy()[:2], np.asarray(j_logits)[:2],
                       [(tr, jr, "retrieval")]
                       + ([(ts, js, "streaming")] if sparse else []),
                       f"decode step {step}") and same and not flipped
        nxt = np.append(np.asarray(j_logits)[:2].argmax(-1), 0).astype(
            np.int32)
        dpos = dpos + np.array([1, 1, 0], np.int32)
        if not sparse:
            continue
        jsel, tsel = np.asarray(j_cache), t_cache.numpy()
        assert tsel.shape == jsel.shape
        for idx in np.ndindex(jsel.shape[:3]):
            if same:
                assert set(tsel[idx]) == set(jsel[idx]), (step, idx)
        # seq 0 has 5-6 pages against a budget of 3: pages are dropped, and
        # the retrieval head's first pick is the newest page
        if refresh:
            assert tsel[0, 0, 0, 0] == (dpos[0] - 1) // PAGE
            assert len(set(tsel[0, 0, 0])) == BUDGET
    return crossed, refreshed


@pytest.mark.parametrize("overrides", [
    dict(kv_bits=8),
    dict(kv_bits=8, kv_zeros=False, sparse_prefill=True, ctx_sink=PAGE,
         ctx_local=2 * PAGE),
    dict(kv_zeros=False),
], ids=["w4a8kv8", "w4a8kv8-pt-both-flags", "w4a8kv4-pt"])
def test_sparse_forward_kv_modes_match_jax(overrides):
    """LServe's sparse decode (and, for per-tensor kv8, sparse prefill's
    band too) over kv8 and per-tensor pools: four decode steps, one
    refresh, a page boundary crossed. The W8A8 body of the reference's
    LServe precision is held in ``tests/test_torch_llama.py`` and in the
    engine (``tests/test_torch_lserve_prefill.py``)."""
    crossed, refreshed = check_sparse_forward(overrides, n_steps=4)
    assert crossed == 1 and refreshed == 1
