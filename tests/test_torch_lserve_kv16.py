"""LServe over kv16 pools: the port against the JAX package (CPU).

``--precision w16a16kv16`` is the default of both packages, and the JAX
package's own LServe engine tests run at it (``tests/test_chunked_prefill.
py``). The same numpy inputs go through the JAX function and its
counterpart in ``omniserve_tpu_torch``:

- decode: the dual-pool attention over kv16 pools (the selector's
  per-head page lists, the streaming ring's sink + local band), the
  port's plain page-list composition (what the card runs, on the plain
  version of its kernels) against the JAX dispatch with the Pallas
  two-stage kernel in interpret mode (2e-2, ``tests/test_pallas_paged_
  attention.py``'s tolerance) and against the port's ``attention_ref``
  (1e-5, both f32 over the same bf16 values);
- chunked prefill over a kv16 ring (wrapped) and over an explicit page
  list: the port's dispatch against the JAX reference (1e-5) and the
  Pallas paged-prefill kernel in interpret mode (2e-2);
- the decode step's two-pool append with K stats: pool bytes and stats
  equal to the JAX scatter path, once per pool on the gathered heads;
- the model: a 2-layer sparse forward at w16a16kv16 under both LServe
  flags (``check_sparse_forward``: logits 1e-4 of their scale, pools and K
  stats equal);
- the engine: greedy tokens of both engines under both flags, 96-token
  chunks over a wrapped ring (compared while every top-2 margin exceeds
  2e-3, ``TrustedPrefix``), and the port's chunked last-token logits equal
  to its single-shot ones within the JAX test's 1.5e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops import paged_kv as j_kv
from omniserve_tpu.ops.pallas import paged_attention as j_pa
from omniserve_tpu.ops.pallas import paged_prefill as j_pp
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import params_from_numpy
from omniserve_tpu_torch.ops import attention_ref as t_ref
from omniserve_tpu_torch.ops import dispatch as t_dispatch
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec
from tests.test_torch_lserve_llama import PAGE as LPAGE
from tests.test_torch_lserve_llama import check_sparse_forward
from tests.test_torch_lserve_ops import (FLAGS, LENS, PAGE, SUB,
                                         assert_pools_equal, build_dual_pools,
                                         decode_kwargs, selections,
                                         to_torch_pool)
from tests.test_torch_lserve_prefill import (check_ring_prefill,
                                             engine_kwargs, prefill_logits,
                                             requests)
from tests.test_torch_precision_engine import TrustedPrefix
from tests.test_torch_precision_engine import serve as precision_serve

D = 128
EXACT = 1e-5
PALLAS_TOL = 2e-2


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def kv16_pools():
    return build_dual_pools(kv_bits=16)


@pytest.mark.parametrize("budget,dec", [(3, (PAGE, 2 * PAGE)),
                                        (4, (64, 100))])
def test_kv16_dual_pool_decode_matches_jax_and_pallas(kv16_pools, budget,
                                                      dec):
    """Per-head page lists (``budget`` selected pages a retrieval head) and
    the ring's band (``dec`` sink / local tokens; the ring wrapped mid page
    and on a page boundary, a context inside the sink page, an inactive
    row) over kv16 pools: the port's page-list composition on the CPU
    against the JAX dispatch's Pallas path in interpret mode (the
    two-stage kernel in its ``per_head_sel`` and band modes) and against
    ``attention_ref``."""
    dp = kv16_pools
    sm, layer = D ** -0.5, 1
    sel = np.asarray(selections(dp, layer, budget)[2])
    jargs = (jnp.asarray(dp["q"]), dp["jr"], layer,
             jnp.asarray(dp["tables"]), jnp.asarray(LENS), sm, PAGE, 16, True)
    pallas = np.asarray(j_pa.paged_decode_attention(
        *jargs, interpret=True, **decode_kwargs(dp, "jax", sel, dec=dec)),
        np.float32)
    want = np.asarray(j_ref.paged_decode_attention(
        *jargs, **decode_kwargs(dp, "jax", sel, dec=dec)), np.float32)
    targs = (T(dp["q"]), dp["tr"], layer, T(dp["tables"]), T(LENS), sm, PAGE)
    ref = t_ref.paged_decode_attention(
        *targs, 16, True, **decode_kwargs(dp, "torch", sel, dec=dec))
    via = t_dispatch.paged_decode_attention(
        *targs, 16, True, **decode_kwargs(dp, "torch", sel, dec=dec))
    lists = t_dec.paged_decode_attention(
        *targs, **decode_kwargs(dp, "torch", sel, dec=dec)).numpy()
    np.testing.assert_allclose(lists, ref.numpy(), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(via.numpy(), want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(lists, pallas, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)
    assert np.abs(want[:3]).max() > 1e-2 and not want[3].any()
    # the selection drops pages: the lists are not the dense history
    assert (sel[0][FLAGS] >= 0).sum(-1).max() == budget < -(-LENS[0] // PAGE)


@pytest.mark.parametrize("length", [61, 90])
def test_kv16_ring_prefill_matches_jax_and_pallas(length):
    """An 8-token chunk over a kv16 1 + 4 page ring (wrapped; stale rows
    past the write head at 61), one streaming kv head at n_rep 2: the
    port's plain version and dispatch against the JAX reference and
    dispatch (1e-5) and the Pallas kernel in interpret mode (2e-2)."""
    check_ring_prefill(length, 16, True, pallas_tol=PALLAS_TOL)


def test_kv16_page_list_prefill_matches_jax_and_pallas():
    """``sel_logic`` without a ring (logical pages in no order, -1 dead)
    over a kv16 pool, retrieval and streaming heads mixed (sink 4, local
    12): the port's dispatch against the JAX dispatch (1e-5) and the
    Pallas kernel in interpret mode (2e-2)."""
    rng = np.random.default_rng(3)
    page, hkv, n_rep, b, w = 8, 2, 2, 2, 6
    jpool = j_kv.make_kv_pool(1, 13, hkv, page, D, kv_bits=16)
    jpool = jpool._replace(**{n: jnp.asarray(rng.normal(
        size=jpool.k_data.shape).astype(np.float32), jnp.bfloat16)
        for n in ("k_data", "v_data")})
    tpool = to_torch_pool(jpool)
    table = rng.permutation(12)[: b * w].reshape(b, w).astype(np.int32)
    sel = np.array([[0, 3, 1, -1, 4, 2], [5, -1, 0, 1, -1, 2]], np.int32)
    ctx = np.array([40, 47], np.int32)
    q = rng.normal(size=(b, 8, hkv * n_rep, D)).astype(np.float32)
    q_pos = np.stack([np.arange(32, 40), np.arange(39, 47)]).astype(np.int32)
    flags = np.array([True, True, False, False])
    kw = dict(sink_size=4, local_size=12)
    jargs = (jnp.asarray(q), jpool, 0, jnp.asarray(table),
             jnp.asarray(q_pos), jnp.asarray(ctx), D ** -0.5, page, 16, True)
    jkw = dict(head_is_retrieval=jnp.asarray(flags),
               sel_logic=jnp.asarray(sel), **kw)
    want = np.asarray(j_dispatch.paged_prefill_attention(*jargs, **jkw))
    pallas = np.asarray(j_pp.paged_prefill_attention(
        *jargs, interpret=True, **jkw), np.float32)
    got = t_dispatch.paged_prefill_attention(
        T(q), tpool, 0, T(table), T(q_pos), T(ctx), D ** -0.5, page, 16,
        True, head_is_retrieval=T(flags), sel_logic=T(sel), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(got, pallas, atol=PALLAS_TOL,
                               rtol=PALLAS_TOL)
    assert np.abs(want).max() > 1e-2


def test_kv16_append_pools_matches_jax():
    """The decode step's append into both kv16 pools (pool row h of each
    taking kv head ``src[h]``; K min/max stats into the retrieval pool):
    the port's two-pool entry on the CPU against the JAX dispatch's
    ``append_kv_decode`` once per pool on the gathered heads, bytes and
    stats equal on every page but the trash page."""
    rng = np.random.default_rng(12)
    src_r, src_s = np.array([0, 2]), np.array([3, 1])   # rows -> kv heads

    def pool(n_pages, with_stats, seed):
        r = np.random.default_rng(seed)
        jp = j_kv.make_kv_pool(2, n_pages, 2, PAGE, D, kv_bits=16,
                               with_stats=with_stats, sub_chunks=SUB)
        jp = jp._replace(**{n: jnp.asarray(r.normal(
            size=jp.k_data.shape).astype(np.float32), jnp.bfloat16)
            for n in ("k_data", "v_data")})
        if with_stats:
            jp = jp._replace(k_stats=jnp.asarray(
                r.normal(size=jp.k_stats.shape).astype(np.float32)))
        return jp, to_torch_pool(jp)

    jr, tr = pool(6, True, 13)
    js, ts = pool(6, False, 14)
    layer = 1
    for pages_r, pages_s, slots_r, slots_s in (
            ([3, -1, 0], [1, -1, 4], [5, 9, 100], [64, 9, 127]),
            ([2, 4, -1], [0, 3, -1], [6, 31, 0], [65, 32, 1])):
        pages_r, pages_s, slots_r, slots_s = (
            np.array(x, np.int32) for x in (pages_r, pages_s, slots_r,
                                            slots_s))
        k = np.array(jnp.asarray(rng.normal(size=(3, 4, D)),
                                 jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(rng.normal(size=(3, 4, D)),
                                 jnp.bfloat16).astype(jnp.float32))
        jr = j_dispatch.append_kv_decode(
            jr, layer, jnp.asarray(k[:, src_r]), jnp.asarray(v[:, src_r]),
            jnp.asarray(pages_r), jnp.asarray(slots_r), PAGE, 16, True,
            update_stats=True, sub_chunks=SUB)
        js = j_dispatch.append_kv_decode(
            js, layer, jnp.asarray(k[:, src_s]), jnp.asarray(v[:, src_s]),
            jnp.asarray(pages_s), jnp.asarray(slots_s), PAGE, 16, True)
        out = t_dispatch.append_kv_decode_pools(
            tr, ts, layer, T(k), T(v), (T(pages_r), T(slots_r), T(src_r)),
            (T(pages_s), T(slots_s), T(src_s)), PAGE, 16, True,
            update_stats=True, sub_chunks=SUB)
        assert out[0] is tr and out[1] is ts           # in place
        trash = (jr.k_data.shape[1] - 1,)
        assert_pools_equal(tr, jr, skip_pages=trash)
        assert_pools_equal(ts, js, skip_pages=trash)
    assert tr.k_data.dtype == torch.bfloat16 and ts.k_stats is None


def test_kv16_sparse_forward_both_flags_matches_jax():
    """A 2-layer w16a16kv16 forward under both LServe flags: a
    whole-prompt prefill with the ctx band, then four decode steps (one
    selector refresh, a page boundary crossed): logits 1e-4 of their scale,
    pools and K stats equal, selections equal as sets."""
    crossed, refreshed = check_sparse_forward(
        dict(weight_bits=16, act_bits=16, kv_bits=16, sparse_prefill=True,
             ctx_sink=LPAGE, ctx_local=2 * LPAGE), n_steps=4)
    assert crossed == 1 and refreshed == 1


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama_lserve_kv16")
    cfg = dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
        max_position_embeddings=4096, rms_norm_eps=1e-5,
        rope_theta=500000.0,
    )
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(d)


# the JAX package's test_sparse_chunked_logits_exact bound: the bf16 pool
# round trip of K/V bounds the legitimate chunked-vs-whole gap
CHUNKED_VS_WHOLE_ATOL = 1.5e-3


def test_kv16_sparse_engine_matches_jax(tiny_model_dir, monkeypatch):
    """Both LServe flags at w16a16kv16 (the JAX package's
    ``test_sparse_chunked_matches_single_shot`` configuration): prompts of
    200 and 120 tokens in 96-token budgets (chunks of 48 at batch 2; the
    200-token ring wraps), IFB single steps, greedy tokens of both engines
    compared while every top-2 margin exceeds 2e-3. Then the port's
    chunked last-token logits of a 200-token prompt against its
    single-shot ones (the JAX test's 1.5e-3, argmax equal)."""
    reqs = requests(2, (200, 120), 3)
    kw = engine_kwargs(tiny_model_dir, precision="w16a16kv16",
                       lm_head_precision="fp16", chunk_prefill_size=96)
    # the dummy draw need not run op by op: the port takes its weights
    jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
    jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
    with jax.disable_jit():
        want = precision_serve(jeng, JSamplingParams, reqs)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    params = params_from_numpy(jparams, "cpu")
    runner.load_params(params)
    spec, ce = runner.spec, runner.cache_engine
    assert (spec.kv_bits, spec.weight_bits) == (16, 16)
    assert spec.sparse_prefill and spec.sparse_decode
    assert ce.streaming_pool.k_data.dtype == torch.bfloat16
    assert ce.retrieval_pool.k_stats.dtype == torch.float32
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = precision_serve(teng, SamplingParams, reqs, groups)
    assert [len(t) for t in got.values()] == [3, 3]
    # never vacuous: at least every request's first token is compared
    assert trusted.compare(got, want) >= len(reqs)
    assert trusted.cut is None or min(trusted.cut.values()) >= 1
    assert trusted.chunked == 5          # ceil(200 / 48) chunks
    monkeypatch.undo()

    def t_forward(runner, batch):
        pools = runner.cache_engine
        return t_llama.llama_forward(runner.params, pools.retrieval_pool,
                                     pools.streaming_pool, batch,
                                     runner.spec, is_prefill=True)[0]

    prompt = np.random.default_rng(5).integers(1, 255, size=200).tolist()
    out = {}
    for chunk in (96, 32000):
        eng = LLMEngine.from_engine_args(EngineArgs(
            device="cpu", **dict(kw, chunk_prefill_size=chunk)))
        eng.worker.model_runner.load_params(params)
        out[chunk] = prefill_logits(eng, t_forward, prompt, chunk)
    np.testing.assert_allclose(out[96], out[32000], rtol=0,
                               atol=CHUNKED_VS_WHOLE_ATOL)
    assert int(np.argmax(out[96])) == int(np.argmax(out[32000]))
