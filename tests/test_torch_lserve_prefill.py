"""LServe's prefill side of the port against the JAX package (CPU).

The same numpy inputs go through the JAX function and its counterpart in
``omniserve_tpu_torch``:

- ops: whole-prompt attention with the sink + local band of streaming heads
  (f32 plain versions 1e-5; the Pallas flash kernel in interpret mode 2e-2,
  ``tests/test_pallas_flash_attention.py``'s tolerance), and chunked
  attention over a wrapped streaming ring (plain versions and dispatch 1e-5;
  the Pallas paged-prefill kernel in interpret mode 3e-2,
  ``tests/test_ring_attention.py``'s tolerance), with the ring maps equal;
- the model: ``_dual_pool_chunk_attn`` (1e-5), and the last-token logits
  of a chunked and a whole-prompt sparse prefill, each equal to the JAX
  forward's (1e-4 of their scale, as ``tests/test_torch_lserve_llama.py``)
  and close to each other (see ``CHUNKED_VS_WHOLE_ATOL``);
- the engine: greedy tokens of ``--sparse-context-mode
  --sparse-decode-mode`` and of ``--sparse-context-mode`` alone, chunked
  (ring wrapped) and whole-prompt, in single steps and in windows.
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
from omniserve_tpu.models import llama as j_llama
from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops import dispatch as j_dispatch
from omniserve_tpu.ops import paged_kv as j_kv
from omniserve_tpu.ops.pallas import flash_attention as j_flash
from omniserve_tpu.ops.pallas import paged_prefill as j_pp
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import params_from_numpy, pool_from_numpy
from omniserve_tpu_torch.ops import attention_ref as t_ref
from omniserve_tpu_torch.ops import dispatch as t_dispatch
from omniserve_tpu_torch.ops import paged_kv as t_kv
from omniserve_tpu_torch.ops.cuda import paged_prefill as t_pp
from tests.test_torch_precision_engine import TrustedPrefix
from tests.test_torch_precision_engine import serve as precision_serve

D = 128
EXACT = 1e-5          # f32 plain versions against the JAX reference
LOGIT_RTOL = 1e-4     # forwards, of max |logit|


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _NumpyPool:
    def __init__(self, jpool):
        for name in ("k_data", "v_data", "kv_scales", "k_stats",
                     "k_scale_per_tensor", "v_scale_per_tensor"):
            a = getattr(jpool, name)
            setattr(self, name, None if a is None else np.array(a))


def to_torch_pool(jpool):
    return pool_from_numpy(_NumpyPool(jpool), "cpu")


# -- whole-prompt prefill with the band -------------------------------------


@pytest.mark.parametrize("lens,flags_kv,sink,local", [
    ((256,), (True, False), 16, 40),
    ((150, 106), (False, True), 8, 24),
    ((100, 100, 56), (False, False), 0, 16),
])
def test_prefill_band_plain_matches_jax_and_pallas(lens, flags_kv, sink,
                                                   local):
    """Packed segments (the second's sinks sit at large packed indices),
    one streaming and one retrieval kv head, n_rep 2."""
    rng = np.random.default_rng(sum(lens) + sink)
    t, hkv, n_rep = sum(lens), 2, 2
    hq = hkv * n_rep
    # bf16-representable inputs: the Pallas kernel computes in bf16
    q, k, v = (jnp.asarray(rng.normal(size=(t, h, D)), jnp.bfloat16)
               .astype(jnp.float32) for h in (hq, hkv, hkv))
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]) \
        .astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    flags_q = np.repeat(np.asarray(flags_kv), n_rep)
    sm = D ** -0.5
    band = dict(sink_size=sink, local_size=local)
    want = np.asarray(j_ref.prefill_attention(
        q, k, v, jnp.asarray(seg), jnp.asarray(pos), sm,
        head_is_retrieval=jnp.asarray(flags_q), **band))
    pallas = np.asarray(j_flash.prefill_attention(
        q, k, v, jnp.asarray(seg), jnp.asarray(pos), sm,
        head_is_retrieval=jnp.asarray(flags_q), interpret=True, **band),
        np.float32)
    tq, tk, tv = (T(np.asarray(x)) for x in (q, k, v))
    got = t_ref.prefill_attention(tq, tk, tv, T(seg), T(pos), sm,
                                  head_is_retrieval=T(flags_q), q_chunk=96,
                                  **band)
    np.testing.assert_allclose(got.numpy(), want, atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-2, rtol=2e-2)
    via = t_dispatch.prefill_attention(tq, tk, tv, T(seg), T(pos), sm,
                                       head_is_retrieval=T(flags_q), **band)
    assert torch.equal(via, t_ref.prefill_attention(
        tq, tk, tv, T(seg), T(pos), sm, head_is_retrieval=T(flags_q),
        **band))
    # the band changed the streaming heads and left the dense ones alone
    dense = t_ref.prefill_attention(tq, tk, tv, T(seg), T(pos), sm)
    streaming = ~T(flags_q)
    assert torch.equal(got[:, ~streaming], dense[:, ~streaming])
    assert not torch.allclose(got[:, streaming], dense[:, streaming])


# -- chunked prefill over a wrapped ring ------------------------------------

PAGE = 8
SINK_B, LOCAL_B = 1, 4
N_SLOTS = SINK_B + LOCAL_B


def ring_slot(b):
    return b if b < SINK_B else SINK_B + (b - SINK_B) % LOCAL_B


def fill_ring(length, h, rng, kv_bits=4, kv_zeros=True):
    """A kv4 / kv8 ring pool (one layer; per-tensor with scales that span
    the codes of these values) with ``length`` tokens appended through the
    ring mapping, in both frameworks."""
    pt = {}
    if not kv_zeros:
        qmax = 7 if kv_bits == 4 else 127
        pt = dict(k_scale_per_tensor=jnp.asarray([1.6 / qmax], jnp.float32),
                  v_scale_per_tensor=jnp.asarray([1.4 / qmax], jnp.float32))
    jpool = j_kv.make_kv_pool(1, N_SLOTS + 1, h, PAGE, D, kv_bits=kv_bits,
                              kv_zeros=kv_zeros, **pt)
    k = rng.normal(size=(length, h, D)).astype(np.float32) * 0.5
    v = rng.normal(size=(length, h, D)).astype(np.float32) * 0.5
    pos = np.arange(length)
    slots = np.array([ring_slot(b) for b in pos // PAGE])
    table = np.arange(N_SLOTS, dtype=np.int32)
    jpool = j_kv.append_kv(jpool, 0, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(table[slots]),
                           jnp.asarray(pos % PAGE), PAGE, kv_bits, kv_zeros)
    return jpool, to_torch_pool(jpool), table[None]


@pytest.mark.parametrize("length", [30, 61, 90])
def test_ring_prefill_matches_jax_and_pallas(length):
    """An 8-token chunk at the end of a ``length``-token context over a
    1 + 4 page ring (wrapped at 61 and 90, with stale rows past the write
    head at 61), one streaming kv head, n_rep 2: the port's plain version
    with the position map, its dispatch with the ring arguments, the JAX
    reference and dispatch, and the Pallas kernel in interpret mode."""
    check_ring_prefill(length, 4, True)


@pytest.mark.parametrize("length,kv_bits,kv_zeros", [
    (61, 8, True), (90, 8, False), (61, 4, False)])
def test_ring_prefill_kv_modes_match_jax_and_pallas(length, kv_bits,
                                                    kv_zeros):
    """The same over kv8 and per-tensor ring pools (LServe's other KV
    modes), the Pallas kernel in interpret mode at 2e-2
    (``tests/test_paged_prefill.py``'s tolerance)."""
    check_ring_prefill(length, kv_bits, kv_zeros, pallas_tol=2e-2)


def check_ring_prefill(length, kv_bits, kv_zeros, pallas_tol=3e-2, n_rep=2):
    rng = np.random.default_rng(length)
    h, tq = 1, 8
    jpool, tpool, table = fill_ring(length, h, rng, kv_bits, kv_zeros)
    q = rng.normal(size=(1, tq, h * n_rep, D)).astype(np.float32)
    q_pos = np.arange(length - tq, length, dtype=np.int32)[None]
    ctx = np.array([length], np.int32)
    sm = D ** -0.5
    band = dict(sink_size=PAGE, local_size=2 * PAGE)
    ring = dict(ring_span_pages=LOCAL_B, ring_sink_tokens=SINK_B * PAGE)
    flags = np.zeros(h * n_rep, bool)
    jargs = (jnp.asarray(q), jpool, 0, jnp.asarray(table),
             jnp.asarray(q_pos), jnp.asarray(ctx), sm, PAGE, kv_bits,
             kv_zeros)
    targs = (T(q), tpool, 0, T(table), T(q_pos), T(ctx), sm, PAGE, kv_bits,
             kv_zeros)

    j_sel = j_kv.ring_logical_blocks(jnp.asarray(ctx), N_SLOTS, SINK_B,
                                     LOCAL_B, PAGE)
    t_sel = t_kv.ring_logical_blocks(T(ctx), N_SLOTS, SINK_B, LOCAL_B, PAGE)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
    j_pos = j_kv.ring_token_positions(jnp.asarray(ctx), N_SLOTS, SINK_B,
                                      LOCAL_B, PAGE)
    t_pos = t_kv.ring_token_positions(T(ctx), N_SLOTS, SINK_B, LOCAL_B, PAGE)
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    if length > N_SLOTS * PAGE:
        assert (t_sel.numpy() > N_SLOTS - 1).any()      # the ring wrapped

    want = np.asarray(j_ref.paged_prefill_attention(
        *jargs, head_is_retrieval=jnp.asarray(flags), kv_positions=j_pos,
        **band))
    got = t_ref.paged_prefill_attention(
        *targs, head_is_retrieval=T(flags), kv_positions=t_pos, q_chunk=3,
        **band)
    np.testing.assert_allclose(got.numpy(), want, atol=EXACT, rtol=EXACT)

    j_via = np.asarray(j_dispatch.paged_prefill_attention(
        *jargs, head_is_retrieval=jnp.asarray(flags), sel_logic=j_sel,
        **band, **ring))
    t_via = t_dispatch.paged_prefill_attention(
        *targs, head_is_retrieval=T(flags), sel_logic=t_sel, **band, **ring)
    np.testing.assert_allclose(t_via.numpy(), j_via, atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(t_via.numpy(), want, atol=EXACT, rtol=EXACT)

    pallas = np.asarray(j_pp.paged_prefill_attention(
        *jargs, head_is_retrieval=jnp.asarray(flags), sel_logic=j_sel,
        interpret=True, **band, **ring), np.float32)
    np.testing.assert_allclose(t_via.numpy(), pallas, atol=pallas_tol,
                               rtol=pallas_tol)


def test_ring_positions_match_brute_force():
    """``ring_token_positions`` of a 1 + 10 page ring (the engine test's
    geometry) against replaying the appends, before and after wraps, and
    ``ring_logical_blocks`` equal to the JAX function's."""
    sink_b, local_b, n_slots = 1, 10, 11
    for length in (7, 88, 95, 176, 200, 320, 333):
        got = t_kv.ring_token_positions(torch.tensor([length]), n_slots,
                                        sink_b, local_b, PAGE)[0].numpy()
        want = np.full(n_slots * PAGE, -1)
        for tok in range(length):
            b = tok // PAGE
            s = b if b < sink_b else sink_b + (b - sink_b) % local_b
            want[s * PAGE + tok % PAGE] = tok
        np.testing.assert_array_equal(got, want, err_msg=str(length))
        np.testing.assert_array_equal(
            t_kv.ring_logical_blocks(torch.tensor([length]), n_slots,
                                     sink_b, local_b, PAGE).numpy(),
            np.asarray(j_kv.ring_logical_blocks(
                jnp.asarray([length]), n_slots, sink_b, local_b, PAGE)))


def test_explicit_page_list_dispatch_matches_jax():
    """``sel_logic`` without a ring (an explicit list of logical pages, -1
    dead) over a dense kv4 pool, mixed retrieval / streaming heads."""
    rng = np.random.default_rng(3)
    hkv, n_rep, b, w = 2, 2, 2, 6
    jpool = j_kv.make_kv_pool(1, 13, hkv, PAGE, D, kv_bits=4, kv_zeros=True)
    jpool = jpool._replace(
        k_data=jnp.asarray(rng.integers(0, 256, jpool.k_data.shape,
                                        dtype=np.uint8)),
        v_data=jnp.asarray(rng.integers(0, 256, jpool.v_data.shape,
                                        dtype=np.uint8)),
        kv_scales=jnp.asarray(rng.uniform(0.05, 0.5, jpool.kv_scales.shape)
                              .astype(np.float32)))
    tpool = to_torch_pool(jpool)
    table = rng.permutation(12)[: b * w].reshape(b, w).astype(np.int32)
    sel = np.array([[0, 3, 1, -1, 4, 2], [5, -1, 0, 1, -1, 2]], np.int32)
    ctx = np.array([40, 47], np.int32)
    q = rng.normal(size=(b, 8, hkv * n_rep, D)).astype(np.float32)
    q_pos = np.stack([np.arange(32, 40), np.arange(39, 47)]).astype(np.int32)
    flags = np.array([True, True, False, False])
    kw = dict(sink_size=4, local_size=12)
    want = np.asarray(j_dispatch.paged_prefill_attention(
        jnp.asarray(q), jpool, 0, jnp.asarray(table), jnp.asarray(q_pos),
        jnp.asarray(ctx), D ** -0.5, PAGE, 4, True,
        head_is_retrieval=jnp.asarray(flags), sel_logic=jnp.asarray(sel),
        **kw))
    got = t_dispatch.paged_prefill_attention(
        T(q), tpool, 0, T(table), T(q_pos), T(ctx), D ** -0.5, PAGE, 4, True,
        head_is_retrieval=T(flags), sel_logic=T(sel), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=EXACT, rtol=EXACT)
    pos = t_pp.kv_positions_of(T(sel), T(ctx), PAGE)
    assert pos.shape == (b, w * PAGE) and int(pos[1, PAGE]) == -1
    assert int(pos[0, PAGE + 2]) == 3 * PAGE + 2


# -- the model ---------------------------------------------------------------

MPAGE = 16


def test_dual_pool_chunk_attn_matches_jax():
    """One chunk's attention with LServe head routing: kv head 0 retrieval
    (dense over its history), kv head 1 streaming over a 1 + 10 page ring
    wrapped by the context (sink 16, local 64)."""
    rng = np.random.default_rng(7)
    kw = dict(num_layers=1, hidden=64, intermediate=128, num_q_heads=4,
              num_kv_heads=2, head_dim=D, vocab=64, page_size=MPAGE,
              sparse_decode=True, sink_blocks=1, local_blocks=10,
              sparse_prefill=True, ctx_sink=16, ctx_local=64)
    j_spec, t_spec = j_llama.LlamaSpec(**kw), t_llama.LlamaSpec(**kw)
    flags = np.array([[True, False]])
    jmeta = j_llama.make_attn_meta(j_spec, flags)
    tmeta = t_llama.make_attn_meta(t_spec, flags, device="cpu")

    def dirty(n_pages, with_stats):
        p = j_kv.make_kv_pool(1, n_pages, 1, MPAGE, D, kv_bits=4,
                              kv_zeros=True, with_stats=with_stats)
        return p._replace(
            k_data=jnp.asarray(rng.integers(0, 256, p.k_data.shape,
                                            dtype=np.uint8)),
            v_data=jnp.asarray(rng.integers(0, 256, p.v_data.shape,
                                            dtype=np.uint8)),
            kv_scales=jnp.asarray(rng.uniform(0.05, 0.5, p.kv_scales.shape)
                                  .astype(np.float32)))

    jr, js = dirty(30, True), dirty(24, False)
    nb, tc = 2, 32
    ctx = np.array([200, 40], np.int32)      # seq 0's ring has wrapped
    q_pos = np.stack([np.arange(168, 200), np.arange(8, 40)]).astype(np.int32)
    q_pos[1, 28:] = -1                        # padding rows
    ctx[1] = 36
    tables = np.stack([rng.permutation(29)[:13],
                       rng.permutation(29)[:13]]).astype(np.int32)
    stables = np.stack([np.arange(11), np.arange(11, 22)]).astype(np.int32)
    q4 = rng.normal(size=(nb, tc, 4, D)).astype(np.float32)
    j_batch = j_llama.PrefillBatch(
        token_ids=None, positions=None, segment_ids=None,
        block_tables=jnp.asarray(tables), last_token_idx=None,
        seq_lens=None, new_page_ids=None,
        streaming_block_tables=jnp.asarray(stables),
        context_lens=jnp.asarray(ctx))
    t_batch = t_llama.PrefillBatch(
        token_ids=None, positions=None, segment_ids=None,
        block_tables=T(tables), last_token_idx=None, context_lens=T(ctx),
        streaming_block_tables=T(stables))
    meta_l = lambda m: {k: m[k][0] for k in ("retrieval_flags", "head_rank")}
    with jax.disable_jit():
        want = np.asarray(j_llama._dual_pool_chunk_attn(
            jnp.asarray(q4), jr, js, 0, j_batch, jnp.asarray(q_pos),
            meta_l(jmeta), j_spec))
    got = t_llama._dual_pool_chunk_attn(
        T(q4), to_torch_pool(jr), to_torch_pool(js), 0, t_batch, T(q_pos),
        meta_l(tmeta), t_spec)
    np.testing.assert_allclose(got.numpy(), want, atol=EXACT, rtol=EXACT)


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama_lserve_prefill")
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


def engine_kwargs(model_dir, **extra):
    """The JAX package's LServe chunked-prefill configuration
    (``tests/test_chunked_prefill.py``), at the port's precision."""
    kw = dict(
        model=model_dir, precision="w4a8kv4", load_format="dummy",
        lm_head_precision="w8a8", tokenizer_mode="skip", block_size=MPAGE,
        max_num_seqs=8, max_num_batched_tokens=8192,
        num_retrieval_blocks=128, seed=5, sparse_context_mode=True,
        sparse_decode_mode=True, static_sparsity=0.5, ctx_sink_size=16,
        ctx_local_size=64, dec_sink_size=16, dec_local_size=32,
        sparse_kv_cache_budget=64, max_model_len=1024,
    )
    kw.update(extra)
    return kw


def prefill_logits(engine, runner_forward, prompt, chunk):
    """Last-token logits of one prompt: chunked when ``chunk`` is shorter,
    else one whole-prompt forward."""
    engine.add_request("r0", prompt_token_ids=list(prompt),
                       sampling_params=engine_sampling(engine)(
                           temperature=0.0, max_tokens=1, ignore_eos=True))
    metadata, _ = engine.scheduler.schedule()
    runner = engine.worker.model_runner
    if chunk < len(prompt):
        logits, _, _ = runner._execute_chunked_prefill(metadata, chunk)
    else:
        batch, _, _ = runner._prepare_prefill(metadata)
        logits = runner_forward(runner, batch)
    return np.asarray(logits[0], np.float32)


def engine_sampling(engine):
    return JSamplingParams if isinstance(engine, JLLMEngine) else \
        SamplingParams


# Chunked and whole-prompt prefill of a w4a8kv4 model differ by more than
# the JAX w16a16kv16 test's 1.5e-3: a chunk reads the earlier chunks' K/V
# back through the 4-bit pool, the whole prompt attends its own bf16 K/V.
# Measured on this prompt: 0.024 of max |logit|; the JAX package's own gap
# at w4a8kv4 is the same (both forwards equal the JAX ones to 1e-4).
CHUNKED_VS_WHOLE_ATOL = 0.06


def test_sparse_chunked_logits_match_jax_and_whole_prompt(tiny_model_dir):
    """A 200-token prompt, 96-token chunks (two chunks of 96 wrap the 1 +
    10 page ring) against one whole-prompt forward: each equals the JAX
    forward, and the two stay within ``CHUNKED_VS_WHOLE_ATOL`` of max
    |logit| with the same argmax (JAX ``test_sparse_chunked_logits_exact``
    at w4a8kv4)."""
    prompt = np.random.default_rng(5).integers(1, 255, size=200).tolist()
    out = {}
    for chunk in (96, 32000):
        with jax.disable_jit():
            jeng = JLLMEngine.from_engine_args(JEngineArgs(
                **engine_kwargs(tiny_model_dir, chunk_prefill_size=chunk)))
            jparams = jax.tree.map(np.asarray,
                                   jeng.worker.model_runner.params)

            def j_forward(runner, batch):
                ce = runner.cache_engine
                return runner._forward[True](runner.params,
                                             ce.retrieval_pool,
                                             ce.streaming_pool, batch)[0]

            want = prefill_logits(jeng, j_forward, prompt, chunk)
        teng = LLMEngine.from_engine_args(EngineArgs(
            device="cpu", **engine_kwargs(tiny_model_dir,
                                          chunk_prefill_size=chunk)))
        runner = teng.worker.model_runner
        assert runner.cache_engine.streaming_pool is not None
        # a chunked config widens the ring to ctx-local + one chunk; with
        # no prompt above the budget it keeps the decode band's 2 pages
        assert runner.spec.local_blocks == (10 if chunk == 96 else 2)
        runner.load_params(params_from_numpy(jparams, "cpu"))

        def t_forward(runner, batch):
            ce = runner.cache_engine
            return t_llama.llama_forward(runner.params, ce.retrieval_pool,
                                         ce.streaming_pool, batch,
                                         runner.spec, is_prefill=True)[0]

        got = prefill_logits(teng, t_forward, prompt, chunk)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_RTOL * scale)
        out[chunk] = got
    scale = np.abs(out[32000]).max()
    np.testing.assert_allclose(out[96], out[32000], rtol=0,
                               atol=CHUNKED_VS_WHOLE_ATOL * scale)
    assert int(np.argmax(out[96])) == int(np.argmax(out[32000]))


# -- the engine ----------------------------------------------------------------


def serve(engine, sp_cls, requests):
    held = []
    for rid, prompt, n in requests:
        engine.add_request(
            rid, prompt_token_ids=list(prompt),
            sampling_params=sp_cls(temperature=0.0, max_tokens=n,
                                   ignore_eos=True))
        held.append(engine.scheduler.waiting[-1])
    steps = 0
    while engine.has_unfinished_requests():
        engine.step()
        steps += 1
        assert steps < 200, "engine did not converge"
    return {g.request_id: list(g.get_seqs()[0].data.output_token_ids)
            for g in held}


def requests(seed, lens, n):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(1, 255, m).tolist(), n)
            for i, m in enumerate(lens)]


# Greedy tokens compare only where the port's top-2 logit margin exceeds
# what a last-bit difference can move: XLA and PyTorch reduce (RMSNorm,
# softmax) in other orders, and one flipped 4-bit K/V code moved the logits
# of a later step by 5e-4 of their scale in a dense chunked run.
MARGIN = 2e-3


def jax_and_port(model_dir, monkeypatch, reqs, **extra):
    """Serve ``reqs`` through both engines with the same weights; returns
    (JAX tokens, port tokens, port runner, [(chunked?, streaming pool?)]
    per port prefill forward). Asserts every real logit row of the port
    has a top-2 margin above ``MARGIN`` of max |logit|."""
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(
            JEngineArgs(**engine_kwargs(model_dir, **extra)))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, reqs)
    teng = LLMEngine.from_engine_args(
        EngineArgs(device="cpu", **engine_kwargs(model_dir, **extra)))
    runner = teng.worker.model_runner
    runner.load_params(params_from_numpy(jparams, "cpu"))
    prefills = []
    real = t_llama.llama_forward

    margins = []

    def forward(params, pool, spool, batch, spec, is_prefill):
        if is_prefill:
            prefills.append((batch.context_lens is not None,
                             spool is not None))
        out = real(params, pool, spool, batch, spec, is_prefill)
        if not is_prefill:
            keep = batch.active
        elif batch.context_lens is None:
            keep = torch.ones(out[0].shape[0], dtype=torch.bool)
        else:   # the rows whose prompt ends in this chunk
            nb = batch.block_tables.shape[0]
            keep = (batch.segment_ids.view(nb, -1) >= 0).any(1) & (
                batch.context_lens == batch.seq_lens)
        rows = out[0][keep]
        if rows.numel():
            top2 = torch.topk(rows, 2, dim=-1).values
            margins.extend(((top2[:, 0] - top2[:, 1])
                            / rows.abs().max()).tolist())
        return out

    monkeypatch.setattr(t_llama, "llama_forward", forward)
    got = serve(teng, SamplingParams, reqs)
    assert min(margins) > MARGIN, min(margins)
    return want, got, runner, prefills


@pytest.mark.parametrize("chunk", [96, 32000])
@pytest.mark.parametrize("windows", [False, True])
def test_sparse_context_and_decode_engine_matches_jax(tiny_model_dir,
                                                      monkeypatch, chunk,
                                                      windows):
    """``--sparse-context-mode --sparse-decode-mode``: prompts of 200 and
    120 tokens, 96-token budget (chunks of 48 at batch 2; the 200-token
    ring wraps) against whole-prompt prefill; IFB single steps or static
    4-step windows."""
    extra = dict(chunk_prefill_size=chunk)
    if windows:
        extra.update(ifb_mode=False, decode_multi_step=4)
    reqs = requests(5, (200, 120), 6)
    want, got, runner, prefills = jax_and_port(tiny_model_dir, monkeypatch,
                                               reqs, **extra)
    assert got == want
    assert [len(t) for t in got.values()] == [6, 6]
    assert prefills and all(s for _, s in prefills)
    assert all(c for c, _ in prefills) == (chunk == 96)
    if chunk == 96:
        assert len(prefills) == 5        # ceil(200 / 48) chunks
    assert bool(runner._ms_fn_cache) == windows


@pytest.mark.parametrize("chunk", [96, 32000])
def test_sparse_context_alone_engine_matches_jax(tiny_model_dir, monkeypatch,
                                                 chunk):
    """``--sparse-context-mode`` alone, as the JAX engine serves it: no
    streaming pool (the engine builds one only under sparse decode), every
    kv head a retrieval head, dense chunked prefill."""
    extra = dict(sparse_decode_mode=False, chunk_prefill_size=chunk)
    reqs = requests(5, (200, 120), 6)
    want, got, runner, prefills = jax_and_port(tiny_model_dir, monkeypatch,
                                               reqs, **extra)
    assert got == want
    assert runner.spec.sparse_prefill and not runner.spec.sparse_decode
    assert runner.cache_engine.streaming_pool is None
    assert bool(runner.params["attn_meta"]["retrieval_flags"].all())
    assert prefills and not any(s for _, s in prefills)
    assert all(c for c, _ in prefills) == (chunk == 96)


# per-layer K and V scales [L] (max |x| / 127) of the tiny W8A8 model's
# K and V on these requests, read from a w8a8kv16 twin
W8A8_KV8_SCALES = ([0.0092, 0.0101], [0.0083, 0.0089])


@pytest.mark.parametrize("precision,granularity,kv_scales", [
    ("w8a8kv8", "per_tensor", W8A8_KV8_SCALES),
    ("w4a8kv8", "fine_grained", None),
])
def test_sparse_engine_kv_modes_match_jax(tiny_model_dir, monkeypatch,
                                          precision, granularity, kv_scales):
    """Both LServe flags over LServe's other pools: the reference's own
    LServe precision (``w8a8kv8 --kv-quant-granularity per_tensor``, the
    calibrated scales in both pools of both engines, the port's through
    ``load_params(kv_scales=)``) and fine-grained ``w4a8kv8``; prompts of
    200 and 120 tokens in 48-token chunks (the 200-token ring wraps), IFB
    single steps. Greedy tokens are compared while every top-2 margin
    exceeds ``MARGIN`` (``TrustedPrefix``: a W8A8 body's margins come
    near it)."""
    reqs = requests(5, (200, 120), 6)
    kw = engine_kwargs(tiny_model_dir, precision=precision,
                       kv_quant_granularity=granularity,
                       chunk_prefill_size=96)
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
        if kv_scales is not None:
            ce = jeng.worker.model_runner.cache_engine
            pt = dict(k_scale_per_tensor=jnp.float32(kv_scales[0]),
                      v_scale_per_tensor=jnp.float32(kv_scales[1]))
            ce.set_pools(ce.retrieval_pool._replace(**pt),
                         ce.streaming_pool._replace(**pt))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, reqs)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    runner.load_params(params_from_numpy(jparams, "cpu"),
                       kv_scales=None if kv_scales is None else
                       tuple(torch.tensor(x) for x in kv_scales))
    spec, spool = runner.spec, runner.cache_engine.streaming_pool
    assert (spec.kv_bits, spec.kv_zeros) == (8, kv_scales is None)
    assert spec.sparse_prefill and spec.sparse_decode
    if kv_scales is not None:
        assert spool.k_scale_per_tensor.tolist() == list(
            np.float32(kv_scales[0]))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = precision_serve(teng, SamplingParams, reqs, groups)
    assert [len(t) for t in got.values()] == [6, 6]
    # never vacuous: at least every request's first token is compared
    assert trusted.compare(got, want) >= len(reqs)
    assert trusted.cut is None or min(trusted.cut.values()) >= 1
    assert trusted.chunked == 5          # ceil(200 / 48) chunks
