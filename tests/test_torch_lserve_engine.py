"""LServe's decode side through both engines (CPU, tiny Llama, w4a8kv4).

``sparse_decode_mode`` with ``static_sparsity=0.5``: one kv head of each
layer keeps its whole history in the retrieval pool (with K min/max stats)
and attends the pages the selector picks; the other lives in the streaming
ring pool and attends its sink + local band. The budget (3 pages) is
smaller than the long prompts, so the selector really drops pages, and the
prompts are longer than sink + ring, so the ring has wrapped.

Each test serves the same greedy requests through the JAX engine (op by op,
``jax.disable_jit()``) and the port with the same packed weights; every
logit row the port computes must have a top-2 margin above the 1e-4 that
``tests/test_torch_lserve_llama.py`` holds the two forwards to, so equal
tokens cannot come from luck.
"""

import json

import jax
import numpy as np
import pytest
import torch

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import params_from_numpy

LOGIT_RTOL = 1e-4
PAGE = 16


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama_lserve")
    cfg = dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
        max_position_embeddings=2048, rms_norm_eps=1e-5,
        rope_theta=500000.0,
    )
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(d)


def engine_kwargs(model_dir, **extra):
    kw = dict(
        model=model_dir, precision="w4a8kv4", load_format="dummy",
        lm_head_precision="w8a8", tokenizer_mode="skip", block_size=PAGE,
        max_num_seqs=8, max_num_batched_tokens=2048,
        num_retrieval_blocks=64, num_streaming_blocks=32, seed=5,
        sparse_decode_mode=True, static_sparsity=0.5, dec_sink_size=PAGE,
        dec_local_size=2 * PAGE, sparse_kv_cache_budget=3 * PAGE,
        selector_update_interval=4,
    )
    kw.update(extra)
    return kw


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


class Recorder:
    """Wraps the port's ``llama_forward``: the top-2 margin (over max
    |logit|) of every real row, how many decode steps refreshed the
    selection, and whether a selection ever dropped a page."""

    def __init__(self, monkeypatch):
        self.margins, self.refreshes, self.decodes = [], 0, 0
        self.dropped_pages = False
        real = t_llama.llama_forward

        def forward(params, pool, spool, batch, spec, is_prefill):
            out = real(params, pool, spool, batch, spec, is_prefill)
            logits = out[0]
            rows = (torch.ones(logits.shape[0], dtype=torch.bool)
                    if is_prefill else batch.active)
            kept = logits[rows]
            top2 = torch.topk(kept, 2, dim=-1).values
            scale = float(kept.abs().max())
            self.margins.extend(((top2[:, 0] - top2[:, 1]) / scale).tolist())
            if not is_prefill:
                assert spool is not None and pool.k_stats is not None
                self.decodes += 1
                self.refreshes += bool(batch.refresh_selection)
                n_pages = (batch.positions + PAGE) // PAGE
                picked = (out[3][:, :, 0] >= 0).sum(-1)     # [L, B]
                self.dropped_pages |= bool(
                    (picked < n_pages[None, :])[:, batch.active].any())
            return out

        monkeypatch.setattr(t_llama, "llama_forward", forward)

    def check(self):
        assert self.margins
        assert min(self.margins) > LOGIT_RTOL, min(self.margins)


def jax_and_port(model_dir, monkeypatch, requests, **extra):
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(
            JEngineArgs(**engine_kwargs(model_dir, **extra)))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, requests)
    teng = LLMEngine.from_engine_args(
        EngineArgs(device="cpu", **engine_kwargs(model_dir, **extra)))
    runner = teng.worker.model_runner
    assert runner.cache_engine.streaming_pool is not None
    assert runner.cache_engine.retrieval_pool.num_heads == 1
    runner.load_params(params_from_numpy(jparams, "cpu"))
    rec = Recorder(monkeypatch)
    got = serve(teng, SamplingParams, requests)
    return want, got, rec, runner


def requests(seed, lens, n):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(1, 255, m).tolist(), n)
            for i, m in enumerate(lens)]


def test_sparse_decode_single_steps_match_jax(tiny_model_dir, monkeypatch):
    """IFB single-step decode: prompts of 90, 61 and 7 tokens (sink + ring
    hold 48), ten tokens each: the 61-token request crosses a page
    boundary, selections refresh on the interval."""
    reqs = requests(0, (90, 61, 7), 10)
    want, got, rec, runner = jax_and_port(tiny_model_dir, monkeypatch, reqs)
    assert got == want
    assert [len(t) for t in got.values()] == [10, 10, 10]
    assert rec.decodes == 9 and rec.refreshes == runner.selector_refreshes
    assert 3 <= rec.refreshes < rec.decodes
    assert rec.dropped_pages
    rec.check()


@pytest.mark.parametrize("mode", ["static", "pipelined"])
def test_sparse_decode_windows_match_jax(tiny_model_dir, monkeypatch, mode):
    """Static-batch 4-step windows (and windows pipelined one ahead in
    benchmarking mode): refreshes inside a window follow the JAX scan's
    rule, and the tokens equal the JAX engine's and the port's own
    single-step tokens."""
    extra = dict(ifb_mode=False, decode_multi_step=4)
    if mode == "pipelined":
        extra["benchmarking_mode"] = True
    reqs = requests(1, (75, 52), 13)
    want, got, rec, runner = jax_and_port(tiny_model_dir, monkeypatch, reqs,
                                          **extra)
    assert got == want
    assert [len(t) for t in got.values()] == [13, 13]
    assert runner._ms_fn_cache                   # windows served decode
    assert rec.refreshes == runner.selector_refreshes >= 3
    assert rec.dropped_pages
    rec.check()
    if mode == "static":
        single = LLMEngine.from_engine_args(EngineArgs(
            device="cpu", **engine_kwargs(tiny_model_dir, ifb_mode=False)))
        single.worker.model_runner.load_params(runner.params)
        assert serve(single, SamplingParams, reqs) == got


def test_sparse_prefill_builds_and_serves(tiny_model_dir):
    """The same engine arguments with ``sparse_context_mode`` added build
    the LServe configuration and serve (the tokens against the JAX engine's
    are in ``tests/test_torch_lserve_prefill.py``): a 90-token prompt over
    a 64-token chunk budget prefills in chunks, the ring widened to hold
    ctx-local + one chunk."""
    engine = LLMEngine.from_engine_args(EngineArgs(
        device="cpu", **engine_kwargs(
            tiny_model_dir, sparse_context_mode=True, ctx_sink_size=PAGE,
            ctx_local_size=2 * PAGE, chunk_prefill_size=4 * PAGE)))
    runner = engine.worker.model_runner
    assert runner.spec.sparse_prefill and runner.spec.sparse_decode
    assert runner.cache_engine.streaming_pool is not None
    assert runner.spec.local_blocks == 6          # (32 + 64) / 16
    got = serve(engine, SamplingParams, requests(6, (90, 20), 4))
    assert [len(t) for t in got.values()] == [4, 4]
    assert all(0 <= t < 256 for t in sum(got.values(), []))


def test_sparse_decode_without_streaming_heads_chunked_prefill(
        tiny_model_dir, monkeypatch):
    """``static_sparsity=0``: every kv head is a retrieval head, there is no
    streaming pool, and a long prompt prefills in chunks over the paged
    pool with the K stats of each chunk's pages reset first; decode still
    attends the selector's pages."""
    reqs = requests(2, (100, 30), 6)
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(JEngineArgs(**engine_kwargs(
            tiny_model_dir, static_sparsity=0.0, chunk_prefill_size=64)))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, reqs)
    teng = LLMEngine.from_engine_args(EngineArgs(
        device="cpu", **engine_kwargs(tiny_model_dir, static_sparsity=0.0,
                                      chunk_prefill_size=64)))
    runner = teng.worker.model_runner
    assert runner.cache_engine.streaming_pool is None
    assert runner.cache_engine.retrieval_pool.k_stats is not None
    runner.load_params(params_from_numpy(jparams, "cpu"))
    chunks = []
    real = t_llama.llama_forward

    def forward(params, pool, spool, batch, spec, is_prefill):
        if is_prefill:
            chunks.append(batch.context_lens is not None)
            assert batch.new_page_ids is not None
        return real(params, pool, spool, batch, spec, is_prefill)

    monkeypatch.setattr(t_llama, "llama_forward", forward)
    assert serve(teng, SamplingParams, reqs) == want
    assert chunks and all(chunks)
    assert runner.selector_refreshes >= 2


def test_sparse_decode_ifb_windows_match_jax(tiny_model_dir, monkeypatch):
    """IFB 4-step windows while each ring is still filling: prompts of 7,
    20 and 9 tokens (below sink + ring), fourteen tokens each, so windows
    cross page boundaries and reserve new streaming pages. Each window must
    see its sequences' refreshed streaming tables, as the JAX engine's
    do."""
    reqs = requests(3, (7, 20, 9), 14)
    want, got, rec, runner = jax_and_port(
        tiny_model_dir, monkeypatch, reqs, decode_multi_step=4)
    assert got == want
    assert [len(t) for t in got.values()] == [14, 14, 14]
    assert runner._ms_fn_cache                   # windows served decode
    rec.check()
