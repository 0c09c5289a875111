"""The port's chunked prefill, prefix reuse and multi-step decode windows
against the JAX package's engine (CPU, tiny Llama, w4a8kv4).

Each test serves the same greedy requests through both engines with the
same packed weights (the JAX engine's dummy draw, carried into the port
with ``params_from_numpy`` and ``load_params``) and the same engine
arguments. The JAX engine runs op by op (``jax.disable_jit()``), where the
two forwards agree to 1e-4 of the logits' scale (``tests/test_torch_llama.py``,
chunked forward included); every logit row the port computes must have a
top-2 margin above that tolerance, so equal tokens cannot come from luck.
On the CPU a window's step runs as an eager loop
(``worker/decode_window.py``); on a card it is a replayed CUDA graph
(``tests/test_torch_kernels_cuda.py``).
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
from omniserve_tpu_torch.worker.model_runner import ModelRunner

LOGIT_RTOL = 1e-4
PAGE = 16


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama_windows")
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
        num_retrieval_blocks=128, seed=5,
    )
    kw.update(extra)
    return kw


def serve(engine, sp_cls, requests, late=()):
    """Greedy requests (id, prompt, max_tokens, prefix_pos); ``late`` ones
    are added after the first step. Returns each request's output tokens."""
    held = []

    def add(reqs):
        for rid, prompt, n, prefix_pos in reqs:
            engine.add_request(
                rid, prompt_token_ids=list(prompt), prefix_pos=prefix_pos,
                sampling_params=sp_cls(temperature=0.0, max_tokens=n,
                                       ignore_eos=True))
            held.append(engine.scheduler.waiting[-1])

    add(requests)
    steps = 0
    while engine.has_unfinished_requests():
        engine.step()
        steps += 1
        if steps == 1:
            add(late)
        assert steps < 200, "engine did not converge"
    return {g.request_id: list(g.get_seqs()[0].data.output_token_ids)
            for g in held}


class MarginRecorder:
    """Wraps the port's ``llama_forward``: the top-2 margin (over max
    |logit|) of every real row it returns, and a count of chunk batches."""

    def __init__(self, monkeypatch):
        self.margins, self.chunked = [], 0
        real = t_llama.llama_forward

        def forward(params, pool, spool, batch, spec, is_prefill):
            out = real(params, pool, spool, batch, spec, is_prefill)
            logits = out[0]
            if not is_prefill:
                rows = batch.active
            elif batch.context_lens is None:
                rows = torch.ones(logits.shape[0], dtype=torch.bool)
            else:
                nb = batch.block_tables.shape[0]
                rows = (batch.segment_ids.view(nb, -1) >= 0).any(1)
                self.chunked += 1
            kept = logits[rows]
            top2 = torch.topk(kept, 2, dim=-1).values
            scale = float(kept.abs().max())
            self.margins.extend(((top2[:, 0] - top2[:, 1]) / scale).tolist())
            return out

        monkeypatch.setattr(t_llama, "llama_forward", forward)

    def check(self):
        assert self.margins
        assert min(self.margins) > LOGIT_RTOL, min(self.margins)


def jax_and_port(model_dir, monkeypatch, requests, late=(), **extra):
    """Serve through the JAX engine, then through the port with its
    weights; returns (jax tokens, port tokens, margin recorder, runner)."""
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(
            JEngineArgs(**engine_kwargs(model_dir, **extra)))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, requests, late)
    teng = LLMEngine.from_engine_args(
        EngineArgs(device="cpu", **engine_kwargs(model_dir, **extra)))
    runner = teng.worker.model_runner
    runner.load_params(params_from_numpy(jparams, "cpu"))
    rec = MarginRecorder(monkeypatch)
    got = serve(teng, SamplingParams, requests, late)
    return want, got, rec, runner


def test_chunked_prefill_matches_jax(tiny_model_dir, monkeypatch):
    """tests/test_chunked_prefill.py:61: prompts of 150/90/40 tokens in a
    64-token budget ([4, 16] chunks, ten of them)."""
    rng = np.random.default_rng(0)
    reqs = [(f"r{i}", rng.integers(1, 255, n).tolist(), 5, None)
            for i, n in enumerate((150, 90, 40))]
    want, got, rec, _ = jax_and_port(tiny_model_dir, monkeypatch, reqs,
                                     chunk_prefill_size=64)
    assert got == want
    assert rec.chunked == 10
    assert [len(t) for t in got.values()] == [5, 5, 5]
    rec.check()


def test_prefix_reuse_matches_jax(tiny_model_dir, monkeypatch):
    """tests/test_prefix.py:140, with the second request arriving after the
    first's prefill: its two-page shared prefix is then computed, and it
    prefills only its suffix through the paged (chunked) path."""
    rng = np.random.default_rng(1)
    shared = rng.integers(2, 250, 2 * PAGE).tolist()
    reqs = [("a", shared + rng.integers(2, 250, 9).tolist(), 4, 2 * PAGE)]
    late = [("b", shared + rng.integers(2, 250, 5).tolist(), 4, 2 * PAGE)]
    calls = []
    real_starts = ModelRunner._prefix_starts

    def starts(metadata):
        s = real_starts(metadata)
        calls.append(s)
        return s

    monkeypatch.setattr(ModelRunner, "_prefix_starts", staticmethod(starts))
    want, got, rec, _ = jax_and_port(tiny_model_dir, monkeypatch, reqs,
                                     late)
    assert got == want
    assert [2 * PAGE] in calls        # "b" skipped its computed prefix
    assert rec.chunked == 1           # and prefilled its suffix only
    rec.check()


def test_static_windows_match_jax_and_single_step(tiny_model_dir,
                                                  monkeypatch):
    """tests/test_multi_step_decode.py:59: static-batch 4-step windows give
    the JAX engine's tokens and the port's own single-step tokens."""
    rng = np.random.default_rng(0)
    reqs = [(f"r{i}", rng.integers(1, 255, n).tolist(), 9, None)
            for i, n in enumerate((20, 33))]
    want, got, rec, runner = jax_and_port(
        tiny_model_dir, monkeypatch, reqs, ifb_mode=False,
        decode_multi_step=4)
    assert got == want
    assert runner._ms_fn_cache                   # windows served decode
    rec.check()
    single = LLMEngine.from_engine_args(EngineArgs(
        device="cpu", **engine_kwargs(tiny_model_dir, ifb_mode=False)))
    single.worker.model_runner.load_params(runner.params)
    assert serve(single, SamplingParams, reqs) == got


@pytest.mark.parametrize("mode", ["pipelined", "ifb"])
def test_pipelined_and_ifb_windows_match_jax(tiny_model_dir, monkeypatch,
                                             mode):
    """tests/test_pipelined_windows.py:46,53: static windows pipelined one
    ahead in benchmarking mode (13 tokens: speculation, then the tail), and
    IFB windows on pure greedy decode batches (11 tokens)."""
    if mode == "pipelined":
        extra = dict(ifb_mode=False, benchmarking_mode=True)
        n = 13
    else:
        extra = dict(ifb_mode=True)
        n = 11
    reqs = [("r0", [5, 9, 2, 6], n, None), ("r1", [3, 1, 4], n, None)]
    want, got, rec, runner = jax_and_port(
        tiny_model_dir, monkeypatch, reqs, max_num_seqs=4,
        decode_multi_step=4, **extra)
    assert [len(t) for t in got.values()] == [n, n]
    assert got == want
    assert runner._ms_fn_cache
    rec.check()
