"""The port's engine against the JAX package's at head_dim 64 (CPU): a
narrow Llama-3.2-1B (its config.json's 32 / 8 = 4 q heads a kv head of
64, the llama3 rope remap, tied embeddings) cut to 8 q over 2 kv heads
(one retrieval, one streaming under LServe's static sparsity 0.5), hidden
512 (dense) or 128 (LServe, ``head_dim`` 64 given in config.json: from a
prompt's second chunk on the two packages' chunked LServe prefill logits
differ by ~1e-2 of their scale at every head dim tried, 16, 32 and 64, so
at hidden 512 a top-2 margin of 4.3e-3 flipped a first token; ROADMAP.md
queue 3, F5).

Both engines serve the same greedy requests with the same packed weights
(the JAX engine's dummy draw carried into the port with
``params_from_numpy`` and ``load_params``): dense w4a8kv4 with chunked
prefill of 16 tokens and static 4-step windows, and both LServe flags
(the selector's per-head lists, the ring's band, a wrapped ring) in IFB
single steps. The JAX engine serves op by op (``jax.disable_jit()``);
greedy tokens are compared while every top-2 margin the port computes
exceeds 2e-3 of max |logit| (``tests/test_torch_precision_engine.
TrustedPrefix``).
"""

import json

import jax
import numpy as np
import pytest

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_lserve_prefill import engine_kwargs as lserve_kwargs
from tests.test_torch_lserve_prefill import requests
from tests.test_torch_precision_engine import TrustedPrefix, serve

PAGE = 16


def model_dir(tmp_path_factory, hidden):
    d = tmp_path_factory.mktemp(f"narrow_llama32_{hidden}")
    cfg = dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        hidden_size=hidden, head_dim=64, intermediate_size=256,
        num_attention_heads=8, num_key_value_heads=2, num_hidden_layers=2,
        vocab_size=256,
        max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling=dict(rope_type="llama3", factor=32.0,
                          low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    )
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(d)


@pytest.fixture(scope="module")
def llama32_model_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, 512)


@pytest.fixture(scope="module")
def llama32_lserve_model_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, 128)


def both_engines(kw, monkeypatch, reqs):
    """(JAX tokens, port tokens, TrustedPrefix, port runner)."""
    jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
    jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
    with jax.disable_jit():
        want = serve(jeng, JSamplingParams, reqs)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    assert runner.spec.head_dim == 64 and runner.spec.n_rep == 4
    assert runner.spec.rope_llama3 == (32.0, 1.0, 4.0, 8192.0)
    runner.load_params(params_from_numpy(jparams, "cpu"))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, reqs, groups)
    assert [len(t) for t in got.values()] == [n for _, _, n in reqs]
    assert trusted.compare(got, want) >= len(reqs)
    return trusted, runner


def test_dense_engine_d64_matches_jax(llama32_model_dir, monkeypatch):
    """w4a8kv4, chunked prefill of 16 tokens and static 4-step windows:
    the decode steps take the split path (append, then the two-stage
    decode's plain version) in both packages."""
    kw = dict(
        model=llama32_model_dir, load_format="dummy",
        lm_head_precision="w8a8", tokenizer_mode="skip", block_size=PAGE,
        max_num_seqs=8, max_num_batched_tokens=2048, num_retrieval_blocks=64,
        seed=5, precision="w4a8kv4", chunk_prefill_size=16, ifb_mode=False,
        decode_multi_step=4)
    reqs = [("r0", list(range(3, 40)), 6), ("r1", [7, 1, 9, 4], 6)]
    trusted, runner = both_engines(kw, monkeypatch, reqs)
    assert trusted.chunked and runner._ms_fn_cache


def test_lserve_engine_d64_matches_jax(llama32_lserve_model_dir,
                                      monkeypatch):
    """Both LServe flags at w4a8kv4: prompts of 200 and 120 tokens in
    48-token chunks (the 200-token ring wraps), IFB single steps over the
    dual pools."""
    kw = lserve_kwargs(llama32_lserve_model_dir, chunk_prefill_size=96)
    trusted, runner = both_engines(kw, monkeypatch,
                                   requests(5, (200, 120), 6))
    assert runner.spec.sparse_prefill and runner.spec.sparse_decode
    assert runner.cache_engine.streaming_pool is not None
    assert trusted.chunked
