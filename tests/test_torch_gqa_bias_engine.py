"""The port's engine against the JAX package's at a Qwen2 shape (CPU): 14 q
heads over 2 kv heads (GQA groups of 7, Qwen2-7B's ratio) and the QKV
bias.

Both engines serve the same greedy requests with the same packed weights
(the JAX engine's dummy draw carried into the port with
``params_from_numpy`` and ``load_params``), chunked prefill of 16 tokens
and static 4-step windows included. The JAX engine serves op by op
(``jax.disable_jit()``); greedy tokens are compared while every top-2
margin the port computes exceeds 2e-3 of max |logit|
(``tests/test_torch_precision_engine.TrustedPrefix``). Most of the time is
the JAX engine compiling each eager op once, so fewer requests or steps
save little (one request instead of two: ~10%).
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
from tests.test_torch_precision_engine import TrustedPrefix, serve

PAGE = 16


@pytest.fixture(scope="module")
def qwen2_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_qwen2")
    cfg = dict(
        architectures=["Qwen2ForCausalLM"], model_type="qwen2",
        hidden_size=224, intermediate_size=256, num_attention_heads=14,
        num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
        max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=1e6,
    )
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(d)


REQUESTS = [("r0", list(range(3, 20)), 5), ("r1", [7, 1, 9, 4], 5)]


def test_qwen2_engine_matches_jax(qwen2_model_dir, monkeypatch):
    """Both engines serve the same greedy requests at a Qwen2 shape (14 q
    heads over 2, the QKV bias) with the same packed weights, chunked
    prefill of 16 tokens and static 4-step windows."""
    kw = dict(
        model=qwen2_model_dir, load_format="dummy", lm_head_precision="w8a8",
        tokenizer_mode="skip", block_size=PAGE, max_num_seqs=8,
        max_num_batched_tokens=2048, num_retrieval_blocks=64, seed=5,
        precision="w4a8kv4", chunk_prefill_size=16, ifb_mode=False,
        decode_multi_step=4)
    # the dummy draw compiled (the same numbers), the serving op by op
    jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
    jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
    with jax.disable_jit():
        want = serve(jeng, JSamplingParams, REQUESTS)
    assert "qkv_bias" in jparams["layers"]
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    assert runner.spec.attn_bias and runner.spec.n_rep == 7
    runner.load_params(params_from_numpy(jparams, "cpu"))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, REQUESTS, groups)
    assert [len(t) for t in got.values()] == [n for _, _, n in REQUESTS]
    assert trusted.compare(got, want) >= len(REQUESTS)
    assert trusted.chunked and runner._ms_fn_cache
