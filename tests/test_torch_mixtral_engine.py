"""The port's engine serving Mixtral against the JAX package's engine
(CPU, tiny model): the same greedy requests through both, with the same
packed weights (the JAX engine's dummy draw carried into the port with
``params_from_numpy`` and ``load_params``), chunked prefill of 16 tokens
(padding rows in the rectangular chunks take no expert capacity) and
static 4-step windows. The JAX engine serves op by op
(``jax.disable_jit()``); tokens are compared while every top-2 margin the
port computes exceeds 2e-3 of max |logit|
(``tests/test_torch_precision_engine.TrustedPrefix``).
"""

import jax
import numpy as np
import pytest

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models.convert import params_from_numpy
from omniserve_tpu_torch.models.mixtral import MixtralSpec
from tests.test_torch_mixtral import write_config_dir
from tests.test_torch_precision_engine import TrustedPrefix, serve


@pytest.fixture(scope="module")
def tiny_mixtral_dir(tmp_path_factory):
    return write_config_dir(tmp_path_factory)


REQUESTS = [("r0", list(range(3, 20)), 5), ("r1", [7, 1, 9, 4], 5)]


def test_engine_matches_jax(tiny_mixtral_dir, monkeypatch):
    """Both engines serve the same greedy requests with the same packed
    weights (the JAX engine's dummy draw carried across), chunked prefill
    of 16 tokens and static 4-step windows: the tokens before the first
    top-2 margin at or below 2e-3 are equal."""
    kw = dict(
        model=tiny_mixtral_dir, load_format="dummy", lm_head_precision="fp16",
        tokenizer_mode="skip", block_size=16, max_num_seqs=8,
        max_num_batched_tokens=2048, num_retrieval_blocks=64, seed=5,
        precision="w4a8kv4", chunk_prefill_size=16, ifb_mode=False,
        decode_multi_step=4)
    jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
    jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
    with jax.disable_jit():
        want = serve(jeng, JSamplingParams, REQUESTS)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    assert isinstance(runner.spec, MixtralSpec)
    assert runner.spec.num_experts == 4
    runner.load_params(params_from_numpy(jparams, "cpu"))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, REQUESTS, groups)
    assert [len(t) for t in got.values()] == [n for _, _, n in REQUESTS]
    assert trusted.compare(got, want) >= len(REQUESTS)
    assert trusted.chunked and runner._ms_fn_cache
