"""The port's engine against the JAX package's engine across QServe's
precision matrix (CPU, tiny Llama).

The served part of ``tests/test_engine_variants.py``'s matrix (w4a8kv4,
w4a8kv8, w4a8kv4 g32) plus w8a8kv8 and w16a16kv8, fine-grained KV: each
serves the same greedy requests through both engines with the same packed
weights (the JAX engine's dummy draw carried into the port with
``params_from_numpy`` and ``load_params``). The JAX engine runs op by op
(``jax.disable_jit()``), where the forwards agree to 1e-4 of the logits'
scale (``tests/test_torch_precision.py``). Greedy tokens are compared only
while every top-2 logit margin the port computes exceeds ``MARGIN`` of max
|logit| (``TrustedPrefix``): XLA and PyTorch reduce (RMSNorm, softmax) in
other orders, and one flipped K/V code moved a later step's logits by 5e-4
of their scale in a dense chunked run (ROADMAP.md queue 3). A kv8 case also
runs chunked prefill and static 4-step windows (the eager loop of a
window's step on the CPU; on a card a replayed CUDA graph).
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

MARGIN = 2e-3
PAGE = 16


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama_precision")
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
        model=model_dir, load_format="dummy", lm_head_precision="w8a8",
        tokenizer_mode="skip", block_size=PAGE, max_num_seqs=8,
        max_num_batched_tokens=2048, num_retrieval_blocks=64, seed=5,
        kv_quant_granularity="fine_grained",
    )
    kw.update(extra)
    return kw


def serve(engine, sp_cls, requests, groups=None):
    groups = [] if groups is None else groups
    for rid, prompt, n in requests:
        engine.add_request(rid, prompt_token_ids=list(prompt),
                           sampling_params=sp_cls(temperature=0.0,
                                                  max_tokens=n,
                                                  ignore_eos=True))
        groups.append(engine.scheduler.waiting[-1])
    steps = 0
    while engine.has_unfinished_requests():
        engine.step()
        steps += 1
        assert steps < 200, "engine did not converge"
    return {g.request_id: list(g.get_seqs()[0].data.output_token_ids)
            for g in groups}


class TrustedPrefix:
    """Wraps the port's ``llama_forward``. From the first forward whose
    real rows hold a top-2 margin at or below ``MARGIN`` of max |logit|,
    a request's later tokens may rightly differ between the engines: the
    tokens each request had before that forward are the ones compared.
    (Inside a multi-step window the outputs land after the window, so the
    cut falls at the window's start: conservative.)"""

    def __init__(self, monkeypatch, groups):
        self.groups, self.cut, self.chunked = groups, None, 0
        real = t_llama.llama_forward

        def forward(params, pool, spool, batch, spec, is_prefill, **kw):
            out = real(params, pool, spool, batch, spec, is_prefill, **kw)
            logits = out[0]
            if not is_prefill:
                rows = batch.active
            elif batch.context_lens is None:
                rows = torch.ones(logits.shape[0], dtype=torch.bool)
            else:   # the rows whose prompt ends in this chunk
                nb = batch.block_tables.shape[0]
                rows = (batch.segment_ids.view(nb, -1) >= 0).any(1) & (
                    batch.context_lens == batch.seq_lens)
                self.chunked += 1
            kept = logits[rows]
            if kept.numel() and self.cut is None:
                top2 = torch.topk(kept, 2, dim=-1).values
                margin = float(((top2[:, 0] - top2[:, 1])
                                / kept.abs().max()).min())
                if margin <= MARGIN:
                    self.cut = {
                        g.request_id:
                            len(g.get_seqs()[0].data.output_token_ids)
                        for g in self.groups}
            return out

        monkeypatch.setattr(t_llama, "llama_forward", forward)

    def compare(self, got, want):
        """Assert equal trusted prefixes; returns the tokens compared."""
        n = 0
        for rid, toks in want.items():
            k = len(toks) if self.cut is None else self.cut[rid]
            assert got[rid][:k] == toks[:k], rid
            n += k
        return n


REQUESTS = [("r0", list(range(3, 20)), 6), ("r1", [7, 1, 9, 4], 9),
            ("r2", list(range(40, 77, 2)), 4)]


@pytest.mark.parametrize("precision,extra", [
    ("w4a8kv4", {}),
    ("w4a8kv8", {}),
    ("w4a8kv4", {"group_size": 32}),
    ("w8a8kv8", {}),
    ("w16a16kv8", {}),
    ("w4a8kv8", {"group_size": 32, "chunk_prefill_size": 16,
                 "ifb_mode": False, "decode_multi_step": 4}),
])
def test_precision_engine_matches_jax(tiny_model_dir, monkeypatch, precision,
                                      extra):
    kw = engine_kwargs(tiny_model_dir, precision=precision, **extra)
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, REQUESTS)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    assert runner.spec.kv_bits == int(precision.split("kv")[1])
    assert runner.spec.group_size == extra.get("group_size", -1)
    runner.load_params(params_from_numpy(jparams, "cpu"))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, REQUESTS, groups)
    assert [len(t) for t in got.values()] == [n for _, _, n in REQUESTS]
    # never vacuous: at least every request's first token is compared
    assert trusted.compare(got, want) >= len(REQUESTS)
    assert trusted.cut is None or min(trusted.cut.values()) >= 1
    if "chunk_prefill_size" in extra:
        assert trusted.chunked               # kv8 pages read back per chunk
        assert runner._ms_fn_cache           # windows served decode
