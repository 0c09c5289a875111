"""The port's engine against the JAX package's engine (CPU, tiny model).

Both engines serve the same packed weights (the JAX engine's dummy draw,
carried into the port with ``params_from_numpy`` and ``load_params``) and
the same three greedy requests. The JAX engine runs op by op
(``jax.disable_jit()``), where ``tests/test_torch_llama.py`` shows the two
forwards agree to 1e-4 of the logits' scale; every step's top-2 logit
margin must exceed that tolerance, so equal tokens cannot come from luck.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models.convert import params_from_numpy

LOGIT_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama_port")
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


def engine_kwargs(model_dir):
    return dict(
        model=model_dir, precision="w4a8kv4", load_format="dummy",
        lm_head_precision="w8a8", tokenizer_mode="skip", block_size=16,
        max_num_seqs=8, max_num_batched_tokens=2048,
        num_retrieval_blocks=64, seed=5,
    )


PROMPTS = [list(range(3, 20)), [7, 1, 9, 4], list(range(40, 77, 2))]
MAX_TOKENS = [6, 9, 4]


def run(engine, sampling_params_cls):
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_TOKENS)):
        engine.add_request(f"r{i}", prompt_token_ids=p,
                           sampling_params=sampling_params_cls(
                               temperature=0.0, max_tokens=n,
                               ignore_eos=True))
    done = {}
    steps = 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                done[o.request_id] = list(o.outputs[0].token_ids)
        steps += 1
        assert steps < 50
    return done


def test_greedy_tokens_match_jax_engine(tiny_model_dir):
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(
            JEngineArgs(**engine_kwargs(tiny_model_dir)))
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = run(jeng, JSamplingParams)

    teng = LLMEngine.from_engine_args(
        EngineArgs(device="cpu", **engine_kwargs(tiny_model_dir)))
    runner = teng.worker.model_runner
    runner.load_params(params_from_numpy(jparams, "cpu"))
    margins = []
    sample = runner._sample

    def recording_sample(logits, metadata, rows):
        top2 = torch.topk(logits[rows], 2, dim=-1).values
        scale = float(logits[rows].abs().max())
        margins.extend(((top2[:, 0] - top2[:, 1]) / scale).tolist())
        return sample(logits, metadata, rows)

    runner._sample = recording_sample
    got = run(teng, SamplingParams)
    assert got == want
    assert len(margins) == sum(MAX_TOKENS)
    assert min(margins) > LOGIT_RTOL, min(margins)


def test_engine_raises_outside_slice(tiny_model_dir, monkeypatch):
    """Chunked prefill, prefix reuse, multi-step windows, LServe's decode
    and prefill sides and the precision matrix serve (see
    tests/test_torch_engine_windows.py, tests/test_torch_lserve_{engine,
    prefill}.py, tests/test_torch_precision_engine.py and
    tests/test_torch_kv16_engine.py), and so do kv8 and per-tensor KV under
    LServe's modes: those cases serve greedy requests equal to the JAX
    engine's (compared while every top-2 margin exceeds 2e-3). kv16 under
    LServe's modes builds its engine (bf16 dual pools, K stats on the
    retrieval pool; served in tests/test_torch_lserve_kv16.py); tensor
    parallelism stays outside the port and raises naming its ROADMAP
    item."""
    from tests.test_torch_precision_engine import TrustedPrefix

    kv16 = LLMEngine.from_engine_args(EngineArgs(
        device="cpu", **dict(engine_kwargs(tiny_model_dir),
                             precision="w16a16kv16", sparse_context_mode=True,
                             sparse_decode_mode=True, static_sparsity=0.5)))
    runner = kv16.worker.model_runner
    spec, ce = runner.spec, runner.cache_engine
    assert spec.kv_bits == 16 and spec.sparse_prefill and spec.sparse_decode
    assert ce.streaming_pool.k_data.dtype == torch.bfloat16
    assert ce.retrieval_pool.k_stats.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine.from_engine_args(EngineArgs(
            device="cpu", **dict(engine_kwargs(tiny_model_dir),
                                 tensor_parallel_size=2)))
    for extra in (dict(precision="w8a8kv8",
                       kv_quant_granularity="per_tensor",
                       sparse_decode_mode=True, static_sparsity=0.5),
                  dict(precision="w4a8kv8", sparse_decode_mode=True,
                       static_sparsity=0.5)):
        kw = dict(engine_kwargs(tiny_model_dir), **extra)
        with jax.disable_jit():
            jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
            jparams = jax.tree.map(np.asarray,
                                   jeng.worker.model_runner.params)
            want = run(jeng, JSamplingParams)
        teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
        runner = teng.worker.model_runner
        assert runner.spec.sparse_decode and runner.spec.kv_bits == 8
        assert runner.cache_engine.streaming_pool is not None
        runner.load_params(params_from_numpy(jparams, "cpu"))
        groups = []
        add_request = teng.add_request

        def recording_add(*a, **k):
            add_request(*a, **k)
            groups.append(teng.scheduler.waiting[-1])

        with monkeypatch.context() as m:
            m.setattr(teng, "add_request", recording_add)
            trusted = TrustedPrefix(m, groups)
            got = run(teng, SamplingParams)
        assert [len(got[f"r{i}"]) for i in range(3)] == MAX_TOKENS
        # never vacuous: at least every request's first token is compared
        assert trusted.compare(got, want) >= len(PROMPTS), extra


def test_device_defaults_to_cuda_and_raises_without_it(tiny_model_dir):
    from omniserve_tpu_torch.engine.arg_utils import resolve_device

    assert resolve_device("cpu") == "cpu"
    if torch.cuda.is_available():
        assert resolve_device("auto") == "cuda:0"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EngineArgs(model=tiny_model_dir).create_engine_configs()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, omniserve_tpu_torch\n"
        "import omniserve_tpu_torch.models.convert\n"
        "import omniserve_tpu_torch.ops.cuda.quant_matmul\n"
        "import omniserve_tpu_torch.ops.cuda.decode_attention\n"
        "import omniserve_tpu_torch.ops.cuda.flash_attention\n"
        "import omniserve_tpu_torch.ops.cuda.paged_prefill\n"
        "import omniserve_tpu_torch.ops.cuda.kv_append\n"
        "import omniserve_tpu_torch.lserve_benchmark\n"
        "import omniserve_tpu_torch.worker.decode_window\n"
        "import omniserve_tpu_torch.worker.model_runner\n"
        "import omniserve_tpu_torch.qserve_benchmark\n"
        "import omniserve_tpu_torch.models.weight_loader\n"
        "import omniserve_tpu_torch.ckpt_converter.convert\n"
        "import omniserve_tpu_torch.ckpt_converter.make_fake_quant_dump\n"
        "import omniserve_tpu_torch.conversation\n"
        "import omniserve_tpu_torch.csrc\n"
        "import omniserve_tpu_torch.eval.ppl\n"
        "import omniserve_tpu_torch.eval.needle\n"
        "import omniserve_tpu_torch.eval.sparse_agreement\n"
        "import omniserve_tpu_torch.eval.longbench.pred\n"
        "import omniserve_tpu_torch.eval.longbench.eval\n"
        "import omniserve_tpu_torch.eval.longbench.metrics\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ("
        "'jax', 'omniserve_tpu', 'safetensors', 'transformers', "
        "'tokenizers', 'rouge_score')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_cache_engine_copy_and_swap_pages():
    from omniserve_tpu_torch.config import CacheConfig, ModelConfig
    from omniserve_tpu_torch.worker.cache_engine import CacheEngine

    from omniserve_tpu_torch.attn_config import sparse_attn_init

    mc = ModelConfig("unused", precision="w4a8kv4",
                     hf_config=type("H", (), {})())
    ce = CacheEngine(mc, CacheConfig(page_size=16,
                                     num_retrieval_device_blocks=6),
                     num_layers=2, num_kv_heads=2, head_dim=8, device="cpu")
    assert ce.streaming_pool is None and ce.retrieval_pool.k_stats is None
    with pytest.raises(ValueError, match="streaming"):
        ce.copy_pages({1: [2]}, streaming=True)

    # LServe's dual pools: the retrieval pool carries K stats, and page ops
    # reach either pool
    sp = sparse_attn_init(sparse_decode_mode=True, static_sparsity=0.5,
                          page_size=16, num_layers=2, num_kv_heads=2)
    dual = CacheEngine(
        mc, CacheConfig(page_size=16, num_retrieval_device_blocks=6,
                        num_streaming_device_blocks=6),
        num_layers=2, num_kv_heads=2, head_dim=8, sp_attn_config=sp,
        device="cpu")
    assert dual.retrieval_pool.num_heads == dual.streaming_pool.num_heads == 1
    assert tuple(dual.retrieval_pool.k_stats.shape) == (2, 6, 1, 8, 8)
    g = torch.Generator().manual_seed(0)
    for engine, streaming in ((ce, False), (dual, False), (dual, True)):
        pool = [t for t in engine._pool(streaming) if t is not None]
        assert len(pool) == (4 if engine is dual and not streaming else 3)
        for t in pool:
            t.copy_(torch.randint(0, 200, t.shape, generator=g).to(t.dtype))
        before = [t.clone() for t in pool]
        engine.copy_pages({1: [3, 4]}, streaming=streaming)
        for t in pool:
            assert torch.equal(t[:, 3], t[:, 1])
            assert torch.equal(t[:, 4], t[:, 1])
        engine.swap_out({2: 0}, streaming=streaming)
        for t in pool:
            t[:, 2] = 0
        engine.swap_in({0: 5}, streaming=streaming)
        for t, b in zip(pool, before):
            assert torch.equal(t[:, 5], b[:, 2])


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU exit; this machine has a GPU")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert '"ok"' not in out.stdout
