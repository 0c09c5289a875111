"""The port's engine against the JAX package's engine at kv16 and
per-tensor KV (CPU, tiny Llama).

The two cases of ``tests/test_engine_variants.py``'s matrix that the
precision-matrix engine test (``tests/test_torch_precision_engine.py``,
whose helpers this file reuses) does not serve: ``w16a16kv16`` and
``w8a8kv8 --kv-quant-granularity per_tensor`` (unit scales under dummy
weights, as in the JAX package); then each width again with chunked
prefill and 4-step windows: static windows over a kv16 pool, IFB windows
over a per-tensor kv8 pool whose calibrated scales (max |x| / 127 of the
tiny model's K and V) both engines take as a checkpoint's: the port
through ``load_params(kv_scales=)``. Greedy tokens are compared while every
top-2 margin exceeds ``MARGIN`` of max |logit|. Last, an engine built with
no ``precision`` serves ``w16a16kv16``, the default, and the CLI's KV
flags reach the spec as they reach the JAX package's model config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu import EngineArgs as JEngineArgs
from omniserve_tpu import LLMEngine as JLLMEngine
from omniserve_tpu import SamplingParams as JSamplingParams
from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_precision_engine import (  # noqa: F401 (fixture)
    REQUESTS,
    TrustedPrefix,
    engine_kwargs,
    serve,
    tiny_model_dir,
)

WINDOWS = {"chunk_prefill_size": 16, "decode_multi_step": 4}
# per-layer K and V scales [L] of the tiny W4A8 model's pools
KV8_SCALES = ([0.0049, 0.0057], [0.0053, 0.0051])


@pytest.mark.parametrize("precision,extra,kv_scales", [
    ("w16a16kv16", {}, None),
    ("w8a8kv8", {"kv_quant_granularity": "per_tensor"}, None),
    ("w16a16kv16", dict(WINDOWS, ifb_mode=False), None),
    ("w4a8kv8", dict(WINDOWS, kv_quant_granularity="per_tensor"),
     KV8_SCALES),
])
def test_kv16_per_tensor_engine_matches_jax(tiny_model_dir, monkeypatch,
                                            precision, extra, kv_scales):
    kw = engine_kwargs(tiny_model_dir, precision=precision, **extra)
    with jax.disable_jit():
        jeng = JLLMEngine.from_engine_args(JEngineArgs(**kw))
        if kv_scales is not None:
            ce = jeng.worker.model_runner.cache_engine
            ce.set_pools(ce.retrieval_pool._replace(
                k_scale_per_tensor=jnp.float32(kv_scales[0]),
                v_scale_per_tensor=jnp.float32(kv_scales[1])),
                ce.streaming_pool)
        jparams = jax.tree.map(np.asarray, jeng.worker.model_runner.params)
        want = serve(jeng, JSamplingParams, REQUESTS)
    teng = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    runner = teng.worker.model_runner
    pool = runner.cache_engine.retrieval_pool
    per_tensor = extra.get("kv_quant_granularity") == "per_tensor"
    assert runner.spec.kv_bits == int(precision.split("kv")[1])
    assert runner.spec.kv_zeros == (not per_tensor)
    assert (pool.kv_scales is None) == (per_tensor or "kv16" in precision)
    assert (pool.k_scale_per_tensor is not None) == per_tensor
    runner.load_params(params_from_numpy(jparams, "cpu"),
                       kv_scales=None if kv_scales is None else
                       tuple(torch.tensor(x) for x in kv_scales))
    if kv_scales is not None:
        assert pool.k_scale_per_tensor.tolist() == list(
            np.float32(kv_scales[0]))
    groups = []
    trusted = TrustedPrefix(monkeypatch, groups)
    got = serve(teng, SamplingParams, REQUESTS, groups)
    assert [len(t) for t in got.values()] == [n for _, _, n in REQUESTS]
    # never vacuous: at least every request's first token is compared
    assert trusted.compare(got, want) >= len(REQUESTS)
    assert trusted.cut is None or min(trusted.cut.values()) >= 1
    if "chunk_prefill_size" in extra:
        assert trusted.chunked               # pages read back per chunk
        assert runner._ms_fn_cache           # windows served decode


def test_default_precision_serves_kv16(tiny_model_dir):
    """No ``precision``: the engine serves the JAX package's default,
    ``w16a16kv16`` (bf16 pool pages, no scales)."""
    kw = engine_kwargs(tiny_model_dir)
    del kw["kv_quant_granularity"]
    engine = LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))
    spec = engine.worker.model_runner.spec
    assert (spec.weight_bits, spec.act_bits, spec.kv_bits) == (16, 16, 16)
    pool = engine.worker.model_runner.cache_engine.retrieval_pool
    assert str(pool.k_data.dtype) == "torch.bfloat16"
    assert pool.kv_scales is None and pool.k_scale_per_tensor is None
    got = serve(engine, SamplingParams, REQUESTS[:2])
    assert [len(t) for t in got.values()] == [n for _, _, n in REQUESTS[:2]]


@pytest.mark.parametrize("flags,want", [
    ([], (16, True)),
    (["--precision", "w4a8kv4", "--kv-cache-dtype", "fp16"], (16, True)),
    (["--precision", "w16a16kv16", "--kv-cache-dtype", "int8"], (8, True)),
    (["--precision", "w8a8kv8", "--kv-quant-granularity", "per_tensor"],
     (8, False)),
])
def test_cli_kv_flags_reach_the_spec_as_in_jax(tiny_model_dir, flags, want):
    """The CLI's KV flags (``--precision``'s kv part, ``--kv-cache-dtype``,
    ``--kv-quant-granularity``) give the JAX package's model config and
    reach the port's ``LlamaSpec``."""
    import argparse

    from omniserve_tpu_torch.models.llama import LlamaSpec

    argv = ["--model", tiny_model_dir, *flags]
    configs = {}
    for name, cls, extra in (("jax", JEngineArgs, []),
                             ("port", EngineArgs, ["--device", "cpu"])):
        parser = cls.add_cli_args(argparse.ArgumentParser())
        configs[name] = cls.from_cli_args(parser.parse_args(
            argv + extra)).create_engine_configs()["model_config"]
    for cfg in configs.values():
        assert (cfg.kv_cache_bits, cfg.kv_zeros) == want
    assert configs["port"].precision == configs["jax"].precision
    spec = LlamaSpec.from_model_config(configs["port"])
    spec.check_supported()
    assert (spec.kv_bits, spec.kv_zeros) == want
