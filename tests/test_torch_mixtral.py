"""The port's Mixtral (``omniserve_tpu_torch/models/mixtral.py``) against
the JAX package's (CPU, tiny model).

2-layer ``mixtral_forward`` prefills and decode steps against the JAX
forward run op by op, with the JAX random draw carried across
(``params_from_numpy``): kv4 through ``tests/test_torch_llama.
check_forward``, kv16 (the W16A16 body) through ``tests/test_torch_lserve_
llama.check_sparse_forward`` with sparse decode off (kv8 and LServe's
flags: ``tests/test_torch_mixtral_pools.py``). Each records every GEMM's
input codes, expert GEMMs included: logits at 1e-4 of their scale and
pools equal while no code moved, then ``FLIP_GATES``
(``tests/test_torch_gqa_bias.py``). The W8A8 lm_head is refused at engine
build, and the port's packed draw has the JAX draw's tree. Both engines:
``tests/test_torch_mixtral_engine.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from omniserve_tpu.models import mixtral as j_mixtral
from omniserve_tpu_torch import EngineArgs, LLMEngine
from omniserve_tpu_torch.models import mixtral as t_mixtral
from omniserve_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_gqa_bias import FLIP_GATES
from tests.test_torch_llama import check_forward, spec_kwargs
from tests.test_torch_lserve_llama import check_sparse_forward

EXPERTS = dict(num_experts=4, top_k=2)
# (spec classes, the JAX random draw, forwards) for check_sparse_forward
MIXTRAL = ((j_mixtral.MixtralSpec, t_mixtral.MixtralSpec),
           j_mixtral.make_random_params,
           (j_mixtral.mixtral_forward, t_mixtral.mixtral_forward))


def both_mixtrals(kw, seed=3):
    """(JAX spec, port spec, JAX draw, the port's copy) of ``kw``."""
    j_spec, t_spec = j_mixtral.MixtralSpec(**kw), t_mixtral.MixtralSpec(**kw)
    t_spec.check_supported()
    jparams = j_mixtral.make_random_params(j_spec, seed=seed)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return j_spec, t_spec, jparams, tparams


def test_forward_kv4_matches_jax():
    """w4a8kv4: a padded prefill of two prompts and a decode step with an
    inactive slot, whose padding rows and inactive row take no capacity."""
    kw = dict(spec_kwargs(16), **EXPERTS)
    check_forward(kw, FLIP_GATES, models=both_mixtrals(kw),
                  forwards=MIXTRAL[2])


def test_forward_kv16_matches_jax():
    """w16a16kv16 (the bf16 expert products): a whole-prompt prefill and
    four decode steps over dirty kv16 pools, crossing a page."""
    over = dict(EXPERTS, lm_head_bits=16, sparse_decode=False,
                weight_bits=16, act_bits=16, kv_bits=16)
    crossed, _ = check_sparse_forward(over, n_steps=4, flip_gates=FLIP_GATES,
                                      family=MIXTRAL)
    assert crossed == 1


@pytest.mark.parametrize("body", [
    dict(weight_bits=4), dict(weight_bits=4, group_size=32),
    dict(weight_bits=8), dict(weight_bits=16, act_bits=16, kv_bits=16)])
def test_random_packed_params_tree(body):
    """The port's packed draw on the device has the JAX draw's tree: the
    same keys, containers, shapes and dtypes (a bf16 lm_head)."""
    kw = dict(spec_kwargs(16), **EXPERTS, **body)
    jparams = jax.tree.map(np.asarray, j_mixtral.make_random_params(
        j_mixtral.MixtralSpec(**kw), seed=0))
    tparams = t_mixtral.make_random_packed_params(
        t_mixtral.MixtralSpec(**kw), seed=0, device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(leaves(v, f"{prefix}{k}/"))
            return out
        if hasattr(tree, "_asdict"):
            return leaves(tree._asdict(), f"{prefix}{type(tree).__name__}/")
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}

    assert leaves(tparams) == leaves(jparams)
    w13 = tparams["layers"]["w13"]
    qweight = w13 if isinstance(w13, torch.Tensor) else w13.qweight
    assert qweight.shape[:2] == (2, 4)          # [L, E, ...]


TINY_MIXTRAL = dict(
    architectures=["MixtralForCausalLM"], model_type="mixtral",
    hidden_size=64, intermediate_size=96, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
    num_local_experts=4, num_experts_per_tok=2,
    max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=1e6,
)


def write_config_dir(tmp_path_factory, config=TINY_MIXTRAL) -> str:
    d = tmp_path_factory.mktemp("tiny_mixtral")
    with open(d / "config.json", "w") as f:
        json.dump(config, f)
    return str(d)


@pytest.fixture(scope="module")
def tiny_mixtral_dir(tmp_path_factory):
    return write_config_dir(tmp_path_factory)


def test_engine_refuses_w8a8_lm_head(tiny_mixtral_dir):
    """The JAX package's Mixtral has no W8A8 lm_head (its draw and loader
    write no ``lm_head_scale``): the port refuses the pairing at engine
    build, naming why, and serves the bf16 head."""
    kw = dict(model=tiny_mixtral_dir, load_format="dummy",
              tokenizer_mode="skip", block_size=16, num_retrieval_blocks=16,
              precision="w4a8kv4", device="cpu")
    with pytest.raises(NotImplementedError, match="lm_head_scale"):
        LLMEngine.from_engine_args(EngineArgs(lm_head_precision="w8a8",
                                              **kw))
    eng = LLMEngine.from_engine_args(EngineArgs(lm_head_precision="fp16",
                                                **kw))
    assert eng.worker.model_runner.params["lm_head"].dtype == torch.bfloat16
    # expert parallelism and tensor parallelism stay refused
    with pytest.raises(NotImplementedError, match="item 10"):
        t_mixtral.MixtralSpec(**dict(spec_kwargs(16), **EXPERTS,
                                     ep_size=2)).check_supported()
