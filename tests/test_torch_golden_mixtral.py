"""The port's Mixtral against Hugging Face's torch ``MixtralForCausalLM``
and against the JAX package's loader (CPU).

Mirrors ``tests/test_golden_mixtral.py``: a tiny HF Mixtral (3 layers, 4
experts, top-2) is built and saved with ``save_pretrained`` inside the
test, then loaded through the port's ``load_mixtral_params`` (each expert
matrix quantized as it is read):

- the loaded parameters equal, byte for byte, the JAX package's
  ``load_mixtral_params`` run op by op (``jax.disable_jit()``; compiled,
  its attention quantizer lands one ulp off, ROADMAP.md "not port
  faults"), at w16a16kv16, w4a8kv4 (per channel), g64 (the widest group
  that divides the tiny model's 192-wide experts) and w8a8;
- w16a16kv16 prefill logits within the JAX test's tolerance of HF's and
  the same argmax; the engine's greedy tokens agree with HF's generate
  for at least 6 of 8 (bf16 and capacity slots against torch f32);
- at w4a8kv4 the first token is HF's.
"""

import jax
import numpy as np
import pytest
import torch

from omniserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams
from omniserve_tpu_torch.config import ModelConfig
from omniserve_tpu_torch.models.llama import PrefillBatch
from omniserve_tpu_torch.models.mixtral import (
    MixtralSpec,
    load_mixtral_params,
    mixtral_forward,
)
from omniserve_tpu_torch.ops.paged_kv import make_kv_pool

PROMPT = [3, 17, 94, 255, 12, 7, 400, 31, 2, 68, 101, 5]
PAGE = 16


@pytest.fixture(scope="module")
def hf_mixtral(tmp_path_factory):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    cfg = MixtralConfig(
        hidden_size=128, intermediate_size=192, num_attention_heads=8,
        num_key_value_heads=4, num_hidden_layers=3, num_local_experts=4,
        num_experts_per_tok=2, vocab_size=512, max_position_embeddings=2048,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    )
    model = MixtralForCausalLM(cfg)
    model.eval()
    d = tmp_path_factory.mktemp("hf_mixtral_golden_torch")
    model.save_pretrained(d)
    return str(d), model


def hf_reference(model, prompt, n_new):
    with torch.no_grad():
        ids = torch.tensor([prompt])
        logits = model(ids).logits[0, -1].float().numpy()
        gen = model.generate(
            ids, max_new_tokens=n_new, do_sample=False, pad_token_id=0,
        )[0, len(prompt):].tolist()
    return logits, gen


def port_logits(path, prompt, precision):
    mc = ModelConfig(model=path, precision=precision)
    spec = MixtralSpec.from_model_config(mc, page_size=PAGE)
    params, _ = load_mixtral_params(mc, spec, device="cpu")
    t = len(prompt)
    tp = PAGE * ((t + PAGE - 1) // PAGE)
    pool = make_kv_pool(spec.num_layers, 8, spec.num_kv_heads, PAGE,
                        spec.head_dim, kv_bits=spec.kv_bits,
                        kv_zeros=spec.kv_zeros, device="cpu")
    batch = PrefillBatch(
        token_ids=torch.tensor(np.pad(prompt, (0, tp - t))),
        positions=torch.tensor(np.pad(np.arange(t), (0, tp - t)),
                               dtype=torch.int32),
        segment_ids=torch.tensor(np.pad(np.zeros(t), (0, tp - t),
                                        constant_values=-1),
                                 dtype=torch.int32),
        block_tables=torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
        last_token_idx=torch.tensor([t - 1]),
        seq_lens=torch.tensor([t], dtype=torch.int32),
    )
    logits, _, _, _ = mixtral_forward(params, pool, None, batch, spec,
                                      is_prefill=True)
    return logits[0].numpy()


def run_engine(path, prompt, n_new, precision):
    engine = LLMEngine.from_engine_args(EngineArgs(
        model=path, precision=precision, block_size=PAGE, max_num_seqs=4,
        max_num_batched_tokens=4096, num_retrieval_blocks=64,
        tokenizer_mode="skip", device="cpu",
    ))
    engine.add_request("g", prompt_token_ids=list(prompt),
                       sampling_params=SamplingParams(
                           temperature=0.0, max_tokens=n_new,
                           ignore_eos=True))
    outs = None
    while engine.has_unfinished_requests():
        for o in engine.step():
            outs = o
    return outs.outputs[0].token_ids


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "_asdict"):
        return _leaves(tree._asdict(), prefix)
    return {prefix: tree}


@pytest.mark.parametrize("precision,group", [
    ("w16a16kv16", -1), ("w4a8kv4", -1), ("w4a8kv4", 64), ("w8a8kv8", -1)])
def test_loader_bytes_equal_jax(hf_mixtral, precision, group):
    from omniserve_tpu.config import ModelConfig as JModelConfig
    from omniserve_tpu.models import mixtral as j_mixtral

    path, _ = hf_mixtral
    jmc = JModelConfig(model=path, precision=precision, group_size=group)
    jspec = j_mixtral.MixtralSpec.from_model_config(jmc, page_size=PAGE)
    with jax.disable_jit():
        jparams, _ = j_mixtral.load_mixtral_params(jmc, jspec)
    want = _leaves(jax.tree.map(np.asarray, jparams))
    mc = ModelConfig(model=path, precision=precision, group_size=group)
    spec = MixtralSpec.from_model_config(mc, page_size=PAGE)
    assert (spec.num_experts, spec.top_k) == (4, 2)
    params, kv_scales = load_mixtral_params(mc, spec, device="cpu")
    assert kv_scales is None
    got = _leaves(params)
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        b = want[name]
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        b = b.view(np.int16) if b.dtype.name == "bfloat16" else b
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_prefill_logits_match_hf(hf_mixtral):
    path, model = hf_mixtral
    want, _ = hf_reference(model, PROMPT, 1)
    got = port_logits(path, PROMPT, "w16a16kv16")
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)
    assert int(got.argmax()) == int(want.argmax())


def test_greedy_tokens_match_hf(hf_mixtral):
    path, model = hf_mixtral
    _, want = hf_reference(model, PROMPT, 8)
    got = run_engine(path, PROMPT, 8, "w16a16kv16")
    agree = 0
    for a, b in zip(got, want):
        if a != b:
            break
        agree += 1
    # bf16 + capacity-slot dispatch vs torch f32: near-ties may flip late
    assert agree >= 6, (got, want)


def test_quantized_first_tokens_track_hf(hf_mixtral):
    path, model = hf_mixtral
    want_logits, want = hf_reference(model, PROMPT, 4)
    got_logits = port_logits(path, PROMPT, "w4a8kv4")
    assert int(got_logits.argmax()) == int(want_logits.argmax())
    got = run_engine(path, PROMPT, 4, "w4a8kv4")
    assert got[0] == want[0], (got, want)
