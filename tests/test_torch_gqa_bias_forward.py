"""2-layer forwards at GQA groups of 7 and with the Qwen2 QKV bias: the
port against the JAX package (CPU).

A Yi-shaped spec (14 q over 2 kv heads) and Qwen2-shaped ones with the
bias (14 / 2 and MHA), head_dim 128: whole-prompt prefill and a decode
step against the op-by-op JAX forward (``tests/test_torch_llama.
check_forward``): logits within 1e-4 of their scale and pools equal while
every GEMM reads the same activation codes in both packages, else within
``FLIP_GATES`` (``tests/test_torch_gqa_bias.py`` says why); the biased qkv
equal bit for bit wherever the qkv GEMMs agree; the bias left out refused;
the bias's dummy draw and its carry through ``params_from_numpy``.

The attention pieces at these groups are in ``tests/test_torch_gqa_bias.py``.
"""

import jax
import numpy as np
import pytest
import torch

from omniserve_tpu_torch.models import llama as t_llama
from omniserve_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_gqa_bias import D, FLIP_GATES, N
from tests.test_torch_llama import both_models, check_forward

SHAPES = {   # (q heads, kv heads, QKV bias)
    "yi": (14, 2, False),
    "qwen2": (14, 2, True),
    "qwen2-mha": (2, 2, True),
}


def spec_kwargs(shape):
    hq, hkv, bias = SHAPES[shape]
    return dict(
        num_layers=2, hidden=256, intermediate=512, num_q_heads=hq,
        num_kv_heads=hkv, head_dim=D, vocab=128, page_size=16,
        rope_base=1e6, rms_eps=1e-6, weight_bits=4, act_bits=8, kv_bits=4,
        kv_zeros=True, lm_head_bits=8, attn_bias=bias,
    )


@pytest.fixture(scope="module")
def models():
    """``both_models`` of each shape, drawn once for the module."""
    return {shape: both_models(spec_kwargs(shape)) for shape in SHAPES}


def test_random_params_draw_the_bias(models):
    """The dummy draw of a biased spec: f32 [L, qkv_out], 0.02 * N(0, 1),
    as the JAX package draws it (the numbers differ)."""
    _, spec, jparams, _ = models["qwen2"]
    bias = t_llama.make_random_packed_params(
        spec, seed=3, device="cpu")["layers"]["qkv_bias"]
    jbias = np.asarray(jparams["layers"]["qkv_bias"])
    assert tuple(bias.shape) == jbias.shape == (2, spec.qkv_out)
    assert bias.dtype == torch.float32 and jbias.dtype == np.float32
    assert 0.015 < float(bias.std()) < 0.025
    assert "qkv_bias" not in t_llama.make_random_packed_params(
        models["yi"][1], seed=0, device="cpu")["layers"]


def test_params_from_numpy_carries_the_bias(models):
    jparams = jax.tree.map(np.asarray, models["qwen2"][2])
    got = params_from_numpy(jparams, "cpu")["layers"]["qkv_bias"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(N(got), jparams["layers"]["qkv_bias"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_matches_jax(shape, models):
    """Whole-prompt prefill and a decode step against the op-by-op JAX
    forward (``tests/test_torch_llama.check_forward``): 1e-4 of the
    logits' scale and pools equal while no activation code flips, else
    FLIP_GATES; the biased qkv equal bit for bit wherever the qkv GEMMs
    agree, the bias left out refused."""
    check_forward(spec_kwargs(shape), FLIP_GATES, models=models[shape])
