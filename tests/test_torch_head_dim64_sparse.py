"""LServe's both flags in 2-layer forwards at head_dim 64: the port against
the JAX package (CPU).

A narrow Llama-3.2-1B (8 q over 2 kv heads of 64, the llama3 rope remap of
its config.json) at w8a8kv8 per-tensor and w16a16kv16
(``tests/test_torch_lserve_llama.check_sparse_forward``), the same numpy
inputs and packed weights through the JAX forward op by op and the port's.
The dense forward at this head_dim is in
``tests/test_torch_head_dim64_forward.py``.
"""

import pytest

from tests.test_torch_head_dim64_forward import FLIP_GATES, LLAMA32_ROPE, PAGE
from tests.test_torch_lserve_llama import check_sparse_forward


@pytest.mark.parametrize("overrides", [
    dict(weight_bits=8, kv_bits=8, kv_zeros=False),
    dict(weight_bits=16, act_bits=16, kv_bits=16),
], ids=["w8a8kv8-pt", "w16a16kv16"])
def test_sparse_forward_d64_matches_jax(overrides):
    """LServe's both flags at head_dim 64, 8 q over 2 kv heads (one
    retrieval, one streaming): a whole-prompt prefill (the band) and four
    decode steps (the selector's per-head lists, the ring's band) at the
    reference's LServe precision and at the default w16a16kv16
    (``check_sparse_forward``: logits 1e-4 of their scale, pools and K
    stats equal, until a last-ulp difference moves a value: then
    ``FLIP_GATES``)."""
    crossed, refreshed = check_sparse_forward(dict(
        hidden=512, num_q_heads=8, head_dim=64, sparse_prefill=True,
        ctx_sink=PAGE, ctx_local=2 * PAGE, **LLAMA32_ROPE, **overrides),
        n_steps=4, flip_gates=FLIP_GATES)
    assert crossed == 1 and refreshed == 1


