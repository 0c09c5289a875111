"""2-layer forwards at head_dim 64: the port against the JAX package (CPU).

A narrow Llama-3.2-1B (n_rep 4, head_dim 64, the llama3 rope remap of its
config.json): whole-prompt prefill and a decode step at w4a8kv4
(``tests/test_torch_llama.check_forward``: logits 1e-4 of their scale,
pools equal), the same numpy inputs and packed weights through the JAX
forward op by op and the port's. LServe's both flags at this head_dim are
in ``tests/test_torch_head_dim64_sparse.py``.
"""

from tests.test_torch_llama import check_forward

PAGE = 16

# At this width an XLA-vs-torch last-ulp difference moves a K / V value
# or an activation code now and then (one bf16 or int8 step): exact at
# 1e-4 until such a move, the sparse forwards then take the gates
# ``check_forward`` takes at Yi's and Qwen2's widths
# (``tests/test_torch_gqa_bias.py:279``)
FLIP_GATES = dict(logits=4e-2, planes=2e-2, codes=1e-2)

# Llama-3.2-1B's rope (config.json: theta 500,000, llama3 scaling factor
# 32, low 1, high 4, original 8,192), n_rep 4, head_dim 64
LLAMA32_ROPE = dict(rope_base=500000.0, rope_llama3=(32.0, 1.0, 4.0, 8192.0))


def test_forward_d64_w4a8kv4_matches_jax():
    """Whole-prompt prefill and a decode step of a 2-layer model at 16 q
    over 4 kv heads of 64 (``check_forward``: logits 1e-4 of their scale,
    pools equal)."""
    kw = dict(num_layers=2, hidden=1024, intermediate=512, num_q_heads=16,
              num_kv_heads=4, head_dim=64, vocab=128, page_size=16,
              weight_bits=4, act_bits=8, kv_bits=4, kv_zeros=True,
              lm_head_bits=8, **LLAMA32_ROPE)
    check_forward(kw)
