"""The port's 2-layer ``mixtral_forward`` against the JAX package's over
kv8 pools (CPU, tiny model): a W4A8 g32 body over fine-grained kv8, and
the reference's LServe precision (W8A8 body, per-tensor kv8) under both
LServe flags, where the decode steps cross a page and the selector
refreshes. ``tests/test_torch_lserve_llama.check_sparse_forward`` with
the Mixtral family: a whole-prompt prefill and four decode steps over
dirty pools, against the JAX forward run op by op; logits at 1e-4 of
their scale and pools equal while no GEMM read other codes, then
``FLIP_GATES``.
"""

import pytest

from tests.test_torch_gqa_bias import FLIP_GATES
from tests.test_torch_lserve_llama import PAGE as LPAGE
from tests.test_torch_lserve_llama import check_sparse_forward
from tests.test_torch_mixtral import EXPERTS, MIXTRAL


@pytest.mark.parametrize("overrides", [
    dict(kv_bits=8, group_size=32),
    dict(weight_bits=8, kv_bits=8, kv_zeros=False, sparse_decode=True,
         sparse_prefill=True, ctx_sink=LPAGE, ctx_local=2 * LPAGE),
], ids=["w4a8kv8-g32", "w8a8kv8-pt-both-flags"])
def test_forward_pools_match_jax(overrides):
    """A whole-prompt prefill and decode steps over dirty pools (kv8;
    per-tensor kv8 under both LServe flags, where a page boundary is
    crossed and the selector refreshes)."""
    over = dict(EXPERTS, lm_head_bits=16, sparse_decode=False)
    over.update(overrides)
    crossed, refreshed = check_sparse_forward(
        over, n_steps=4, flip_gates=FLIP_GATES, family=MIXTRAL)
    assert crossed == 1 and refreshed == 1
