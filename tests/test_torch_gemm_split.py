"""The per-channel W4A8 GEMM's plan and its split over K, on the CPU.

The kernel (``csrc/quant_gemm.cu``, row 1) picks its tiles and its split
over K in ``ops/cuda/quant_matmul.channel_plan`` from the shapes alone,
and at decode M the blocks of a cluster sum their int32 partials before
the one f32 epilogue. What of that runs on the host or has a plain version
is held here:

- the plan over a grid of (M, N, K, SM count): every block count at least
  1, the runs of stages cover K/2 exactly, at most 8 splits (a cluster),
  the decode body at M <= 128 and the prefill body above, and the plan a
  function of those shapes alone; the main path's shapes;
- the int32 partials of a split (``channel_split_psums_plain``), summed and
  passed through the plain epilogue, equal the plain GEMM bit for bit and
  the JAX package's Pallas kernel in interpret mode within its own test's
  1e-5, at the four layer shapes of Llama-3-8B cut by 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops.pallas import quant_matmul as j_pk
from omniserve_tpu_torch.ops.cuda import quant_matmul as qm

# (K, N) of one layer's projections: qkv, o, gate_up, down (Llama-3-8B / 8)
LAYER_SHAPES = [(512, 768), (512, 512), (512, 3584), (1792, 512)]


@pytest.mark.parametrize("sms", [132, 78, 16])
@pytest.mark.parametrize("m", [1, 8, 32, 33, 100, 128, 129, 8192])
@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 4096), (4096, 28672),
                                 (14336, 4096), (256, 128), (1024, 4096)])
def test_channel_plan_covers_k(m, k, n, sms):
    plan = qm.channel_plan(m, n, k, sms)
    n_stages = k // 2 // qm.STAGE_ROWS
    assert 1 <= plan.splits <= qm.MAX_SPLIT and plan.per_split >= 1
    runs = [range(s * plan.per_split,
                  min(n_stages, (s + 1) * plan.per_split))
            for s in range(plan.splits)]
    assert all(len(r) > 0 for r in runs)
    assert sorted(i for r in runs for i in r) == list(range(n_stages))
    if m <= qm.DECODE_MAX_M:
        assert plan.mt >= m and plan.mt in (32, 64, 128)
        if plan.n_wg == 2:       # wide decode: the channel tiles fill the card
            assert plan.mt == 128 and plan.splits == 1
            assert -(-n // 128) >= sms
            tiles = -(-n // 256)
        else:
            assert plan.n_wg == 1
            tiles = -(-n // 128)
    else:
        assert plan.n_wg == 2 and plan.mt == 128 and plan.splits == 1
        tiles = -(-m // 128) * -(-n // 256)
    assert plan.blocks == tiles * plan.splits >= 1
    assert qm.channel_plan(m, n, k, sms) == plan


def test_channel_plan_main_path_shapes():
    """About one wave of resident blocks at decode on 132 SMs (two blocks
    an SM at M tiles of 32), gate_up unsplit, and the prefill body on the
    bench's chunks."""
    assert qm.channel_plan(8, 4096, 4096, 132).splits == 8         # o
    assert qm.channel_plan(8, 4096, 14336, 132).blocks == 256      # down
    assert qm.channel_plan(128, 28672, 4096, 132)[:3] == (128, 2, 1)  # gate_up
    plan = qm.channel_plan(128, 6144, 4096, 132)                    # qkv
    assert plan.mt == 128 and 96 <= plan.blocks <= 2 * 132
    assert qm.channel_plan(8192, 4096, 4096, 132) == qm.ChannelPlan(
        128, 2, 1, 16, 1024)


def _operands(rng, m, k, n):
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    qw = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    s1 = rng.uniform(0.003, 0.006, n).astype(np.float32)
    sz = (8.0 * s1).astype(np.float32)
    a_scale = rng.uniform(0.01, 0.05, m).astype(np.float32)
    a_sum = (a_scale * a.astype(np.int64).sum(axis=1)).astype(np.float32)
    return a, qw, s1, sz, a_scale, a_sum


@pytest.mark.parametrize("m", [8, 100])
@pytest.mark.parametrize("k,n", LAYER_SHAPES)
def test_split_psums_match_plain_and_jax(k, n, m):
    """Each run's int32 partial, summed in split order and through the
    plain epilogue, equals the plain GEMM bit for bit (the split a small
    card's plan makes: K/2 in several runs) and the Pallas kernel."""
    rng = np.random.default_rng(k + n + m)
    ops = _operands(rng, m, k, n)
    t = [torch.from_numpy(x) for x in ops]
    plan = qm.channel_plan(m, n, k, 16)
    n_stages = k // 2 // qm.STAGE_ROWS
    per = plan.per_split if plan.splits > 1 else max(1, n_stages // 2)
    parts = qm.channel_split_psums_plain(t[0], t[1], per)
    assert parts.dtype == torch.int32
    assert parts.shape == (-(-n_stages // per), m, n) and parts.shape[0] > 1
    got = qm.channel_epilogue_plain(parts.sum(dim=0), *t[2:],
                                    out_dtype=torch.float32)
    want = qm.w4a8_matmul_per_channel_plain(*t, out_dtype=torch.float32)
    assert torch.equal(got, want)
    jax_out = j_pk.w4a8_matmul_per_channel(
        *(jnp.asarray(x) for x in ops), out_dtype=jnp.float32,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-5,
                               atol=1e-5)
