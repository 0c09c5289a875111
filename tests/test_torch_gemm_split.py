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

Rows 3 (W8A8) and 2 (per group) run the same body in their own modes
(``gemm_plan`` of mode "w8" and "group"), held the same way: their plans
over the grid (stages of 128 weight rows: K for W8, K/2 for W4) and on the
main path, their plain split partials against the plain GEMMs and the
Pallas kernels, and a numpy model of the per-group body's 32-bit per-word
dequant against the reference's int32 dequant and int8 wrap, exhaustively.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops.pallas import quant_matmul as j_pk
from omniserve_tpu_torch.ops import matmul as omq
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


# -- rows 3 (W8A8) and 2 (per group) on the same body ------------------------


@pytest.mark.parametrize("mode", ["w8", "group"])
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("m", [1, 8, 100, 128, 129, 8192])
@pytest.mark.parametrize("k,n", [(4096, 6144), (14336, 4096), (4096, 128256),
                                 (256, 128), (1792, 272)])
def test_gemm_plan_covers_weight_rows(mode, m, k, n, sms):
    """The runs of stages cover the weight rows (K for W8, K/2 for W4)
    exactly, at most 8 splits, the decode body at M <= 128, and the plan a
    function of the shapes alone; N % 16 != 0 takes the mma.sync body."""
    plan = qm.gemm_plan(mode, m, n, k, sms)
    rows = k if mode == "w8" else k // 2
    assert qm.weight_rows(mode, k) == rows
    n_stages = rows // qm.STAGE_ROWS
    assert 1 <= plan.splits <= qm.MAX_SPLIT and plan.per_split >= 1
    runs = [range(s * plan.per_split,
                  min(n_stages, (s + 1) * plan.per_split))
            for s in range(plan.splits)]
    assert all(len(r) > 0 for r in runs)
    assert sorted(i for r in runs for i in r) == list(range(n_stages))
    if m <= qm.DECODE_MAX_M:
        assert plan.mt >= m and plan.mt in (32, 64, 128)
        assert plan.n_wg == 1 or (plan.mt == 128 and plan.splits == 1)
    else:
        assert (plan.mt, plan.n_wg, plan.splits) == (128, 2, 1)
    assert plan.blocks >= 1
    assert qm.gemm_plan(mode, m, n, k, sms) == plan
    assert qm.gemm_plan(mode, m, n + 4, k, sms) is None


def test_gemm_plan_main_path_shapes():
    """Llama-3-8B's body GEMMs and the lm_head (N=128,256) at the bench's
    decode M=8 / 128 and chunk M=8192 on 132 SMs; row 1's plans are
    ``gemm_plan``'s of mode "channel"."""
    P = qm.ChannelPlan
    want = {   # (M, K, N): W8 plan, per-group plan
        (8, 4096, 6144): (P(32, 1, 6, 6, 288), P(32, 1, 6, 3, 288)),
        (8, 4096, 4096): (P(32, 1, 8, 4, 256), P(32, 1, 8, 2, 256)),
        (8, 4096, 28672): (P(32, 1, 1, 32, 224), P(32, 1, 1, 16, 224)),
        (8, 14336, 4096): (P(32, 1, 8, 14, 256), P(32, 1, 8, 7, 256)),
        (8, 4096, 128256): (P(32, 1, 1, 32, 1002), P(32, 1, 1, 16, 1002)),
        (128, 4096, 6144): (P(128, 1, 3, 11, 144), P(128, 1, 3, 6, 144)),
        (128, 4096, 4096): (P(128, 1, 4, 8, 128), P(128, 1, 4, 4, 128)),
        (128, 4096, 28672): (P(128, 2, 1, 32, 112), P(128, 2, 1, 16, 112)),
        (128, 14336, 4096): (P(128, 1, 4, 28, 128), P(128, 1, 4, 14, 128)),
        (128, 4096, 128256): (P(128, 2, 1, 32, 501), P(128, 2, 1, 16, 501)),
        (8192, 4096, 6144): (P(128, 2, 1, 32, 1536), P(128, 2, 1, 16, 1536)),
        (8192, 4096, 4096): (P(128, 2, 1, 32, 1024), P(128, 2, 1, 16, 1024)),
        (8192, 4096, 28672): (P(128, 2, 1, 32, 7168),
                              P(128, 2, 1, 16, 7168)),
        (8192, 14336, 4096): (P(128, 2, 1, 112, 1024),
                              P(128, 2, 1, 56, 1024)),
        (8192, 4096, 128256): (P(128, 2, 1, 32, 32064),
                               P(128, 2, 1, 16, 32064)),
    }
    for (m, k, n), (w8, group) in want.items():
        assert qm.gemm_plan("w8", m, n, k, 132) == w8
        assert qm.gemm_plan("group", m, n, k, 132) == group
        assert qm.gemm_plan("channel", m, n, k, 132) == qm.channel_plan(
            m, n, k, 132)


def _small_card_per(mode, m, k, n):
    """A split of several runs: the plan a 16-SM card makes, or halves."""
    plan = qm.gemm_plan(mode, m, n, k, 16)
    n_stages = qm.weight_rows(mode, k) // qm.STAGE_ROWS
    return plan.per_split if plan.splits > 1 else max(1, n_stages // 2)


@pytest.mark.parametrize("m", [8, 100])
@pytest.mark.parametrize("k,n", LAYER_SHAPES)
def test_w8a8_split_psums_match_plain_and_jax(k, n, m):
    """W8A8's run partials, summed in split order through the plain
    epilogue, equal the plain GEMM bit for bit and the Pallas kernel in
    interpret mode within its test's 1e-5."""
    rng = np.random.default_rng(3 * k + n + m)
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    ws = rng.uniform(0.0003, 0.0006, n).astype(np.float32)
    a_scale = rng.uniform(0.01, 0.05, m).astype(np.float32)
    t = [torch.from_numpy(x) for x in (a, w, ws, a_scale)]
    per = _small_card_per("w8", m, k, n)
    parts = qm.w8a8_split_psums_plain(t[0], t[1], per)
    assert parts.dtype == torch.int32
    assert parts.shape == (-(-k // qm.STAGE_ROWS // per), m, n)
    assert parts.shape[0] > 1
    got = qm.scale_epilogue_plain(parts.sum(dim=0), t[2], t[3],
                                  out_dtype=torch.float32)
    assert torch.equal(got, qm.w8a8_matmul_plain(*t, out_dtype=torch.float32))
    jax_out = j_pk.w8a8_matmul(*(jnp.asarray(x) for x in (a, w, ws, a_scale)),
                               out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("m,group_size", [(8, 128), (100, 32)])
@pytest.mark.parametrize("k,n", LAYER_SHAPES)
def test_group_split_psums_match_plain_and_jax(k, n, m, group_size):
    """The per-group run partials (both K halves of each run of packed
    rows, weights dequantized as the reference does), summed in split order
    through the plain epilogue, equal the plain GEMM bit for bit and the
    Pallas kernel in interpret mode within its test's 1e-5; s2 over [0, 17]
    and zeros over the whole int8 range."""
    rng = np.random.default_rng(5 * k + n + m + group_size)
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    qw = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    s1 = rng.uniform(0.003, 0.006, n).astype(np.float32)
    s2 = rng.integers(0, 18, (k // group_size, n), dtype=np.int8)
    s2z = rng.integers(-128, 128, (k // group_size, n), dtype=np.int8)
    a_scale = rng.uniform(0.01, 0.05, m).astype(np.float32)
    ops = (a, qw, s1, s2, s2z, a_scale)
    t = [torch.from_numpy(x) for x in ops]
    per = _small_card_per("group", m, k, n)
    parts = qm.group_split_psums_plain(t[0], t[1], t[3], t[4], group_size,
                                       per)
    assert parts.dtype == torch.int32 and parts.shape[0] > 1
    assert parts.shape == (-(-k // 2 // qm.STAGE_ROWS // per), m, n)
    got = qm.scale_epilogue_plain(parts.sum(dim=0), t[2], t[5],
                                  out_dtype=torch.float32)
    want = qm.w4a8_matmul_per_group_plain(*t, group_size=group_size,
                                          out_dtype=torch.float32)
    assert torch.equal(got, want)
    jax_out = j_pk.w4a8_matmul_per_group(
        *(jnp.asarray(x) for x in ops), group_size=group_size,
        out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-5,
                               atol=1e-5)


def test_per_word_dequant_model_is_exact():
    """The per-group body's dequant of a split word (4 u4 codes of one
    channel, one byte each): one 32-bit multiply by s2, then a bytewise add
    of the zero mod 256 (``__vadd4``), as numpy uint32 arithmetic, over
    every u4 code, every s2 in [0, 17] and every int8 zero, each code in
    every byte of a word whose other bytes hold 15 (the largest neighbour)
    and in both nibbles of the packed byte. Equal to the reference's int32
    dequant with its int8 wrap (``ops/matmul.dequant_per_group``): no carry
    crosses a byte."""
    u, s, z = (x.ravel() for x in np.meshgrid(
        np.arange(16), np.arange(18), np.arange(-128, 128), indexing="ij"))
    assert u.size == 16 * 18 * 256

    def model(packed_words, shift):
        x = ((packed_words >> np.uint32(shift)) & np.uint32(0x0F0F0F0F))
        prod = (x.astype(np.uint64) * s.astype(np.uint64)) & 0xFFFFFFFF
        zb = (z & 0xFF).astype(np.uint64)
        out = np.zeros_like(prod)
        for b in range(4):       # __vadd4: four byte lanes, no carry out
            lane = ((prod >> (8 * b)) + zb) & 0xFF
            out |= lane << (8 * b)
        return out

    # the reference: the port's dequant of [K/2 = 32, N] packed rows, one
    # case a column, one group a half (s2 / zero equal in both halves)
    g = 32
    qw = np.full((g, u.size), 0xFF, dtype=np.uint8)
    qw[0] = (u | (u << 4)).astype(np.uint8)
    w_i8 = omq.dequant_per_group(
        torch.from_numpy(qw), torch.from_numpy(np.stack([s, s]).astype(np.int8)),
        torch.from_numpy(np.stack([z, z]).astype(np.int8)), g).numpy()
    ref_int32 = (u * s + z).astype(np.int32).astype(np.int8)
    assert np.array_equal(w_i8[0], ref_int32)      # low half, row 0
    assert np.array_equal(w_i8[g], ref_int32)      # high half, row 0
    for pos, shift in itertools.product(range(4), (0, 4)):
        code_bytes = np.full((4, u.size), 0xFF, dtype=np.uint32)
        code_bytes[pos] = (u | (u << 4)).astype(np.uint32)
        words = sum(code_bytes[b] << np.uint32(8 * b) for b in range(4))
        out = model(words.astype(np.uint32), shift)
        got = ((out >> (8 * pos)) & 0xFF).astype(np.uint8).view(np.int8)
        assert np.array_equal(got, ref_int32), (pos, shift)
        # the neighbours: code 15 * s2 + zero, each in its own byte
        for b in set(range(4)) - {pos}:
            nb = ((out >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
            assert np.array_equal(
                nb, (15 * s + z).astype(np.int32).astype(np.int8))
