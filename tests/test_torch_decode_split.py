"""The split over pages of the port's decode kernels, on the CPU.

The list kernel (per-head lists, the band, and the fused append over the
dense list of the block table) and the kv16 kernel cut each page list into
runs of entries, one block each, and merge the blocks' f32 partials with a
second kernel. What of that runs on the host or has a plain version is
held here:

- ``split_plan`` over a grid of (B, H, Tp, SM count): every list entry in
  exactly one run, no run empty, the plan a function of those shapes alone,
  and the main path's shapes (one block per list at the bench's batch 128,
  splits at batch 1 and 8);
- the combine's plain version against the JAX package: the JAX reference
  ``attention_ref.paged_decode_attention(..., return_lse=True)`` over
  disjoint subsets of each sequence's pages (one of them empty), merged by
  the port's ``combine_partials_plain``, equals the JAX reference over all
  the pages within 1e-5 (both f32 over the same values);
- the partials the kernels write (``page_list_partials_plain``), merged by
  the same combine, equal the unsplit plain version within 1e-5, for
  per-head lists in no order with dead entries, a run of dead entries only
  and a row of length 0;
- the fused append's partials (``fused_append_partials_plain``: the new
  token counted in the run that owns its page), merged by the same
  combine, equal the unsplit plain fused decode within 1e-5, kv4 / kv8 /
  per-tensor kv8, with the pool equal to ``append_kv``'s byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniserve_tpu.ops import attention_ref as j_ref
from omniserve_tpu.ops.paged_kv import append_kv as j_append_kv
from omniserve_tpu.ops.paged_kv import make_kv_pool as j_make_kv_pool
from omniserve_tpu_torch.models.convert import pool_from_numpy
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec

# label -> (kv_bits, kv_zeros)
MODES = {"kv4": (4, True), "kv8": (8, True), "pt8": (8, False),
         "kv16": (16, True)}
PAGE, D = 32, 128


def filled_pools(rng, mode, h, lengths, tables, layers=2):
    """A JAX pool and its port copy, holding ``lengths[s]`` random tokens
    of sequence s (pages from ``tables[s]``) in every layer."""
    kv_bits, kv_zeros = MODES[mode]
    scales = {}
    if not kv_zeros:
        qmax = 7 if kv_bits == 4 else 127
        scales = {name: jnp.asarray((3.5 / qmax * rng.uniform(
            0.8, 1.2, layers)).astype(np.float32))
            for name in ("k_scale_per_tensor", "v_scale_per_tensor")}
    jpool = j_make_kv_pool(layers, int(tables.max()) + 2, h, PAGE, D,
                           kv_bits=kv_bits, kv_zeros=kv_zeros, **scales)
    for lay in range(layers):
        for s, ln in enumerate(lengths):
            if ln <= 0:
                continue
            pos = np.arange(ln)
            jpool = j_append_kv(
                jpool, lay,
                jnp.asarray(rng.standard_normal((ln, h, D)), jnp.float32),
                jnp.asarray(rng.standard_normal((ln, h, D)), jnp.float32),
                jnp.asarray(tables[s][pos // PAGE]), jnp.asarray(pos % PAGE),
                page_size=PAGE, kv_bits=kv_bits, kv_zeros=kv_zeros)
    return jpool, pool_from_numpy(jax.tree.map(np.asarray, jpool), "cpu")


def bf16_values(rng, shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("b,h,tp,sms", [
    (1, 4, 32, 132), (8, 4, 32, 132), (8, 8, 9, 132), (128, 8, 12, 132),
    (3, 2, 1, 132), (2, 4, 7, 16), (5, 3, 100, 1), (1, 1, 33, 132),
    (64, 1, 257, 78)])
def test_split_plan_covers_every_entry_once(b, h, tp, sms):
    n_split, per = t_dec.split_plan(b, h, tp, sms)
    assert 1 <= n_split <= tp and per >= 1
    runs = [range(s * per, min(tp, (s + 1) * per)) for s in range(n_split)]
    assert all(len(r) > 0 for r in runs)
    assert sorted(i for r in runs for i in r) == list(range(tp))
    # about two waves of blocks, unless the lists are too short for that
    k = min(-(-2 * sms // (b * h)), tp)
    assert k / 2 <= n_split <= k
    assert t_dec.split_plan(b, h, tp, sms) == (n_split, per)


def test_split_plan_main_path_shapes():
    """One block per list at the bench's batch (row 6, B=128: 1,024
    lists); splits at rows 5 and 6's small batches on 132 SMs."""
    assert t_dec.split_plan(128, 8, 12, 132) == (1, 12)
    assert t_dec.split_plan(128, 8, 64, 132)[0] == 1
    assert t_dec.split_plan(1, 4, 32, 132)[0] >= 16     # row 5, B=1
    assert t_dec.split_plan(8, 4, 32, 132)[0] > 1       # row 5, B=8
    assert t_dec.split_plan(8, 8, 9, 132)[0] > 1        # row 6, B=8


@pytest.mark.parametrize("mode", list(MODES))
def test_combine_plain_matches_jax_unsplit(mode):
    """JAX partials over disjoint page subsets (the last one empty), merged
    by the port's plain combine, equal JAX's unsplit output."""
    kv_bits, kv_zeros = MODES[mode]
    rng = np.random.default_rng(101)
    h, n_rep, w = 2, 2, 5
    lengths = [4 * PAGE + 9, 2 * PAGE, 17, 0]
    b = len(lengths)
    tables = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    jpool, _ = filled_pools(rng, mode, h, lengths, tables)
    q = jnp.asarray(bf16_values(rng, (b, h * n_rep, D)))
    args = (jpool, 1, jnp.asarray(tables), jnp.asarray(lengths, jnp.int32),
            D ** -0.5, PAGE, kv_bits, kv_zeros)
    want = np.asarray(j_ref.paged_decode_attention(q, *args))
    subsets = [[3, 0], [1], [4, 2], []]      # logical pages of each part
    parts = []
    for pages in subsets:
        idx = np.full((b, h, 2), -1, np.int32)
        idx[:, :, :len(pages)] = pages
        out, m, l = j_ref.paged_decode_attention(
            q, *args, page_idxes=jnp.asarray(idx), return_lse=True)
        parts.append([torch.from_numpy(np.array(x, np.float32))
                      for x in (out, m, l)])
    m = torch.stack([p[1] for p in parts])
    l = torch.stack([p[2] for p in parts])
    acc = torch.stack([p[0] * p[2][..., None] for p in parts])
    assert bool((m[-1] == float("-inf")).all()) and bool((l[-1] == 0).all())
    got = t_dec.combine_partials_plain(m, l, acc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3], 0.0)


@pytest.mark.parametrize("per_split", [1, 2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_split_partials_plain_match_unsplit(mode, per_split):
    """The kernels' partials in plain PyTorch, merged by the plain combine,
    equal the unsplit plain version: per-head lists in no order with dead
    entries and pages past the length, Tp = 5 not a multiple of the run
    length, a run of dead entries only (entries 3-4 of sequence 1), an
    all-dead list and a row of length 0."""
    rng = np.random.default_rng(7)
    h, n_rep, w = 2, 4, 6
    lengths = [5 * PAGE + 3, 2 * PAGE + 1, 3 * PAGE, 0]
    b = len(lengths)
    tables = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    _, pool = filled_pools(rng, mode, h, lengths, tables)
    sel_logic = torch.tensor([
        [[5, 0, 3, -1, 1], [2, 4, -1, 5, 0]],
        [[2, 1, 0, -1, -1], [0, 5, 1, -1, -1]],
        [[-1, -1, -1, -1, -1], [2, 1, 0, 4, -1]],
        [[0, 1, -1, -1, -1], [0, -1, -1, -1, -1]],
    ], dtype=torch.int32)
    safe = torch.clamp(sel_logic.long(), min=0)
    sel_phys = torch.where(
        sel_logic >= 0,
        torch.from_numpy(tables).long()[:, None, :].expand(-1, h, -1)
        .gather(2, safe), 0).to(torch.int32)
    q = torch.from_numpy(bf16_values(rng, (b, h, n_rep, D)))   # f32
    lens = torch.tensor(lengths, dtype=torch.int32)
    kw = dict(sm_scale=D ** -0.5, page_size=PAGE)
    want = t_dec.page_list_attention_plain(
        q, pool, 1, sel_phys, sel_logic, lens, **kw)
    m, l, acc = t_dec.page_list_partials_plain(
        q, pool, 1, sel_phys, sel_logic, lens, per_split=per_split, **kw)
    assert m.shape[0] == -(-5 // per_split)
    got = t_dec.combine_partials_plain(m, l, acc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[2, 0].abs().max()) == 0.0 and float(
        got[3].abs().max()) == 0.0


@pytest.mark.parametrize("per_split", [1, 2])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt8"])
def test_append_split_partials_match_fused_plain(mode, per_split):
    """The fused decode on the split body: the new token appended by the
    block that owns its page, the runs' partials over the dense list of
    the block table merged by the plain combine, equal the unsplit plain
    fused decode within 1e-5, and the pool equals ``append_kv``'s byte for
    byte. New tokens at slot 0 of a fresh page, at slot page/2 (the kv4
    byte it shares), at the last slot, a row of length 1 and one of 0."""
    kv_bits, kv_zeros = MODES[mode]
    rng = np.random.default_rng(11)
    h, n_rep, w = 2, 4, 6
    lengths = [5 * PAGE + 1, 2 * PAGE + PAGE // 2 + 1, 3 * PAGE, 1, 0]
    b = len(lengths)
    tables = rng.permutation(b * w).astype(np.int32).reshape(b, w)
    _, pool = filled_pools(rng, mode, h, [max(n - 1, 0) for n in lengths],
                           tables)
    twin = pool.clone()
    q = torch.from_numpy(bf16_values(rng, (b, h * n_rep, D)))
    k_new, v_new = (torch.from_numpy(bf16_values(rng, (b, h, D)))
                    for _ in range(2))
    args = (torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32),
            k_new, v_new)
    kw = dict(sm_scale=D ** -0.5, page_size=PAGE, kv_bits=kv_bits,
              kv_zeros=kv_zeros)
    m, l, acc = t_dec.fused_append_partials_plain(q, pool, 1, *args,
                                                  per_split=per_split, **kw)
    assert m.shape[0] == -(-w // per_split)
    got = t_dec.combine_partials_plain(m, l, acc).reshape(b, h * n_rep, D)
    want = t_dec.paged_decode_attention_fused_plain(q, twin, 1, *args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[4].abs().max()) == 0.0
    for x, y in zip(pool, twin):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)
