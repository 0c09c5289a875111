"""Host-side pieces of the Hopper flash prefill kernel, on the CPU.

``live_tile_ranges`` gives the kernel its loop bounds (each 128-query
tile's live 64-key tiles, dense heads and streaming heads) and its
heaviest-first launch order; ``check_tma_operand`` refuses tensors a TMA
tensor map cannot describe. Both are held here against a brute-force mask
built from the plain version's rule (``ops/attention_ref.prefill_attention``).
"""

import numpy as np
import pytest
import torch

from omniserve_tpu_torch.ops.cuda import flash_attention as fa


def _mask(seg, pos, sink, local, stream):
    """[T, T] bool: query i sees key j (the plain version's rule)."""
    s, p = seg[:, None], pos[:, None]
    m = (s == seg[None, :]) & (s >= 0) & (p >= pos[None, :])
    if stream:
        m &= (pos[None, :] < sink) | (p - pos[None, :] < local)
    return m


def _walk(row, stream):
    """The kernel's walk over one q tile's ranges (flash_prefill.cu)."""
    dlo, dhi, a, b = (int(x) for x in row[:4])
    if not stream:
        return set(range(dlo, dhi))
    ahi = min(a, dhi)
    blo = max(b, ahi, dlo)
    return set(range(dlo, ahi)) | set(range(blo, dhi))


def _live(mask, t):
    """Per q tile: the key tiles holding a visible pair."""
    out = []
    for i0 in range(0, t, fa.BLOCK_Q):
        rows = mask[i0:i0 + fa.BLOCK_Q]
        js = np.nonzero(rows.any(axis=0))[0]
        out.append(set((js // fa.BLOCK_K).tolist()))
    return out


def _packed(lens, pad_tail=0, start=None, rng=None, shuffle=False):
    seg, pos = [], []
    for i, n in enumerate(lens):
        seg += [i] * n
        p0 = 0 if start is None else start[i]
        pp = np.arange(p0, p0 + n)
        if shuffle:
            rng.shuffle(pp)
        pos += pp.tolist()
    seg += [-1] * pad_tail
    pos += [0] * pad_tail
    return np.array(seg, np.int64), np.array(pos, np.int64)


def _check(seg, pos, sink, local, exact):
    t = len(seg)
    ranges, order = fa.live_tile_ranges(
        torch.tensor(seg, dtype=torch.int32),
        torch.tensor(pos, dtype=torch.int32), sink, local, band=True)
    dense_r, _ = fa.live_tile_ranges(torch.tensor(seg, dtype=torch.int32),
                                     torch.tensor(pos, dtype=torch.int32))
    n_qt = -(-t // fa.BLOCK_Q)
    assert ranges.shape == (n_qt, 6) and ranges.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(n_qt))
    # the dense columns do not depend on the band
    assert torch.equal(dense_r[:, :2], ranges[:, :2])
    assert torch.equal(dense_r[:, 4:], ranges[:, 4:])
    dense_mask = _mask(seg, pos, sink, local, False)
    valid = seg >= 0
    for qt in range(n_qt):
        rows = slice(qt * fa.BLOCK_Q, min(t, (qt + 1) * fa.BLOCK_Q))
        for kt in range(int(ranges[qt, 4]), int(ranges[qt, 5])):
            keys = slice(kt * fa.BLOCK_K, (kt + 1) * fa.BLOCK_K)
            assert (kt + 1) * fa.BLOCK_K <= t
            # every valid query of the tile sees every key of the tile
            sub = dense_mask[rows, keys][valid[rows]]
            assert sub.all(), (qt, kt)
    for stream in (False, True):
        live = _live(_mask(seg, pos, sink, local, stream), t)
        for qt in range(n_qt):
            walked = _walk(ranges[qt].tolist(), stream)
            assert live[qt] <= walked, (stream, qt, live[qt] - walked)
            if exact == "exact":
                assert walked == live[qt], (stream, qt, walked ^ live[qt])
            elif exact == "span" and live[qt]:
                assert walked <= set(range(min(live[qt]), max(live[qt]) + 1))
            elif exact == "all":     # not the usual batch: every key tile
                assert walked == set(range(-(-t // fa.BLOCK_K)))
    return ranges, order


@pytest.mark.parametrize("t,sink,local", [
    (4096, 128, 2048),      # phase 7 (b)'s band shape, a quarter of its length
    (1000, 64, 256),        # ragged tail, band edges inside tiles
    (700, 40, 100),         # sink and local edges mid tile
    (300, 0, 128),          # no sinks
    (129, 16, 1),           # one key of band: the diagonal only
])
def test_single_rising_segment_is_exact(t, sink, local):
    seg, pos = _packed([t])
    ranges, _ = _check(seg, pos, sink, local, exact="exact")
    # below the diagonal every key tile is known whole
    for qt in range(ranges.shape[0]):
        assert int(ranges[qt, 4]) == 0
        assert int(ranges[qt, 5]) == (qt * fa.BLOCK_Q + 1) // fa.BLOCK_K


@pytest.mark.parametrize("lens,pad", [
    ([50, 130, 7], 5),              # segments straddle the 128-row tiles
    ([300, 450, 9], 5),
    ([128, 128, 256], 0),           # segments on tile edges
    ([1, 1, 1, 200], 60),           # a q tile of padding only
])
def test_packed_segments_cover_every_live_tile(lens, pad):
    seg, pos = _packed(lens, pad_tail=pad)
    ranges, _ = _check(seg, pos, 16, 100, exact="span")
    if pad >= fa.BLOCK_Q:
        # the all-padding tile walks nothing
        assert ranges[-1, 0] == ranges[-1, 1]


def test_padding_tile_walks_nothing():
    seg, pos = _packed([100], pad_tail=300)
    ranges, _ = _check(seg, pos, 8, 32, exact="exact")
    for qt in (1, 2, 3):
        assert int(ranges[qt, 0]) == int(ranges[qt, 1])


def test_prefix_positions_and_irregular_inputs_stay_covered():
    """Segments that start past position 0 (prefix reuse) keep tight
    ranges; positions shuffled within a segment, one segment id split over
    two runs, or padding before a valid token are not the usual batch:
    every key tile is walked, which covers every live pair."""
    rng = np.random.default_rng(0)
    seg, pos = _packed([200, 90, 300], pad_tail=7, start=[64, 0, 1000])
    _check(seg, pos, 70, 50, exact="span")
    seg, pos = _packed([260, 150], rng=rng, shuffle=True)
    _check(seg, pos, 20, 40, exact="all")
    seg = np.array([0] * 100 + [1] * 80 + [0] * 90, np.int64)
    pos = np.concatenate([np.arange(100), np.arange(80), np.arange(100, 190)])
    _check(seg, pos, 10, 60, exact="all")
    seg = np.array([-1] * 10 + [0] * 300, np.int64)
    pos = np.concatenate([np.zeros(10, np.int64), np.arange(300)])
    _check(seg, pos, 10, 60, exact="all")


def test_launch_order_is_heaviest_first():
    seg, pos = _packed([700, 500], pad_tail=20)
    ranges, order = fa.live_tile_ranges(torch.tensor(seg, dtype=torch.int32),
                                        torch.tensor(pos, dtype=torch.int32))
    work = (ranges[:, 1] - ranges[:, 0])[order.long()]
    assert bool((work[:-1] >= work[1:]).all())
    # the causal triangle's last tile leads
    assert int(order[0]) == 5


def test_tma_operand_alignment():
    x = torch.zeros((8, 2, 128), dtype=torch.bfloat16)
    fa.check_tma_operand(x, "q")
    flat = torch.zeros(8 * 2 * 128 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_tma_operand(flat[1:].view(8, 2, 128), "k")
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_tma_operand(x.transpose(0, 1), "v")
