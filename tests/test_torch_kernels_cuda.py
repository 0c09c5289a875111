"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Small shapes (the main path's shapes run in ``chip_smoke.py``); every test
skips without CUDA. On a machine with an H100:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import dead_row_written

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def assert_pools_equal(a, b, skip_trash=False):
    """Same bytes, planes and stats (float tensors bit for bit, so NaN
    planted in dead slots compares equal to itself); ``skip_trash`` leaves
    out the top page, which absorbs the kernels' writes for inactive rows."""
    end = -1 if skip_trash else None
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.dim() == 1:          # per-tensor scales [L]
            assert torch.equal(x, y)
        else:
            assert torch.equal(x[:, :end], y[:, :end])


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (8, 512, 256),
                                   (40, 1024, 384), (300, 256, 80)])
def test_w4a8_per_channel_kernel(dev, m, k, n):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev)
    a, s, asum = quantize_activations(
        torch.randn((m, k), generator=g, device=dev), fuse_sum=True)
    qw = torch.randint(0, 256, (3, k // 2, n), generator=g,
                       dtype=torch.uint8, device=dev)
    s1 = torch.empty((3, n), device=dev).uniform_(0.003, 0.006, generator=g)
    before = cuda.LAUNCHES["w4a8_matmul_per_channel"]
    got = qm.w4a8_matmul_per_channel(a, qw[1], s1[1], 8 * s1[1], s, asum,
                                     out_dtype=torch.float32)
    assert cuda.LAUNCHES["w4a8_matmul_per_channel"] == before + 1
    want = qm.w4a8_matmul_per_channel_plain(a, qw[1], s1[1], 8 * s1[1], s,
                                            asum, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(8, 512, 128), (33, 256, 260)])
def test_w8a8_kernel(dev, m, k, n):
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev, 1)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8,
                      device=dev)
    ws = torch.empty(n, device=dev).uniform_(0.0003, 0.0006, generator=g)
    got = qm.w8a8_matmul(a, w, ws, s)
    want = qm.w8a8_matmul_plain(a, w, ws, s)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernels_refuse_bad_inputs(dev):
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm

    a = torch.zeros((4, 96), dtype=torch.int8, device=dev)
    w = torch.zeros((48, 64), dtype=torch.uint8, device=dev)
    f = torch.ones(64, device=dev)
    r = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="% 128"):
        qm.w4a8_matmul_per_channel(a, w, f, f, r, r)
    # the per-channel kernel's TMA boxes need rows of a multiple of 16 bytes
    a2 = torch.zeros((4, 256), dtype=torch.int8, device=dev)
    w2 = torch.zeros((128, 68), dtype=torch.uint8, device=dev)
    f2 = torch.ones(68, device=dev)
    with pytest.raises(ValueError, match="% 16"):
        qm.w4a8_matmul_per_channel(a2, w2, f2, f2, r, r)
    with pytest.raises(ValueError, match="CUDA"):
        qm.w8a8_matmul(a.cpu(), w.to(torch.int8), f, r)


@pytest.mark.parametrize("lens,hq,hkv", [([300], 8, 2), ([50, 130, 7], 4, 4),
                                         ([300, 77], 56, 8)])   # Yi-34B's
def test_flash_prefill_kernel(dev, lens, hq, hkv):
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    t, d = sum(lens) + 5, 128
    g = _gen(dev, 2)
    q = torch.randn((t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    seg = torch.full((t,), -1, dtype=torch.int32)
    pos = torch.zeros(t, dtype=torch.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        pos[o:o + n] = torch.arange(n)
        o += n
    seg, pos = seg.to(dev), pos.to(dev)
    got = fa.flash_prefill(q, k, v, seg, pos, d ** -0.5)
    want = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("lens,hq,hkv,flags_kv,sink,local", [
    ([700], 8, 2, [1, 0], 64, 256),            # band tiles skipped
    ([300, 450, 9], 4, 4, [0, 1, 0, 0], 16, 100),   # packed, ragged tail
    ([1000], 8, 8, [0] * 8, 0, 128),           # no sinks
    ([700, 90], 56, 8, [1, 0, 0, 1, 0, 1, 1, 0], 64, 256),   # Yi-34B's
])
def test_flash_prefill_band_kernel(dev, lens, hq, hkv, flags_kv, sink, local):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    t, d = sum(lens) + 5, 128
    g = _gen(dev, 12)
    q = torch.randn((t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    seg = torch.full((t,), -1, dtype=torch.int32)
    pos = torch.zeros(t, dtype=torch.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        pos[o:o + n] = torch.arange(n)
        o += n
    seg, pos = seg.to(dev), pos.to(dev)
    flags = torch.tensor(flags_kv, dtype=torch.bool,
                         device=dev).repeat_interleave(hq // hkv)
    band = dict(head_is_retrieval=flags, sink_size=sink, local_size=local)
    before = cuda.LAUNCHES["flash_prefill_band"]
    got = fa.flash_prefill(q, k, v, seg, pos, d ** -0.5, **band)
    assert cuda.LAUNCHES["flash_prefill_band"] == before + 1
    want = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5, **band)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    dense = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5)
    assert not torch.allclose(got[:, ~flags].float(),
                              dense[:, ~flags].float(), atol=2e-2)


def test_flash_prefill_band_all_retrieval_is_dense(dev):
    """Band arguments whose flags are all 1 run, and count as, the dense
    kernel: ``flash_prefill_band`` counts only calls where a head streams."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    t, hq, hkv, d = 600, 8, 2, 128
    g = _gen(dev, 14)
    q = torch.randn((t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    seg = torch.zeros(t, dtype=torch.int32, device=dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)
    flags = torch.ones(hq, dtype=torch.bool, device=dev)
    before = dict(cuda.LAUNCHES)
    got = fa.flash_prefill(q, k, v, seg, pos, d ** -0.5,
                           head_is_retrieval=flags, sink_size=16,
                           local_size=64)
    assert cuda.LAUNCHES["flash_prefill_band"] == before["flash_prefill_band"]
    assert cuda.LAUNCHES["flash_prefill"] == before["flash_prefill"] + 1
    want = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _ring_pool(dev, g, lens, h, page, sink_b, local_b, d=128):
    """A streaming ring pool (one layer of two) holding ``lens[s]`` tokens of
    each sequence, written page by page through the ring mapping as the
    engine writes it (later wraps overwrite earlier pages)."""
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    n_slots = sink_b + local_b
    b = len(lens)
    pool = make_kv_pool(2, b * n_slots + 1, h, page, d, device=dev)
    # the sequences' slots interleaved, so tables are not contiguous
    tables = torch.arange(b * n_slots, dtype=torch.int32).view(n_slots, b)
    tables = tables.t().contiguous().to(dev)
    for s, n in enumerate(lens):
        for p0 in range(0, n, page):
            pos = torch.arange(p0, min(n, p0 + page), device=dev)
            blk = p0 // page
            slot = blk if blk < sink_b else sink_b + (blk - sink_b) % local_b
            append_kv(pool, 1,
                      torch.randn((len(pos), h, d), generator=g, device=dev),
                      torch.randn((len(pos), h, d), generator=g, device=dev),
                      tables[s, slot].long().expand(len(pos)), pos % page,
                      page, 4, True)
    return pool, tables


@pytest.mark.parametrize("lens,chunk,page,sink_b,local_b,n_rep,band,flags", [
    # the wrapped ring of chip_smoke: 1 + 80 pages, context 20,000 (not a
    # page multiple: stale rows past the write head), a 2,048-token chunk
    ([20000], 2048, 128, 1, 80, 4, (128, 8192), [0, 0]),
    # two sequences wrapped several times, one padded halfway; mixed heads
    ([300, 229], 40, 16, 1, 6, 2, (16, 48), [1, 0]),
    # a ring that has not wrapped: never-written rows stay dead
    ([100, 70], 24, 16, 2, 8, 8, (16, 32), [0, 0]),
    # GQA groups of 7 and 3 (dead rows past BM / n_rep tokens a block)
    ([300, 229], 40, 16, 1, 6, 7, (16, 48), [1, 0]),
    ([20000], 300, 128, 1, 80, 3, (128, 8192), [0, 1]),
])
def test_paged_prefill_ring_kernel(dev, lens, chunk, page, sink_b, local_b,
                                   n_rep, band, flags):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import ring_logical_blocks

    b, h, d = len(lens), 2, 128
    n_slots = sink_b + local_b
    g = _gen(dev, 13)
    pool, tables = _ring_pool(dev, g, lens, h, page, sink_b, local_b)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    ctx = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.stack([n - chunk + torch.arange(chunk, dtype=torch.int32)
                         for n in lens])
    if b > 1:     # the second row's prompt ends halfway through the chunk
        q_pos[1] = lens[1] - chunk // 2 + torch.arange(chunk,
                                                        dtype=torch.int32)
        q_pos[1, chunk // 2:] = -1
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    sel = ring_logical_blocks(ctx, n_slots, sink_b, local_b, page)
    kw = dict(sm_scale=d ** -0.5, page_size=page,
              head_is_retrieval=torch.tensor(flags, dtype=torch.bool,
                                             device=dev).repeat_interleave(
                                                 n_rep),
              sink_size=band[0], local_size=band[1], sel_logic=sel,
              ring_span_pages=local_b, ring_sink_tokens=sink_b * page)
    before = cuda.LAUNCHES["paged_prefill_ring"]
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES["paged_prefill_ring"] == before + 1
    want = pp.paged_prefill_attention_plain(q, pool, 1, tables, q_pos, ctx,
                                            **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if b > 1:
        assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


def test_paged_prefill_page_list_kernel(dev):
    """An explicit page list without a ring (slots in any order, dead
    slots), mixed heads, over a dense pool."""
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    page, h, d, n_rep, w = 16, 2, 128, 4, 6
    g = _gen(dev, 14)
    pool = make_kv_pool(2, 13, h, page, d, device=dev)
    pos = torch.arange(6 * page, device=dev)
    tables = torch.tensor([[3, 9, 0, 5, 11, 7], [1, 4, 10, 2, 8, 6]],
                          dtype=torch.int32, device=dev)
    for s in range(2):
        append_kv(pool, 1, torch.randn((6 * page, h, d), generator=g,
                                       device=dev),
                  torch.randn((6 * page, h, d), generator=g, device=dev),
                  tables[s].long()[pos // page], pos % page, page, 4, True)
    sel = torch.tensor([[0, 3, 1, -1, 4, 2], [5, -1, 0, 1, -1, 2]],
                       dtype=torch.int32, device=dev)
    ctx = torch.tensor([80, 95], dtype=torch.int32, device=dev)
    q_pos = torch.stack([torch.arange(48, 80), torch.arange(63, 95)]).to(
        device=dev, dtype=torch.int32)
    q = torch.randn((2, 32, h * n_rep, d), generator=g, device=dev).bfloat16()
    kw = dict(sm_scale=d ** -0.5, page_size=page, sel_logic=sel,
              head_is_retrieval=torch.tensor([True] * n_rep + [False] * n_rep,
                                             device=dev),
              sink_size=8, local_size=20)
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx, **kw)
    want = pp.paged_prefill_attention_plain(q, pool, 1, tables, q_pos, ctx,
                                            **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("n_rep", [1, 3, 4, 7])
def test_decode_attention_append_kernel(dev, n_rep):
    from omniserve_tpu_torch.ops.cuda import decode_attention as da
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    page, h, d, w = 128, 2, 128, 4
    lens = torch.tensor([2 * page + 17, page, 1, 0], dtype=torch.int32)
    b = len(lens)
    tables = torch.arange(b * w, dtype=torch.int32).view(b, w)
    tables[3] = 0
    g = _gen(dev, 3)
    pool = make_kv_pool(2, b * w + 1, h, page, d, device=dev)
    for s in range(3):
        n = int(lens[s]) - 1
        if n <= 0:
            continue
        pos = torch.arange(n, device=dev)
        append_kv(pool, 1, torch.randn((n, h, d), generator=g, device=dev),
                  torch.randn((n, h, d), generator=g, device=dev),
                  tables[s].to(dev)[pos // page], pos % page, page, 4, True)
    twin = pool.clone()
    q = torch.randn((b, h * n_rep, d), generator=g, device=dev).bfloat16()
    kn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    vn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    args = (tables.to(dev), lens.to(dev), kn, vn)
    got = da.paged_decode_attention_fused(q, pool, 1, *args, sm_scale=0.1,
                                          page_size=page)
    want = da.paged_decode_attention_fused_plain(q, twin, 1, *args,
                                                 sm_scale=0.1, page_size=page)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[3].abs().max()) == 0.0
    assert_pools_equal(pool, twin)


@pytest.mark.parametrize("history,chunk,n_rep,page,ragged", [
    (0, 24, 4, 16, False),       # first chunk, tokens of one tile
    (40, 24, 2, 16, False),      # history in earlier pages
    (16, 16, 1, 16, True),       # second row padded (q_pos -1) halfway
    (200, 130, 4, 128, False),   # page 128, chunk spans two pages
    (300, 64, 8, 128, True),
    (40, 24, 7, 16, True),       # GQA groups of 7 and 3: 18 and 42 tokens
    (896, 128, 7, 128, False),   # a block, the last rows dead (Yi-34B's
    (200, 130, 3, 128, True),    # bench chunk at 7)
])
def test_paged_prefill_kernel(dev, history, chunk, n_rep, page, ragged):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    b, h, d = 2, 2, 128
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 4)
    pool = make_kv_pool(2, b * w + 1, h, page, d, device=dev)
    # pages of the two sequences interleaved, so tables are not contiguous
    tables = torch.arange(b * w, dtype=torch.int32).view(w, b).t()
    tables = tables.contiguous().to(dev)
    pos = torch.arange(total, device=dev)
    for s in range(b):
        append_kv(pool, 1, torch.randn((total, h, d), generator=g, device=dev),
                  torch.randn((total, h, d), generator=g, device=dev),
                  tables[s].long()[pos // page], pos % page, page, 4, True)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    if ragged:
        q_pos[1, chunk // 2:] = -1
        ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    before = cuda.LAUNCHES["paged_prefill_attention"]
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx,
                                     sm_scale=d ** -0.5, page_size=page)
    assert cuda.LAUNCHES["paged_prefill_attention"] == before + 1
    want = pp.paged_prefill_attention_plain(q, pool, 1, tables, q_pos, ctx,
                                            sm_scale=d ** -0.5,
                                            page_size=page)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if ragged:
        assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


def test_decode_window_graph_matches_eager(dev):
    """Eight replays of the captured decode step give the eager loop's
    tokens and pool bytes, from the same pool and metadata. The 16-token
    pages fail the JAX package's supports rule, so each layer's step runs
    the split path: row 10's append, then row 6 (one launch each)."""
    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool
    from omniserve_tpu_torch.worker.decode_window import DecodeWindow

    spec = llama.LlamaSpec(num_layers=2, hidden=512, intermediate=1024,
                           num_q_heads=4, num_kv_heads=2, head_dim=128,
                           vocab=1024, page_size=16, lm_head_bits=8)
    params = llama.make_random_packed_params(spec, seed=3, device=dev)
    lens, b_pad, w = [37, 5, 20], 8, 6
    tables = np.zeros((b_pad, w), np.int32)
    tables[:3] = np.arange(3 * w).reshape(3, w)
    pool = make_kv_pool(2, 3 * w + 1, 2, 16, 128, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, spec.vocab, n) for n in lens]
    batch = llama.PrefillBatch(
        token_ids=torch.from_numpy(np.concatenate(prompts)).to(dev),
        positions=torch.from_numpy(np.concatenate(
            [np.arange(n) for n in lens]).astype(np.int32)).to(dev),
        segment_ids=torch.from_numpy(np.concatenate(
            [np.full(n, i) for i, n in enumerate(lens)]).astype(
                np.int32)).to(dev),
        block_tables=torch.from_numpy(tables[:3]).to(dev),
        last_token_idx=torch.tensor(np.cumsum(lens) - 1, device=dev),
    )
    with torch.inference_mode():
        logits, _, _, _ = llama.llama_forward(params, pool, None, batch, spec,
                                              is_prefill=True)
        first = np.zeros(b_pad, np.int32)
        first[:3] = logits.argmax(-1).cpu().numpy()
        positions = np.zeros(b_pad, np.int32)
        positions[:3] = lens
        active = np.arange(b_pad) < 3
        twin = pool.clone()
        toks = {}
        for mode, p in (("graph", pool), ("eager", twin)):
            win = DecodeWindow(params, p, spec, b_pad, w, dev,
                               use_graph=mode == "graph")
            assert bool(win.graphs) == (mode == "graph")
            win.load(first, positions, active, tables)
            before = dict(cuda.LAUNCHES)
            toks[mode] = win.run(8).cpu().numpy()
            for name in ("kv_append_decode", "paged_mqa_attention"):
                assert (cuda.LAUNCHES[name] - before[name]
                        == 8 * spec.num_layers), name
            assert (cuda.LAUNCHES["decode_attention_append"]
                    == before["decode_attention_append"])
    np.testing.assert_array_equal(toks["graph"][:, :3], toks["eager"][:, :3])
    assert_pools_equal(pool, twin)


@pytest.mark.parametrize("heads,with_stats,dtype", [
    (4, True, torch.bfloat16), (4, False, torch.bfloat16),
    (8, False, torch.float32), (1, True, torch.float32)])
def test_kv_append_decode_kernel(dev, heads, with_stats, dtype):
    """Three appends on the same pages (low nibble, high nibble, another
    sub-chunk), two tokens inactive: bytes, planes and stats equal the
    plain version's on every page but the trash page."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import kv_append as ka
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool

    page, d, t = 128, 128, 8
    g = _gen(dev, 5)
    pool = make_kv_pool(2, 13, heads, page, d, with_stats=with_stats,
                        device=dev)
    for x in pool:
        if x is not None:      # recycled pages are dirty
            x.copy_(torch.randint(0, 200, x.shape, generator=g,
                                  device=dev).to(x.dtype))
    twin = pool.clone()
    pages = torch.tensor([4, 9, -1, 0, 7, -1, 2, 10], dtype=torch.int32,
                         device=dev)
    for step, slot0 in enumerate((5, 64, 127)):
        slots = ((slot0 + torch.arange(t) * 17) % page).to(torch.int32).to(dev)
        k = torch.randn((t, heads, d), generator=g, device=dev).to(dtype)
        v = torch.randn((t, heads, d), generator=g, device=dev).to(dtype)
        before = cuda.LAUNCHES["kv_append_decode"]
        ka.append_kv_decode(pool, step % 2, k, v, pages, slots, page,
                            update_stats=with_stats)
        assert cuda.LAUNCHES["kv_append_decode"] == before + 1
        ka.append_kv_decode_plain(twin, step % 2, k, v, pages, slots, page,
                                  update_stats=with_stats)
    torch.cuda.synchronize()
    assert_pools_equal(pool, twin, skip_trash=True)


def _filled_pool(dev, g, n_pages, heads, page=128, d=128):
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    pool = make_kv_pool(2, n_pages + 1, heads, page, d, device=dev)
    n = n_pages * page
    pos = torch.arange(n, device=dev)
    append_kv(pool, 1, torch.randn((n, heads, d), generator=g, device=dev),
              torch.randn((n, heads, d), generator=g, device=dev),
              pos // page, pos % page, page, 4, True)
    return pool


@pytest.mark.parametrize("n_rep", [1, 3, 4, 7])
def test_decode_attention_ph_kernel(dev, n_rep):
    """Per-head lists in no order with dead entries, a context that ends
    inside a listed page, an all-dead row and an inactive row."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    page, h, d, n_pages = 128, 2, 128, 12
    g = _gen(dev, 6)
    pool = _filled_pool(dev, g, n_pages, h)
    lens = torch.tensor([5 * page + 9, 3 * page, 700, 0], dtype=torch.int32)
    sel_logic = torch.tensor([
        [[5, 0, 3, -1, 1], [5, 4, -1, 2, 0]],
        [[2, 1, 0, -1, -1], [2, -1, 0, -1, -1]],
        [[-1, -1, -1, -1, -1], [5, 1, 3, 0, 4]],
        [[0, 1, -1, -1, -1], [0, -1, -1, -1, -1]],
    ], dtype=torch.int32)
    # logical page p of row r lives in physical page (p + 2 r) % n_pages
    sel_phys = torch.where(
        sel_logic >= 0,
        (sel_logic + 2 * torch.arange(4)[:, None, None]) % n_pages, 0,
    ).to(torch.int32)
    q = torch.randn((4, h, n_rep, d), generator=g, device=dev).bfloat16()
    args = (q, pool, 1, sel_phys.to(dev), sel_logic.to(dev), lens.to(dev))
    before = cuda.LAUNCHES["decode_attention_ph"]
    got = da.paged_mqa_attention_single_pass_ph(*args, sm_scale=d ** -0.5,
                                                page_size=page)
    assert cuda.LAUNCHES["decode_attention_ph"] == before + 1
    want = da.page_list_attention_plain(*args, sm_scale=d ** -0.5,
                                        page_size=page)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[2, 0].abs().max()) == 0.0      # all-dead list
    assert float(got[3].abs().max()) == 0.0         # inactive row
    assert float(got[2, 1].abs().max()) > 0.0
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("band", [(128, 256), (64, 100), (-1, 0)])
def test_decode_attention_band_kernel(dev, band):
    """One list per sequence over a ring pool of 1 sink + 2 ring pages:
    wrapped mid page, wrapped on a page boundary, inside the sink page,
    inactive. Held against the list contract's plain version, and the whole
    dual-pool composition against ``attention_ref``."""
    from omniserve_tpu_torch.ops import attention_ref, cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    page, h, d = 128, 2, 128
    g = _gen(dev, 7)
    lens = torch.tensor([5 * page + 37, 4 * page, 90, 0], dtype=torch.int32,
                        device=dev)
    b = len(lens)
    # garbage everywhere first (never-written lanes), then the live tokens
    spool = _filled_pool(dev, g, 3 * b, h)
    spool.kv_scales[:, 7:9].fill_(float("nan"))          # unlisted pages
    spool.kv_scales[:, 6, :, :, 90:] = float("nan")      # past row 2's end
    stables = torch.arange(3 * b, dtype=torch.int32, device=dev).view(b, 3)
    sel_phys, sel_logic, span = da.streaming_page_lists(
        stables, lens, 1, page, 256)
    q = torch.randn((b, h, 4, d), generator=g, device=dev).bfloat16()
    kw = dict(sm_scale=d ** -0.5, page_size=page, band_sink_tokens=band[0],
              band_local_tokens=band[1], ring_span_pages=span,
              ring_sink_tokens=page)
    before = cuda.LAUNCHES["decode_attention_band"]
    got = da.paged_mqa_attention_single_pass(q, spool, 1, sel_phys,
                                             sel_logic, lens, **kw)
    assert cuda.LAUNCHES["decode_attention_band"] == before + 1
    want = da.page_list_attention_plain(q, spool, 1, sel_phys, sel_logic,
                                        lens, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[3].abs().max()) == 0.0
    assert torch.isfinite(got.float()).all()
    if band[0] < 0:
        return
    # the composition: 2 retrieval + 2 streaming heads, selected pages
    rpool = _filled_pool(dev, g, 6 * b, h)
    tables = torch.arange(6 * b, dtype=torch.int32, device=dev).view(b, 6)
    flags = torch.tensor([True, False, False, True], device=dev)
    rank = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    page_idxes = torch.tensor([[5, 0, 2], [3, 1, -1], [0, -1, -1],
                               [-1, -1, -1]], dtype=torch.int32, device=dev)
    page_idxes = page_idxes[:, None, :].repeat(1, 4, 1)
    q2 = torch.randn((b, 16, d), generator=g, device=dev).bfloat16()
    spool.kv_scales.nan_to_num_(nan=1.0)   # attention_ref reads whole pages
    kw2 = dict(streaming_pool=spool, streaming_block_tables=stables,
               head_is_retrieval=flags, head_rank=rank, sink_blocks=1,
               local_blocks=2, page_idxes=page_idxes,
               dec_sink_tokens=band[0], dec_local_tokens=band[1])
    got2 = da.paged_decode_attention(q2, rpool, 1, tables, lens,
                                     d ** -0.5, page, **kw2)
    want2 = attention_ref.paged_decode_attention(
        q2, rpool, 1, tables, lens, d ** -0.5, page, 4, True, **kw2)
    torch.testing.assert_close(got2.float(), want2.float(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("n_rep", [3, 7])
def test_decode_dead_rows_write_nothing_kernel(dev, n_rep):
    """n_rep 3 and 7 run in the row capacity 4 and 8: the fused append
    (kv4) and the band (kv4, split over blocks) against their plain
    versions at the tests' gate, and that gate refuses the plain output
    with a dead row's result written over the next group's first row."""
    from omniserve_tpu_torch.ops.cuda import decode_attention as da
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    page, h, d, w = 128, 2, 128, 4
    lens = torch.tensor([3 * page + 17, 2 * page, 70], dtype=torch.int32)
    b = len(lens)
    tables = torch.arange(b * w, dtype=torch.int32).view(b, w).to(dev)
    g = _gen(dev, 41)
    pool = make_kv_pool(2, b * w + 1, h, page, d, device=dev)
    for s in range(b):
        n = int(lens[s]) - 1
        pos = torch.arange(n, device=dev)
        append_kv(pool, 1, torch.randn((n, h, d), generator=g, device=dev),
                  torch.randn((n, h, d), generator=g, device=dev),
                  tables[s][pos // page], pos % page, page, 4, True)
    twin = pool.clone()
    q = torch.randn((b, h * n_rep, d), generator=g, device=dev).bfloat16()
    kn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    vn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    args = (tables, lens.to(dev), kn, vn)
    kw = dict(sm_scale=d ** -0.5, page_size=page)
    got = da.paged_decode_attention_fused(q, pool, 1, *args, **kw)
    want = da.paged_decode_attention_fused_plain(q, twin, 1, *args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert_pools_equal(pool, twin)
    # the same token appended again writes the same bytes
    uniform = da.paged_decode_attention_fused_plain(
        torch.zeros_like(q), twin, 1, *args, **kw)
    bad = dead_row_written(want.view(b, h, n_rep, d),
                           uniform.view(b, h, n_rep, d))
    assert not torch.allclose(bad.float(), want.view(b, h, n_rep, d).float(),
                              rtol=5e-2, atol=5e-2)

    # the band over the pool's dense lists, split over blocks
    lists = da.dense_page_lists(tables, lens.to(dev), page)
    q4 = q.view(b, h, n_rep, d)
    bkw = dict(kw, band_sink_tokens=page, band_local_tokens=page + 40)
    got = da.paged_mqa_attention_single_pass(q4, pool, 1, *lists,
                                             lens.to(dev), **bkw)
    want = da.page_list_attention_plain(q4, pool, 1, *lists, lens.to(dev),
                                        **bkw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    uniform = da.page_list_attention_plain(torch.zeros_like(q4), pool, 1,
                                           *lists, lens.to(dev), **bkw)
    assert not torch.allclose(dead_row_written(want, uniform).float(),
                              want.float(), rtol=5e-2, atol=5e-2)


LIST_MODES = ("kv8", "pt4", "pt8")


def _plant_dead_garbage(pool, layer, page, lens, phys_of):
    """NaN planes (fine-grained pools) past each context's end in the page
    that holds it, and 0xFF codes there: never-written slots hold garbage,
    and every use of them must stay behind the mask. ``phys_of(s, p)`` is
    the physical page of sequence s's logical page p."""
    rows = pool.k_data.shape[3]
    for s, n in enumerate(lens):
        if n <= 0 or n % page == 0:
            continue
        phys, slot = phys_of(s, (n - 1) // page), (n - 1) % page + 1
        if pool.kv_scales is not None:
            pool.kv_scales[layer, phys, :, :, slot:] = float("nan")
        if rows == page:         # kv8 rows: slot = row
            pool.k_data[layer, phys, :, slot:] = 255
            pool.v_data[layer, phys, :, slot:] = 255


@pytest.mark.parametrize("page", [128, 256])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("mode", LIST_MODES)
def test_decode_attention_list_kv_modes_kernel(dev, mode, n_rep, page):
    """Rows 4 (band/ring) and 5 (per-head lists) over kv8 and per-tensor
    pools: per-head lists in no order with dead entries, a context inside a
    listed page, an all-dead list and an inactive row; the ring's band
    list (wrapped mid page and on a page boundary, inside the sink page,
    inactive). Garbage planted past each context; launches counted under
    the mode's name."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    h, d, n_pages = 2, 128, 24
    g = _gen(dev, 31)
    suffix = "_kv8" if mode == "kv8" else "_pt"
    pool = _codes_pool(dev, g, mode, 2, n_pages + 1, h, page, d)
    lens = [5 * page + 9, 3 * page, 2 * page + 60, 0]
    sel_logic = torch.tensor([
        [[5, 0, 3, -1, 1], [5, 4, -1, 2, 0]],
        [[2, 1, 0, -1, -1], [2, -1, 0, -1, -1]],
        [[-1, -1, -1, -1, -1], [2, 1, 0, -1, -1]],
        [[0, 1, -1, -1, -1], [0, -1, -1, -1, -1]],
    ], dtype=torch.int32)
    # logical page p of row r lives in physical page p + 6 r (no page is
    # shared, so garbage past one row's context is no other row's token)
    _plant_dead_garbage(pool, 1, page, lens, lambda s, p: p + 6 * s)
    sel_phys = torch.where(
        sel_logic >= 0, sel_logic + 6 * torch.arange(4)[:, None, None], 0,
    ).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((4, h, n_rep, d), generator=g, device=dev).bfloat16()
    args = (q, pool, 1, sel_phys.to(dev), sel_logic.to(dev), lens_t)
    kw = dict(sm_scale=d ** -0.5, page_size=page)
    before = cuda.LAUNCHES["decode_attention_ph" + suffix]
    got = da.paged_mqa_attention_single_pass_ph(*args, **kw)
    assert cuda.LAUNCHES["decode_attention_ph" + suffix] == before + 1
    want = da.page_list_attention_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[2, 0].abs().max()) == 0.0      # all-dead list
    assert float(got[3].abs().max()) == 0.0         # inactive row
    assert float(got[2, 1].abs().max()) > 0.0
    assert torch.isfinite(got.float()).all()

    # the ring's band: 1 sink + 2 ring pages per sequence
    b = 4
    slens = torch.tensor([5 * page + 37, 4 * page, 90, 0],
                         dtype=torch.int32, device=dev)
    spool = _codes_pool(dev, g, mode, 2, 3 * b + 1, h, page, d)
    stables = torch.arange(3 * b, dtype=torch.int32, device=dev).view(b, 3)
    _plant_dead_garbage(spool, 1, page, [0, 0, 90, 0],
                        lambda s, p: int(stables[s, 0]))
    sel_phys, sel_logic, span = da.streaming_page_lists(
        stables, slens, 1, page, 2 * page)
    q = torch.randn((b, h, n_rep, d), generator=g, device=dev).bfloat16()
    kw = dict(sm_scale=d ** -0.5, page_size=page, band_sink_tokens=page,
              band_local_tokens=2 * page, ring_span_pages=span,
              ring_sink_tokens=page)
    before = cuda.LAUNCHES["decode_attention_band" + suffix]
    got = da.paged_mqa_attention_single_pass(q, spool, 1, sel_phys,
                                             sel_logic, slens, **kw)
    assert cuda.LAUNCHES["decode_attention_band" + suffix] == before + 1
    want = da.page_list_attention_plain(q, spool, 1, sel_phys, sel_logic,
                                        slens, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[3].abs().max()) == 0.0
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("page", [128, 256])
@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("mode", LIST_MODES)
def test_kv_append_decode_kv_modes_kernel(dev, mode, with_stats, page):
    """Row 10 over kv8 and per-tensor pools: three appends on the same
    dirty pages, two tokens inactive; bytes, planes, stats and scales equal
    the plain version's on every page but the trash page."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import kv_append as ka
    from omniserve_tpu_torch.ops.paged_kv import KVPool

    heads, d, t, n_sub = 4, 128, 8, 4
    g = _gen(dev, 32)
    kv_bits, fine = PSP_MODES[mode]
    base = _codes_pool(dev, g, mode, 2, 13, heads, page, d)
    stats = (torch.randn((2, 13, heads, 2 * n_sub, d), generator=g,
                         device=dev) if with_stats else None)
    pool = base._replace(k_stats=stats)
    twin = pool.clone()
    name = "kv_append_decode" + ("_kv8" if mode == "kv8" else "_pt")
    pages = torch.tensor([4, 9, -1, 0, 7, -1, 2, 10], dtype=torch.int32,
                         device=dev)
    for step, slot0 in enumerate((5, page // 2, page - 1)):
        slots = ((slot0 + torch.arange(t) * 17) % page).to(torch.int32).to(dev)
        k = torch.randn((t, heads, d), generator=g, device=dev).bfloat16()
        v = torch.randn((t, heads, d), generator=g, device=dev).bfloat16()
        before = cuda.LAUNCHES[name]
        ka.append_kv_decode(pool, step % 2, k, v, pages, slots, page,
                            update_stats=with_stats, sub_chunks=n_sub)
        assert cuda.LAUNCHES[name] == before + 1
        ka.append_kv_decode_plain(twin, step % 2, k, v, pages, slots, page,
                                  update_stats=with_stats, sub_chunks=n_sub,
                                  kv_bits=kv_bits, kv_zeros=fine)
    torch.cuda.synchronize()
    assert isinstance(pool, KVPool)
    assert_pools_equal(pool, twin, skip_trash=True)


# the two-pool append: 4 kv heads, rows 0 and 2 to the retrieval pool,
# 1 and 3 to the streaming pool (each pool's row -> head map)
POOL_SRC = ((0, 2), (1, 3))


def _two_pool_case(dev, mode, t, with_stats, page=128, seed=51, d=128):
    """Dirty retrieval (with stats) and streaming pools of ``mode`` (kv4,
    kv8, pt4, pt8, kv16), one token per sequence into distinct pages of each
    (every fifth inactive), bf16 K / V rows [t, 4, D] as slices of a fused
    qkv row (tokens 3 * 4 * D apart), and the pools' maps."""
    n_sub, hp = 4, 2
    g = _gen(dev, seed)
    n_pages = 2 * t + 1
    pools = []
    for stats in (with_stats, False):
        if mode == "kv16":
            pools.append(_kv16_pool(dev, g, 2, n_pages, hp, page, d, stats))
            continue
        pool = _codes_pool(dev, g, mode, 2, n_pages, hp, page, d)
        if pool.k_scale_per_tensor is not None:    # layers' scales differ
            pool.k_scale_per_tensor[0] *= 1.3
            pool.v_scale_per_tensor[0] *= 0.8
        if stats:
            pool = pool._replace(k_stats=torch.randn(
                (2, n_pages, hp, 2 * n_sub, d), generator=g, device=dev))
        pools.append(pool)
    targets = []
    for src in POOL_SRC:
        pages = torch.randperm(n_pages - 1, generator=g, device=dev)[:t].to(
            torch.int32)
        pages[1::5] = -1
        slots = torch.randint(0, page, (t,), generator=g, device=dev).to(
            torch.int32)
        targets.append((pages, slots,
                        torch.tensor(src, dtype=torch.int64, device=dev)))
    qkv = torch.randn((t, 3, 4, d), generator=g, device=dev).bfloat16()
    return pools, targets, qkv[:, 1], qkv[:, 2]


def _refused(pools, twins, what):
    """Raise unless the two pairs of pools differ somewhere (trash page
    left out)."""
    for got, want in zip(pools, twins):
        try:
            assert_pools_equal(got, want, skip_trash=True)
        except AssertionError:
            return
    raise AssertionError(f"equal pools with {what} planted")


@pytest.mark.parametrize("t", [1, 8, 128])
@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt4", "pt8", "kv16"])
def test_kv_append_decode_pools_kernel(dev, mode, with_stats, t):
    """Row 10's two-pool entry, one launch for LServe's retrieval and
    streaming pools, each row reading its kv head through the pool's map
    out of K / V rows that are views of a fused qkv row (kv4 / kv8
    codes, fine-grained or per-tensor, or kv16 values): bytes, planes,
    stats (retrieval pool only) and scales equal the two plain appends'
    on every page but the trash page, three steps on the same pages. The
    plain versions refuse a token one slot late, the other layer's scales
    or planes, and the two pools' maps swapped."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    kv_bits, fine = PSP_MODES.get(mode, (16, True))
    (rpool, spool), (tr, ts), k, v = _two_pool_case(dev, mode, t, with_stats)
    assert k.stride(0) == 3 * 4 * 128     # read in place, no gather
    twins = (rpool.clone(), spool.clone())
    start = (rpool.clone(), spool.clone())
    name = ka.launch_name(kv_bits, not fine)
    kw = dict(update_stats=with_stats, sub_chunks=4)
    plain_kw = dict(kv_bits=kv_bits, kv_zeros=fine, **kw)
    for step in range(3):
        layer = step % 2
        before = cuda.LAUNCHES[name]
        ka.append_kv_decode_pools(rpool, spool, layer, k, v, tr, ts, 128,
                                  **kw)
        assert cuda.LAUNCHES[name] == before + 1
        ka.append_kv_decode_pools_plain(*twins, layer, k, v, tr, ts, 128,
                                        **plain_kw)
        tr = (tr[0], (tr[1] + 37) % 128, tr[2])    # the same pages
        ts = (ts[0], (ts[1] + 64) % 128, ts[2])
    torch.cuda.synchronize()
    for got, want in zip((rpool, spool), twins):
        assert_pools_equal(got, want, skip_trash=True)
    # planted faults, against one step from the starting pools
    got = tuple(p.clone() for p in start)
    ka.append_kv_decode_pools(*got, 1, k, v, tr, ts, 128, **kw)
    faults = {
        "each token one slot late": (start, (tr[0], (tr[1] + 1) % 128, tr[2]),
                                     (ts[0], (ts[1] + 1) % 128, ts[2])),
        "the pools' maps swapped": (start, (tr[0], tr[1], ts[2]),
                                    (ts[0], ts[1], tr[2])),
    }
    if not fine:      # per-tensor codes quantized with layer 0's scales
        faults["the other layer's scales"] = (tuple(p._replace(
            k_scale_per_tensor=p.k_scale_per_tensor.flip(0).contiguous(),
            v_scale_per_tensor=p.v_scale_per_tensor.flip(0).contiguous())
            for p in start), tr, ts)
    for what, (pools, a, b_) in faults.items():
        bad = tuple(p.clone() for p in pools)
        ka.append_kv_decode_pools_plain(*bad, 1, k, v, a, b_, 128,
                                        **plain_kw)
        bad = tuple(p._replace(k_scale_per_tensor=s.k_scale_per_tensor,
                               v_scale_per_tensor=s.v_scale_per_tensor)
                    for p, s in zip(bad, got))
        _refused(got, bad, what)


def test_kv_append_decode_pools_refuses_bad_inputs(dev):
    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    (rpool, spool), (tr, ts), k, v = _two_pool_case(dev, "kv8", 8, False)
    with pytest.raises(ValueError, match="src"):
        ka.append_kv_decode_pools(rpool, spool, 0, k, v,
                                  (tr[0], tr[1], tr[2][:1]), ts, 128)
    with pytest.raises(TypeError, match="src"):
        ka.append_kv_decode_pools(rpool, spool, 0, k, v,
                                  (tr[0], tr[1], tr[2].int()), ts, 128)
    pt_pool = _codes_pool(dev, _gen(dev, 3), "pt8", 2, 17, 2, 128)
    with pytest.raises(ValueError, match="KV mode"):
        ka.append_kv_decode_pools(rpool, pt_pool, 0, k, v, tr, ts, 128)


@pytest.mark.parametrize("page,n_rep", [(128, 1), (256, 2), (128, 4),
                                        (256, 8), (128, 7), (256, 3)])
@pytest.mark.parametrize("mode", LIST_MODES)
def test_paged_prefill_ring_kv_modes_kernel(dev, mode, page, n_rep):
    """Row 7's page list with the ring relabel and the band over kv8 and
    per-tensor pools: two sequences wrapped several times, one padded
    halfway, stale rows past the write head; launches counted under the
    mode's ring name."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import ring_logical_blocks

    lens, chunk, sink_b, local_b = [20 * page + 37, 15 * page + 50], 128, 1, 6
    b, h, d = len(lens), 2, 128
    n_slots = sink_b + local_b
    g = _gen(dev, 33)
    pool = _codes_pool(dev, g, mode, 1, b * n_slots + 1, h, page, d)
    tables = torch.randperm(b * n_slots, generator=g, device=dev).view(
        b, n_slots).to(torch.int32)
    ctx = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.stack([n - chunk + torch.arange(chunk, dtype=torch.int32)
                         for n in lens])
    q_pos[1] = lens[1] - chunk // 2 + torch.arange(chunk, dtype=torch.int32)
    q_pos[1, chunk // 2:] = -1
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    sel = ring_logical_blocks(ctx, n_slots, sink_b, local_b, page)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    kv_bits, fine = PSP_MODES[mode]
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=fine, sel_logic=sel, ring_span_pages=local_b,
              ring_sink_tokens=sink_b * page,
              head_is_retrieval=torch.tensor(
                  [True] * n_rep + [False] * n_rep, device=dev),
              sink_size=page, local_size=3 * page)
    name = "paged_prefill_ring" + ("_kv8" if mode == "kv8" else "_pt")
    before = cuda.LAUNCHES[name]
    got = pp.paged_prefill_attention(q, pool, 0, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = pp.paged_prefill_attention_plain(q, pool, 0, tables, q_pos, ctx,
                                            **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["pt4", "pt8"])
def test_list_kernels_read_per_tensor_scales_after_capture(dev, mode):
    """Rows 5, 4 (band) and 10 captured in one CUDA graph over a per-tensor
    pool, the layer's scales changed afterwards in place: the replay uses
    the new scales (read on the device), equal to the plain versions run
    with them."""
    from omniserve_tpu_torch.ops.cuda import decode_attention as da
    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    page, h, d, n_rep, b = 128, 2, 128, 4, 2
    g = _gen(dev, 34)
    pool = _codes_pool(dev, g, mode, 2, 9, h, page, d)
    kv_bits = PSP_MODES[mode][0]
    lens = torch.tensor([3 * page + 5, 2 * page], dtype=torch.int32,
                        device=dev)
    sel_logic = torch.tensor([[[3, 0, 1], [3, 2, -1]], [[1, 0, -1], [1, -1,
                              0]]], dtype=torch.int32, device=dev)
    sel_phys = torch.where(sel_logic >= 0, sel_logic + 4 * torch.arange(
        b, device=dev)[:, None, None], 0).to(torch.int32)
    q = torch.randn((b, h, n_rep, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    pages = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    slots = torch.tensor([5, 0], dtype=torch.int32, device=dev)
    kw = dict(sm_scale=d ** -0.5, page_size=page)
    band_kw = dict(band_sink_tokens=page, band_local_tokens=page,
                   ring_span_pages=0)
    lists = (sel_phys[:, 0].contiguous(), sel_logic[:, 0].contiguous())
    twin = pool.clone()
    out = {}

    def step():
        ka.append_kv_decode(pool, 1, k, v, pages, slots, page)
        out["ph"] = da.paged_mqa_attention_single_pass_ph(
            q, pool, 1, sel_phys, sel_logic, lens, **kw)
        out["band"] = da.paged_mqa_attention_single_pass(
            q, pool, 1, *lists, lens, **kw, **band_kw)

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    qmax = 7 if kv_bits == 4 else 127
    for p in (pool, twin):
        p.k_scale_per_tensor.copy_(torch.tensor([2.0, 2.6], device=dev)
                                   / qmax)
        p.v_scale_per_tensor.copy_(torch.tensor([1.5, 2.2], device=dev)
                                   / qmax)
    graph.replay()
    torch.cuda.synchronize()
    ka.append_kv_decode_plain(twin, 1, k, v, pages, slots, page,
                              kv_bits=kv_bits, kv_zeros=False)
    assert_pools_equal(pool, twin)
    want_ph = da.page_list_attention_plain(q, twin, 1, sel_phys, sel_logic,
                                           lens, **kw)
    want_band = da.page_list_attention_plain(q, twin, 1, *lists, lens, **kw,
                                             **band_kw)
    torch.testing.assert_close(out["ph"].float(), want_ph.float(),
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(out["band"].float(), want_band.float(),
                               rtol=5e-2, atol=5e-2)


def test_sparse_decode_window_graphs_match_eager(dev):
    """Ten window steps under sparse decode (refresh steps and reuse steps,
    a page boundary): the two replayed graphs give the eager loop's tokens,
    pool bytes, K stats and selection."""
    _sparse_window_case(dev, 4, True)


@pytest.mark.parametrize("mode", ["kv8", "pt4", "pt8", "kv16"])
def test_sparse_decode_window_kv_modes_graph_matches_eager(dev, mode):
    """The same over kv8, per-tensor and kv16 pools; per-tensor scales are
    loaded into both pools AFTER the graphs are captured, so the replayed
    steps must read them on the device."""
    kv_bits, fine = PSP_MODES.get(mode, (16, True))
    _sparse_window_case(dev, kv_bits, fine)


def _sparse_window_case(dev, kv_bits, kv_zeros):
    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda.decode_attention import list_mode
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool
    from omniserve_tpu_torch.worker.decode_window import DecodeWindow

    page = 128
    spec = llama.LlamaSpec(
        num_layers=2, hidden=512, intermediate=1024, num_q_heads=8,
        num_kv_heads=4, head_dim=128, vocab=1024, page_size=page,
        lm_head_bits=8, sparse_decode=True, sink_blocks=1, local_blocks=2,
        dec_sink_tokens=128, dec_local_tokens=256, budget_pages=3,
        selector_interval=4, kv_bits=kv_bits, kv_zeros=kv_zeros)
    flags = np.array([[True, True, False, False]] * 2)
    params = llama.make_random_packed_params(spec, seed=3, device=dev,
                                             retrieval_flags=flags)
    lens, b_pad, w = [5 * page - 4, 70, 2 * page + 1], 8, 6
    tables = np.zeros((b_pad, w), np.int32)
    tables[:3] = np.arange(3 * w).reshape(3, w)
    stables = np.zeros((b_pad, 3), np.int32)
    stables[:3] = np.arange(9).reshape(3, 3)
    kv = dict(kv_bits=kv_bits, kv_zeros=kv_zeros, device=dev)
    rpool = make_kv_pool(2, 3 * w + 1, 2, page, 128, with_stats=True, **kv)
    spool = make_kv_pool(2, 10, 2, page, 128, **kv)
    suffix = "_kv16" if kv_bits == 16 else list_mode(rpool, page)[2]
    qmax = 7 if kv_bits == 4 else 127
    scales = (torch.tensor([0.9, 1.1], device=dev) / qmax,
              torch.tensor([1.0, 0.8], device=dev) / qmax)

    def load_scales(*pools):
        for pool in pools:
            if pool.k_scale_per_tensor is not None:
                pool.k_scale_per_tensor.copy_(scales[0])
                pool.v_scale_per_tensor.copy_(scales[1])

    load_scales(rpool, spool)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, spec.vocab, n) for n in lens]

    def dev_i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    batch = llama.PrefillBatch(
        token_ids=torch.from_numpy(np.concatenate(prompts)).to(dev),
        positions=dev_i32(np.concatenate([np.arange(n) for n in lens])),
        segment_ids=dev_i32(np.concatenate(
            [np.full(n, i) for i, n in enumerate(lens)])),
        block_tables=dev_i32(tables[:3]),
        last_token_idx=torch.tensor(np.cumsum(lens) - 1, device=dev),
        seq_lens=dev_i32(lens), streaming_block_tables=dev_i32(stables[:3]),
        new_page_ids=dev_i32(tables[:3].reshape(-1)),
    )
    with torch.inference_mode():
        logits, _, _, _ = llama.llama_forward(params, rpool, spool, batch,
                                              spec, is_prefill=True)
        first = np.zeros(b_pad, np.int32)
        first[:3] = logits.argmax(-1).cpu().numpy()
        positions = np.zeros(b_pad, np.int32)
        positions[:3] = lens
        active = np.arange(b_pad) < 3
        toks, sels = {}, {}
        pools = {"graph": (rpool, spool),
                 "eager": (rpool.clone(), spool.clone())}
        for mode, (rp, sp) in pools.items():
            sel = torch.full((2, b_pad, 4, 3), -1, dtype=torch.int32,
                             device=dev)
            for pool in (rp, sp):       # captured at other (unit) scales
                if pool.k_scale_per_tensor is not None:
                    pool.k_scale_per_tensor.fill_(1.0)
                    pool.v_scale_per_tensor.fill_(1.0)
            win = DecodeWindow(params, rp, spec, b_pad, w, dev,
                               use_graph=mode == "graph", streaming_pool=sp,
                               page_idxes=sel)
            assert len(win.graphs) == (2 if mode == "graph" else 0)
            assert int(sel.max()) == -1            # capture left it alone
            load_scales(rp, sp)
            win.load(first, positions, active, tables, stables)
            before = dict(cuda.LAUNCHES)
            toks[mode] = win.run(10, refresh_first=True).cpu().numpy()
            assert win.refreshes_in(10, True) == 3
            for name, per_step in (("kv_append_decode" + suffix, 1),
                                   ("decode_attention_ph" + suffix, 1),
                                   ("decode_attention_band" + suffix, 1)):
                assert (cuda.LAUNCHES[name] - before[name]
                        == 10 * spec.num_layers * per_step), name
            sels[mode] = sel.cpu().numpy()
    np.testing.assert_array_equal(toks["graph"][:, :3], toks["eager"][:, :3])
    np.testing.assert_array_equal(sels["graph"][:, :3], sels["eager"][:, :3])
    assert (sels["graph"][:, 0, :2] >= 0).all()    # seq 0: budget used up
    for a, b_ in zip(pools["graph"], pools["eager"]):
        assert_pools_equal(a, b_, skip_trash=True)


# -- the precision matrix: per-group GEMM, kv8 pools -----------------------


def _per_group_weights(g, k, n, group_size, s2_max=17, layers=3):
    qw = torch.randint(0, 256, (layers, k // 2, n), generator=g,
                       dtype=torch.uint8, device=g.device)
    s1 = torch.empty((layers, n), device=g.device).uniform_(0.003, 0.006,
                                                            generator=g)
    s2 = torch.randint(1, s2_max + 1, (layers, k // group_size, n),
                       generator=g, dtype=torch.int8, device=g.device)
    s2z = torch.randint(-128, 128, s2.shape, generator=g, dtype=torch.int8,
                        device=g.device)
    return qw, s1, s2, s2z


@pytest.mark.parametrize("m,k,n,group_size", [
    (1, 256, 128, 32), (8, 512, 256, 128), (40, 1024, 384, 64),
    (300, 256, 68, 128), (130, 2048, 256, 128),
])
def test_w4a8_per_group_kernel(dev, m, k, n, group_size):
    """Exact against the plain version, with s2 up to 17 and zeros over the
    whole int8 range: the wrapped reconstruction included."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev, 7)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    qw, s1, s2, s2z = _per_group_weights(g, k, n, group_size)
    args = (a, qw[1], s1[1], s2[1], s2z[1], s)
    before = cuda.LAUNCHES["w4a8_matmul_per_group"]
    got = qm.w4a8_matmul_per_group(*args, group_size=group_size,
                                   out_dtype=torch.float32)
    assert cuda.LAUNCHES["w4a8_matmul_per_group"] == before + 1
    want = qm.w4a8_matmul_per_group_plain(*args, group_size=group_size,
                                          out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got16 = qm.w4a8_matmul_per_group(*args, group_size=group_size)
    torch.testing.assert_close(got16, want.bfloat16(), rtol=0, atol=0)


def test_w4a8_per_group_kernel_s2_17_edge(dev):
    """Every code 15 and every s2 17 (255 before the zero): zeros that wrap
    the int8 reconstruction both ways."""
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    m, k, n, gs = 16, 512, 128, 32
    g = _gen(dev, 8)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    qw = torch.full((k // 2, n), 0xFF, dtype=torch.uint8, device=dev)
    s1 = torch.full((n,), 0.004, device=dev)
    s2 = torch.full((k // gs, n), 17, dtype=torch.int8, device=dev)
    zeros = torch.tensor([-128, -8, 0, 100, 127], dtype=torch.int8,
                         device=dev)
    s2z = zeros[torch.randint(0, 5, s2.shape, generator=g, device=dev)]
    for mm in (m, 200):
        aa, ss = (a, s) if mm == m else quantize_activations(
            torch.randn((mm, k), generator=g, device=dev))[:2]
        got = qm.w4a8_matmul_per_group(aa, qw, s1, s2, s2z, ss,
                                       group_size=gs, out_dtype=torch.float32)
        want = qm.w4a8_matmul_per_group_plain(aa, qw, s1, s2, s2z, ss,
                                              group_size=gs,
                                              out_dtype=torch.float32)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_w4a8_per_group_kernel_refuses_bad_groups(dev):
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm

    m, k, n = 4, 512, 128
    a = torch.zeros((m, k), dtype=torch.int8, device=dev)
    qw = torch.zeros((k // 2, n), dtype=torch.uint8, device=dev)
    f, r = torch.ones(n, device=dev), torch.ones(m, device=dev)
    for gs in (16, 96):            # not a multiple of 32; not dividing K/2
        s2 = torch.ones((k // gs, n), dtype=torch.int8, device=dev)
        with pytest.raises(ValueError, match="group_size"):
            qm.w4a8_matmul_per_group(a, qw, f, s2, s2, r, group_size=gs)


def _kv8_pool(dev, g, layers, n_pages, h, page, d, lens, tables):
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    pool = make_kv_pool(layers, n_pages, h, page, d, kv_bits=8, device=dev)
    for s, n in enumerate(lens):
        if n <= 0:
            continue
        pos = torch.arange(n, device=dev)
        append_kv(pool, layers - 1,
                  torch.randn((n, h, d), generator=g, device=dev),
                  torch.randn((n, h, d), generator=g, device=dev),
                  tables[s].to(dev).long()[pos // page], pos % page, page,
                  8, True)
    return pool


@pytest.mark.parametrize("n_rep", [1, 4, 7])
def test_decode_attention_append_kv8_kernel(dev, n_rep):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    page, h, d, w = 128, 2, 128, 4
    lens = torch.tensor([2 * page + 17, page, 1, 0], dtype=torch.int32)
    b = len(lens)
    tables = torch.arange(b * w, dtype=torch.int32).view(b, w)
    tables[3] = 0
    g = _gen(dev, 9)
    pool = _kv8_pool(dev, g, 2, b * w + 1, h, page, d,
                     [int(n) - 1 for n in lens], tables)
    twin = pool.clone()
    q = torch.randn((b, h * n_rep, d), generator=g, device=dev).bfloat16()
    kn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    vn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    args = (tables.to(dev), lens.to(dev), kn, vn)
    before = cuda.LAUNCHES["decode_attention_append_kv8"]
    got = da.paged_decode_attention_fused(q, pool, 1, *args, sm_scale=0.1,
                                          page_size=page, kv_bits=8)
    assert cuda.LAUNCHES["decode_attention_append_kv8"] == before + 1
    want = da.paged_decode_attention_fused_plain(
        q, twin, 1, *args, sm_scale=0.1, page_size=page, kv_bits=8)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[3].abs().max()) == 0.0
    assert_pools_equal(pool, twin)


@pytest.mark.parametrize("history,chunk,n_rep,page,ragged", [
    (0, 24, 4, 16, False),
    (40, 24, 2, 16, True),
    (200, 130, 4, 128, False),
    (300, 64, 8, 128, True),
    (300, 64, 7, 128, True),
])
def test_paged_prefill_kv8_kernel(dev, history, chunk, n_rep, page, ragged):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    b, h, d = 2, 2, 128
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 10)
    tables = torch.arange(b * w, dtype=torch.int32).view(w, b).t()
    tables = tables.contiguous().to(dev)
    pool = _kv8_pool(dev, g, 2, b * w + 1, h, page, d, [total] * b, tables)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    if ragged:
        q_pos[1, chunk // 2:] = -1
        ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=8)
    before = dict(cuda.LAUNCHES)
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES["paged_prefill_kv8"] == \
        before["paged_prefill_kv8"] + 1
    assert cuda.LAUNCHES["paged_prefill_attention"] == \
        before["paged_prefill_attention"]
    want = pp.paged_prefill_attention_plain(q, pool, 1, tables, q_pos, ctx,
                                            **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if ragged:
        assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


@pytest.mark.parametrize("bits", [(4, 8, 128, 8, True), (8, 8, -1, 8, True),
                                  (16, 16, -1, 4, True),
                                  (16, 16, -1, 16, True),
                                  (8, 8, -1, 8, False)])
def test_decode_window_graph_matches_eager_precisions(dev, bits):
    """A captured decode step under per-group, W8A8 and W16A16 bodies and
    kv8, kv16 (the split append + list decode) and per-tensor pools replays
    the eager loop's tokens and pool bytes."""
    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool
    from omniserve_tpu_torch.worker.decode_window import DecodeWindow

    wb, ab, gs, kv, zeros = bits
    spec = llama.LlamaSpec(num_layers=2, hidden=512, intermediate=1024,
                           num_q_heads=4, num_kv_heads=2, head_dim=128,
                           vocab=1024, page_size=16, lm_head_bits=8,
                           weight_bits=wb, act_bits=ab, group_size=gs,
                           kv_bits=kv, kv_zeros=zeros)
    params = llama.make_random_packed_params(spec, seed=3, device=dev)
    lens, b_pad, w = [37, 5, 20], 8, 6
    tables = np.zeros((b_pad, w), np.int32)
    tables[:3] = np.arange(3 * w).reshape(3, w)
    pool = make_kv_pool(2, 3 * w + 1, 2, 16, 128, kv_bits=kv, kv_zeros=zeros,
                        device=dev)
    if not zeros:
        pool.k_scale_per_tensor.copy_(torch.tensor([0.02, 0.03]))
        pool.v_scale_per_tensor.copy_(torch.tensor([0.025, 0.02]))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, spec.vocab, n) for n in lens]
    batch = llama.PrefillBatch(
        token_ids=torch.from_numpy(np.concatenate(prompts)).to(dev),
        positions=torch.from_numpy(np.concatenate(
            [np.arange(n) for n in lens]).astype(np.int32)).to(dev),
        segment_ids=torch.from_numpy(np.concatenate(
            [np.full(n, i) for i, n in enumerate(lens)]).astype(
                np.int32)).to(dev),
        block_tables=torch.from_numpy(tables[:3]).to(dev),
        last_token_idx=torch.tensor(np.cumsum(lens) - 1, device=dev),
    )
    with torch.inference_mode():
        logits, _, _, _ = llama.llama_forward(params, pool, None, batch, spec,
                                              is_prefill=True)
        first = np.zeros(b_pad, np.int32)
        first[:3] = logits.argmax(-1).cpu().numpy()
        positions = np.zeros(b_pad, np.int32)
        positions[:3] = lens
        active = np.arange(b_pad) < 3
        twin = pool.clone()
        toks = {}
        for mode, p in (("graph", pool), ("eager", twin)):
            win = DecodeWindow(params, p, spec, b_pad, w, dev,
                               use_graph=mode == "graph")
            win.load(first, positions, active, tables)
            toks[mode] = win.run(6).cpu().numpy()
    np.testing.assert_array_equal(toks["graph"][:, :3], toks["eager"][:, :3])
    assert_pools_equal(pool, twin, skip_trash=True)


# -- kv16 and per-tensor KV ----------------------------------------------------


def _mode_pool(dev, g, mode, layers, n_pages, h, page, d, lens, tables):
    """A kv16 or per-tensor (kv4 / kv8, scales max |x| / qmax of N(0, 1))
    pool holding ``lens[s]`` random tokens of sequence s in its last
    layer."""
    from omniserve_tpu_torch.ops.paged_kv import append_kv, make_kv_pool

    kv_bits, zeros = {"kv16": (16, True), "pt4": (4, False),
                      "pt8": (8, False)}[mode]
    qmax = 7 if kv_bits == 4 else 127
    pool = make_kv_pool(
        layers, n_pages, h, page, d, kv_bits=kv_bits, kv_zeros=zeros,
        device=dev)
    if not zeros:
        pool.k_scale_per_tensor.copy_(torch.linspace(3.0, 3.6, layers) / qmax)
        pool.v_scale_per_tensor.copy_(torch.linspace(3.4, 3.2, layers) / qmax)
    for s, n in enumerate(lens):
        if n <= 0:
            continue
        pos = torch.arange(n, device=dev)
        append_kv(pool, layers - 1,
                  torch.randn((n, h, d), generator=g, device=dev),
                  torch.randn((n, h, d), generator=g, device=dev),
                  tables[s].to(dev).long()[pos // page], pos % page, page,
                  kv_bits, zeros)
    return pool, kv_bits, zeros


@pytest.mark.parametrize("n_rep,page", [(1, 128), (4, 128), (8, 16),
                                        (7, 128), (3, 16)])
def test_paged_mqa_attention_kv16_kernel(dev, n_rep, page):
    """Row 6's kv16 mode over the dense list against its plain version and
    against ``attention_ref.paged_decode_attention``; a row of length 0
    gives zeros."""
    from omniserve_tpu_torch.ops import attention_ref, cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    h, d, w = 2, 128, 20 if page == 16 else 4
    lens = torch.tensor([2 * page + 17, page, 1, 0], dtype=torch.int32)
    b = len(lens)
    tables = torch.randperm(b * w, generator=torch.Generator().manual_seed(
        1)).view(b, w).to(torch.int32)
    g = _gen(dev, 11)
    pool, _, _ = _mode_pool(dev, g, "kv16", 2, b * w + 1, h, page, d,
                            lens.tolist(), tables)
    q = torch.randn((b, h, n_rep, d), generator=g, device=dev).bfloat16()
    lists = da.dense_page_lists(tables.to(dev), lens.to(dev), page)
    kw = dict(sm_scale=0.1, page_size=page)
    before = cuda.LAUNCHES["paged_mqa_attention_kv16"]
    got = da.paged_mqa_attention(q, pool, 1, *lists, lens.to(dev), **kw)
    assert cuda.LAUNCHES["paged_mqa_attention_kv16"] == before + 1
    want = da.page_list_attention_plain(q, pool, 1, *lists, lens.to(dev),
                                        **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    ref = attention_ref.paged_decode_attention(
        q.reshape(b, h * n_rep, d), pool, 1, tables.to(dev), lens.to(dev),
        0.1, page, 16, True)
    torch.testing.assert_close(got.reshape(b, h * n_rep, d).float(),
                               ref.float(), rtol=5e-2, atol=5e-2)
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_append_decode_kv16_kernel(dev, dtype):
    """kv16 appends (two tokens inactive): pool bytes equal the plain
    version's on every page but the trash page."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import kv_append as ka
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool

    page, d, t, heads = 128, 128, 8, 4
    g = _gen(dev, 12)
    pool = make_kv_pool(2, 13, heads, page, d, kv_bits=16, device=dev)
    for x in (pool.k_data, pool.v_data):      # recycled pages are dirty
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    twin = pool.clone()
    pages = torch.tensor([4, 9, -1, 0, 7, -1, 2, 10], dtype=torch.int32,
                         device=dev)
    for step, slot0 in enumerate((5, 64, 127)):
        slots = ((slot0 + torch.arange(t) * 17) % page).to(torch.int32).to(dev)
        k = torch.randn((t, heads, d), generator=g, device=dev).to(dtype)
        v = torch.randn((t, heads, d), generator=g, device=dev).to(dtype)
        before = dict(cuda.LAUNCHES)
        ka.append_kv_decode(pool, step % 2, k, v, pages, slots, page)
        assert cuda.LAUNCHES["kv_append_decode_kv16"] == \
            before["kv_append_decode_kv16"] + 1
        assert cuda.LAUNCHES["kv_append_decode"] == before["kv_append_decode"]
        ka.append_kv_decode_plain(twin, step % 2, k, v, pages, slots, page,
                                  kv_bits=16)
    torch.cuda.synchronize()
    assert_pools_equal(pool, twin, skip_trash=True)


def _kv16_pool(dev, g, layers, n_pages, h, page, d=128, with_stats=False):
    """A kv16 pool of N(0, 1) bf16 values (recycled pages are dirty), with
    random K stats when ``with_stats``."""
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool

    pool = make_kv_pool(layers, n_pages, h, page, d, kv_bits=16,
                        with_stats=with_stats, device=dev)
    for x in (pool.k_data, pool.v_data) + ((pool.k_stats,) if with_stats
                                           else ()):
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    return pool


KV16_LIST_TOL = 1e-2


def _gate_refuses(got, want, planted):
    """``got`` within KV16_LIST_TOL of the plain output ``want``, and each
    of ``planted`` ((label, the plain output with a fault planted in its
    inputs)) outside it."""
    torch.testing.assert_close(got.float(), want.float(), rtol=KV16_LIST_TOL,
                               atol=KV16_LIST_TOL)
    for what, bad in planted:
        assert not torch.allclose(bad.float(), want.float(),
                                  rtol=KV16_LIST_TOL,
                                  atol=KV16_LIST_TOL), what


@pytest.mark.parametrize("page", [128, 256])
@pytest.mark.parametrize("n_rep", [4, 7])
def test_decode_attention_kv16_lists_kernel(dev, n_rep, page):
    """Row 6's kv16 modes of LServe's decode. Per-head lists in no order
    with dead entries, a context inside a listed page, an all-dead list and
    an inactive row; then the ring's band list (wrapped mid page and on a
    page boundary, inside the sink page, inactive). NaN planted in the
    never-written rows past each context must stay behind the mask.
    Launches counted as ``decode_attention_ph_kv16`` /
    ``decode_attention_band_kv16``; the gate refuses the plain version with
    the lengths a page short, and with the band's window moved by a
    page."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    h, d, n_pages = 2, 128, 24
    g = _gen(dev, 35)
    pool = _kv16_pool(dev, g, 2, n_pages + 1, h, page)
    lens = [5 * page + 9, 3 * page, 2 * page + 60, 0]
    sel_logic = torch.tensor([
        [[5, 0, 3, -1, 1], [5, 4, -1, 2, 0]],
        [[2, 1, 0, -1, -1], [2, -1, 0, -1, -1]],
        [[-1, -1, -1, -1, -1], [2, 1, 0, -1, -1]],
        [[0, 1, -1, -1, -1], [0, -1, -1, -1, -1]],
    ], dtype=torch.int32)
    # logical page p of row r lives in physical page p + 6 r
    for s, n in enumerate(lens):
        if n > 0 and n % page:
            phys = (n - 1) // page + 6 * s
            pool.k_data[1, phys, :, n % page:] = float("nan")
            pool.v_data[1, phys, :, n % page:] = float("nan")
    sel_phys = torch.where(
        sel_logic >= 0, sel_logic + 6 * torch.arange(4)[:, None, None], 0,
    ).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((4, h, n_rep, d), generator=g, device=dev).bfloat16()
    lists = (sel_phys.to(dev), sel_logic.to(dev))
    kw = dict(sm_scale=d ** -0.5, page_size=page)
    before = dict(cuda.LAUNCHES)
    got = da.paged_mqa_attention_ph(q, pool, 1, *lists, lens_t, **kw)
    assert cuda.LAUNCHES["decode_attention_ph_kv16"] == \
        before["decode_attention_ph_kv16"] + 1
    assert cuda.LAUNCHES["paged_mqa_attention_kv16"] == \
        before["paged_mqa_attention_kv16"]
    want = da.page_list_attention_plain(q, pool, 1, *lists, lens_t, **kw)
    short = da.page_list_attention_plain(q, pool, 1, *lists,
                                         (lens_t - page).clamp(min=0), **kw)
    _gate_refuses(got, want, [("lengths a page short", short)])
    assert float(got[2, 0].abs().max()) == 0.0      # all-dead list
    assert float(got[3].abs().max()) == 0.0         # inactive row
    assert float(got[2, 1].abs().max()) > 0.0
    assert torch.isfinite(got.float()).all()

    # the ring's band: 1 sink + 2 ring pages per sequence
    b = 4
    slens = torch.tensor([5 * page + 37, 4 * page, 90, 0],
                         dtype=torch.int32, device=dev)
    spool = _kv16_pool(dev, g, 2, 3 * b + 1, h, page)
    stables = torch.arange(3 * b, dtype=torch.int32, device=dev).view(b, 3)
    # row 2's sink page past its 90 tokens was never written
    spool.k_data[1, int(stables[2, 0]), :, 90:] = float("nan")
    spool.v_data[1, int(stables[2, 0]), :, 90:] = float("nan")
    sel_phys, sel_logic, span = da.streaming_page_lists(
        stables, slens, 1, page, 2 * page)
    q = torch.randn((b, h, n_rep, d), generator=g, device=dev).bfloat16()
    kw = dict(sm_scale=d ** -0.5, page_size=page, band_sink_tokens=page,
              band_local_tokens=2 * page, ring_span_pages=span,
              ring_sink_tokens=page)
    args = (q, spool, 1, sel_phys, sel_logic, slens)
    before = cuda.LAUNCHES["decode_attention_band_kv16"]
    got = da.paged_mqa_attention_band(*args, **kw)
    assert cuda.LAUNCHES["decode_attention_band_kv16"] == before + 1
    want = da.page_list_attention_plain(*args, **kw)
    _gate_refuses(got, want, [("the band's window moved by a page",
                               da.page_list_attention_plain(*args, **dict(
                                   kw, band_local_tokens=page)))])
    assert float(got[3].abs().max()) == 0.0
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("page,n_rep", [(128, 4), (256, 4), (128, 7),
                                        (256, 7)])
def test_paged_prefill_ring_kv16_kernel(dev, page, n_rep):
    """Row 7's page list with the ring relabel and the band over kv16
    pages: two sequences wrapped several times, one padded halfway, stale
    rows past the write head, a retrieval head beside a streaming one;
    launches counted as ``paged_prefill_ring_kv16``; the gate refuses the
    plain version with the band's local window moved by a page."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import ring_logical_blocks

    lens, chunk, sink_b, local_b = [20 * page + 37, 15 * page + 50], 128, 1, 6
    b, h, d = len(lens), 2, 128
    n_slots = sink_b + local_b
    g = _gen(dev, 36)
    pool = _kv16_pool(dev, g, 1, b * n_slots + 1, h, page)
    tables = torch.randperm(b * n_slots, generator=g, device=dev).view(
        b, n_slots).to(torch.int32)
    ctx = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.stack([n - chunk + torch.arange(chunk, dtype=torch.int32)
                         for n in lens])
    q_pos[1] = lens[1] - chunk // 2 + torch.arange(chunk, dtype=torch.int32)
    q_pos[1, chunk // 2:] = -1
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    sel = ring_logical_blocks(ctx, n_slots, sink_b, local_b, page)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=16, kv_zeros=True,
              sel_logic=sel, ring_span_pages=local_b,
              ring_sink_tokens=sink_b * page,
              head_is_retrieval=torch.tensor(
                  [True] * n_rep + [False] * n_rep, device=dev),
              sink_size=page, local_size=3 * page)
    before = cuda.LAUNCHES["paged_prefill_ring_kv16"]
    got = pp.paged_prefill_attention(q, pool, 0, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES["paged_prefill_ring_kv16"] == before + 1
    want = pp.paged_prefill_attention_plain(q, pool, 0, tables, q_pos, ctx,
                                            **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float(got[1, chunk // 2:].float().abs().max()) == 0.0
    bad = pp.paged_prefill_attention_plain(q, pool, 0, tables, q_pos, ctx,
                                           **dict(kw, local_size=2 * page))
    assert not torch.allclose(bad.float(), want.float(), rtol=2e-2,
                              atol=2e-2)


@pytest.mark.parametrize("mode,n_rep", [("pt4", 1), ("pt4", 4), ("pt8", 4),
                                        ("pt4", 7), ("pt8", 3)])
def test_decode_attention_append_pt_kernel(dev, mode, n_rep):
    """The per-tensor fused decode against its plain version: outputs within
    5e-2, pool bytes equal (the codes of the appended token included)."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    page, h, d, w = 128, 2, 128, 4
    lens = torch.tensor([2 * page + 17, page, 1, 0], dtype=torch.int32)
    b = len(lens)
    tables = torch.arange(b * w, dtype=torch.int32).view(b, w)
    tables[3] = 0
    g = _gen(dev, 13)
    pool, kv_bits, _ = _mode_pool(dev, g, mode, 2, b * w + 1, h, page, d,
                                  [int(n) - 1 for n in lens], tables)
    twin = pool.clone()
    q = torch.randn((b, h * n_rep, d), generator=g, device=dev).bfloat16()
    kn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    vn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    args = (tables.to(dev), lens.to(dev), kn, vn)
    before = cuda.LAUNCHES["decode_attention_append_pt"]
    got = da.paged_decode_attention_fused(q, pool, 1, *args, sm_scale=0.1,
                                          page_size=page, kv_bits=kv_bits)
    assert cuda.LAUNCHES["decode_attention_append_pt"] == before + 1
    want = da.paged_decode_attention_fused_plain(
        q, twin, 1, *args, sm_scale=0.1, page_size=page, kv_bits=kv_bits,
        kv_zeros=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    assert float(got[3].abs().max()) == 0.0
    assert_pools_equal(pool, twin)


@pytest.mark.parametrize("mode", ["kv16", "pt4", "pt8"])
@pytest.mark.parametrize("history,chunk,n_rep,page,ragged", [
    (40, 24, 2, 16, True),
    (300, 64, 8, 128, True),
    (300, 64, 7, 128, True),
])
def test_paged_prefill_kv16_pt_kernel(dev, mode, history, chunk, n_rep, page,
                                      ragged):
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    b, h, d = 2, 2, 128
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 14)
    tables = torch.arange(b * w, dtype=torch.int32).view(w, b).t()
    tables = tables.contiguous().to(dev)
    pool, kv_bits, zeros = _mode_pool(dev, g, mode, 2, b * w + 1, h, page, d,
                                      [total] * b, tables)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    if ragged:
        q_pos[1, chunk // 2:] = -1
        ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=zeros)
    name = "paged_prefill_kv16" if mode == "kv16" else "paged_prefill_pt"
    before = cuda.LAUNCHES[name]
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = pp.paged_prefill_attention_plain(q, pool, 1, tables, q_pos, ctx,
                                            **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if ragged:
        assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


def test_kv16_values_beyond_f16_range(dev):
    """kv16 pages hold bf16 values f16 cannot: paged prefill and the list
    decode keep them (a V value of 1e5 at position 19 reaches every row
    that sees it)."""
    from omniserve_tpu_torch.ops.cuda import decode_attention as da
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    page, h, d, b = 16, 1, 128, 1
    g = _gen(dev, 15)
    tables = torch.arange(3, dtype=torch.int32).view(1, 3).to(dev)
    pool, _, _ = _mode_pool(dev, g, "kv16", 1, 4, h, page, d, [40], tables)
    pool.v_data[0, 1, 0, 3] = 1e5             # position 19's value
    q = torch.randn((b, 8, h, d), generator=g, device=dev).bfloat16()
    q_pos = (32 + torch.arange(8, dtype=torch.int32)).view(1, 8).to(dev)
    ctx = torch.tensor([40], dtype=torch.int32, device=dev)
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=16)
    got = pp.paged_prefill_attention(q, pool, 0, tables, q_pos, ctx, **kw)
    want = pp.paged_prefill_attention_plain(q, pool, 0, tables, q_pos, ctx,
                                            **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    lists = da.dense_page_lists(tables, ctx, page)
    qd = q[:, 0].reshape(1, h, 1, d)
    got_d = da.paged_mqa_attention(qd, pool, 0, *lists, ctx,
                                        sm_scale=0.1, page_size=page)
    want_d = da.page_list_attention_plain(qd, pool, 0, *lists, ctx,
                                          sm_scale=0.1, page_size=page)
    assert bool(torch.isfinite(got_d).all())
    torch.testing.assert_close(got_d.float(), want_d.float(), rtol=5e-2,
                               atol=5e-2)


# -- row 8: single-pass prefill in the integer domain ------------------------

PSP_MODES = {"kv4": (4, True), "kv8": (8, True), "pt4": (4, False),
             "pt8": (8, False)}


def _codes_pool(dev, g, mode, layers, n_pages, h, page, d=128):
    """A kv4 / kv8 pool of random codes, with folded planes (scales in
    [0.1, 0.4] / 2**(kv_bits - 4), integer zeros within the levels) or
    per-tensor scales (3.5 / qmax, 3.0 / qmax per layer)."""
    from omniserve_tpu_torch.ops.paged_kv import KVPool

    kv_bits, fine = PSP_MODES[mode]
    rows = page // 2 if kv_bits == 4 else page
    k, v = (torch.randint(0, 256, (layers, n_pages, h, rows, d), generator=g,
                          dtype=torch.uint8, device=dev) for _ in range(2))
    if not fine:
        qmax = 7 if kv_bits == 4 else 127
        return KVPool(k, v, None,
                      k_scale_per_tensor=torch.full((layers,), 3.5 / qmax,
                                                    device=dev),
                      v_scale_per_tensor=torch.full((layers,), 3.0 / qmax,
                                                    device=dev))
    levels = 2 ** kv_bits
    lo, hi = 0.1 * 16 / levels, 0.4 * 16 / levels
    shape = (layers, n_pages, h, page)
    ks, vs = (torch.empty(shape, device=dev).uniform_(lo, hi, generator=g)
              for _ in range(2))
    kz, vz = (torch.randint(0, levels, shape, generator=g, device=dev).float()
              for _ in range(2))
    planes = torch.stack([ks, ks * (kz + 128.0), vs, vz + 128.0], dim=2)
    return KVPool(k, v, planes.contiguous())


def _check_psp(pool, layer, tables, q_pos, ctx, q, name, plain_pool=None,
               **kw):
    """Row 8 launched once under ``name`` and within 2e-2 of its plain
    version (run on ``plain_pool`` where given: the same pool without the
    garbage planted past the contexts)."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

    before = cuda.LAUNCHES[name]
    got = psp.paged_prefill_single_pass(q, pool, layer, tables, q_pos, ctx,
                                        **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = psp.paged_prefill_single_pass_plain(
        q, pool if plain_pool is None else plain_pool, layer, tables, q_pos,
        ctx, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    return got


@pytest.mark.parametrize("mode", list(PSP_MODES))
@pytest.mark.parametrize("history,chunk,n_rep,page,ragged", [
    (0, 24, 4, 128, False),      # first chunk, one page
    (200, 130, 2, 128, True),    # the chunk spans pages; a row padded
    (300, 64, 8, 256, True),     # 256-token pages: two units a page
    (1000, 96, 1, 128, False),   # history over eight pages
    # pages of an odd multiple of 128: under kv4 a 64-key sub-tile of a
    # unit lies in the page's first (low nibble) or second (high) half
    (500, 300, 2, 384, True),
    (700, 100, 4, 640, False),
])
def test_prefill_single_pass_kernel(dev, mode, history, chunk, n_rep, page,
                                    ragged):
    """Dense table, each mode; the planes past each context are NaN (the
    kernel must mask before it multiplies)."""
    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

    b, h, d = 2, 2, 128
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 21)
    pool = _codes_pool(dev, g, mode, 2, b * w + 1, h, page, d)
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    if ragged:
        q_pos[1, chunk // 2:] = -1
        ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    kv_bits, fine = PSP_MODES[mode]
    clean = pool.clone()
    if fine:
        for s in range(b):
            n = int(ctx[s])
            last = int(tables[s, (n - 1) // page])
            pool.kv_scales[1, last, :, :, (n - 1) % page + 1:] = float("nan")
    got = _check_psp(pool, 1, tables, q_pos, ctx, q,
                     psp.launch_name(kv_bits, fine, False), plain_pool=clean,
                     sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
                     kv_zeros=fine)
    if ragged:
        assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


@pytest.mark.parametrize("mode", list(PSP_MODES))
def test_prefill_single_pass_page_list_kernel(dev, mode):
    """An explicit page list without a ring (slots in any order, dead
    slots), one retrieval and one streaming kv head."""
    page, h, d, n_rep = 128, 2, 128, 4
    g = _gen(dev, 22)
    pool = _codes_pool(dev, g, mode, 1, 13, h, page, d)
    tables = torch.tensor([[3, 9, 0, 5, 11, 7], [1, 4, 10, 2, 8, 6]],
                          dtype=torch.int32, device=dev)
    sel = torch.tensor([[0, 3, 1, -1, 4, 2], [5, -1, 0, 1, -1, 2]],
                       dtype=torch.int32, device=dev)
    ctx = torch.tensor([640, 760], dtype=torch.int32, device=dev)
    q_pos = torch.stack([torch.arange(384, 640), torch.arange(504, 760)]).to(
        device=dev, dtype=torch.int32)
    q = torch.randn((2, 256, h * n_rep, d), generator=g, device=dev).bfloat16()
    kv_bits, fine = PSP_MODES[mode]
    _check_psp(pool, 0, tables, q_pos, ctx, q,
               "paged_prefill_single_pass_list", sm_scale=d ** -0.5,
               page_size=page, kv_bits=kv_bits, kv_zeros=fine, sel_logic=sel,
               head_is_retrieval=torch.tensor([True] * n_rep + [False] * n_rep,
                                              device=dev),
               sink_size=64, local_size=160)


@pytest.mark.parametrize("mode", list(PSP_MODES))
@pytest.mark.parametrize("lens,chunk,sink_b,local_b,n_rep,band", [
    # chip_smoke's wrapped ring: 1 + 80 pages, context 20,000 (stale rows
    # past the write head), a 2,048-token chunk
    ([20000], 2048, 1, 80, 4, (128, 8192)),
    # two sequences wrapped several times, one padded halfway
    ([3000, 2290], 256, 1, 6, 2, (128, 512)),
    ([3000, 2290], 256, 1, 6, 7, (128, 512)),   # a GQA group of 7
])
def test_prefill_single_pass_ring_kernel(dev, mode, lens, chunk, sink_b,
                                         local_b, n_rep, band):
    from omniserve_tpu_torch.ops.paged_kv import ring_logical_blocks

    b, h, d, page = len(lens), 2, 128, 128
    n_slots = sink_b + local_b
    g = _gen(dev, 23)
    pool = _codes_pool(dev, g, mode, 1, b * n_slots + 1, h, page, d)
    tables = torch.randperm(b * n_slots, generator=g, device=dev).view(
        b, n_slots).to(torch.int32)
    ctx = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.stack([n - chunk + torch.arange(chunk, dtype=torch.int32)
                         for n in lens])
    if b > 1:
        q_pos[1] = lens[1] - chunk // 2 + torch.arange(chunk,
                                                        dtype=torch.int32)
        q_pos[1, chunk // 2:] = -1
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    sel = ring_logical_blocks(ctx, n_slots, sink_b, local_b, page)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    kv_bits, fine = PSP_MODES[mode]
    got = _check_psp(
        pool, 0, tables, q_pos, ctx, q, "paged_prefill_single_pass_list",
        sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits, kv_zeros=fine,
        sel_logic=sel, ring_span_pages=local_b, ring_sink_tokens=sink_b * page,
        head_is_retrieval=torch.zeros(h * n_rep, dtype=torch.bool,
                                      device=dev),
        sink_size=band[0], local_size=band[1])
    if b > 1:
        assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


def test_prefill_single_pass_band_dense_kernel(dev):
    """The sink + local band over a dense table (kv head 1 streaming): the
    units outside every row's band are skipped, the rest attended."""
    page, h, d, n_rep, b = 128, 2, 128, 4, 1
    total, chunk = 4096, 512
    w = total // page
    g = _gen(dev, 24)
    pool = _codes_pool(dev, g, "kv4", 1, w + 1, h, page, d)
    tables = torch.randperm(w, generator=g, device=dev).view(1, w).to(
        torch.int32)
    q_pos = (total - chunk + torch.arange(chunk, dtype=torch.int32,
                                          device=dev))[None]
    ctx = torch.tensor([total], dtype=torch.int32, device=dev)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    _check_psp(pool, 0, tables, q_pos, ctx, q,
               "paged_prefill_single_pass_list", sm_scale=d ** -0.5,
               page_size=page, kv_bits=4, kv_zeros=True,
               head_is_retrieval=torch.tensor([True] * n_rep + [False] * n_rep,
                                              device=dev),
               sink_size=128, local_size=1000)


@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("page", [128, 256, 384])
@pytest.mark.parametrize("mode", list(PSP_MODES))
def test_prefill_single_pass_pages_and_reps_kernel(dev, mode, page, n_rep):
    """Row 8 on the wgmma core over a dense table in every mode, at pages
    of 128, 256 and 384 tokens (under kv4 a 64-key tile of a 384-token
    page lies in the page's first or second half: its own rows and
    nibble) and every GQA width; the chunk ends inside a tile of 128 rows
    and the second row is padded halfway; past each context the pool holds
    garbage (NaN planes, 0xFF codes) that the kernel must keep out of
    every product: its plain version runs on the clean pool. Also within
    1e-2 of each row's norm."""
    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

    b, h, d, chunk = 2, 2, 128, 150
    history = 2 * page + 37
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 43)
    pool = _codes_pool(dev, g, mode, 2, b * w + 1, h, page, d)
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    q_pos[1, chunk // 2:] = -1
    ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    kv_bits, fine = PSP_MODES[mode]
    clean = pool.clone()
    _plant_past_context(pool, 1, page, ctx, tables, kv_bits, fine)
    got = _check_psp(pool, 1, tables, q_pos, ctx, q,
                     psp.launch_name(kv_bits, fine, False), plain_pool=clean,
                     sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
                     kv_zeros=fine)
    assert float(got[1, chunk // 2:].float().abs().max()) == 0.0
    want = psp.paged_prefill_single_pass_plain(
        q, clean, 1, tables, q_pos, ctx, sm_scale=d ** -0.5, page_size=page,
        kv_bits=kv_bits, kv_zeros=fine).float()
    err = torch.linalg.vector_norm(got.float() - want, dim=-1)
    assert bool((err <= 1e-2 * torch.linalg.vector_norm(want, dim=-1)
                 + 1e-6).all())


@pytest.mark.parametrize("page", [128, 384])
@pytest.mark.parametrize("mode", list(PSP_MODES))
def test_prefill_single_pass_page_list_dead_slots_kernel(dev, mode, page):
    """Row 8's page-list mode at pages of 128 and 384: slots in any order,
    dead slots whose pages hold NaN planes and 0xFF codes, logical pages
    left out of the list, garbage past each context; one retrieval and one
    streaming kv head with sink and band edges inside tiles."""
    h, d, n_rep, chunk = 2, 128, 4, 200
    g = _gen(dev, 44)
    pool = _codes_pool(dev, g, mode, 1, 13, h, page, d)
    tables = torch.tensor([[3, 9, 0, 5, 11, 7], [1, 4, 10, 2, 8, 6]],
                          dtype=torch.int32, device=dev)
    sel = torch.tensor([[0, 3, 1, -1, 4, 2], [5, -1, 0, 1, -1, 2]],
                       dtype=torch.int32, device=dev)
    ctx = torch.tensor([5 * page - 20, 5 * page + 50], dtype=torch.int32,
                       device=dev)
    q_pos = torch.stack([int(n) - chunk + torch.arange(chunk)
                         for n in ctx.tolist()]).to(device=dev,
                                                    dtype=torch.int32)
    q = torch.randn((2, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    kv_bits, fine = PSP_MODES[mode]
    clean = pool.clone()
    for s, slot in ((0, 3), (1, 1), (1, 4)):        # the dead slots' pages
        phys = int(tables[s, slot])
        if fine:
            pool.kv_scales[0, phys] = float("nan")
        pool.k_data[0, phys] = 255
        pool.v_data[0, phys] = 255
    # past each context: the last listed page's tail
    for s, (last_logic, first) in enumerate(((4, page - 20), (5, 50))):
        phys = int(tables[s, sel[s].tolist().index(last_logic)])
        if fine:
            pool.kv_scales[0, phys, :, :, first:] = float("nan")
    _check_psp(pool, 0, tables, q_pos, ctx, q,
               "paged_prefill_single_pass_list", plain_pool=clean,
               sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
               kv_zeros=fine, sel_logic=sel,
               head_is_retrieval=torch.tensor([True] * n_rep + [False] * n_rep,
                                              device=dev),
               sink_size=40, local_size=150)


ROW_TAIL = 5e-3   # half of chip_smoke's 1e-2-of-the-row gate


def _emulate_single_pass(args, kw, p_dtype):
    """The single-pass algorithm in f32 over the dequantized pages: P times
    the key's V scale (per tensor: P) rounded to ``p_dtype`` and multiplied
    by the V codes, the zero (bias) corrected after P.V, the output rounded
    to bf16. Returns [B, Tc, Hq, D] f32."""
    from omniserve_tpu_torch.ops.paged_kv import gather_kv_for_seq

    q, pool, layer, tables, q_pos, ctx = args
    page, kv_bits, fine = kw["page_size"], kw["kv_bits"], kw["kv_zeros"]
    b, hkv = q.shape[0], pool.k_data.shape[2]
    n_rep = q.shape[2] // hkv
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    k, v = gather_kv_for_seq(pool, layer, tables, page, kv_bits, fine)
    if fine:
        planes = pool.kv_scales[layer][tables.long()]    # [B, W, 4, H, page]
        vs = planes[:, :, 2].permute(0, 1, 3, 2).reshape(b, -1, hkv)
        vz = planes[:, :, 3].permute(0, 1, 3, 2).reshape(b, -1, hkv) - 128.0
        v_mul = 1.0
    else:
        v_mul = pool.v_scale_per_tensor[layer]
        vs = torch.ones(v.shape[:3], device=q.device) * v_mul
        vz = torch.full_like(vs, 128.0 if kv_bits == 8 else 8.0)
    codes = torch.round(v / vs[..., None] + vz[..., None])
    if not fine:
        vs = torch.ones_like(vs)          # P alone is rounded, pt_v after
    kp = torch.arange(k.shape[1], device=q.device)
    for i in range(b):
        kf = k[i].repeat_interleave(n_rep, 1)
        sc = torch.einsum("qhd,khd->hqk", q[i].float(), kf) * kw["sm_scale"]
        mask = (kp[None, :] <= q_pos[i][:, None].long()) & (kp < ctx[i])
        sc = sc.masked_fill(~mask[None], float("-inf"))
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        pv = (p * vs[i].repeat_interleave(n_rep, 1).t()[:, None, :]).to(
            p_dtype).float()
        zf = vz[i].repeat_interleave(n_rep, 1).t()[:, None, :]
        o = (torch.einsum("hqk,khd->qhd", pv,
                          codes[i].repeat_interleave(n_rep, 1))
             - (pv * zf).sum(-1).t()[..., None]) * v_mul
        out[i] = (o / p.sum(-1).t()[..., None]).to(torch.bfloat16).float()
    return out


@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt8"])
def test_prefill_single_pass_row_error_tail(dev, mode):
    """Why row 8 rounds P to f16 where the TPU kernel rounds it to bf16, at
    the bench's last chunk (128 sequences x 128 queries after 896 tokens,
    Llama-3-8B heads, 524,288 (token, q head) rows): the kernel's largest
    row error against its plain version stays within ``ROW_TAIL`` of the
    row's norm and within 1.5x of the algorithm emulated with f16 P, and,
    over fine-grained pools (P times each key's V scale is what is
    rounded), the same emulation with bf16 P has a tail over 2x as large
    (it comes near chip_smoke's 1e-2 gate). Prints the three largest row
    errors (run with ``-s`` to read them)."""
    import json

    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

    b, h, n_rep, d, page, history, tc = 128, 8, 4, 128, 128, 896, 128
    w = (history + tc) // page
    g = _gen(dev, 28)
    pool = _codes_pool(dev, g, mode, 1, b * w + 1, h, page, d)
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    q = torch.randn((b, tc, h * n_rep, d), generator=g, device=dev).bfloat16()
    q_pos = (history + torch.arange(tc, dtype=torch.int32, device=dev)
             ).repeat(b, 1)
    ctx = torch.full((b,), history + tc, dtype=torch.int32, device=dev)
    kv_bits, fine = PSP_MODES[mode]
    args = (q, pool, 0, tables, q_pos, ctx)
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=fine)
    want = psp.paged_prefill_single_pass_plain(*args, **kw)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)

    def tail(got):
        return float((torch.linalg.vector_norm(got.float() - want, dim=-1)
                      / den).max())

    err = {"kernel": tail(psp.paged_prefill_single_pass(*args, **kw)),
           "f16 P": tail(_emulate_single_pass(args, kw, torch.float16)),
           "bf16 P": tail(_emulate_single_pass(args, kw, torch.bfloat16))}
    print(json.dumps({"pool": mode, "card": torch.cuda.get_device_name(0),
                      "largest row error": err}))
    assert err["kernel"] <= ROW_TAIL, err
    assert err["kernel"] <= 1.5 * err["f16 P"], err
    if fine:
        assert err["bf16 P"] > 2 * err["f16 P"], err


def test_prefill_single_pass_refuses_bad_inputs(dev):
    from omniserve_tpu_torch.ops.cuda import prefill_single_pass as psp

    g = _gen(dev, 25)
    pool = _codes_pool(dev, g, "kv4", 1, 3, 2, 64)
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16, device=dev)
    args = (q, pool, 0, torch.zeros((1, 2), dtype=torch.int32, device=dev),
            torch.arange(8, dtype=torch.int32, device=dev)[None],
            torch.tensor([8], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="multiple of 128"):
        psp.paged_prefill_single_pass(*args, sm_scale=0.1, page_size=64)


# -- row 11: the decode step's embedding gather ------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embed_gather_kernel(dev, dtype, id_dtype):
    """Equal bytes to the plain version, eagerly and replayed from a
    captured CUDA graph (new ids copied into the captured buffer), with a
    negative id and an id of V among the ids."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import embed_gather as eg

    g = _gen(dev, 26)
    v, d = 1000, 4096 if dtype == torch.bfloat16 else 256
    table = torch.randn((v, d), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, v, (24,), generator=g, device=dev).to(id_dtype)
    ids[3], ids[7] = -5, v
    before = cuda.LAUNCHES["embed_gather"]
    got = eg.embed_gather(table, ids)
    assert cuda.LAUNCHES["embed_gather"] == before + 1
    want = eg.embed_gather_plain(table, ids)
    assert torch.equal(got, want)
    assert torch.equal(got[3], table[0]) and torch.equal(got[7], table[-1])
    static = ids.clone()
    eg.embed_gather(table, static)      # loads the module before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = eg.embed_gather(table, static)
    for seed in (1, 2):
        new = torch.randint(-3, v + 3, (24,), generator=_gen(dev, seed),
                            device=dev).to(id_dtype)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eg.embed_gather_plain(table, new))


def test_dispatch_switches_choose_rows_8_and_11(dev, monkeypatch):
    """Row 7 and ``table[ids]`` with the switches off (the default); rows 8
    and 11 with them on, and the same results within the kernels' gates."""
    from omniserve_tpu_torch.ops import cuda, dispatch

    page, h, d, n_rep, b, chunk, history = 128, 2, 128, 4, 2, 64, 300
    w = -(-(history + chunk) // page)
    g = _gen(dev, 27)
    pool = _codes_pool(dev, g, "kv4", 1, b * w + 1, h, page, d)
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    q_pos = (history + torch.arange(chunk, dtype=torch.int32,
                                    device=dev)).repeat(b, 1)
    ctx = torch.full((b,), history + chunk, dtype=torch.int32, device=dev)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    table = torch.randn((500, 256), generator=g, device=dev).bfloat16()
    ids = torch.randint(0, 500, (8,), generator=g, device=dev)
    args = (q, pool, 0, tables, q_pos, ctx, d ** -0.5, page, 4, True)
    names = ("paged_prefill_attention", "paged_prefill_single_pass",
             "embed_gather")

    def run():
        before = {k: cuda.LAUNCHES[k] for k in names}
        out = dispatch.paged_prefill_attention(*args)
        emb = dispatch.embed_lookup(table, ids)
        return out, emb, {k: cuda.LAUNCHES[k] - before[k] for k in names}

    for var in ("OMNISERVE_PREFILL_SINGLE_PASS", "OMNISERVE_EMBED_DMA"):
        monkeypatch.delenv(var, raising=False)
    off, emb_off, n_off = run()
    assert n_off == {"paged_prefill_attention": 1,
                     "paged_prefill_single_pass": 0, "embed_gather": 0}
    monkeypatch.setenv("OMNISERVE_PREFILL_SINGLE_PASS", "1")
    monkeypatch.setenv("OMNISERVE_EMBED_DMA", "1")
    on, emb_on, n_on = run()
    assert n_on == {"paged_prefill_attention": 0,
                    "paged_prefill_single_pass": 1, "embed_gather": 1}
    torch.testing.assert_close(on.float(), off.float(), rtol=4e-2, atol=4e-2)
    assert torch.equal(emb_on, emb_off)
    # kv16 pools and LSE outputs are not the rule's: row 7 (or its raise)
    assert not dispatch.single_pass_applies(16, page, d)
    with pytest.raises(NotImplementedError):
        dispatch.paged_prefill_attention(*args, return_lse=True)


# -- rows 9 and 7 on the wgmma core: 128-row query tiles, 64-key stages ------


@pytest.mark.parametrize("lens,pad,hq,hkv,flags_kv,sink,local", [
    ([1000], 37, 8, 2, None, 0, 0),            # ragged tail: T % 64 != 0
    # segments straddle the 128-row q tiles; sink and band edges mid tile
    ([100, 200, 63], 5, 4, 2, [1, 0], 40, 100),
    # q tiles of padding only: an empty live kv range
    ([90], 300, 8, 8, [0, 0, 0, 0, 1, 1, 1, 1], 16, 33),
    ([129, 127, 256], 0, 16, 2, [0, 1], 64, 64),   # edges on tile edges
])
def test_flash_prefill_tile_edges_kernel(dev, lens, pad, hq, hkv, flags_kv,
                                         sink, local):
    """Row 9's tiles against the plain version where they are cut: ragged
    tails, segments across q tiles, q tiles with nothing to attend, band
    edges inside a key tile; padding rows give exactly 0."""
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    n, d = sum(lens), 128
    t = n + pad
    g = _gen(dev, 40)
    q = torch.randn((t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    seg = torch.full((t,), -1, dtype=torch.int32)
    pos = torch.zeros(t, dtype=torch.int32)
    o = 0
    for i, m in enumerate(lens):
        seg[o:o + m] = i
        pos[o:o + m] = torch.arange(m)
        o += m
    seg, pos = seg.to(dev), pos.to(dev)
    kw = {}
    if flags_kv is not None:
        kw = dict(head_is_retrieval=torch.tensor(
            flags_kv, dtype=torch.bool, device=dev).repeat_interleave(
                hq // hkv), sink_size=sink, local_size=local)
    got = fa.flash_prefill(q, k, v, seg, pos, d ** -0.5, **kw)
    want = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if pad:
        assert float(got[n:].float().abs().max()) == 0.0


def _plant_past_context(pool, layer, page, ctx, tables, kv_bits, fine):
    """Garbage where no row may look: past each context in the page that
    holds it and in the table's later pages, NaN planes (fine-grained
    pools), 0xFF codes (kv4 / kv8) or NaN values (kv16)."""
    w = tables.shape[1]
    for s in range(tables.shape[0]):
        n = int(ctx[s])
        for slot_tbl in range((n - 1) // page, w):
            phys = int(tables[s, slot_tbl])
            first = (n - 1) % page + 1 if slot_tbl == (n - 1) // page else 0
            if first >= page:
                continue
            if kv_bits == 16:
                pool.k_data[layer, phys, :, first:] = float("nan")
                pool.v_data[layer, phys, :, first:] = float("nan")
                continue
            if fine:
                pool.kv_scales[layer, phys, :, :, first:] = float("nan")
            if kv_bits == 8:
                pool.k_data[layer, phys, :, first:] = 255
                pool.v_data[layer, phys, :, first:] = 255
            elif first == 0:
                pool.k_data[layer, phys] = 255
                pool.v_data[layer, phys] = 255


@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [128, 256, 384])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt4", "pt8", "kv16"])
def test_paged_prefill_pages_and_reps_kernel(dev, mode, page, n_rep):
    """Row 7 over a dense table in every kv mode, at pages of 128, 256 and
    384 tokens (under kv4 a 64-key sub-tile of a 384-token page lies in
    the page's first or second half: its own rows and nibble) and every
    GQA width, the second row padded halfway; past each context the pool
    holds garbage (NaN planes or values, 0xFF codes) that the kernel must
    keep out of every product: its plain version runs on the clean pool.
    Launches counted under the mode's name."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import KVPool

    b, h, d, chunk = 2, 2, 128, 150
    history = 2 * page + 37
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 41)
    if mode == "kv16":
        shape = (2, b * w + 1, h, page, d)
        pool = KVPool(*(torch.randn(shape, generator=g, device=dev).bfloat16()
                        for _ in range(2)), None)
        kv_bits, fine = 16, True
    else:
        pool = _codes_pool(dev, g, mode, 2, b * w + 1, h, page, d)
        kv_bits, fine = PSP_MODES[mode]
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    q_pos[1, chunk // 2:] = -1
    ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    clean = pool.clone()
    _plant_past_context(pool, 1, page, ctx, tables, kv_bits, fine)
    name = {"kv4": "paged_prefill_attention", "kv8": "paged_prefill_kv8",
            "kv16": "paged_prefill_kv16"}.get(mode, "paged_prefill_pt")
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=fine)
    before = cuda.LAUNCHES[name]
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = pp.paged_prefill_attention_plain(q, clean, 1, tables, q_pos, ctx,
                                            **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


@pytest.mark.parametrize("page", [128, 384])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt8"])
def test_paged_prefill_page_list_dead_slots_kernel(dev, mode, page):
    """Row 7's page-list mode at pages of 128 and 384: slots in any order,
    dead slots whose pages hold NaN planes and 0xFF codes, logical pages
    left out of the list, garbage past each context; one retrieval and one
    streaming kv head with sink and band edges inside tiles."""
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp

    h, d, n_rep, chunk = 2, 128, 4, 200
    g = _gen(dev, 42)
    pool = _codes_pool(dev, g, mode, 1, 13, h, page, d)
    tables = torch.tensor([[3, 9, 0, 5, 11, 7], [1, 4, 10, 2, 8, 6]],
                          dtype=torch.int32, device=dev)
    sel = torch.tensor([[0, 3, 1, -1, 4, 2], [5, -1, 0, 1, -1, 2]],
                       dtype=torch.int32, device=dev)
    ctx = torch.tensor([5 * page - 20, 5 * page + 50], dtype=torch.int32,
                       device=dev)
    q_pos = torch.stack([int(n) - chunk + torch.arange(chunk)
                         for n in ctx.tolist()]).to(device=dev,
                                                    dtype=torch.int32)
    q = torch.randn((2, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    kv_bits, fine = PSP_MODES[mode]
    clean = pool.clone()
    for s, slot in ((0, 3), (1, 1), (1, 4)):        # the dead slots' pages
        phys = int(tables[s, slot])
        if fine:
            pool.kv_scales[0, phys] = float("nan")
        pool.k_data[0, phys] = 255
        pool.v_data[0, phys] = 255
    # past each context: the last listed page's tail
    for s, (last_logic, first) in enumerate(((4, page - 20), (5, 50))):
        phys = int(tables[s, sel[s].tolist().index(last_logic)])
        if fine:
            pool.kv_scales[0, phys, :, :, first:] = float("nan")
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=fine, sel_logic=sel,
              head_is_retrieval=torch.tensor([True] * n_rep + [False] * n_rep,
                                             device=dev),
              sink_size=40, local_size=150)
    got = pp.paged_prefill_attention(q, pool, 0, tables, q_pos, ctx, **kw)
    want = pp.paged_prefill_attention_plain(q, clean, 0, tables, q_pos, ctx,
                                            **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("case", ["one", "packed", "padding", "prefix",
                                  "shuffled", "split", "pad_first", "long"])
def test_flash_tile_ranges_kernel(dev, case, band):
    """Row 9's tile-range kernel (run first by every flash prefill launch)
    equals its plain version, ranges and launch order, on usual batches
    and on inputs it answers with every key tile."""
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    rng = np.random.default_rng(7)

    def packed(lens, pad=0, start=None):
        seg, pos = [], []
        for i, n in enumerate(lens):
            seg += [i] * n
            p0 = 0 if start is None else start[i]
            pos += list(range(p0, p0 + n))
        return seg + [-1] * pad, pos + [0] * pad

    seg, pos = {
        "one": packed([1000]),
        "packed": packed([50, 130, 7, 300], pad=5),
        "padding": packed([90], pad=300),
        "prefix": packed([200, 90, 300], pad=7, start=[64, 0, 1000]),
        "shuffled": (packed([260, 150])[0],
                     rng.permutation(410).tolist()),
        "split": ([0] * 100 + [1] * 80 + [0] * 90,
                  list(range(100)) + list(range(80)) + list(range(100, 190))),
        "pad_first": ([-1] * 10 + [0] * 300, [0] * 10 + list(range(300))),
        "long": packed([16384]),
    }[case]
    seg = torch.tensor(seg, dtype=torch.int32, device=dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = fa.tile_ranges(seg, pos, 128, 8192 if case == "long" else 100, band)
    want = fa.live_tile_ranges(seg, pos, 128, 8192 if case == "long" else 100,
                               band)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Rows 5 and 6 split over pages: per-head lists of kv4 / kv8 / per-tensor
# kv8 pages (row 5) and the kv16 list shared by the heads (row 6)
# ---------------------------------------------------------------------------

SPLIT_MODES = {"kv4": "decode_attention_ph", "kv8": "decode_attention_ph_kv8",
               "pt8": "decode_attention_ph_pt",
               "kv16": "paged_mqa_attention_kv16"}


def _split_case(dev, seed, mode, b, h, n_rep, page, tp, lens):
    """A 2-layer pool and page lists [B, H, tp] in no order over layer 1:
    each list takes its sequence's newest page, other live pages, a dead
    entry and a page past the length (sequence 1 keeps those two at the
    end, so the last runs of entries hold nothing live); list (2, 0) is all
    dead; a row of length 0 lists pages all the same. NaN planes (kv16: NaN
    values) and 0xFF kv8 codes are planted past each context, in the page
    past it and in the page the dead entries name. Returns (q, pool,
    sel_phys, sel_logic, lengths)."""
    from omniserve_tpu_torch.ops.paged_kv import KVPool

    d, g = 128, _gen(dev, seed)
    rng = np.random.default_rng(seed)
    w = max(-(-max(lens) // page), 1) + 1
    n_pages = b * w + 1
    trash = n_pages - 1                      # the page dead entries name
    if mode == "kv16":
        pool = KVPool(*(torch.randn((2, n_pages, h, page, d), generator=g,
                                    device=dev).bfloat16() for _ in range(2)),
                      None)
    else:
        pool = _codes_pool(dev, g, mode, 2, n_pages, h, page, d)
    logic = np.full((b, h, tp), -1, np.int64)
    for s, n in enumerate(lens):
        live = -(-n // page)
        for hh in range(h):
            if s == 2 and hh == 0:
                continue
            first = [live - 1] if live else []
            others = list(rng.permutation(max(live - 1, 0)))
            extra = [-1, live] if tp >= 3 else []
            picks = (first + others)[:tp - len(extra)]
            if s == 1:
                entries = list(rng.permutation(picks)) + extra
            else:
                entries = list(rng.permutation(picks + extra))
            logic[s, hh, :len(entries)] = entries
    phys = np.where(logic >= 0, logic + w * np.arange(b)[:, None, None],
                    trash)
    # garbage where no live token sits
    _plant_dead_garbage(pool, 1, page, lens, lambda s, p: p + w * s)
    for s, n in enumerate(lens):
        for p in {-(-n // page), -1}:        # the page past it, the trash
            pg = trash if p < 0 else w * s + p
            if mode == "kv16":
                pool.k_data[1, pg] = float("nan")
                pool.v_data[1, pg] = float("nan")
                continue
            if pool.kv_scales is not None:
                pool.kv_scales[1, pg] = float("nan")
            pool.k_data[1, pg] = 255
            pool.v_data[1, pg] = 255
    if mode == "kv16":
        for s, n in enumerate(lens):
            if n % page:
                pg = w * s + (n - 1) // page
                pool.k_data[1, pg, :, n % page:] = float("nan")
                pool.v_data[1, pg, :, n % page:] = float("nan")
    q = torch.randn((b, h, n_rep, d), generator=g, device=dev).bfloat16()
    return (q, pool, torch.from_numpy(phys).to(torch.int32).to(dev),
            torch.from_numpy(logic).to(torch.int32).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _split_call(mode, q, pool, sel_phys, sel_logic, lens, page, plain=False):
    """Row 5 (per-head lists) or, kv16, row 6 over head 0's lists."""
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    if mode == "kv16":
        sel_phys = sel_phys[:, 0].contiguous()
        sel_logic = sel_logic[:, 0].contiguous()
    fn = (da.page_list_attention_plain if plain else
          da.paged_mqa_attention if mode == "kv16"
          else da.paged_mqa_attention_single_pass_ph)
    return fn(q, pool, 1, sel_phys, sel_logic, lens, sm_scale=128 ** -0.5,
              page_size=page)


def _check_split(dev, mode, args, page, want_split):
    """Kernel against plain (kv16 5e-3, the quantized modes 5e-2), zeros
    for rows of length 0 and all-dead lists, one launch counted, the split
    plan as wanted; returns the kernel's output."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    q, _, _, sel_logic, lens = args
    b, h = q.shape[:2]
    n_split, per = da.split_plan(b, h, sel_logic.shape[-1],
                                 cuda.sm_count(dev))
    assert want_split(n_split, per), (n_split, per)
    name = SPLIT_MODES[mode]
    before = cuda.LAUNCHES[name]
    got = _split_call(mode, *args, page)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES[name] == before + 1
    want = _split_call(mode, *args, page, plain=True)
    tol = 5e-3 if mode == "kv16" else 5e-2
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for s, n in enumerate(lens.tolist()):
        if n <= 0:
            assert float(got[s].abs().max()) == 0.0
    if b > 2:      # an all-dead list (kv16: sequence 2's, head 0's list)
        assert float(got[2, 0].abs().max()) == 0.0
    return got


@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("mode,page", [
    (m, p) for m in SPLIT_MODES
    for p in ((16, 128, 256) if m == "kv16" else (128, 256))])
def test_split_decode_kernel(dev, mode, page, n_rep):
    """S > 1 with a ragged last run (Tp = 11 entries in runs of 2 at 32
    lists on 132 SMs): kernel (and combine) against the plain version, a
    run of dead and past-length entries only, a row of length 0, garbage
    planted in dead slots; then one captured CUDA graph replayed twice
    equals the eager call bit for bit. kv16 also at pages of 16."""
    b, h, tp = 8, 4, 11
    lens = [9 * page + 5, 7 * page, 9 * page + page - 1, 0, 4 * page + 1,
            9 * page, 8 * page + 77 % page, 3]
    args = _split_case(dev, 41, mode, b, h, n_rep, page, tp, lens)
    got = _check_split(dev, mode, args, page,
                       lambda n, per: n > 1 and tp % per != 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _split_call(mode, *args, page)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, got) and torch.equal(out, got)


@pytest.mark.parametrize("shape", ["one block per list", "tp1"])
@pytest.mark.parametrize("mode", list(SPLIT_MODES))
def test_split_decode_one_run_kernel(dev, mode, shape):
    """S = 1 (the block writes the output itself): 264 lists of 3 entries
    (two waves of blocks on 132 SMs without a split), and lists of one
    entry each (Tp = 1: the newest page)."""
    page = 128
    if shape == "tp1":
        b, h, tp = 4, 4, 1
        lens = [2 * page + 9, page, 0, 5]
    else:
        b, h, tp = 66, 4, 3
        lens = [(s * 37) % (3 * page) for s in range(b)]
    args = _split_case(dev, 43, mode, b, h, 4, page, tp, lens)
    _check_split(dev, mode, args, page, lambda n, per: n == 1)


# (K, N) of one Llama-3-8B layer's W4A8 projections: qkv, o, gate_up, down
LAYER_GEMMS = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]


@pytest.mark.parametrize("m", [1, 8, 16, 17, 100, 128, 256, 8192])
@pytest.mark.parametrize("k,n", LAYER_GEMMS)
def test_w4a8_per_channel_layer_shapes_kernel(dev, k, n, m):
    """Row 1 at the main path's layer shapes, both bodies (M <= 128: the
    decode body, split over K in a cluster; above: the prefill body): equal
    to the plain version (error 0; bf16 out and f32 out), and one captured
    CUDA graph replayed twice equal to the eager call bit for bit."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev, 5)
    a, s, asum = quantize_activations(
        torch.randn((m, k), generator=g, device=dev), fuse_sum=True)
    qw = torch.randint(0, 256, (k // 2, n), generator=g, dtype=torch.uint8,
                       device=dev)
    s1 = torch.empty(n, device=dev).uniform_(0.003, 0.006, generator=g)
    sz = 8.0 * s1
    for dtype in (torch.float32, torch.bfloat16):
        before = cuda.LAUNCHES["w4a8_matmul_per_channel"]
        got = qm.w4a8_matmul_per_channel(a, qw, s1, sz, s, asum,
                                         out_dtype=dtype)
        assert cuda.LAUNCHES["w4a8_matmul_per_channel"] == before + 1
        want = qm.w4a8_matmul_per_channel_plain(a, qw, s1, sz, s, asum,
                                                out_dtype=dtype)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert float((got.float() - want.float()).abs().max()) == 0.0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.w4a8_matmul_per_channel(a, qw, s1, sz, s, asum)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, got) and torch.equal(out, got)


APPEND_NAMES = {"kv4": "decode_attention_append",
                "kv8": "decode_attention_append_kv8",
                "pt4": "decode_attention_append_pt",
                "pt8": "decode_attention_append_pt"}


def _append_case(dev, mode, b, page, seed):
    """A 2-layer pool of random codes over b sequences of 8 kv heads whose
    lengths (the new token included) put it at slot 0 of a fresh page, at
    slot page/2 (the kv4 byte it shares), at the last slot, and in the
    middle of a page, with a row of length 1 and one of 0. Returns (q,
    pool, tables, lens, k_new, v_new, kv_bits, kv_zeros, plant): ``plant``
    puts NaN planes and (kv8) 0xFF codes in every slot at or past the new
    token's of a pool (the plain versions read them into masked products,
    so they run on a copy without it)."""
    h, n_rep, d = 8, 4, 128
    pattern = [2 * page + 1, page + page // 2 + 1, 3 * page, 1, 0,
               2 * page + 37, page // 2 + 1, 3 * page - 5]
    lens = [pattern[s] if s < len(pattern)
            else 1 + (s * 97) % (3 * page) for s in range(b)]
    w = 3
    g = _gen(dev, seed)
    pool = _codes_pool(dev, g, mode, 2, b * w + 1, h, page, d)
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    phys = tables.tolist()

    def plant(p):
        _plant_dead_garbage(p, 1, page, [max(n - 1, 0) for n in lens],
                            lambda s, lp: phys[s][lp])
        for s, n in enumerate(lens):   # a new token at slot 0 of its page
            if n > 0 and (n - 1) % page == 0:
                pg = phys[s][(n - 1) // page]
                if p.kv_scales is not None:
                    p.kv_scales[1, pg] = float("nan")
                if p.k_data.shape[3] == page:
                    p.k_data[1, pg] = 255
                    p.v_data[1, pg] = 255

    q = torch.randn((b, h * n_rep, d), generator=g, device=dev).bfloat16()
    kn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    vn = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    kv_bits, fine = PSP_MODES[mode]
    return (q, pool, tables, torch.tensor(lens, dtype=torch.int32,
                                          device=dev), kn, vn, kv_bits, fine,
            plant)


@pytest.mark.parametrize("b", [8, 128])
@pytest.mark.parametrize("page", [128, 256])
@pytest.mark.parametrize("mode", list(APPEND_NAMES))
def test_decode_attention_append_split_kernel(dev, mode, page, b):
    """Row 4's fused append on the split body (S > 1 at B=8, S = 1 at
    B=128 on 132 SMs): outputs within 5e-2 and 1e-2 of each row's norm,
    zeros for the row of length 0, pools and planes byte-equal to the
    plain append (garbage planted where the token lands), one launch
    counted; a captured graph replayed twice equals the eager call (the
    re-appended token writes the same bytes)."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    q, pool, tables, lens, kn, vn, kv_bits, fine, plant = _append_case(
        dev, mode, b, page, 61)
    n_split = da.split_plan(b, 8, tables.shape[1],
                            cuda.sm_count(dev))[0]
    assert (n_split > 1) == (b == 8 and cuda.sm_count(dev) >= 132)
    clean = pool.clone()
    plant(pool)
    twin = pool.clone()
    kw = dict(sm_scale=128 ** -0.5, page_size=page, kv_bits=kv_bits)
    name = APPEND_NAMES[mode]
    before = cuda.LAUNCHES[name]
    got = da.paged_decode_attention_fused(q, pool, 1, tables, lens, kn, vn,
                                          **kw)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES[name] == before + 1
    # the pool's bytes against the plain append over the same garbage, the
    # output against the plain version over the pool without it
    da.paged_decode_attention_fused_plain(q, twin, 1, tables, lens, kn, vn,
                                          kv_zeros=fine, **kw)
    want = da.paged_decode_attention_fused_plain(
        q, clean, 1, tables, lens, kn, vn, kv_zeros=fine, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    live = lens > 0
    num = (got.float() - want.float()).norm(dim=-1)[live]
    den = want.float().norm(dim=-1)[live].clamp_min(1e-30)
    assert float((num / den).max()) <= 1e-2
    assert float(got[~live].abs().max()) == 0.0
    assert_pools_equal(pool, twin)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_decode_attention_fused(q, pool, 1, tables, lens, kn,
                                              vn, **kw)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, got) and torch.equal(out, got)
    assert_pools_equal(pool, twin)


# -- rows 3 (W8A8) and 2 (per group) on the int8 wgmma body ----------------

WGMMA_M = [1, 8, 100, 128, 129, 300, 8192]   # decode (split) and prefill


def _graph_equals_eager(call, eager):
    """One captured CUDA graph of ``call`` replayed twice equals the eager
    output bit for bit."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(out, eager)


def _assert_split(qm, mode, m, k, n, dev):
    """Decode M splits the weight rows over a cluster, except where the
    channel tiles alone fill the card (gate_up, the lm_head)."""
    from omniserve_tpu_torch.ops import cuda

    plan = qm.gemm_plan(mode, m, n, k, cuda.sm_count(dev))
    assert plan is not None
    if m <= qm.DECODE_MAX_M and n < 16384:
        assert plan.splits > 1, plan
    if m > qm.DECODE_MAX_M:
        assert (plan.n_wg, plan.splits) == (2, 1), plan


@pytest.mark.parametrize("m", WGMMA_M)
@pytest.mark.parametrize("k,n", LAYER_GEMMS)
def test_w8a8_wgmma_layer_shapes_kernel(dev, k, n, m):
    """Row 3's W8 mode at the W8A8 body's layer shapes: equal to the plain
    version (error 0, f32 and bf16 out), split at decode M, and a replayed
    graph equal to the eager call."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev, 11)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    w = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8,
                      device=dev)
    ws = torch.empty(n, device=dev).uniform_(0.0003, 0.0006, generator=g)
    _assert_split(qm, "w8", m, k, n, dev)
    for dtype in (torch.float32, torch.bfloat16):
        before = cuda.LAUNCHES["w8a8_matmul"]
        got = qm.w8a8_matmul(a, w, ws, s, out_dtype=dtype)
        assert cuda.LAUNCHES["w8a8_matmul"] == before + 1
        want = qm.w8a8_matmul_plain(a, w, ws, s, out_dtype=dtype)
        assert torch.equal(got, want)
    _graph_equals_eager(lambda: qm.w8a8_matmul(a, w, ws, s), got)


@pytest.mark.parametrize("m", [1, 8, 128])
def test_w8a8_wgmma_lm_head_kernel(dev, m):
    """Row 3 at the lm_head (K=4,096, N=128,256): the channel tiles alone
    fill the card (no split); equal to plain, graph replay equal."""
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    k, n = 4096, 128256
    g = _gen(dev, 12)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    w = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8,
                      device=dev)
    ws = torch.empty(n, device=dev).uniform_(0.0003, 0.0006, generator=g)
    assert qm.gemm_plan("w8", m, n, k, 132).splits == 1
    for dtype in (torch.float32, torch.bfloat16):
        got = qm.w8a8_matmul(a, w, ws, s, out_dtype=dtype)
        assert torch.equal(got, qm.w8a8_matmul_plain(a, w, ws, s,
                                                     out_dtype=dtype))
    _graph_equals_eager(lambda: qm.w8a8_matmul(a, w, ws, s), got)


@pytest.mark.parametrize("m", WGMMA_M)
@pytest.mark.parametrize("k,n,group_size", [
    (4096, 6144, 32), (4096, 6144, 64), (4096, 6144, 128),
    (14336, 4096, 128), (14336, 4096, 224), (1792, 256, 224),
])
def test_w4a8_per_group_wgmma_kernel(dev, k, n, group_size, m):
    """Row 2's per-group mode at layer shapes and G in {32, 64, 128, 224}
    (224: a stage of 128 packed rows straddles two groups): equal to the
    plain version (error 0, f32 and bf16 out) with s2 up to 17 and zeros
    over the whole int8 range, split at decode M, graph replay equal."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev, 13)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    qw, s1, s2, s2z = _per_group_weights(g, k, n, group_size, layers=1)
    args = (a, qw[0], s1[0], s2[0], s2z[0], s)
    if n >= 4096:
        _assert_split(qm, "group", m, k, n, dev)
    for dtype in (torch.float32, torch.bfloat16):
        before = cuda.LAUNCHES["w4a8_matmul_per_group"]
        got = qm.w4a8_matmul_per_group(*args, group_size=group_size,
                                       out_dtype=dtype)
        assert cuda.LAUNCHES["w4a8_matmul_per_group"] == before + 1
        want = qm.w4a8_matmul_per_group_plain(*args, group_size=group_size,
                                              out_dtype=dtype)
        assert torch.equal(got, want)
    _graph_equals_eager(lambda: qm.w4a8_matmul_per_group(
        *args, group_size=group_size), got)


@pytest.mark.parametrize("m", [8, 128, 300])
def test_w4a8_per_group_wgmma_s2_17_edge(dev, m):
    """Every code 15 and every s2 17 (255 before the zero), zeros that wrap
    both ways, at the qkv shape: the split decode and the prefill body."""
    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    k, n, gs = 4096, 6144, 128
    g = _gen(dev, 14)
    a, s, _ = quantize_activations(torch.randn((m, k), generator=g,
                                               device=dev))
    qw = torch.full((k // 2, n), 0xFF, dtype=torch.uint8, device=dev)
    s1 = torch.full((n,), 0.004, device=dev)
    s2 = torch.full((k // gs, n), 17, dtype=torch.int8, device=dev)
    zeros = torch.tensor([-128, -8, 0, 100, 127], dtype=torch.int8,
                         device=dev)
    s2z = zeros[torch.randint(0, 5, s2.shape, generator=g, device=dev)]
    got = qm.w4a8_matmul_per_group(a, qw, s1, s2, s2z, s, group_size=gs,
                                   out_dtype=torch.float32)
    want = qm.w4a8_matmul_per_group_plain(a, qw, s1, s2, s2z, s,
                                          group_size=gs,
                                          out_dtype=torch.float32)
    assert torch.equal(got, want)


def test_w8a8_and_per_group_narrow_n_take_mma_sync_body(dev):
    """At N % 16 != 0 (the TMA boxes' rows) rows 3 and 2 launch the
    mma.sync body, ``quant_gemm_kernel``; the main path's shapes launch the
    wgmma body, ``int8_wgmma_kernel``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from omniserve_tpu_torch.ops.cuda import quant_matmul as qm
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    def launched(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, " ".join(e.name for e in prof.events()
                             if e.device_type == DeviceType.CUDA)

    g = _gen(dev, 15)
    for m, n, body in ((33, 260, "quant_gemm_kernel"),
                       (33, 256, "int8_wgmma_kernel")):
        a, s, _ = quantize_activations(torch.randn((m, 512), generator=g,
                                                   device=dev))
        w = torch.randint(-128, 128, (512, n), generator=g,
                          dtype=torch.int8, device=dev)
        ws = torch.empty(n, device=dev).uniform_(0.0003, 0.0006, generator=g)
        got, names = launched(lambda: qm.w8a8_matmul(a, w, ws, s))
        assert body in names, names
        assert torch.equal(got, qm.w8a8_matmul_plain(a, w, ws, s))
    for m, n, body in ((300, 68, "quant_gemm_kernel"),
                       (300, 64, "int8_wgmma_kernel")):
        a, s, _ = quantize_activations(torch.randn((m, 256), generator=g,
                                                   device=dev))
        qw, s1, s2, s2z = _per_group_weights(g, 256, n, 128, layers=1)
        args = (a, qw[0], s1[0], s2[0], s2z[0], s)
        got, names = launched(lambda: qm.w4a8_matmul_per_group(*args))
        assert body in names, names
        assert torch.equal(got, qm.w4a8_matmul_per_group_plain(*args))


# ---------------------------------------------------------------------------
# Head dim 64 (Llama-3.2-1B, TinyLlama) and row 6's kv4 / kv8 modes
# ---------------------------------------------------------------------------

TWO_STAGE_POOLS = ("kv4", "kv8", "pt4", "pt8", "kv16")
DECODE_TOL = 5e-2     # chip_smoke's decode gate


def _two_stage_pool(dev, g, mode, layers, n_pages, h, page, d):
    if mode == "kv16":
        return _kv16_pool(dev, g, layers, n_pages, h, page, d)
    return _codes_pool(dev, g, mode, layers, n_pages, h, page, d)


def _swap_nibbles(pool):
    """The pool with the two nibbles of every code byte swapped (a kv4
    page's halves exchanged)."""
    swap = lambda x: ((x & 0x0F) << 4) | (x >> 4)    # noqa: E731
    return pool._replace(k_data=swap(pool.k_data), v_data=swap(pool.v_data))


def _decode_gate(got, want, planted):
    """``got`` within DECODE_TOL of the plain output ``want``; each planted
    fault's plain output outside it."""
    torch.testing.assert_close(got.float(), want.float(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    for what, bad in planted:
        assert not torch.allclose(bad.float(), want.float(),
                                  rtol=DECODE_TOL, atol=DECODE_TOL), what


@pytest.mark.parametrize("d,page", [(64, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("mode", TWO_STAGE_POOLS)
def test_two_stage_decode_kernel(dev, mode, n_rep, d, page):
    """Row 6 (the two-stage decode's kernel) in each list mode over each
    pool kind at head_dim 64 and at head_dim 128 with 64-token pages (the
    pools the JAX package's supports rule keeps from rows 4 / 5): a dense
    list, per-head lists in no order with dead entries (an all-dead list, an
    inactive row) and the ring's band, garbage planted past each context.
    Launches counted under ``two_stage_name`` (``_d64`` at head_dim 64);
    the gate refuses the plain version with the lengths a page short, the
    band moved by a page and, over kv4 pools, the nibble halves swapped."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    h, n_pages = 2, 24
    g = _gen(dev, 61)
    pool = _two_stage_pool(dev, g, mode, 2, n_pages + 1, h, page, d)
    lens = [5 * page + 9, 3 * page, 2 * page + 30, 0]
    if mode == "kv16":
        for s, n in enumerate(lens):
            if n > 0 and n % page:
                phys = (n - 1) // page + 6 * s
                pool.k_data[1, phys, :, n % page:] = float("nan")
                pool.v_data[1, phys, :, n % page:] = float("nan")
    else:
        _plant_dead_garbage(pool, 1, page, lens, lambda s, p: p + 6 * s)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(sm_scale=d ** -0.5, page_size=page)
    faults = []

    def check(call, list_mode, args, kw, extra=()):
        name = da.two_stage_name(list_mode, args[1], page, d)
        assert name.endswith("_d64") == (d == 64)
        before = dict(cuda.LAUNCHES)
        got = call(*args, **kw)
        assert cuda.LAUNCHES[name] == before[name] + 1
        assert sum(cuda.LAUNCHES.values()) == sum(before.values()) + 1
        want = da.page_list_attention_plain(*args, **kw)
        planted = list(extra)
        if mode in ("kv4", "pt4"):
            planted.append(("the nibble halves swapped",
                            da.page_list_attention_plain(
                                args[0], _swap_nibbles(args[1]), *args[2:],
                                **kw)))
        _decode_gate(got, want, planted)
        assert torch.isfinite(got.float()).all()
        return got

    # the dense list of a block table (logical page p of row s at p + 6 s)
    tables = (torch.arange(6)[None, :] + 6 * torch.arange(4)[:, None]).to(
        torch.int32).to(dev)
    q = torch.randn((4, h, n_rep, d), generator=g, device=dev).bfloat16()
    lists = da.dense_page_lists(tables, lens_t, page)
    args = (q, pool, 1, *lists, lens_t)
    got = check(da.paged_mqa_attention, "dense", args, kw, [
        ("the list a page short", da.page_list_attention_plain(
            q, pool, 1, *lists, (lens_t - page).clamp(min=0), **kw))])
    assert float(got[3].abs().max()) == 0.0
    # per-head lists
    sel_logic = torch.tensor([
        [[5, 0, 3, -1, 1], [5, 4, -1, 2, 0]],
        [[2, 1, 0, -1, -1], [2, -1, 0, -1, -1]],
        [[-1, -1, -1, -1, -1], [2, 1, 0, -1, -1]],
        [[0, 1, -1, -1, -1], [0, -1, -1, -1, -1]],
    ], dtype=torch.int32)
    sel_phys = torch.where(
        sel_logic >= 0, sel_logic + 6 * torch.arange(4)[:, None, None], 0,
    ).to(torch.int32)
    args = (q, pool, 1, sel_phys.to(dev), sel_logic.to(dev), lens_t)
    got = check(da.paged_mqa_attention_ph, "ph", args, kw, [
        ("the lists a page short", da.page_list_attention_plain(
            *args[:5], (lens_t - page).clamp(min=0), **kw))])
    assert float(got[2, 0].abs().max()) == 0.0      # all-dead list
    assert float(got[3].abs().max()) == 0.0         # inactive row
    # the ring's band: 1 sink + 2 ring pages per sequence
    b = 4
    slens = torch.tensor([5 * page + 37, 4 * page, 40, 0],
                         dtype=torch.int32, device=dev)
    spool = _two_stage_pool(dev, g, mode, 2, 3 * b + 1, h, page, d)
    stables = torch.arange(3 * b, dtype=torch.int32, device=dev).view(b, 3)
    sel_phys, sel_logic, span = da.streaming_page_lists(
        stables, slens, 1, page, 2 * page)
    kwb = dict(kw, band_sink_tokens=page, band_local_tokens=2 * page,
               ring_span_pages=span, ring_sink_tokens=page)
    args = (q, spool, 1, sel_phys, sel_logic, slens)
    got = check(da.paged_mqa_attention_band, "band", args, kwb, [
        ("the band moved by a page", da.page_list_attention_plain(
            *args, **dict(kwb, band_local_tokens=page)))])
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("d,page", [(64, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt8", "kv16"])
def test_decode_route_two_stage_kernel(dev, mode, d, page):
    """The fused decode's route (``dispatch.paged_decode_attention_fused``)
    where the JAX package's supports rule is False: row 10's append, then
    row 6, equal to the split plain path's output and pool bytes; rows 4
    and 5 launch no time."""
    from omniserve_tpu_torch.ops import cuda, dispatch
    from omniserve_tpu_torch.ops.cuda import decode_attention as da

    h, n_rep, b = 2, 4, 3
    g = _gen(dev, 62)
    kv_bits, fine = PSP_MODES.get(mode, (16, True))
    pool = _two_stage_pool(dev, g, mode, 2, 4 * b + 1, h, page, d)
    twin = pool.clone()
    tables = torch.randperm(4 * b, generator=g, device=dev).view(b, 4).to(
        torch.int32)
    lens = torch.tensor([3 * page + 5, page, 1], dtype=torch.int32,
                        device=dev)
    q = torch.randn((b, h * n_rep, d), generator=g, device=dev).bfloat16()
    k_new, v_new = (torch.randn((b, h, d), generator=g,
                                device=dev).bfloat16() for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=fine)
    before = dict(cuda.LAUNCHES)
    out, _, _ = dispatch.paged_decode_attention_fused(
        q, pool, None, 1, tables, lens, k_new, v_new, **kw)
    moved = {k for k in cuda.LAUNCHES if cuda.LAUNCHES[k] != before[k]}
    assert moved == {da.two_stage_name("dense", pool, page, d),
                     cuda.launch_name("kv_append_decode" + (
                         {"kv8": "_kv8", "pt8": "_pt", "kv16": "_kv16"}
                         .get(mode, "")), d)}, moved
    want = da.paged_decode_attention_fused_plain(
        q, twin, 1, tables, lens, k_new, v_new, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    assert_pools_equal(pool, twin)


@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt4", "pt8", "kv16"])
def test_kv_append_decode_d64_kernel(dev, mode, with_stats):
    """Row 10 at head_dim 64, both entries: one pool (the split decode's
    append) and the two-pool LServe step; bytes, planes, stats and scales
    equal the plain versions' on every page but the trash page; the plain
    version with each token one slot late is refused."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import kv_append as ka

    kv_bits, fine = PSP_MODES.get(mode, (16, True))
    t, page = 8, 128
    (rpool, spool), (tr, ts), k, v = _two_pool_case(dev, mode, t, with_stats,
                                                    seed=63, d=64)
    start = (rpool.clone(), spool.clone())
    twins = (rpool.clone(), spool.clone())
    name = ka.launch_name(kv_bits, not fine, 64)
    assert name.endswith("_d64")
    kw = dict(update_stats=with_stats, sub_chunks=4)
    plain_kw = dict(kv_bits=kv_bits, kv_zeros=fine, **kw)
    before = cuda.LAUNCHES[name]
    ka.append_kv_decode_pools(rpool, spool, 1, k, v, tr, ts, page, **kw)
    ka.append_kv_decode(rpool, 0, k[:, tr[2]].contiguous(),
                        v[:, tr[2]].contiguous(), tr[0], tr[1], page, **kw)
    assert cuda.LAUNCHES[name] == before + 2
    ka.append_kv_decode_pools_plain(*twins, 1, k, v, tr, ts, page,
                                    **plain_kw)
    ka.append_kv_decode_plain(twins[0], 0, k[:, tr[2]], v[:, tr[2]], tr[0],
                              tr[1], page, **plain_kw)
    torch.cuda.synchronize()
    for got, want in zip((rpool, spool), twins):
        assert_pools_equal(got, want, skip_trash=True)
    got = tuple(p.clone() for p in start)
    ka.append_kv_decode_pools(*got, 1, k, v, tr, ts, page, **kw)
    late = tuple(p.clone() for p in start)
    ka.append_kv_decode_pools_plain(
        *late, 1, k, v, (tr[0], (tr[1] + 1) % page, tr[2]),
        (ts[0], (ts[1] + 1) % page, ts[2]), page, **plain_kw)
    _refused(got, late, "each token one slot late")


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("lens,hq,hkv", [([700], 32, 8), ([300, 450, 9], 4, 4),
                                         ([500, 77], 32, 4)])
def test_flash_prefill_d64_kernel(dev, lens, hq, hkv, band):
    """Row 9 at head_dim 64 (Llama-3.2-1B's 32 / 8 heads, TinyLlama's 32 /
    4), dense and with the sink + local band, packed prompts with a ragged
    tail; launches counted as ``flash_prefill_d64`` /
    ``flash_prefill_band_d64``."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import flash_attention as fa

    t, d = sum(lens) + 5, 64
    g = _gen(dev, 64)
    q = torch.randn((t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((t, hkv, d), generator=g, device=dev).bfloat16()
    seg = torch.full((t,), -1, dtype=torch.int32)
    pos = torch.zeros(t, dtype=torch.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        pos[o:o + n] = torch.arange(n)
        o += n
    seg, pos = seg.to(dev), pos.to(dev)
    kw = {}
    if band:
        flags = torch.tensor([i % 2 == 0 for i in range(hkv)],
                             device=dev).repeat_interleave(hq // hkv)
        kw = dict(head_is_retrieval=flags, sink_size=32, local_size=200)
    name = "flash_prefill_band_d64" if band else "flash_prefill_d64"
    before = cuda.LAUNCHES[name]
    got = fa.flash_prefill(q, k, v, seg, pos, d ** -0.5, **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if band:
        dense = fa.prefill_attention_plain(q, k, v, seg, pos, d ** -0.5)
        assert not torch.allclose(got[:, ~flags].float(),
                                  dense[:, ~flags].float(), atol=2e-2)


@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("page", [64, 128, 256])
@pytest.mark.parametrize("mode", ["kv4", "kv8", "pt4", "pt8", "kv16"])
def test_paged_prefill_d64_kernel(dev, mode, page, n_rep):
    """Row 7 at head_dim 64 over a dense table in every kv mode (a 64-byte
    kv4 / kv8 row, a 128-byte kv16 row), the second row padded halfway,
    garbage past each context; then its page list with the ring relabel
    and the band. Launches counted under the mode's ``_d64`` names."""
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.cuda import paged_prefill as pp
    from omniserve_tpu_torch.ops.paged_kv import ring_logical_blocks

    b, h, d, chunk = 2, 2, 64, 150
    history = 2 * page + 37
    total = history + chunk
    w = -(-total // page) + 1
    g = _gen(dev, 65)
    pool = _two_stage_pool(dev, g, mode, 2, b * w + 1, h, page, d)
    kv_bits, fine = PSP_MODES.get(mode, (16, True))
    tables = torch.randperm(b * w, generator=g, device=dev).view(b, w).to(
        torch.int32)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    q_pos = (history + torch.arange(chunk, dtype=torch.int32)).repeat(b, 1)
    ctx = torch.full((b,), total, dtype=torch.int32)
    q_pos[1, chunk // 2:] = -1
    ctx[1] = history + chunk // 2
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    clean = pool.clone()
    _plant_past_context(pool, 1, page, ctx, tables, kv_bits, fine)
    sfx = {"kv8": "_kv8", "pt4": "_pt", "pt8": "_pt", "kv16": "_kv16"}.get(
        mode, "")
    name = ("paged_prefill" + sfx if sfx else "paged_prefill_attention") + \
        "_d64"
    kw = dict(sm_scale=d ** -0.5, page_size=page, kv_bits=kv_bits,
              kv_zeros=fine)
    before = cuda.LAUNCHES[name]
    got = pp.paged_prefill_attention(q, pool, 1, tables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = pp.paged_prefill_attention_plain(q, clean, 1, tables, q_pos, ctx,
                                            **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float(got[1, chunk // 2:].float().abs().max()) == 0.0

    # the ring: two sequences wrapped several times, one padded halfway
    lens, chunk, sink_b, local_b = [20 * page + 37, 15 * page + 50], 128, 1, 6
    n_slots = sink_b + local_b
    rpool = _two_stage_pool(dev, g, mode, 1, b * n_slots + 1, h, page, d)
    rtables = torch.randperm(b * n_slots, generator=g, device=dev).view(
        b, n_slots).to(torch.int32)
    ctx = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.stack([n - chunk + torch.arange(chunk, dtype=torch.int32)
                         for n in lens])
    q_pos[1] = lens[1] - chunk // 2 + torch.arange(chunk, dtype=torch.int32)
    q_pos[1, chunk // 2:] = -1
    q_pos, ctx = q_pos.to(dev), ctx.to(dev)
    sel = ring_logical_blocks(ctx, n_slots, sink_b, local_b, page)
    q = torch.randn((b, chunk, h * n_rep, d), generator=g,
                    device=dev).bfloat16()
    kw = dict(kw, sel_logic=sel, ring_span_pages=local_b,
              ring_sink_tokens=sink_b * page,
              head_is_retrieval=torch.tensor(
                  [True] * n_rep + [False] * n_rep, device=dev),
              sink_size=page, local_size=3 * page)
    name = "paged_prefill_ring" + sfx + "_d64"
    before = cuda.LAUNCHES[name]
    got = pp.paged_prefill_attention(q, rpool, 0, rtables, q_pos, ctx, **kw)
    assert cuda.LAUNCHES[name] == before + 1
    want = pp.paged_prefill_attention_plain(q, rpool, 0, rtables, q_pos,
                                            ctx, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float(got[1, chunk // 2:].float().abs().max()) == 0.0


@pytest.mark.parametrize("extra", [dict(head_dim=96), dict(page=512)])
def test_engine_refuses_what_no_card_kernel_takes(dev, tmp_path, extra):
    """F4: an engine on a card at head_dim 96 (a 768-wide, 8-head model),
    or with 512-token pages, raises at build time naming the limit and
    ROADMAP.md queue 2 item G; the same engine builds on the CPU."""
    import json

    from omniserve_tpu_torch import EngineArgs, LLMEngine

    heads = 8
    cfg = dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        hidden_size=heads * extra.get("head_dim", 64), intermediate_size=256,
        num_attention_heads=heads, num_key_value_heads=2,
        num_hidden_layers=1, vocab_size=256, max_position_embeddings=4096,
        rms_norm_eps=1e-5, rope_theta=500000.0)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    kw = dict(model=str(tmp_path), precision="w4a8kv4", load_format="dummy",
              lm_head_precision="w8a8", tokenizer_mode="skip",
              block_size=extra.get("page", 64), max_num_seqs=2,
              max_num_batched_tokens=1024, num_retrieval_blocks=16, seed=0)
    what = "head_dim 96" if "head_dim" in extra else "512-token pages"
    with pytest.raises(NotImplementedError, match=what) as err:
        LLMEngine.from_engine_args(EngineArgs(device="cuda", **kw))
    assert "queue 2 item G" in str(err.value)
    LLMEngine.from_engine_args(EngineArgs(device="cpu", **kw))


# -- the weight loader's quantization on the card (no kernel of its own) ------


@pytest.mark.parametrize("precision,group", [("w4a8", -1), ("w4a8", 128),
                                             ("w8a8", -1), ("w16a16", -1)])
def test_quantize_layer_weights_on_card_equals_cpu(dev, precision, group):
    """``quantize_layer_weights`` on the card against the same call on the
    CPU at Llama-3.2-1B's layer shapes (qkv 3,072 x 2,048, o 2,048 x
    2,048, gate_up 16,384 x 2,048, down 2,048 x 8,192; two layers), byte
    for byte: the quantizers divide by tensors (``ieee_div``), never by a
    Python scalar, which CUDA turns into a multiply by the reciprocal."""
    from omniserve_tpu_torch.models import llama

    w_bits = int(precision[1:precision.index("a")])
    spec = llama.LlamaSpec(
        num_layers=2, hidden=2048, intermediate=8192, num_q_heads=32,
        num_kv_heads=8, head_dim=64, vocab=128256,
        weight_bits=w_bits, act_bits=16 if w_bits == 16 else 8,
        group_size=group)
    rng = np.random.default_rng(0)
    shapes = {"qkv": (3072, 2048), "o": (2048, 2048),
              "gate_up": (16384, 2048), "down": (2048, 8192)}
    fp = {n: (rng.standard_normal((2,) + s, dtype=np.float32) * 0.02)
          for n, s in shapes.items()}
    fp["attn_ln"] = np.ones((2, 2048), np.float32)
    got = llama.quantize_layer_weights(fp, spec, device=dev)
    want = llama.quantize_layer_weights(fp, spec, device="cpu")
    for name in shapes:
        g, w = got[name], want[name]
        pairs = ([(g, w)] if isinstance(w, torch.Tensor)
                 else list(zip(g, w)))
        for a, b in pairs:
            assert a.is_cuda and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b), name


# -- Mixtral: the expert GEMMs on rows 1-3 and the MoE block -----------------


@pytest.mark.parametrize("m", [64, 4096])
@pytest.mark.parametrize("name,k,n", [("w13", 4096, 28672),
                                      ("w2", 14336, 4096)])
@pytest.mark.parametrize("mode", ["channel", "group", "w8"])
def test_expert_gemms_at_mixtral_shapes(dev, mode, name, k, n, m):
    """Rows 1-3 at Mixtral-8x7B's expert shapes, called as the served path
    calls them (``llama._apply_linear`` on index ``layer * E + e`` of a
    [L*E, ...] = [256, ...] stack, inside ``cuda.expert_launches``): the
    experts at stack indices 0 and 255 equal to their plain versions
    within 1e-5 at an expert's capacity at decode batch 128 (M = 64) and
    at an 8,192-token chunk (4,096), each launch counted under the
    ``_moe`` entry and not under the body GEMM's."""
    from chip_smoke import MOE_ENTRIES, MOE_STACK, moe_stack
    from omniserve_tpu_torch.models import llama
    from omniserve_tpu_torch.ops import cuda
    from omniserve_tpu_torch.ops.quantization import quantize_activations

    g = _gen(dev, 7)
    w = moe_stack(dev, g, mode, k, n, (0, MOE_STACK - 1))
    spec = llama.LlamaSpec(num_layers=1, hidden=k, intermediate=n,
                           num_q_heads=1, num_kv_heads=1, head_dim=128,
                           vocab=8, weight_bits=8 if mode == "w8" else 4,
                           group_size=128 if mode == "group" else -1)
    a, s, asum = quantize_activations(
        torch.randn((m, k), generator=g, device=dev),
        fuse_sum=mode == "channel")
    entry = MOE_ENTRIES[mode]
    for i in (0, MOE_STACK - 1):
        before = dict(cuda.LAUNCHES)
        with cuda.expert_launches():
            got = llama._apply_linear(w, spec, a, s, asum, i)
        assert cuda.LAUNCHES[entry] == before[entry] + 1
        base = entry[: -len("_moe")]
        assert cuda.LAUNCHES[base] == before[base]
        with cuda.plain_versions():
            want = llama._apply_linear(w, spec, a, s, asum, i)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                                   atol=1e-5)
    del w
    torch.cuda.empty_cache()


def _moe_spec(**extra):
    from omniserve_tpu_torch.models import mixtral

    kw = dict(num_layers=2, hidden=512, intermediate=768, num_q_heads=4,
              num_kv_heads=2, head_dim=128, vocab=512, page_size=128,
              lm_head_bits=16, num_experts=8, top_k=2)
    kw.update(extra)
    return mixtral.MixtralSpec(**kw)


@pytest.mark.parametrize("body", [dict(), dict(group_size=128),
                                  dict(weight_bits=8)])
def test_moe_mlp_graph_replay_matches_eager(dev, body):
    """Mixtral's MoE block (router, top-2, capacity dispatch, 16 expert
    GEMMs on rows 1-3, SwiGLU, combine) captured once in a CUDA graph and
    replayed on new rows and a new valid mask copied into its static
    inputs: bit for bit the eager block's output, finite (empty capacity
    rows carry zero scales), and the plain versions' within 1e-5 of its
    scale."""
    from omniserve_tpu_torch.models import mixtral
    from omniserve_tpu_torch.ops import cuda

    spec = _moe_spec(**body)
    lp = mixtral.make_random_packed_params(spec, seed=4,
                                           device=dev)["layers"]
    t, d = 96, spec.hidden
    g = _gen(dev, 8)
    h_in = torch.zeros((t, d), dtype=torch.bfloat16, device=dev)
    valid_in = torch.zeros(t, dtype=torch.bool, device=dev)

    def block():
        return mixtral.moe_mlp(h_in, lp, spec, layer=1, valid=valid_in)

    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            block()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        entry = "w4a8_matmul_per_group_moe" if body.get("group_size") else (
            "w8a8_matmul_moe" if body.get("weight_bits") == 8
            else "w4a8_matmul_per_channel_moe")
        before = cuda.LAUNCHES[entry]
        with torch.cuda.graph(graph):
            out = block()
        assert cuda.LAUNCHES[entry] == before + 16
        for trial in range(3):
            h = (torch.randn((t, d), generator=g, device=dev) * 2).bfloat16()
            valid = torch.rand(t, generator=g, device=dev) > 0.25 * trial
            h_in.copy_(h)
            valid_in.copy_(valid)
            graph.replay()
            eager = mixtral.moe_mlp(h, lp, spec, layer=1, valid=valid)
            assert torch.equal(out, eager)
            with cuda.plain_versions():
                plain = mixtral.moe_mlp(h, lp, spec, layer=1, valid=valid)
            scale = float(plain.float().abs().max())
            torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                                       atol=1e-5 * scale)
            assert torch.isfinite(out.float()).all()


def test_mixtral_decode_window_graph_matches_eager(dev):
    """Eight replays of a captured Mixtral decode step (``DecodeWindow``
    over a ``MixtralSpec`` runs ``mixtral_forward``: row 4's fused append,
    row 1's expert GEMMs) give the eager loop's tokens and pool bytes."""
    from omniserve_tpu_torch.models import llama, mixtral
    from omniserve_tpu_torch.ops.paged_kv import make_kv_pool
    from omniserve_tpu_torch.worker.decode_window import DecodeWindow

    spec = _moe_spec()
    params = mixtral.make_random_packed_params(spec, seed=3, device=dev)
    lens, b_pad, w = [300, 5, 200], 8, 4
    tables = np.zeros((b_pad, w), np.int32)
    tables[:3] = np.arange(3 * w).reshape(3, w)
    pool = make_kv_pool(2, 3 * w + 1, 2, 128, 128, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.vocab, n) for n in lens]
    batch = llama.PrefillBatch(
        token_ids=torch.from_numpy(np.concatenate(prompts)).to(dev),
        positions=torch.from_numpy(np.concatenate(
            [np.arange(n) for n in lens]).astype(np.int32)).to(dev),
        segment_ids=torch.from_numpy(np.concatenate(
            [np.full(n, i) for i, n in enumerate(lens)]).astype(
                np.int32)).to(dev),
        block_tables=torch.from_numpy(tables[:3]).to(dev),
        last_token_idx=torch.tensor(np.cumsum(lens) - 1, device=dev),
    )
    with torch.inference_mode():
        logits, _, _, _ = mixtral.mixtral_forward(params, pool, None, batch,
                                                  spec, is_prefill=True)
        first = np.zeros(b_pad, np.int32)
        first[:3] = logits.argmax(-1).cpu().numpy()
        positions = np.zeros(b_pad, np.int32)
        positions[:3] = lens
        active = np.arange(b_pad) < 3
        twin = pool.clone()
        toks = {}
        for mode, p in (("graph", pool), ("eager", twin)):
            win = DecodeWindow(params, p, spec, b_pad, w, dev,
                               use_graph=mode == "graph")
            win.load(first, positions, active, tables)
            toks[mode] = win.run(8).cpu().numpy()
            if mode == "graph":
                assert win.launches_per_step[False][
                    "w4a8_matmul_per_channel_moe"] == 16 * spec.num_layers
    np.testing.assert_array_equal(toks["graph"][:, :3], toks["eager"][:, :3])
    assert_pools_equal(pool, twin, skip_trash=True)
