"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Small shapes (the main path's shapes run in ``chip_smoke.py``); every test
skips without CUDA. On a machine with an H100:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (8, 512, 256),
                                   (40, 1024, 384), (300, 256, 68)])
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
    with pytest.raises(ValueError, match="CUDA"):
        qm.w8a8_matmul(a.cpu(), w.to(torch.int8), f, r)


@pytest.mark.parametrize("lens,hq,hkv", [([300], 8, 2), ([50, 130, 7], 4, 4)])
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


@pytest.mark.parametrize("n_rep", [1, 4])
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
    twin = type(pool)(*(x.clone() for x in pool))
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
    for a, b_ in zip(pool, twin):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("history,chunk,n_rep,page,ragged", [
    (0, 24, 4, 16, False),       # first chunk, tokens of one tile
    (40, 24, 2, 16, False),      # history in earlier pages
    (16, 16, 1, 16, True),       # second row padded (q_pos -1) halfway
    (200, 130, 4, 128, False),   # page 128, chunk spans two pages
    (300, 64, 8, 128, True),
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
    tokens and pool bytes, from the same pool and metadata."""
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
        twin = type(pool)(*(x.clone() for x in pool))
        toks = {}
        for mode, p in (("graph", pool), ("eager", twin)):
            win = DecodeWindow(params, p, spec, b_pad, w, dev,
                               use_graph=mode == "graph")
            assert (win.graph is not None) == (mode == "graph")
            win.load(first, positions, active, tables)
            before = cuda.LAUNCHES["decode_attention_append"]
            toks[mode] = win.run(8).cpu().numpy()
            assert (cuda.LAUNCHES["decode_attention_append"] - before
                    == 8 * spec.num_layers)
    np.testing.assert_array_equal(toks["graph"][:, :3], toks["eager"][:, :3])
    for a, b_ in zip(pool, twin):
        assert torch.equal(a, b_)
