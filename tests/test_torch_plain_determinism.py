"""The port's CPU plain decode gives one result for one input (ROADMAP
queue 3, F6).

F6 was one report of ``ops/cuda/decode_attention.py
paged_decode_attention_fused_plain`` giving two outputs 1.7e-5 apart for
the same inputs (``tests/test_torch_precision.py::
test_kv8_fused_decode_plain_matches_jax``, its last assertion). The
inputs here are that test's: a kv8 fine-grained pool of 128-token pages,
2 kv heads of 128 at n_rep 2, four rows (one inactive). Every call, on a
fresh copy of the pool, must give byte-equal outputs and pools: under
intra-op thread counts 1 to 8, with every input at another storage offset
(another alignment for the BLAS calls of ``attention_ref._sdpa``), and
beside a thread that keeps the CPU busy with matrix products.
"""

import threading

import numpy as np
import pytest
import torch

from omniserve_tpu_torch.ops import paged_kv
from omniserve_tpu_torch.ops.cuda import decode_attention as t_dec

PAGE, H, D, N_REP, W = 128, 2, 128, 2, 4
LENGTHS_OLD = [PAGE * 2 + 17, PAGE - 1, 3 * PAGE, 0]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(14)
    b = len(LENGTHS_OLD)
    tables = np.arange(b * W, dtype=np.int32).reshape(b, W)
    tables[3] = 0
    pool = paged_kv.make_kv_pool(2, tables.size + 1, H, PAGE, D, kv_bits=8,
                                 kv_zeros=True, device="cpu")
    for layer in range(2):
        for s, ln in enumerate(LENGTHS_OLD[:3]):
            pos = np.arange(ln)
            paged_kv.append_kv(
                pool, layer,
                torch.from_numpy(rng.standard_normal((ln, H, D)).astype(
                    np.float32)),
                torch.from_numpy(rng.standard_normal((ln, H, D)).astype(
                    np.float32)),
                torch.from_numpy(tables[s][pos // PAGE]),
                torch.from_numpy((pos % PAGE).astype(np.int32)),
                PAGE, kv_bits=8, kv_zeros=True)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).float()

    lens = np.asarray(LENGTHS_OLD, np.int32) + 1
    lens[3] = 0
    return dict(pool=pool, q=bf16((b, H * N_REP, D)), k=bf16((b, H, D)),
                v=bf16((b, H, D)), tables=torch.from_numpy(tables),
                lens=torch.from_numpy(lens))


def shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x``'s values in a view ``offset`` elements into a new buffer."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def call(inp, offset=0):
    pool = paged_kv.KVPool(*[None if t is None else shifted(t, offset)
                             for t in inp["pool"]])
    out = t_dec.paged_decode_attention_fused_plain(
        shifted(inp["q"], offset), pool, 1, shifted(inp["tables"], offset),
        shifted(inp["lens"], offset), shifted(inp["k"], offset),
        shifted(inp["v"], offset), sm_scale=D ** -0.5, page_size=PAGE,
        kv_bits=8)
    return [out] + [t for t in pool if t is not None]


def assert_bytes_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.contiguous().view(torch.uint8).equal(
            b.contiguous().view(torch.uint8))


def test_plain_decode_repeats_under_threads_and_offsets(inputs):
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        want = call(inputs)
        assert want[0][3].abs().max() == 0      # the inactive row
        for n in range(1, 9):
            torch.set_num_threads(n)
            for offset in (0, 1, 3, 16):
                assert_bytes_equal(call(inputs, offset), want)
    finally:
        torch.set_num_threads(threads)


def test_plain_decode_repeats_beside_a_busy_cpu(inputs):
    want = call(inputs)
    stop = threading.Event()

    def load():
        a = torch.randn(256, 256)
        while not stop.is_set():
            a = torch.tanh(a @ a)

    busy = [threading.Thread(target=load) for _ in range(2)]
    for t in busy:
        t.start()
    try:
        for _ in range(8):
            assert_bytes_equal(call(inputs), want)
    finally:
        stop.set()
        for t in busy:
            t.join()
